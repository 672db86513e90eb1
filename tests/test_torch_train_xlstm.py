"""The train-step parity of ``test_torch_train.py`` on reduced
xlstm-350m (10 steps against ``jax.jit(repro.launch.steps.
make_train_step)``, ``grad_accum`` 1 and 2), and the bf16-parameter
trainer on it (ROADMAP C13).  A file of its own so that the JAX
compiles of the sLSTM's scan run on another test worker than the other
two architectures'."""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
from repro_torch.launch import steps
from repro_torch.models import forward_loss
from repro_torch.models.convert import params_from_jax
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten, map_tree
from test_torch_train import (  # noqa: F401
    J, _jax_batches, _jax_init, _torch_batch, one_cpu_thread, parity_run,
    test_step0_gradients_match_jax, test_train_step_grad_norm_matches_jax,
    test_train_step_losses_match_jax, test_train_step_params_match_jax)


@pytest.fixture(scope="module", params=[1, 2], ids=["accum1", "accum2"])
def trained(request, J):
    return parity_run(J, "xlstm-350m", request.param)


# -- bf16 parameters (ROADMAP C13) ------------------------------------------

def test_bf16_xlstm_trains_and_matches_jax(J):
    """The JAX trainer casts every float parameter to bf16 for a bf16
    run; the sLSTM's recurrent matrices must then meet the f32 h in f32,
    as the JAX einsum's promotion gives them (this raised a dtype error
    in the port before).  ``forward_loss`` within 1e-2 of the JAX
    package's, then 3 bf16 train steps, the first one's loss that
    forward's."""
    jnp = J.jnp
    jcfg, cfg = J.get_reduced("xlstm-350m"), get_reduced("xlstm-350m")
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="bfloat16")
    jp = _jax_init(J, "xlstm-350m")
    tp = params_from_jax(J.jax.tree.map(np.asarray, jp), cfg, device="cpu")
    jp = J.jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
    tp = map_tree(lambda x: x.to(torch.bfloat16), tp)
    batches = _jax_batches(J, jcfg, J.Shape("smoke", REDUCED_SHAPE.seq_len,
                                            REDUCED_SHAPE.global_batch,
                                            "train"))[:3]
    want, _ = J.m.forward_loss(jp, jcfg, batches[0],
                               compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got, _ = forward_loss(tp, cfg, _torch_batch(batches[0]),
                              compute_dtype=torch.bfloat16)
    assert float(got) == pytest.approx(float(want), rel=1e-2)

    topt = adamw_init(tp)
    assert "master" in topt
    tstep = steps.make_train_step(cfg, run)
    losses = []
    for b in batches:
        tp, topt, tm = tstep(tp, topt, _torch_batch(b))
        losses.append(float(tm["loss"]))
    assert all(map(math.isfinite, losses))
    assert losses[0] == pytest.approx(float(got), rel=1e-6)
    assert all(x.dtype == torch.bfloat16 for _, x in flatten(tp))
    assert int(topt["step"]) == 3
