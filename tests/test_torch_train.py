"""The port's training path against the JAX package's: AdamW and its
schedule, the data pipeline, rematerialisation, the train step and the
bf16 trainer, on the CPU at reduced size.

  * ``adamw_update`` after 3 updates, ``cosine_schedule`` and
    ``global_norm`` on shared numpy trees (f32, and bf16 parameters with
    the f32 master) within 1e-6 of the JAX package's;
  * 10 steps of the port's ``make_train_step`` against
    ``jax.jit(repro.launch.steps.make_train_step)`` on reduced yi-9b,
    jamba-v0.1-52b and xlstm-350m, from the JAX ``init_params`` carried
    across by ``params_from_jax`` and on the JAX ``make_batch`` batches,
    with ``grad_accum`` 1 and 2: losses within 2e-5 relative, the global
    gradient norm within 1e-4, the step-0 gradients within 5e-5 of each
    leaf's largest |grad|, the parameters within 2 x the summed learning
    rate (``PARAM_BOUND``);
  * reduced xlstm with bf16 parameters (ROADMAP C13), in
    ``test_torch_train_xlstm.py``: ``forward_loss`` within 1e-2 of the
    JAX package's, and 3 bf16 train steps;
  * the entry points (``Trainer``, ``SyntheticPipeline`` /
    ``make_batch``, ``train.main``) raise with no card and no
    ``device="cpu"``.

On the card (``cuda``-marked, skipped here): the card against the CPU
port on the reduced models, and one yi-9b step at full width.  JAX is
imported inside the fixtures that need it, so the card's machine (no
JAX) runs the ``cuda`` tests alone:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_train.py
"""
import math
import types
from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
from repro_torch.core.straggler import StragglerMonitor
from repro_torch.data import SyntheticPipeline, make_batch
from repro_torch.launch import steps, train
from repro_torch.models import forward_loss
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.optim import (adamw_init, adamw_update, cosine_schedule,
                               global_norm)
from repro_torch.tree import flatten, map_tree

ARCHS = ("yi-9b", "jamba-v0.1-52b", "xlstm-350m")
STEPS = 10
DATA_SEED = 3
# an AdamW step moves an element by about lr whatever its gradient's
# size, so an element whose tiny gradient flips sign between the two
# packages can drift by up to 2 x the summed rates: 2 x 1.65e-4 over the
# 10 warm-up steps (lr_t = 3e-4 (t + 1) / 100).  Measured gap on the
# CPU: at most 2.7e-6 (jamba, grad_accum 2).
PARAM_BOUND = 2 * sum(3e-4 * (t + 1) / 100 for t in range(STEPS))


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """One intra-op thread for this module's tiny tensors: beside other
    test workers on the machine, OpenMP's spinning threads made the
    port's CPU steps up to ~100x slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def J():
    """The JAX package's modules (imported here: the card's machine has
    no JAX and runs only this file's ``cuda`` tests)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import RunConfig as JRun
    from repro.configs import ShapeConfig as JShape
    from repro.configs import get_reduced as jget_reduced
    from repro.data.pipeline import make_batch as jmake_batch
    from repro.launch import steps as jsteps
    from repro.models import model as jm
    from repro.optim import adamw as jadamw
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Run=JRun, Shape=JShape, get_reduced=jget_reduced,
        make_batch=jmake_batch, steps=jsteps, m=jm, adamw=jadamw)


def _np_tree(J, tree):
    return J.jax.tree.map(lambda x: np.asarray(x, np.float32)
                          if x.dtype == J.jnp.bfloat16 else np.asarray(x),
                          tree)


def _flat(tree) -> dict:
    """'/'-joined key -> numpy leaf of a nested dict of arrays."""
    return {"/".join(map(str, p)): np.asarray(a) for p, a in flatten(tree)}


def _assert_trees_close(got: dict, want: dict, atol_of):
    assert set(got) == set(want)
    worst = 0.0
    for k in want:
        gap = float(np.max(np.abs(got[k] - want[k]), initial=0.0))
        assert gap <= atol_of(want[k]), (k, gap, atol_of(want[k]))
        worst = max(worst, gap)
    return worst


# -- AdamW -----------------------------------------------------------------

def _opt_tree(rng, dtype):
    return {"a": rng.standard_normal((4, 8)).astype(dtype),
            "nested": {"b": rng.standard_normal(3).astype(dtype),
                       "c": rng.standard_normal((2, 5)).astype(dtype)}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(J, dtype):
    jnp = J.jnp
    rng = np.random.default_rng(5)
    p0 = _opt_tree(rng, np.float32)
    grads = [_opt_tree(rng, np.float32) for _ in range(3)]
    tdt = getattr(torch, dtype)
    jp = J.jax.tree.map(lambda x: jnp.asarray(x, dtype), p0)
    tp = map_tree(lambda x: torch.from_numpy(x).to(tdt), p0)
    jopt, topt = J.adamw.adamw_init(jp), adamw_init(tp)
    assert ("master" in topt) == ("master" in jopt) == (dtype != "float32")
    for i, g in enumerate(grads):
        # a large gradient on the first update: the clip engages
        g = J.jax.tree.map(lambda x: x * (40.0 if i == 0 else 0.3), g)
        jlr = J.adamw.cosine_schedule(jopt["step"], base_lr=1e-2,
                                      warmup_steps=2)
        tlr = cosine_schedule(topt["step"], base_lr=1e-2, warmup_steps=2)
        jp, jopt, jm_ = J.adamw.adamw_update(
            J.jax.tree.map(lambda x: jnp.asarray(x, dtype), g), jopt, jp,
            lr=jlr)
        tp, topt, tm = adamw_update(
            map_tree(lambda x: torch.from_numpy(x).to(tdt), g), topt, tp,
            lr=tlr)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm_["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm_["lr"]), rel=1e-6)
    assert int(topt["step"]) == int(jopt["step"]) == 3
    assert all(x.dtype == tdt for _, x in flatten(tp))
    got = _flat(params_to_jax({"params": tp, **topt}))
    want = _flat(_np_tree(J, {"params": jp, **jopt}))
    _assert_trees_close(got, want, lambda w: 1e-6 * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("step", [0, 50, 100, 5000, 20000])
def test_cosine_schedule_matches_jax(J, step):
    want = J.adamw.cosine_schedule(J.jnp.int32(step), base_lr=3e-4)
    got = cosine_schedule(torch.tensor(step, dtype=torch.int32),
                          base_lr=3e-4)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_global_norm_matches_jax(J):
    rng = np.random.default_rng(6)
    tree = _opt_tree(rng, np.float32)
    want = J.adamw.global_norm(J.jax.tree.map(J.jnp.asarray, tree))
    got = global_norm(map_tree(torch.from_numpy, tree))
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    bf = map_tree(lambda x: torch.from_numpy(x).to(torch.bfloat16), tree)
    want = J.adamw.global_norm(J.jax.tree.map(
        lambda x: J.jnp.asarray(x, J.jnp.bfloat16), tree))
    assert float(global_norm(bf)) == pytest.approx(float(want), rel=1e-6)


# -- the data pipeline -----------------------------------------------------

def test_make_batch_is_a_function_of_seed_and_step():
    cfg = get_reduced("yi-9b")
    shape = replace(REDUCED_SHAPE, seq_len=64, global_batch=4)
    a = make_batch(cfg, shape, 7, seed=1, device="cpu")
    b = SyntheticPipeline(cfg, shape, seed=1, device="cpu").batch(7)
    for k in ("tokens", "targets"):
        assert a[k].dtype == torch.int32 and a[k].shape == (4, 64)
        assert torch.equal(a[k], b[k])
    assert torch.equal(a["tokens"][:, 1:], a["targets"][:, :-1])
    assert not torch.equal(a["tokens"],
                           make_batch(cfg, shape, 8, seed=1,
                                      device="cpu")["tokens"])
    assert not torch.equal(a["tokens"],
                           make_batch(cfg, shape, 7, seed=2,
                                      device="cpu")["tokens"])
    # u**3 skews the draws to low ids: P(tok < V/8) = P(u < 1/2) = 1/2
    big = make_batch(cfg, replace(shape, seq_len=4096), 0, device="cpu")
    toks = big["tokens"].numpy()
    assert 0 <= toks.min() and toks.max() < cfg.vocab_size
    assert abs(np.mean(toks < cfg.vocab_size // 8) - 0.5) < 0.02


def test_make_batch_raises_on_unported_inputs(J):
    """The stub frontends' inputs: ``enc_embeds`` (whisper) and
    ``patch_embeds`` (internvl2, whose tokens are seq_len less the
    patches) of the JAX package's shapes and dtypes, 0.02 * N(0, 1),
    a function of (seed, step)."""
    for arch, key in (("whisper-large-v3", "enc_embeds"),
                      ("internvl2-2b", "patch_embeds")):
        cfg = get_reduced(arch)
        want = J.make_batch(J.get_reduced(arch), J.Shape(
            "smoke", REDUCED_SHAPE.seq_len, REDUCED_SHAPE.global_batch,
            "train"), 0)
        got = make_batch(cfg, REDUCED_SHAPE, 0, device="cpu")
        assert set(got) == set(want) == {"tokens", "targets", key}
        for name in got:
            assert tuple(got[name].shape) == want[name].shape, name
            assert str(got[name].dtype)[6:] == str(want[name].dtype), name
        e = got[key]
        assert float(e.std()) == pytest.approx(0.02, rel=0.1)
        assert torch.equal(e, make_batch(cfg, REDUCED_SHAPE, 0,
                                         device="cpu")[key])
        assert not torch.equal(e, make_batch(cfg, REDUCED_SHAPE, 1,
                                             device="cpu")[key])


# -- rematerialisation -----------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_value(arch):
    cfg = get_reduced(arch)
    params = train.init_params(cfg, 0, device="cpu")
    batch = make_batch(cfg, REDUCED_SHAPE, 0, device="cpu")
    out = {}
    for remat in (False, True):
        run = RunConfig(model=cfg, shape=REDUCED_SHAPE,
                        compute_dtype="float32", remat=remat)
        out[remat] = steps.make_value_and_grad(cfg, run)(params, batch)
    assert torch.equal(out[True][0], out[False][0])
    for (_, a), (_, b) in zip(flatten(out[True][1]), flatten(out[False][1])):
        assert torch.equal(a, b)


# -- the train step against the JAX package's --------------------------------

def _jax_batches(J, jcfg, shape, n=STEPS):
    return [{k: np.asarray(v) for k, v in
             J.make_batch(jcfg, shape, s, seed=DATA_SEED).items()}
            for s in range(n)]


def _torch_batch(b, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in b.items()}


_JAX_PARAMS = {}


def _jax_init(J, arch):
    """The JAX ``init_params`` of the reduced ``arch`` (cached: its jit
    takes seconds)."""
    if arch not in _JAX_PARAMS:
        _JAX_PARAMS[arch] = J.jax.jit(J.m.init_params, static_argnums=0)(
            J.get_reduced(arch), J.jax.random.PRNGKey(0))
    return _JAX_PARAMS[arch]


def parity_run(J, arch, accum, n_steps=STEPS):
    """``n_steps`` (10) steps of both packages' train steps from the same
    weights on the same batches, with the port's step-0 gradients and the JAX
    step's, recovered from its first moment: after step 0, ``mu = (1 -
    beta1) * scale * g`` with ``scale = min(1, clip / (|g| + 1e-9))``
    from the step's own grad_norm (a few f32 roundings away from g)."""
    jcfg, cfg = J.get_reduced(arch), get_reduced(arch)
    jshape = J.Shape("smoke", REDUCED_SHAPE.seq_len,
                     REDUCED_SHAPE.global_batch, "train", grad_accum=accum)
    shape = replace(REDUCED_SHAPE, grad_accum=accum)
    jrun = J.Run(model=jcfg, shape=jshape, compute_dtype="float32")
    run = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    batches = _jax_batches(J, jcfg, jshape, n_steps)
    jp = _jax_init(J, arch)
    tp = params_from_jax(J.jax.tree.map(np.asarray, jp), cfg, device="cpu")
    _, tg = steps.make_value_and_grad(cfg, run)(tp, _torch_batch(batches[0]))

    jstep = J.jax.jit(J.steps.make_train_step(jcfg, jrun))
    jopt = J.adamw.adamw_init(jp)
    tstep = steps.make_train_step(cfg, run)
    topt = adamw_init(tp)
    jm_, tm = [], []
    for b in batches:
        jp, jopt, m = jstep(jp, jopt, b)
        jm_.append({k: float(v) for k, v in m.items()})
        if len(jm_) == 1:
            scale = min(1.0, run.grad_clip / (jm_[0]["grad_norm"] + 1e-9))
            jg = J.jax.tree.map(
                lambda mu: np.asarray(mu) / ((1 - run.beta1) * scale),
                jopt["mu"])
        tp, topt, m = tstep(tp, topt, _torch_batch(b))
        tm.append({k: float(v) for k, v in m.items()})
    return types.SimpleNamespace(
        jax_metrics=jm_, metrics=tm,
        jax_grads=_flat(jg), grads=_flat(params_to_jax(tg)),
        jax_params=_flat(_np_tree(J, jp)), params=_flat(params_to_jax(tp)))


# xlstm-350m's runs are in test_torch_train_xlstm.py, on another worker
@pytest.fixture(scope="module", params=[(a, n) for a in ARCHS[:2]
                                        for n in (1, 2)],
                ids=[f"{a}-accum{n}" for a in ARCHS[:2] for n in (1, 2)])
def trained(request, J):
    return parity_run(J, *request.param)


def test_train_step_losses_match_jax(trained):
    for t, (got, want) in enumerate(zip(trained.metrics,
                                        trained.jax_metrics)):
        assert math.isfinite(got["loss"])
        assert got["loss"] == pytest.approx(want["loss"], rel=2e-5), t
        assert got["lr"] == pytest.approx(want["lr"], rel=1e-6), t


def test_train_step_grad_norm_matches_jax(trained):
    for t, (got, want) in enumerate(zip(trained.metrics,
                                        trained.jax_metrics)):
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-4), t


def test_step0_gradients_match_jax(trained):
    """Each leaf within 5e-5 of its largest |grad| (measured on the CPU:
    at most 2.7e-5 (jamba), 1.2e-5 (xlstm), 1e-6 (yi-9b))."""
    _assert_trees_close(trained.grads, trained.jax_grads,
                        lambda w: 5e-5 * np.abs(w).max())


def test_train_step_params_match_jax(trained):
    worst = _assert_trees_close(trained.params, trained.jax_params,
                                lambda w: PARAM_BOUND)
    assert worst < PARAM_BOUND


def test_train_step_with_the_kernels_raises_naming_c6():
    cfg = get_reduced("yi-9b")
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, attention_impl="pallas")
    with pytest.raises(NotImplementedError, match="C6"):
        steps.make_train_step(cfg, run)


# -- the straggler monitor -------------------------------------------------

def test_straggler_monitor_is_the_jax_packages():
    from repro.core.straggler import StragglerMonitor as JaxMonitor
    rng = np.random.default_rng(0)
    ours, theirs = StragglerMonitor(min_pods=2), JaxMonitor(min_pods=2)
    for _ in range(12):
        for pod, base in (("a", 1.0), ("b", 1.05), ("c", 2.5), ("d", 1.9)):
            t = base * (1 + 0.1 * rng.random())
            ours.record(pod, t)
            theirs.record(pod, t)
    assert ours.times == theirs.times and ours.counts == theirs.counts
    assert ours.stragglers() == theirs.stragglers() == ["c"]
    for pod in ("c", "d", "b"):
        assert ours.evict(pod) == theirs.evict(pod)
    assert ours.evicted == theirs.evicted == ["c", "d"]


# -- the entry points ------------------------------------------------------

def test_training_entry_points_default_to_the_card(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, shape, run = train.build("yi-9b", reduced=True)
    for call in (lambda: train.Trainer(cfg, shape, run),
                 lambda: SyntheticPipeline(cfg, shape),
                 lambda: make_batch(cfg, shape, 0),
                 lambda: train.main(["--arch", "yi-9b", "--reduced",
                                     "--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    tr = train.Trainer(cfg, shape, run, device="cpu")
    assert tr.params["embed"]["table"].device.type == "cpu"
    assert tr.pipe.batch(0)["tokens"].device.type == "cpu"


def test_build_sets_remat_for_full_configs():
    _, shape, run = train.build("yi-9b", reduced=False, batch=2, seq=4096,
                                grad_accum=2)
    assert run.remat and shape.grad_accum == 2 and shape.global_batch == 2
    _, shape, run = train.build("yi-9b", reduced=True)
    assert not run.remat and (shape.seq_len, shape.global_batch) == (64, 4)


# -- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card-side training checks")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_card_train_steps_match_the_cpu(cuda, arch):
    """3 f32 steps on the card and on the CPU from the same weights and
    batches: losses within 1e-5 relative, grad_norm within 1e-4, the
    parameters within PARAM_BOUND."""
    cfg = get_reduced(arch)
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="float32")
    cpu_p = train.init_params(cfg, 0, device="cpu")
    card_p = map_tree(lambda x: x.to(cuda), cpu_p)
    out = {}
    for dev, p in (("cpu", cpu_p), ("cuda", card_p)):
        opt, step, ms = adamw_init(p), steps.make_train_step(cfg, run), []
        for s in range(3):
            p, opt, m = step(p, opt, make_batch(cfg, REDUCED_SHAPE, s,
                                                device=dev))
            ms.append({k: float(v) for k, v in m.items()})
        out[dev] = (ms, _flat(params_to_jax(p)))
    for got, want in zip(out["cuda"][0], out["cpu"][0]):
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"],
                                                 rel=1e-4)
    _assert_trees_close(out["cuda"][1], out["cpu"][1], lambda w: PARAM_BOUND)


@pytest.mark.cuda
def test_card_full_width_train_step(cuda):
    """One yi-9b step at full width, 4 of 48 layers, B=2, S=4096,
    grad_accum 2, remat on: a finite loss within 2.0 of ln 64000."""
    cfg, shape, run = train.build("yi-9b", reduced=False, batch=2, seq=4096,
                                  grad_accum=2)
    cfg = replace(cfg, num_layers=4)
    run = run.replace(model=cfg)
    tr = train.Trainer(cfg, shape, run, device=cuda)
    loss, = tr.train(1, log_every=0)
    assert abs(loss - math.log(cfg.vocab_size)) < 2.0
    assert int(tr.opt["step"]) == 1
