"""bf16 parity of the port's three model families with the JAX package:
the training forward's loss and logits at every position and the prefill's
greedy token, on reduced yi-9b, jamba-v0.1-52b and xlstm-350m.

The card runs its forwards in bf16, so this is the dtype the port's
cells use; the model-level tests beside this file hold f32 to 2e-5.
Weights come from the JAX ``init_params`` and cross as numpy through
``params_from_jax``; tokens are numpy draws from a fixed seed; B=2,
S=64, on the CPU.  The two frameworks round to bf16 at other places, so
the losses are held to 2e-3 relative (inside the 1e-2 bf16 gate of the
forwards that ``chip_smoke.py`` runs on the card), and the training
forward's logits at every position to limits set from this file's
measurements (``LOGITS``); the JAX side runs its reference path, the
port's side its reference path and its kernel hooks (the plain versions
on the CPU).  The prefill's logits of the last position of each prompt
must pick the same token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import model as jm
from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax

ARCHS = ("yi-9b", "jamba-v0.1-52b", "xlstm-350m")
B, S = 2, 64
# the loss gaps measured here: 2.6e-5 (yi-9b), 4.1e-4 (jamba), 1.05e-5
# (xlstm); 2e-3 is five times the largest, inside the 1e-2 bf16 gate
REL = 2e-3
# logits, per arch: (relative RMS gap, largest gap at any position, the
# top-two lead above which the greedy token must agree), about twice
# what the reference and kernel-hook paths measure here: RMS 0.0072 /
# 0.0085, 0.0720, 0.0350; largest 0.036, 1.25, 0.28; tokens that
# differ lead by at most 0.0156, 0.1406, 0.0469 (checked positions: 100,
# 44 and 79 of 128).  jamba's bf16 logits are as far from its own f32
# ones on either side (JAX 0.140, the port 0.127 relative RMS): the
# model at random init, not the port.
LOGITS = {"yi-9b": (0.02, 0.0625, 0.0625),
          "jamba-v0.1-52b": (0.15, 2.0, 0.3125),
          "xlstm-350m": (0.07, 0.5, 0.125)}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    """(port cfg, jax cfg, jax params, port params, tokens, targets)."""
    name = request.param
    cfg, jcfg = get_reduced(name), jax_get_reduced(name)
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(16)
    tok = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    tgt[:, -1] = -1
    return cfg, jcfg, jp, tp, tok, tgt


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_bf16_forward_loss_matches_jax(arch, impl):
    cfg, jcfg, jp, tp, tok, tgt = arch
    want, _ = jm.forward_loss(
        jp, jcfg, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
        compute_dtype=jnp.bfloat16)
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="bfloat16",
                    attention_impl=impl)
    hooks = steps._resolve_kernels(run) if impl == "pallas" else {}
    ops.reset_launches()
    got, _ = M.forward_loss(tp, cfg, {"tokens": torch.from_numpy(tok),
                                      "targets": torch.from_numpy(tgt)},
                            compute_dtype=torch.bfloat16, run_cfg=run,
                            **hooks)
    assert not any(ops.LAUNCHES.values())      # CPU: plain versions
    want = float(want)
    assert np.isfinite(float(got))
    assert abs(float(got) - want) <= REL * abs(want), (float(got), want)


def test_bf16_prefill_picks_the_jax_tokens(arch):
    cfg, jcfg, jp, tp, tok, _ = arch
    want, _ = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(tok)},
                         compute_dtype=jnp.bfloat16)
    got, _ = M.prefill(tp, cfg, {"tokens": torch.from_numpy(tok)},
                       compute_dtype=torch.bfloat16)
    want = np.asarray(want.astype(jnp.float32))[..., :cfg.vocab_size]
    got = got.float().numpy()[..., :cfg.vocab_size]
    assert got.shape == want.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))



def _captured_logits(module, call):
    """Run ``call()`` with ``module.cross_entropy_loss`` wrapped so that it
    keeps the logits it is given: the training forward's own logits at
    every position, as f32 numpy."""
    seen = []
    inner = module.cross_entropy_loss

    def keep(logits, *args, **kw):
        seen.append(logits)
        return inner(logits, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "cross_entropy_loss", keep)
        call()
    (logits,) = seen
    if isinstance(logits, torch.Tensor):
        return logits.float().numpy()
    return np.asarray(logits.astype(jnp.float32))


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_bf16_forward_logits_match_jax_at_every_position(arch, impl):
    """The training forward's bf16 logits at every (b, s) against the JAX
    package's: the relative RMS gap, the largest gap at any position, and
    the same greedy token wherever the JAX top two logits are further
    apart than the arch's lead (bf16 logits of ~2.6 tie within an ulp,
    0.0156, elsewhere)."""
    cfg, jcfg, jp, tp, tok, tgt = arch
    rms_lim, max_lim, lead = LOGITS[cfg.name.removesuffix("-reduced")]
    want = _captured_logits(jm, lambda: jm.forward_loss(
        jp, jcfg, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
        compute_dtype=jnp.bfloat16))
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="bfloat16",
                    attention_impl=impl)
    hooks = steps._resolve_kernels(run) if impl == "pallas" else {}
    got = _captured_logits(M, lambda: M.forward_loss(
        tp, cfg, {"tokens": torch.from_numpy(tok),
                  "targets": torch.from_numpy(tgt)},
        compute_dtype=torch.bfloat16, run_cfg=run, **hooks))
    want, got = want[..., :cfg.vocab_size], got[..., :cfg.vocab_size]
    assert got.shape == want.shape == (B, S, cfg.vocab_size)
    assert np.isfinite(got).all()
    rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
    assert rms <= rms_lim, rms
    assert np.abs(got - want).max() <= max_lim, np.abs(got - want).max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > lead
    np.testing.assert_array_equal(got.argmax(-1)[clear],
                                  want.argmax(-1)[clear])
