"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX package's ``repro.models.mla`` on the same weights and
inputs, on the CPU in f32.

  * ``_queries``, ``_latents``, ``mla_forward`` (the decompressed form
    through the chunked reference attention, on each of its branches:
    one block, KV-segmented, segmented and query-chunked) and
    ``mla_decode`` (the absorbed form against the latent cache) within
    2e-5;
  * the prefill's logits against token-by-token decode within 2e-4, as
    the JAX package's tests/test_archs.py holds its own.

Weights are numpy draws from a seed at reduced minicpm3-4b's MLA widths
(q_lora 32, kv_lora 16, nope 8, rope 8, v 8: the q/k head dim 16 is not
the v head dim) and at wider ones (q/k 24, v 16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.models import mla as jmla
from repro.models import model as jm
from repro_torch.configs import MLAConfig, get_reduced
from repro_torch.models import mla
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)
D_MODEL, HEADS, THETA = 64, 4, 1e4
WIDTHS = {"reduced": MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                               qk_nope_head_dim=8, qk_rope_head_dim=8,
                               v_head_dim=8),
          "wide": MLAConfig(q_lora_rank=48, kv_lora_rank=32,
                            qk_nope_head_dim=16, qk_rope_head_dim=8,
                            v_head_dim=16)}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _weights(cfg, seed):
    """numpy MLA weights of the JAX tree's shapes; norms' scales drawn
    around 1 so that they count."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmla.init_mla(
        jax.random.PRNGKey(0), D_MODEL, HEADS, cfg))
    flat, tree = jax.tree_util.tree_flatten(shapes)
    leaves = [(1 + 0.1 * rng.standard_normal(s.shape)) if len(s.shape) == 1
              else rng.standard_normal(s.shape) / np.sqrt(s.shape[0])
              for s in flat]
    jp = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(a, jnp.float32) for a in leaves])
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jp, tp


def _x(rng, B, S):
    return rng.standard_normal((B, S, D_MODEL)).astype(np.float32)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_queries_and_latents(width):
    cfg = WIDTHS[width]
    jp, tp = _weights(cfg, 1)
    x = _x(np.random.default_rng(2), 2, 12)
    pos = np.arange(5, 17)
    want_q = jmla._queries(jp, jnp.asarray(x), jnp.asarray(pos), cfg, THETA)
    got_q = mla._queries(tp, torch.from_numpy(x), torch.from_numpy(pos),
                         cfg, THETA)
    want_l = jmla._latents(jp, jnp.asarray(x), jnp.asarray(pos), cfg, THETA)
    got_l = mla._latents(tp, torch.from_numpy(x), torch.from_numpy(pos),
                         cfg, THETA)
    for got, want in zip(got_q + got_l, want_q + want_l):
        assert tuple(got.shape) == want.shape
        _close(got, want)


@pytest.mark.parametrize("width", sorted(WIDTHS))
@pytest.mark.parametrize("S,q_chunk", [(12, 1024), (32, 8), (32, 4),
                                       (24, 8)],
                         ids=["one-block", "segmented", "segmented-chunked",
                              "chunked"])
def test_mla_forward(width, S, q_chunk):
    """Output and the latents that seed the cache; the v head dim
    differs from the q/k one on every branch of chunked_attention."""
    cfg = WIDTHS[width]
    jp, tp = _weights(cfg, 3)
    x = _x(np.random.default_rng(4), 2, S)
    pos = np.arange(S)
    want, (wc, wr) = jmla.mla_forward(jp, jnp.asarray(x),
                                      positions=jnp.asarray(pos), mla=cfg,
                                      rope_theta=THETA, q_chunk=q_chunk)
    got, (gc, gr) = mla.mla_forward(tp, torch.from_numpy(x),
                                    positions=torch.from_numpy(pos), mla=cfg,
                                    rope_theta=THETA, q_chunk=q_chunk)
    _close(got, want)
    _close(gc, wc)
    _close(gr, wr)


@pytest.mark.parametrize("width", sorted(WIDTHS))
def test_mla_decode(width):
    """Five absorbed-form steps from a cache holding random latents: the
    outputs and the cache within 2e-5 of the JAX package's, the port's
    cache written in place."""
    cfg = WIDTHS[width]
    jp, tp = _weights(cfg, 5)
    rng = np.random.default_rng(6)
    B, smax = 2, 10
    cache = {"c_kv": rng.standard_normal((B, smax, cfg.kv_lora_rank)),
             "k_rope": rng.standard_normal((B, smax, cfg.qk_rope_head_dim))}
    jc = {k: jnp.asarray(v, jnp.float32) for k, v in cache.items()}
    tc = {k: torch.from_numpy(v.astype(np.float32)) for k, v in cache.items()}
    for pos in (3, 4, 5, 6, 9):
        x = _x(rng, B, 1)
        want, jc = jmla.mla_decode(jp, jnp.asarray(x), jc,
                                   pos=jnp.int32(pos), mla=cfg,
                                   rope_theta=THETA)
        before = tc["c_kv"]
        got, tc = mla.mla_decode(tp, torch.from_numpy(x), tc, pos=pos,
                                 mla=cfg, rope_theta=THETA)
        assert tc["c_kv"] is before
        _close(got, want)
        for k in tc:
            _close(tc[k], jc[k])


def test_init_mla_cache():
    cfg = WIDTHS["wide"]
    c = mla.init_mla_cache(3, 20, cfg, torch.bfloat16, "cpu")
    j = jmla.init_mla_cache(3, 20, cfg, jnp.bfloat16)
    assert {k: tuple(v.shape) for k, v in c.items()} == \
        {k: v.shape for k, v in j.items()}
    assert all(v.dtype == torch.bfloat16 and not v.any()
               for v in c.values())


def test_prefill_agrees_with_absorbed_decode():
    """Reduced minicpm3-4b: the prefill's (decompressed) last logits
    within 2e-4 of token-by-token absorbed decode's, and the decode's
    latent cache within 2e-5 of the prefill's latents."""
    cfg = get_reduced("minicpm3-4b")
    jp = jax.jit(jm.init_params, static_argnums=0)(
        jax_get_reduced("minicpm3-4b"), jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tok = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32))
    logits, pre = M.prefill(tp, cfg, {"tokens": tok},
                            compute_dtype=torch.float32)
    caches = M.init_cache(cfg, 2, 9, torch.float32, device="cpu")
    for t in range(8):
        step, caches = M.decode_step(tp, cfg, caches, tok[:, t:t + 1], t,
                                     compute_dtype=torch.float32)
    np.testing.assert_allclose(step.numpy(), logits.numpy(), rtol=2e-4,
                               atol=2e-4)
    for name in ("c_kv", "k_rope"):
        np.testing.assert_allclose(caches[0]["b0"][name][:, :8].numpy(),
                                   pre[0]["b0"][name].numpy(), **TOL)
