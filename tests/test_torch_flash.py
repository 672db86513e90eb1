"""The port's flash attention (plain version and wrappers) against the
JAX package's, on shared numpy inputs.

On the CPU the port's wrappers run the plain version
(``repro_torch.kernels.ref``); the JAX side runs its jnp oracle and its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs them.
Tolerances are those of ``tests/test_kernels.py``: 2e-5 for f32, 2e-2
for bf16.  The CUDA kernel itself is held to the plain version on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import \
    flash_attention_kernel as jax_flash_kernel
from repro_torch.kernels import ops, ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _pair(a, name):
    """The same numpy values as a torch and a jax array of one dtype
    (both casts round to nearest even)."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a).astype(jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(seed, q_shape, kv_shape, name):
    rng = np.random.default_rng(seed)
    return [_pair(rng.standard_normal(s).astype(np.float32), name)
            for s in (q_shape, kv_shape, kv_shape)]


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (1, 128, 128, 2, 2, 64, True),
    (2, 256, 256, 4, 2, 64, True),      # GQA
    (1, 128, 384, 2, 1, 128, False),    # cross-ish, MQA
    (2, 96, 160, 2, 2, 80, True),       # not 128-aligned
])
def test_model_layout_plain_version_matches_jax(B, Sq, Skv, H, Hkv, D,
                                                causal, name):
    (qt, qj), (kt, kj), (vt, vj) = _qkv(B * Sq + D, (B, Sq, H, D),
                                        (B, Skv, Hkv, D), name)
    ops.reset_launches()
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert ops.LAUNCHES["flash_attention"] == 0      # CPU: plain version
    assert got.dtype == qt.dtype and got.shape == (B, Sq, H, D)
    # the JAX wrapper (Pallas, interpret mode on the CPU)
    np.testing.assert_allclose(_f32(got),
                               _f32(jops.flash_attention(qj, kj, vj,
                                                         causal=causal)),
                               **_tol(name))
    # the JAX oracle in the kernel layout
    def bhsd(x, heads):
        return x.transpose(0, 2, 1, 3).reshape(B * heads, -1, D)
    want = jref.flash_attention_ref(bhsd(qj, H), bhsd(kj, Hkv), bhsd(vj, Hkv),
                                    causal=causal)
    want = want.reshape(B, H, Sq, D).transpose(0, 2, 1, 3)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol(name))


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("kw", [
    dict(causal=True, q_offset=128),
    dict(causal=False, kv_len=200),
    dict(causal=True, kv_len=192, q_offset=64, scale=0.05),
], ids=["q_offset", "kv_len", "both_and_scale"])
def test_kernel_layout_plain_version_matches_jax(kw, name):
    """(BHG, S, D) entry point with GQA (G = 2), q_offset and kv_len,
    against the JAX oracle and the Pallas kernel (interpret mode)."""
    (qt, qj), (kt, kj), (vt, vj) = _qkv(7, (4, 128, 128), (2, 256, 128),
                                        name)
    got = ops.flash_attention_kernel(qt, kt, vt, **kw)
    assert got.shape == qt.shape and got.dtype == qt.dtype
    np.testing.assert_allclose(
        _f32(got), _f32(jref.flash_attention_ref(qj, kj, vj, **kw)),
        **_tol(name))
    np.testing.assert_allclose(
        _f32(got), _f32(jax_flash_kernel(qj, kj, vj, interpret=True, **kw)),
        **_tol(name))


def test_plain_model_layout_is_the_kernel_layout_regrouped():
    """GQA grouping: head h reads kv head h // G, the model's reshape."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 16, 6, 8), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 24, 2, 8), np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 24, 2, 8), np.float32))
    got = ref.flash_attention_model_ref(q, k, v, causal=False)
    kk = k.repeat_interleave(3, dim=2)
    vv = v.repeat_interleave(3, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kk) * 8 ** -0.5
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), vv)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bad", ["dtype", "mixed_dtype", "head_dim",
                                 "batch", "groups", "kv_len", "q_offset",
                                 "device"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 8, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    v = torch.zeros(2, 8, 2, 16)
    kw = {}
    fn = ops.flash_attention
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(t.shape[:-1] + (264,)) for t in (q, k, v))
    elif bad == "batch":
        k, v = k[:1], v[:1]
    elif bad == "groups":
        q = torch.zeros(2, 8, 3, 16)
    elif bad in ("kv_len", "q_offset"):
        fn = ops.flash_attention_kernel
        q, k, v = torch.zeros(4, 8, 16), torch.zeros(2, 8, 16), \
            torch.zeros(2, 8, 16)
        kw = {"causal": True, bad: 0 if bad == "kv_len" else -1}
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises((TypeError, ValueError)):
        fn(q, k, v, **kw)
