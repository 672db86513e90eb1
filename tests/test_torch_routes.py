"""The two routes of the flash attention and moe_gmm kernels: the rule
that picks one (a pure function of dtype, widths, strides and base
addresses, checked here on the CPU), the route counters, ``_force_route``,
and, on the card, each route held to the plain version at the existing
tolerances with the tensor-core (wgmma) route forced.

The file imports neither JAX nor the JAX package, so it also runs on the
card's machine; the repository's conftest imports JAX, hence
``--noconftest`` there:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_routes.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

BF, F32 = torch.bfloat16, torch.float32
ALIGNED = [256, 512, 768, 1024]          # base addresses, 16-byte aligned


def _model_strides(q, k, v, o):
    return [t.stride(a) for t in (q, k, v, o) for a in (0, 1, 2)]


# -- the route rules (CPU) -----------------------------------------------------

@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("D", [16, 64, 80, 128, 256])
def test_flash_route_by_dtype_and_head_dim(dtype, D):
    q = torch.empty((2, 96, 4, D), dtype=dtype)
    k = torch.empty((2, 160, 2, D), dtype=dtype)
    strides = _model_strides(q, k, k, q)
    want = "wgmma" if dtype == BF and D in (64, 128) else "simt"
    assert ops.flash_route(dtype, D, strides, ALIGNED) == want


@pytest.mark.parametrize("D", [64, 128])
def test_flash_route_by_strides_and_alignment(D):
    q = torch.empty((2, 96, 4, D), dtype=BF)
    k = torch.empty((2, 96, 2, D), dtype=BF)
    strides = _model_strides(q, k, k, q)
    assert ops.flash_route(BF, D, strides, ALIGNED) == "wgmma"
    # a head-dim view of a wider row: the row stride is 4 elements off
    wide = torch.empty((2, 96, 4, D + 4), dtype=BF)[..., :D]
    odd = _model_strides(wide, k, k, q)
    assert any(s % 8 for s in odd)
    assert ops.flash_route(BF, D, odd, ALIGNED) == "simt"
    # a base 8 bytes off a 16-byte boundary
    assert ops.flash_route(BF, D, strides, [256, 520, 768, 1024]) == "simt"
    # the kernel-level layout: one kv head with stride 0, a strided q
    qk = torch.empty((150, 16, D), dtype=BF).transpose(0, 1)
    kk = torch.empty((4, 1100, D), dtype=BF)
    G = 4
    kernel = [G * qk.stride(0), qk.stride(1), qk.stride(0),
              kk.stride(0), kk.stride(1), 0, kk.stride(0), kk.stride(1), 0,
              G * 150 * D, D, 150 * D]
    assert ops.flash_route(BF, D, kernel, ALIGNED) == "wgmma"


@pytest.mark.parametrize("x_dtype,w_dtype,D,F,want", [
    (BF, BF, 4096, 14336, "wgmma"),          # jamba's up / gate product
    (BF, BF, 14336, 4096, "wgmma"),          # and its down product
    (BF, BF, 40, 56, "wgmma"),               # widths off the tile, aligned
    (BF, BF, 300, 70, "simt"),               # rows not 16-byte strided
    (BF, BF, 256, 100, "simt"),
    (BF, F32, 64, 64, "simt"),               # mixed types
    (F32, BF, 64, 64, "simt"),
    (F32, F32, 4096, 14336, "simt"),         # f32: the 1e-5 gate
])
def test_gmm_route(x_dtype, w_dtype, D, F, want):
    assert ops.gmm_route(x_dtype, w_dtype, D, F, ALIGNED[:3]) == want


def test_gmm_route_needs_aligned_bases():
    assert ops.gmm_route(BF, BF, 64, 64, [256, 258, 512]) == "simt"


def test_reset_launches_clears_the_route_counts():
    assert set(ops.ROUTES) == {"flash_attention.wgmma",
                               "flash_attention.simt", "moe_gmm.wgmma",
                               "moe_gmm.simt"}
    for name in ops.ROUTES:
        ops.ROUTES[name] = 3
    ops.LAUNCHES["moe_gmm"] = 2
    ops.reset_launches()
    assert not any(ops.ROUTES.values()) and not any(ops.LAUNCHES.values())


def test_force_route_pins_and_restores():
    assert ops._pick("moe_gmm", "wgmma") == "wgmma"
    with ops._force_route("moe_gmm", "simt"):
        assert ops._pick("moe_gmm", "wgmma") == "simt"
        assert ops._pick("flash_attention", "wgmma") == "wgmma"
        with ops._force_route("moe_gmm", None):
            assert ops._pick("moe_gmm", "wgmma") == "wgmma"
        assert ops._pick("moe_gmm", "simt") == "simt"
    assert ops._pick("moe_gmm", "simt") == "simt"
    with ops._force_route("flash_attention", "wgmma"):
        assert ops._pick("flash_attention", "wgmma") == "wgmma"
        with pytest.raises(ValueError, match="forced"):
            ops._pick("flash_attention", "simt")
    with pytest.raises(ValueError):
        with ops._force_route("mamba_scan", "wgmma"):
            pass
    with pytest.raises(ValueError):
        with ops._force_route("moe_gmm", "tensor"):
            pass


def test_cpu_tensors_take_the_plain_version_whatever_the_route():
    """A CPU tensor runs the plain version: no launch, no route, even
    with the wgmma route forced."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 8, 64))).to(BF)
    w = torch.from_numpy(rng.standard_normal((2, 64, 32))).to(BF)
    q = torch.from_numpy(rng.standard_normal((1, 16, 2, 64))).to(BF)
    ops.reset_launches()
    with ops._force_route("moe_gmm", "wgmma"), \
            ops._force_route("flash_attention", "wgmma"):
        assert torch.equal(ops.moe_gmm(x, w), ref.moe_gmm_ref(x, w))
        assert torch.equal(
            ops.flash_attention(q, q, q),
            ref.flash_attention_model_ref(q, q, q, causal=True))
    assert not any(ops.LAUNCHES.values()) and not any(ops.ROUTES.values())


# -- each route on the card ----------------------------------------------------

FLASH_TOL = {F32: 2e-5, BF: 2e-2}
REL_TOL = {F32: 1e-5, BF: 1e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype=BF):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _routed(op, route, fn):
    """Run ``fn`` with ``op`` forced onto ``route``; assert it launched
    once, on that route."""
    before = dict(ops.ROUTES)
    with ops._force_route(op, route):
        out = fn()
    torch.cuda.synchronize()
    after = dict(ops.ROUTES)
    assert after[f"{op}.{route}"] == before[f"{op}.{route}"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "simt"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (1, 256, 256, 2, 2, 128, True),       # G = 1
    (1, 256, 256, 2, 2, 128, False),
    (2, 256, 256, 8, 2, 64, True),        # G = 4
    (1, 192, 320, 8, 1, 128, False),      # G = 8, ragged Sq and Skv
    (2, 300, 300, 8, 1, 64, True),        # G = 8, ragged causal
    (1, 1, 37, 4, 2, 128, False),         # one query
])
def test_flash_route_equals_plain_version(cuda, B, Sq, Skv, H, Hkv, D,
                                          causal, route):
    gen = torch.Generator(device=cuda).manual_seed(Sq * H + D)
    q = _randn(gen, (B, Sq, H, D))
    k = _randn(gen, (B, Skv, Hkv, D))
    v = _randn(gen, (B, Skv, Hkv, D))
    got = _routed("flash_attention", route,
                  lambda: ops.flash_attention(q, k, v, causal=causal))
    tol = FLASH_TOL[BF]
    torch.testing.assert_close(
        got.float(), ref.flash_attention_model_ref(q, k, v, causal=causal)
        .float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("kw", [
    dict(causal=True, q_offset=1000),
    dict(causal=False, kv_len=300),
    dict(causal=True, kv_len=500, q_offset=400, scale=0.07),
    dict(causal=True, q_offset=129),
], ids=["q_offset", "kv_len", "both_and_scale", "offset_off_tile"])
def test_flash_wgmma_kernel_layout_masks(cuda, kw, D):
    """The (BHG, S, D) entry point on the wgmma route: G = 4, a strided
    q, one kv head with stride 0, q_offset and kv_len masks."""
    gen = torch.Generator(device=cuda).manual_seed(D)
    q = _randn(gen, (150, 16, D)).transpose(0, 1)       # (16, 150, D)
    k = _randn(gen, (4, 1100, D))
    v = _randn(gen, (4, 1100, D))
    got = _routed("flash_attention", "wgmma",
                  lambda: ops.flash_attention_kernel(q, k, v, **kw))
    tol = FLASH_TOL[BF]
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_flash_wgmma_refuses_what_its_rule_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = _randn(gen, (1, 64, 2, 80))
    with ops._force_route("flash_attention", "wgmma"):
        with pytest.raises(ValueError, match="forced"):
            ops.flash_attention(q, q, q)
    q32 = _randn(gen, (1, 64, 2, 64), F32)
    with ops._force_route("flash_attention", "wgmma"):
        with pytest.raises(ValueError, match="forced"):
            ops.flash_attention(q32, q32, q32)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "simt"])
@pytest.mark.parametrize("E,C,D,F", [
    (4, 8, 512, 1024),                    # the decode capacity
    (3, 72, 256, 200),                    # ragged C, F off the 256 tile
    (2, 1280, 512, 256),                  # the forward's capacity
    (2, 130, 72, 520),                    # D off the 64 tile
])
def test_gmm_route_equals_plain_version(cuda, E, C, D, F, route):
    gen = torch.Generator(device=cuda).manual_seed(E * C + F)
    x = _randn(gen, (E, C, D))
    w = (torch.randn((E, D, F), generator=gen, device=cuda)
         * D ** -0.5).to(BF)
    got = _routed("moe_gmm", route, lambda: ops.moe_gmm(x, w))
    want = ref.moe_gmm_ref(x, w).float()
    assert got.dtype == BF and got.shape == (E, C, F)
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= REL_TOL[BF]


@pytest.mark.cuda
def test_gmm_wgmma_refuses_what_its_rule_does_not_take(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    x, w = _randn(gen, (2, 16, 300)), _randn(gen, (2, 300, 64))
    with ops._force_route("moe_gmm", "wgmma"):
        with pytest.raises(ValueError, match="forced"):
            ops.moe_gmm(x, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["yi-9b", "jamba-v0.1-52b"])
def test_model_forwards_take_the_wgmma_route(cuda, arch):
    """Reduced yi-9b and jamba widened to head dim 64 (two heads of the
    reduced d_model 128), bf16 through the kernel hooks: every flash and
    moe_gmm launch on the wgmma route, the loss within 1e-2 of the
    reference path's."""
    import dataclasses
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, init_params
    cfg = dataclasses.replace(get_reduced(arch), d_model=128, num_heads=2,
                              num_kv_heads=1, head_dim=64)
    params = init_params(cfg, 0, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32)).to(cuda)
    batch = {"tokens": tok, "targets": tok}
    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    ops.reset_launches()
    got, _ = forward_loss(params, cfg, batch, compute_dtype=BF, **hooks)
    assert ops.LAUNCHES["flash_attention"] > 0
    assert ops.ROUTES["flash_attention.wgmma"] == \
        ops.LAUNCHES["flash_attention"]
    assert ops.ROUTES["moe_gmm.wgmma"] == ops.LAUNCHES["moe_gmm"]
    assert ops.ROUTES["flash_attention.simt"] == \
        ops.ROUTES["moe_gmm.simt"] == 0
    want, _ = forward_loss(params, cfg, batch, compute_dtype=BF)
    assert abs(float(got) - float(want)) <= 1e-2 * abs(float(want))
