"""The flash attention and ``moe_gmm`` kernels at the shapes the rest of
the model zoo gives them, against their plain versions, on the card:

  * flash at qwen3-moe-30b-a3b's self-attention after its qk-norm (B=2,
    S=4096, H=32, Hkv=4, D=128, q and k RMS-normed per head), at
    internvl2-2b's over 256 patches + 3,840 tokens (H=16, Hkv=8) and at
    whisper-large-v3's decoder (B=2, S=448 = 3.5 query tiles of 128,
    H=Hkv=20, D=64), causal;
  * ``moe_gmm`` at qwen3's expert products (E=128, C=640, 2048 -> 768
    and 768 -> 2048);

in f32 and bf16, on the route the model takes (bf16: the tensor-core
"wgmma" route; f32: the CUDA-core "simt" route) and, for bf16, on the
simt route forced too: flash elementwise within 2e-5 / 2e-2 (absolute
plus relative) and by the worst query row's relative error within
1e-5 / 1e-2, ``moe_gmm`` within 1e-5 / 1e-2 of the largest |plain|, one
launch a call.  Every test carries the ``cuda`` marker and skips
without an NVIDIA GPU; the file imports no JAX:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_zoo_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models.layers import rms_head_norm

F32, BF = torch.float32, torch.bfloat16
FLASH_TOL = {F32: 2e-5, BF: 2e-2}
FLASH_ROW_TOL = {F32: 1e-5, BF: 1e-2}
GMM_TOL = {F32: 1e-5, BF: 1e-2}
# (B, S, H, Hkv, D, qk-norm)
FLASH_SHAPES = {"qwen3-qknorm": (2, 4096, 32, 4, 128, True),
                "internvl2": (2, 4096, 16, 8, 128, False),
                "whisper-decoder": (2, 448, 20, 20, 64, False)}
# (E, C, D, F)
GMM_SHAPES = {"qwen3-up": (128, 640, 2048, 768),
              "qwen3-down": (128, 640, 768, 2048)}
ROUTES = [(F32, "simt"), (BF, "wgmma"), (BF, "simt")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _routed(op, route, fn):
    before = dict(ops.ROUTES)
    with ops._force_route(op, route):
        out = fn()
    torch.cuda.synchronize()
    after = dict(ops.ROUTES)
    assert after[f"{op}.{route}"] == before[f"{op}.{route}"] + 1
    assert sum(after.values()) == sum(before.values()) + 1
    return out


def _worst_row(got, want) -> float:
    diff = (got.float() - want.float()).square().sum(-1).sqrt()
    norm = want.float().square().sum(-1).sqrt().clamp_min(1e-30)
    return float((diff / norm).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", ROUTES,
                         ids=["f32-simt", "bf16-wgmma", "bf16-simt"])
@pytest.mark.parametrize("shape", sorted(FLASH_SHAPES))
def test_flash_at_the_zoo_shapes(cuda, shape, dtype, route):
    B, S, H, Hkv, D, qk_norm = FLASH_SHAPES[shape]
    if dtype == F32 or route == "wgmma":
        # the route the model takes at this dtype
        assert ops.flash_route(dtype, D, [0], [0]) == route
    gen = torch.Generator(device=cuda).manual_seed(S * H + D)
    q = torch.randn((B, S, H, D), generator=gen, device=cuda).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=gen, device=cuda).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=gen, device=cuda).to(dtype)
    if qk_norm:
        scale = 1 + 0.1 * torch.randn(D, generator=gen, device=cuda)
        q, k = rms_head_norm(q, scale), rms_head_norm(k, scale)
    got = _routed("flash_attention", route,
                  lambda: ops.flash_attention(q, k, v, causal=True))
    want = ref.flash_attention_model_ref(q, k, v, causal=True)
    assert got.dtype == dtype and got.shape == want.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _worst_row(got, want) <= FLASH_ROW_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,route", ROUTES,
                         ids=["f32-simt", "bf16-wgmma", "bf16-simt"])
@pytest.mark.parametrize("shape", sorted(GMM_SHAPES))
def test_moe_gmm_at_the_qwen3_shapes(cuda, shape, dtype, route):
    E, C, D, F = GMM_SHAPES[shape]
    gen = torch.Generator(device=cuda).manual_seed(E * C + F)
    x = torch.randn((E, C, D), generator=gen, device=cuda).to(dtype)
    w = (torch.randn((E, D, F), generator=gen, device=cuda)
         * D ** -0.5).to(dtype)
    if dtype == F32 or route == "wgmma":
        assert ops.gmm_route(dtype, dtype, D, F,
                             [x.data_ptr(), w.data_ptr()]) == route
    got = _routed("moe_gmm", route, lambda: ops.moe_gmm(x, w))
    want = ref.moe_gmm_ref(x, w).float()
    assert got.dtype == dtype and got.shape == (E, C, F)
    assert torch.isfinite(got.float()).all()
    err = float((got.float() - want).abs().max() / want.abs().max())
    assert err <= GMM_TOL[dtype]
