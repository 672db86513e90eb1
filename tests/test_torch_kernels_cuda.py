"""The port's CUDA kernels against their plain versions, on the card:
the campaign tick kernels, the flash attention kernel, the MoE grouped
product, the Mamba selective scan and the chunkwise mLSTM.

Every test here carries the ``cuda`` marker and skips without an NVIDIA
GPU (a CUDA kernel has no CPU mode).  The file imports neither JAX nor
the JAX package, so it also runs on the card's machine, which has no
JAX; the repository's conftest imports JAX, hence ``--noconftest``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_kernels_cuda.py

The row generators are shared with ``test_torch_campaign_ops.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref


def alloc_rows(seed, R, C, hi=30):
    """Random count rows plus the allocator's edge cases: k = 0,
    k = total, k > total, an empty row, and totals near 2**20."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, hi, (R, C)).astype(np.int32)
    counts[3] = 0                                  # tot = 0
    counts[4] = rng.integers(0, 2 ** 20 // C, C)   # tot near 2**20
    tot = counts.sum(1)
    k = rng.integers(0, 40, R).astype(np.int32)
    k[0], k[1], k[2], k[3] = 0, tot[1], tot[2] + 7, 5
    k[4] = tot[4] - 1
    return counts, k


def fma_flip_rows(seed, R, C):
    """Rows where ``inc * s + 1e-3`` lands within an f32 ulp of an
    integer, chosen so that one fused multiply-add (a single rounding)
    floors some cell differently from the multiply and the add rounded
    separately: the allocator is exact only with two roundings."""
    rng = np.random.default_rng(seed)
    found_c, found_k = [], []
    while len(found_c) < R:
        counts = rng.integers(0, 100000, (4096, C)).astype(np.int32)
        tot = counts.sum(1)
        k = rng.integers(1, np.maximum(tot, 1) + 1).astype(np.int32)
        s = (k.astype(np.float32) / np.maximum(tot, 1).astype(np.float32))
        inc = np.cumsum(counts, 1).astype(np.float32)
        two = np.floor(inc * s[:, None] + np.float32(1e-3))
        # f32 x f32 is exact in f64, so this rounds once, like an FMA
        fused = np.floor((inc.astype(np.float64) * s[:, None]
                          + np.float32(1e-3)).astype(np.float32))
        rows = np.nonzero((two != fused).any(1))[0]
        found_c.extend(counts[rows])
        found_k.extend(k[rows])
    return np.array(found_c[:R]), np.array(found_k[:R])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _on(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("R,C", [(10200, 18), (1020, 10), (64, 18)])
def test_alloc_kernel_equals_plain_version(cuda, R, C):
    counts, k = alloc_rows(R, R, C)
    counts[-64:], k[-64:] = fma_flip_rows(C, 64, C)
    c_d, k_d = _on(counts, cuda), _on(k, cuda)
    before = ops.LAUNCHES["campaign_preempt"]
    got = ops.campaign_preempt(c_d, k_d)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["campaign_preempt"] == before + 1
    assert torch.equal(got, ref.campaign_alloc_ref(c_d, k_d))


@pytest.mark.cuda
def test_advance_and_bill_kernels_equal_plain_versions(cuda):
    rng = np.random.default_rng(3)
    busy = _on(rng.integers(0, 200, (10200, 16)).astype(np.int32), cuda)
    mask = _on((np.arange(16)[None, :] >= rng.integers(8, 16, (10200, 1)))
               .astype(np.int32), cuda)
    adv, fin = ops.campaign_advance(busy, mask)
    adv_p, fin_p = ref.campaign_advance_ref(busy, mask)
    assert torch.equal(adv, adv_p) and torch.equal(fin, fin_p)
    live = _on(rng.integers(0, 500, (1020, 10)).astype(np.int32), cuda)
    rate = _on(rng.uniform(0, 1, (1020, 10)).astype(np.float32), cuda)
    onehot = _on(np.eye(3, dtype=np.float32)[rng.integers(0, 3, 10)], cuda)
    spent, prov = ops.campaign_bill(live, rate, onehot)
    spent_p, prov_p = ref.campaign_bill_ref(live, rate, onehot)
    torch.testing.assert_close(spent, spent_p, rtol=1e-6, atol=0)
    torch.testing.assert_close(prov, prov_p, rtol=1e-6, atol=0)


@pytest.mark.cuda
def test_sweep_through_kernels_equals_plain_path(cuda):
    """The engine on the card, kernels vs plain versions, same draws:
    identical rows (the CUDA twin of the JAX package's Pallas-interpret
    vs oracle-path test)."""
    from dataclasses import replace
    from repro_torch.core.api import sweep
    from repro_torch.core.scenarios import planning_grid
    specs = [replace(s, duration_h=48.0) for s in planning_grid()[:4]]
    ops.reset_launches()
    with ops._force_route("campaign_sweep", "ops"):
        got = sweep(specs, [0, 1])
    assert ops.LAUNCHES == {"campaign_preempt": 384, "campaign_match": 192,
                            "campaign_advance": 192, "campaign_bill": 192,
                            "campaign_sweep": 0,
                            "flash_attention": 0, "moe_gmm": 0,
                            "mamba_scan": 0, "mlstm_chunk": 0}
    want = sweep(specs, [0, 1], use_kernels=False)
    for a, b in zip(got.rows, want.rows):
        assert a["cost"] == pytest.approx(b["cost"], rel=1e-5)
        for k in ("preemptions", "jobs_finished", "nat_drops",
                  "by_provider", "events_fired"):
            assert a[k] == b[k], k


# -- flash attention -----------------------------------------------------------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (1, 128, 128, 2, 2, 64, True),
    (2, 256, 256, 4, 2, 64, True),       # GQA
    (1, 128, 384, 2, 1, 128, False),     # MQA, not causal
    (2, 96, 160, 2, 2, 80, True),        # ragged tiles, D = 80
    (1, 1, 37, 4, 2, 16, False),         # one query, the reduced head dim
    (1, 200, 200, 2, 1, 256, True),      # the largest head dim
])
def test_flash_kernel_equals_plain_version(cuda, B, Sq, Skv, H, Hkv, D,
                                           causal, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(B * Sq + D)
    q = _randn(gen, (B, Sq, H, D), dtype)
    k = _randn(gen, (B, Skv, Hkv, D), dtype)
    v = _randn(gen, (B, Skv, Hkv, D), dtype)
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.flash_attention_model_ref(q, k, v, causal=causal)
        .float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kw", [
    dict(causal=True, q_offset=1000),
    dict(causal=False, kv_len=300),
    dict(causal=True, kv_len=500, q_offset=400, scale=0.07),
], ids=["q_offset", "kv_len", "both_and_scale"])
def test_flash_kernel_layout_masks(cuda, kw, dtype):
    """(BHG, S, D) entry point, G = 4, with q_offset / kv_len masks, and
    a strided (non-contiguous) q."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(5)
    q = _randn(gen, (150, 16, 128), dtype).transpose(0, 1)  # (16,150,128)
    k = _randn(gen, (4, 1100, 128), dtype)
    v = _randn(gen, (4, 1100, 128), dtype)
    got = ops.flash_attention_kernel(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.flash_attention_ref(q, k, v, **kw).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
def test_model_forward_through_the_kernel(cuda):
    """Reduced yi-9b on the card: the kernel path's loss equals the plain
    version's, one launch per layer."""
    import dataclasses
    from repro_torch.configs import get_reduced
    from repro_torch.models import forward_loss, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_reduced("yi-9b"), num_layers=3)
    params = init_params(cfg, 0, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32)).to(cuda)
    batch = {"tokens": tok, "targets": tok}
    ops.reset_launches()
    got, _ = forward_loss(params, cfg, batch, compute_dtype=torch.float32,
                          flash_fn=ops.flash_attention)
    assert ops.LAUNCHES["flash_attention"] == 3
    want, _ = forward_loss(params, cfg, batch, compute_dtype=torch.float32,
                           flash_fn=ref.flash_attention_model_ref)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


# -- moe_gmm and mamba_scan ----------------------------------------------------

# max |kernel - plain| / max |plain|: the sums run in another order than
# the plain version's, so the error scales with the largest output
REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("E,C,D,F", [
    (2, 64, 32, 64),
    (3, 72, 40, 56),                     # unaligned everywhere
    (4, 8, 256, 96),                     # decode-sized capacity
    (2, 130, 300, 70),                   # ragged tiles on every axis
])
def test_moe_gmm_kernel_equals_plain_version(cuda, E, C, D, F, x_dtype,
                                             w_dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(E * C + F)
    x = _randn(gen, (E, C, D), x_dtype)
    w = _randn(gen, (E, D, F), w_dtype)
    before = ops.LAUNCHES["moe_gmm"]
    got = ops.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["moe_gmm"] == before + 1
    assert got.dtype == x_dtype and got.shape == (E, C, F)
    assert _rel_err(got, ref.moe_gmm_ref(x, w)) <= REL_TOL[x_dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["f32", "bf16", "model"])
@pytest.mark.parametrize("B,S,di,N", [
    (1, 64, 32, 8),
    (2, 128, 64, 16),
    (1, 96, 48, 8),                      # di not a power of two
    (2, 70, 33, 5),                      # N not a power of two, ragged S
    (1, 40, 24, 32),                     # the largest state
])
def test_mamba_scan_kernel_equals_plain_version(cuda, B, S, di, N, mix):
    """Streams in f32, in bf16, or as the model passes them (xc and Bm
    in bf16, dt and Cm in f32)."""
    gen = torch.Generator(device=cuda).manual_seed(B * S + di)
    bf = torch.bfloat16
    dtypes = {"f32": (torch.float32,) * 4, "bf16": (bf,) * 4,
              "model": (bf, torch.float32, bf, torch.float32)}[mix]
    xc = torch.randn((B, S, di), generator=gen, device=cuda)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, di), generator=gen, device=cuda))
    bm = torch.randn((B, S, N), generator=gen, device=cuda)
    cm = torch.randn((B, S, N), generator=gen, device=cuda)
    xc, dt, bm, cm = (t.to(d) for t, d in zip((xc, dt, bm, cm), dtypes))
    a = -torch.exp(torch.randn((di, N), generator=gen, device=cuda))
    before = ops.LAUNCHES["mamba_scan"]
    got = ops.mamba_scan(xc, dt, bm, cm, a)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == before + 1
    assert got.dtype == xc.dtype and got.shape == (B, S, di)
    assert _rel_err(got, ref.mamba_scan_ref(xc, dt, bm, cm, a)) \
        <= REL_TOL[xc.dtype]


@pytest.mark.cuda
def test_hybrid_forward_through_the_kernels(cuda):
    """Reduced jamba on the card: the kernel path's loss equals the
    reference path's; one flash, 3 x 4 moe_gmm and 7 mamba_scan
    launches."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("jamba-v0.1-52b")
    params = init_params(cfg, 0, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32)).to(cuda)
    batch = {"tokens": tok, "targets": tok}
    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    ops.reset_launches()
    got, parts = forward_loss(params, cfg, batch,
                              compute_dtype=torch.float32, **hooks)
    assert {k: ops.LAUNCHES[k] for k in ("flash_attention", "moe_gmm",
                                         "mamba_scan")} == \
        {"flash_attention": 1, "moe_gmm": 12, "mamba_scan": 7}
    want, wparts = forward_loss(params, cfg, batch,
                                compute_dtype=torch.float32)
    assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(parts["aux"]) == pytest.approx(float(wparts["aux"]),
                                                rel=1e-5)


# -- mlstm_chunk ---------------------------------------------------------------

# tests/test_kernels.py's tolerances for the mLSTM kernel
MLSTM_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}


def _mlstm_inputs(gen, lead, S, dqk, dv, dtype, gate_dtype=None):
    """q/k/v normal, logi = normal - 5, logf = log_sigmoid(normal + 3),
    as tests/test_kernels.py draws them; ``lead`` is (BH,) for the
    kernel layout and (B, H) for the model layout (then (B, S, H, d))."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    if len(lead) == 1:
        q, k, v = draw(*lead, S, dqk), draw(*lead, S, dqk), draw(*lead, S, dv)
        gshape = (*lead, S, 1)
    else:
        B, H = lead
        q, k, v = draw(B, S, H, dqk), draw(B, S, H, dqk), draw(B, S, H, dv)
        gshape = (B, S, H)
    li = draw(*gshape) - 5.0
    lf = torch.nn.functional.logsigmoid(draw(*gshape) + 3.0)
    gd = gate_dtype or dtype
    return q.to(dtype), k.to(dtype), v.to(dtype), li.to(gd), lf.to(gd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,dqk,dv,bs", [
    (2, 128, 32, 32, 64),
    (4, 256, 64, 64, 128),
    (1, 128, 16, 48, 32),                # dqk != dv
    (2, 256, 64, 80, 128),               # dv not a multiple of the tile
    (1, 512, 96, 40, 256),               # block_s above the kernel's chunk
])
def test_mlstm_chunk_kernel_equals_plain_version(cuda, BH, S, dqk, dv, bs,
                                                 dtype):
    gen = torch.Generator(device=cuda).manual_seed(BH * S + dv)
    q, k, v, li, lf = _mlstm_inputs(gen, (BH,), S, dqk, dv, dtype)
    before = ops.LAUNCHES["mlstm_chunk"]
    got = ops.mlstm_chunk(q, k, v, li, lf, block_s=bs)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_chunk"] == before + 1
    assert got.dtype == dtype and got.shape == (BH, S, dv)
    tol = MLSTM_TOL[dtype]
    torch.testing.assert_close(got.float(),
                               ref.mlstm_ref(q, k, v, li, lf).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_chunk_kernel_at_the_xlstm_shape(cuda, dtype):
    """xlstm-350m's mLSTM at B=1: 4 heads, S=4096, dqk=dv=512, the model's
    gates in f32."""
    gen = torch.Generator(device=cuda).manual_seed(350)
    q, k, v, li, lf = _mlstm_inputs(gen, (1, 4), 4096, 512, 512, dtype,
                                    torch.float32)
    got = ops.mlstm_chunk_model(q, k, v, li, lf)
    torch.cuda.synchronize()
    tol = MLSTM_TOL[dtype]
    torch.testing.assert_close(
        got.float(), ref.mlstm_model_ref(q, k, v, li, lf).float(),
        rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [128, 300, 1])
def test_mlstm_chunk_model_layout_reads_strided_views(cuda, S):
    """The model's (B, S, H, d) views of a (B, H, S, d) tensor, bf16
    streams with f32 gates, and any S (a ragged last chunk)."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v, li, lf = _mlstm_inputs(gen, (2, 3), S, 32, 48, torch.bfloat16,
                                    torch.float32)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    li, lf = (t.transpose(1, 2).contiguous().transpose(1, 2)
              for t in (li, lf))
    assert S == 1 or not q.is_contiguous()
    got = ops.mlstm_chunk_model(q, k, v, li, lf)
    torch.cuda.synchronize()
    torch.testing.assert_close(
        got.float(), ref.mlstm_model_ref(q, k, v, li, lf).float(),
        rtol=5e-2, atol=5e-2)


@pytest.mark.cuda
def test_xlstm_forward_through_the_kernel(cuda):
    """Reduced xlstm-350m on the card: the kernel path's loss equals the
    chunked reference path's (S=200: one reference chunk of 200, kernel
    chunks of 128 and 72); one mlstm_chunk launch per mLSTM layer."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("xlstm-350m")
    params = init_params(cfg, 0, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32)).to(cuda)
    batch = {"tokens": tok, "targets": tok}
    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    ops.reset_launches()
    got, _ = forward_loss(params, cfg, batch, compute_dtype=torch.float32,
                          **hooks)
    assert ops.LAUNCHES["mlstm_chunk"] == 7
    want, _ = forward_loss(params, cfg, batch, compute_dtype=torch.float32)
    assert float(got) == pytest.approx(float(want), rel=1e-4)
