"""The CUDA-core ("simt") routes of flash attention and moe_gmm.

On the CPU: ``tiled_mirror``, the plain mirror of the
CUDA-core flash kernel's f32 arithmetic (128-key tiles, the online
softmax with expf of the score less the running max, the final division
by max(l, 1e-30)), against the JAX package's oracle and its Pallas kernel
in interpret mode, on the shapes of ``tests/test_kernels.py`` and ragged
cases with ``q_offset`` and ``kv_len``, within 2e-5 elementwise and 1e-5
in the worst query row; and ``ops.gmm_row_tile``, the rule that picks the
moe_gmm kernel's row tile.

On the card (``cuda`` marker, skipped without one): both kernels forced
onto the simt route at shapes on the edges of their tiles, in f32, bf16
and mixed types, against their plain versions; and the reduced yi-9b
(at the full model's 48 layers) and jamba f32 forwards, every flash and
moe_gmm launch on the simt route.  The card's machine has no JAX, so
those run without the repository's conftest:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_simt.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

F32, BF = torch.float32, torch.bfloat16


def _worst_row(got, want):
    """max over rows of ||got - want|| / ||want|| (norms over the last
    dim), as chip_smoke.py's flash gate."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = np.sqrt(((got - want) ** 2).sum(-1))
    norm = np.maximum(np.sqrt((want ** 2).sum(-1)), 1e-30)
    return float((diff / norm).max())


# -- on the CPU: the mirror against the JAX package ---------------------------

def tiled_mirror(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, kv_len=None, scale=None, q_offset: int = 0,
                 block_k: int = 128) -> torch.Tensor:
    """The arithmetic of the CUDA-core flash kernel in plain PyTorch, in
    ``ref.flash_attention_ref``'s layout: q scaled in f32, then key tiles of
    ``block_k`` up to min(Skv, kv_len), each masked (-1e30; keys past Skv
    are left out, as the kernel's -inf weighs them exactly 0) and folded
    into the running max m, sum l and accumulator by the online softmax
    (alpha = exp(m - m_new), p = exp(s - m_new), acc = alpha acc + p.v),
    and the output divided by max(l, 1e-30).  Tiles the kernel skips (above
    the diagonal of a whole query tile) change nothing here: every score
    in them is masked, so alpha is 1 and p is 0 exactly."""
    BHG, Sq, D = q.shape
    BKV, Skv, _ = k.shape
    G = BHG // BKV
    f32 = torch.float32
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(BKV, G, Sq, D).to(f32) * scale
    kf, vf = k.to(f32), v.to(f32)
    lim = Skv if kv_len is None else min(Skv, kv_len)
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((BKV, G, Sq), -1e30, dtype=f32, device=q.device)
    l = torch.zeros((BKV, G, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((BKV, G, Sq, D), dtype=f32, device=q.device)
    for k0 in range(0, lim, block_k):
        k1 = min(k0 + block_k, Skv)
        s = torch.einsum("bgqd,bkd->bgqk", qg, kf[:, k0:k1])
        kpos = torch.arange(k0, k1, device=q.device)
        mask = (kpos >= lim)[None, :].expand(Sq, -1)
        if causal:
            mask = mask | (qpos[:, None] < kpos[None, :])
        s.masked_fill_(mask, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = alpha * l + p.sum(-1)
        acc = alpha[..., None] * acc + torch.einsum("bgqk,bkd->bgqd", p,
                                                    vf[:, k0:k1])
        m = m_new
    o = acc / l.clamp_min(1e-30)[..., None]
    return o.reshape(BHG, Sq, D).to(q.dtype)


def _jax():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_kernel
    return jnp, jops, jref, flash_attention_kernel


def _check_mirror(got, *wants):
    for want in wants:
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        assert _worst_row(got, want) <= 1e-5


@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (1, 128, 128, 2, 2, 64, True),
    (2, 256, 256, 4, 2, 64, True),      # GQA
    (1, 128, 384, 2, 1, 128, False),    # MQA, three key tiles
    (2, 96, 160, 2, 2, 80, True),       # ragged tiles, D = 80
])
def test_tiled_mirror_matches_jax_model_layout(B, Sq, Skv, H, Hkv, D,
                                               causal):
    jnp, jops, jref, _ = _jax()
    rng = np.random.default_rng(B * Sq + D)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D)))

    def heads(x):                        # (B, S, h, D) -> (B * h, S, D)
        return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(
            -1, x.shape[1], D)
    got = tiled_mirror(
        *(torch.from_numpy(heads(x)) for x in (q, k, v)), causal=causal)
    got = got.reshape(B, H, Sq, D).transpose(1, 2).numpy()
    oracle = jref.flash_attention_ref(*(jnp.asarray(heads(x))
                                        for x in (q, k, v)), causal=causal)
    oracle = np.asarray(oracle).reshape(B, H, Sq, D).transpose(0, 2, 1, 3)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal)
    _check_mirror(got, oracle, pallas)


@pytest.mark.parametrize("BHG,BKV,Sq,Skv,D,kw", [
    (4, 2, 128, 256, 128, dict(causal=True, q_offset=128)),
    (4, 2, 128, 256, 128, dict(causal=False, kv_len=200)),
    (4, 2, 128, 256, 128, dict(causal=True, kv_len=192, q_offset=64,
                               scale=0.05)),
    # ragged: a query tile and key tiles cut short, kv_len inside the
    # last tile, G = 4
    (8, 2, 200, 333, 80, dict(causal=True, q_offset=150, kv_len=290)),
    (8, 2, 37, 300, 48, dict(causal=False, kv_len=129)),
], ids=["q_offset", "kv_len", "both_and_scale", "ragged_causal",
        "ragged_kv_len"])
def test_tiled_mirror_matches_jax_kernel_layout(BHG, BKV, Sq, Skv, D, kw):
    jnp, _, jref, jax_flash_kernel = _jax()
    rng = np.random.default_rng(Sq + Skv)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((BHG, Sq, D), (BKV, Skv, D), (BKV, Skv, D)))
    got = tiled_mirror(
        *(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()
    # the Pallas kernel takes whole 128-row tiles: pad S and D with zeros
    # as the JAX wrapper does, mask the padded keys with kv_len and keep
    # the true head dim's scale
    def pad(x):
        return jnp.asarray(np.pad(x, ((0, 0), (0, -x.shape[1] % 128),
                                      (0, -D % 128))))
    pallas = jax_flash_kernel(
        pad(q), pad(k), pad(v), interpret=True,
        **{**kw, "kv_len": min(Skv, kw.get("kv_len", Skv)),
           "scale": kw.get("scale", D ** -0.5)})[:, :Sq, :D]
    qj, kj, vj = (jnp.asarray(x) for x in (q, k, v))
    _check_mirror(got, jref.flash_attention_ref(qj, kj, vj, **kw), pallas)


@pytest.mark.parametrize("block_k", [128, 64, 7])
def test_tiled_mirror_does_not_depend_on_the_tile(block_k):
    """The tile changes only the rounding: block_k = 7 leaves some rows
    a tile of masked keys only, which must weigh nothing."""
    rng = np.random.default_rng(block_k)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((6, 50, 16), (3, 90, 16), (3, 90, 16)))
    kw = dict(causal=True, q_offset=20, kv_len=61)
    got = tiled_mirror(q, k, v, block_k=block_k, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("C,tile", [(1, 16), (8, 16), (16, 16), (17, 16),
                                    (32, 16), (33, 128), (64, 128),
                                    (128, 128), (129, 128), (192, 128),
                                    (257, 128),
                                    (640, 128), (1280, 128)])
def test_gmm_row_tile(C, tile):
    assert ops.gmm_row_tile(C) == tile


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(gen, shape, dtype, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).to(dtype)


def _unaligned(t):
    """A contiguous copy of t whose base is one element past an aligned
    address: the kernels' element-at-a-time loads."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _simt(op, fn):
    with ops._force_route(op, "simt"):
        before = ops.ROUTES[f"{op}.simt"]
        got = fn()
        torch.cuda.synchronize()
        assert ops.ROUTES[f"{op}.simt"] == before + 1
    return got


GMM_TOL = {F32: 1e-5, BF: 1e-2}


@pytest.mark.cuda
@pytest.mark.parametrize("x_dtype,w_dtype", [(F32, F32), (BF, BF), (BF, F32),
                                             (F32, BF)],
                         ids=["f32", "bf16", "bf16_x", "bf16_w"])
@pytest.mark.parametrize("E,C,D,F", [
    (2, 1, 64, 128),                     # one row
    (3, 8, 256, 96),                     # decode capacity, a 16-row tile
    (2, 16, 100, 36),                    # a ragged last K step
    (2, 5, 20, 40),                      # D below one K step (32 rows)
    (2, 15, 40, 129),
    (2, 17, 33, 127),                    # two 16-row tiles, ragged K
    (2, 32, 48, 64),                     # the last C on 16-row tiles
    (2, 33, 40, 100),                    # the first 128-row tile
    (2, 64, 5, 64),                      # D below one K step (16 rows)
    (2, 65, 7, 130),
    (2, 127, 129, 128),
    (1, 128, 136, 256),                  # whole tiles
    (2, 129, 300, 70),                   # a ragged F
    (1, 256, 72, 384),                   # two whole 128-row tiles
    (1, 260, 64, 384),
])
@pytest.mark.parametrize("aligned", [True, False], ids=["vec", "scalar"])
def test_gmm_simt_on_tile_edges(cuda, E, C, D, F, x_dtype, w_dtype, aligned):
    gen = torch.Generator(device=cuda).manual_seed(E * C + D + F)
    x = _randn(gen, (E, C, D), x_dtype)
    w = _randn(gen, (E, D, F), w_dtype, D ** -0.5)
    if not aligned:
        x = _unaligned(x)
    got = _simt("moe_gmm", lambda: ops.moe_gmm(x, w))
    assert got.dtype == x_dtype and got.shape == (E, C, F)
    want = ref.moe_gmm_ref(x, w)
    err = float((got.float() - want.float()).abs().max()
                / want.float().abs().max().clamp(min=1e-30))
    assert err <= GMM_TOL[x_dtype]


FLASH_TOL = {F32: (2e-5, 1e-5), BF: (2e-2, 1e-2)}   # elementwise, worst row


def _check_flash(got, want, dtype):
    tol, row_tol = FLASH_TOL[dtype]
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert _worst_row(got.cpu().numpy(), want.cpu().numpy()) <= row_tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Skv,H,Hkv,D,causal", [
    (1, 1, 1, 2, 1, 64, True),           # one query, one key
    (1, 1, 300, 4, 2, 16, False),
    (1, 127, 127, 2, 2, 64, True),       # one tile less one
    (1, 128, 128, 2, 1, 80, True),       # one whole tile
    (2, 129, 129, 2, 2, 128, True),      # one past it
    (1, 512, 512, 16, 2, 128, True),     # four tiles, GQA 8:1
    (1, 200, 513, 2, 1, 256, False),     # the largest head dim, 64-row tiles
    (1, 65, 129, 2, 2, 256, True),
    (1, 130, 70, 2, 1, 128, False),      # more queries than keys
    # head dims whose last group of 4 is partial (element-wise loads
    # and stores)
    (1, 100, 150, 2, 1, 30, True),
    (2, 131, 70, 4, 2, 30, False),
    (1, 129, 257, 2, 2, 65, True),
    (1, 70, 200, 4, 1, 65, False),
])
def test_flash_simt_on_tile_edges(cuda, B, Sq, Skv, H, Hkv, D, causal,
                                  dtype):
    gen = torch.Generator(device=cuda).manual_seed(B * Sq + Skv + D)
    q = _randn(gen, (B, Sq, H, D), dtype)
    k = _randn(gen, (B, Skv, Hkv, D), dtype)
    v = _randn(gen, (B, Skv, Hkv, D), dtype)
    got = _simt("flash_attention",
                lambda: ops.flash_attention(q, k, v, causal=causal))
    _check_flash(got, ref.flash_attention_model_ref(q, k, v, causal=causal),
                 dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("D,kw,layout", [
    (128, dict(causal=True, q_offset=1000), "strided"),
    (128, dict(causal=False, kv_len=300), "strided"),
    (80, dict(causal=True, kv_len=500, q_offset=400, scale=0.07),
     "strided"),
    (64, dict(causal=True, q_offset=129, kv_len=1000), "unaligned"),
    (128, dict(causal=False, kv_len=1), "unaligned"),   # one key
], ids=["q_offset", "kv_len", "both_d80", "unaligned", "one_key"])
def test_flash_simt_kernel_layout(cuda, D, kw, layout, dtype):
    """(BHG, S, D) entry point, G = 8 (GQA 8:1), with q_offset / kv_len
    masks, and a strided q (a transposed view) or unaligned q, k, v
    (element-at-a-time loads)."""
    gen = torch.Generator(device=cuda).manual_seed(D + len(kw))
    q = _randn(gen, (150, 16, D), dtype).transpose(0, 1)   # (16, 150, D)
    k = _randn(gen, (2, 1100, D), dtype)
    v = _randn(gen, (2, 1100, D), dtype)
    if layout == "unaligned":
        q, k, v = (_unaligned(t.contiguous()) for t in (q, k, v))
    got = _simt("flash_attention",
                lambda: ops.flash_attention_kernel(q, k, v, **kw))
    _check_flash(got, ref.flash_attention_ref(q, k, v, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,num_layers,launches", [
    ("yi-9b", 48, {"flash_attention": 48}),
    ("jamba-v0.1-52b", None, {"flash_attention": 1, "moe_gmm": 12}),
])
def test_f32_forwards_take_the_simt_route(cuda, arch, num_layers, launches):
    """The reduced yi-9b (at the full model's 48 layers) and jamba in f32
    through the kernel hooks: every flash and moe_gmm launch on the simt
    route, the loss within 1e-5 of the plain / reference path's."""
    import dataclasses
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, init_params
    cfg = get_reduced(arch)
    if num_layers:
        cfg = dataclasses.replace(cfg, num_layers=num_layers)
    params = init_params(cfg, 0, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 200)).astype(np.int32)).to(cuda)
    batch = {"tokens": tok, "targets": tok}
    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    ops.reset_launches()
    got, _ = forward_loss(params, cfg, batch, compute_dtype=F32, **hooks)
    assert {op: ops.LAUNCHES[op] for op in launches} == launches
    assert {op: ops.ROUTES[f"{op}.simt"] for op in launches} == launches
    assert ops.ROUTES["flash_attention.wgmma"] == \
        ops.ROUTES["moe_gmm.wgmma"] == 0
    want, _ = forward_loss(params, cfg, batch, compute_dtype=F32)
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
