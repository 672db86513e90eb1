"""The two-phase (chunkwise) mLSTM of the tensor-core kernel
``csrc/mlstm_chunk_wgmma.cu`` and the route rule that picks it, plus the
redesigned ``mamba_scan`` kernel on the card.

On the CPU: ``ref.mlstm_chunkwise_ref``, the plain mirror of the kernel's
algorithm (the gate pass, the states entering every chunk, then every
chunk's outputs, with the kernel's bf16 roundings), against the JAX
package's sequential oracle and its Pallas kernel in interpret mode on
shared numpy inputs, at ``tests/test_torch_xlstm.py``'s kernel shapes and a
model-layout case with a ragged last chunk; ``ops.mlstm_route`` by dtype,
width and alignment; forced routes; the route counters.  Tolerances: the
kernel's, 5e-4 (f32) and 5e-2 (bf16).

On the card (``cuda`` marker, skipped without one): both mLSTM routes
against the plain version at the edge shapes and at the xlstm shape, the
xlstm forward's 21 launches on the tensor-core route, and ``mamba_scan``
at N = 1, 8, 16, 17, 32 with a ``di`` off the block's channels in the
three stream mixes.  The module imports no JAX (the JAX tests import it
inside), so the card's machine, which has none, collects it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_chunkwise.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

BF, F32 = torch.bfloat16, torch.float32
DTYPES = {"float32": F32, "bfloat16": BF}
TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# tests/test_torch_xlstm.py's KERNEL_SHAPES: (BH, S, dqk, dv, block_s)
KERNEL_SHAPES = [(2, 128, 32, 32, 64),
                 (4, 256, 64, 64, 128),
                 (1, 128, 16, 48, 32)]
ALIGNED = [256, 512, 768, 1024]          # base addresses, 16-byte aligned


def _inputs(seed, lead, S, dqk, dv):
    """numpy q/k/v normal, logi = normal - 5, logf = log_sigmoid(normal +
    3) (tests/test_kernels.py's draws): ``lead`` + (S, d) streams and
    ``lead`` + (S, 1) gates."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((*lead, S, dqk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((*lead, S, dv)).astype(np.float32)
    li = (rng.standard_normal((*lead, S, 1)) - 5.0).astype(np.float32)
    x = rng.standard_normal((*lead, S, 1)).astype(np.float32) + 3.0
    lf = (-np.logaddexp(0.0, -x)).astype(np.float32)       # log_sigmoid
    return q, k, v, li, lf


def _jax_pair(arrays, name):
    """The JAX oracle's and the Pallas kernel's inputs (interpret mode on
    the CPU) in the case's dtype: the streams cast, the gates f32, as
    tests/test_torch_xlstm.py passes them."""
    jnp = pytest.importorskip("jax.numpy")
    jdt = jnp.float32 if name == "float32" else jnp.bfloat16
    return [jnp.asarray(a).astype(jdt) for a in arrays]


def _torch(arrays, name):
    return [torch.from_numpy(np.array(a)).to(DTYPES[name]) for a in arrays]


def _close(got, want, name):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               **TOL[name])


def _f32(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(F32).numpy()
    import jax.numpy as jnp
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# -- the mirror against the JAX package ---------------------------------------

@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("BH,S,dqk,dv,bs", KERNEL_SHAPES)
def test_chunkwise_mirror_matches_jax(BH, S, dqk, dv, bs, name):
    """The mirror at the kernel's chunk, min(block_s, S, 128), against the
    sequential oracle and the Pallas kernel in interpret mode."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    arrays = _inputs(BH * S + dv, (BH,), S, dqk, dv)
    ts, js = _torch(arrays, name), _jax_pair(arrays, name)
    got = ref.mlstm_chunkwise_ref(*ts, chunk=min(bs, S, 128))
    assert got.dtype == DTYPES[name] and got.shape == (BH, S, dv)
    _close(_f32(got), _f32(jref.mlstm_ref(*js)), name)
    _close(_f32(got), _f32(jops.mlstm_chunk(*js, block_s=bs)), name)


@pytest.mark.parametrize("name", list(DTYPES))
def test_chunkwise_mirror_model_layout_ragged_last_chunk(name):
    """The model layout (B, S, H, d) at S=300: chunks of 128, 128 and 44,
    through the (B*H, S, d) rows the kernel reads, against the oracle and
    the Pallas kernel (whose chunk, 100, divides S)."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    B, H, S, dqk, dv = 2, 3, 300, 32, 48
    q, k, v, li, lf = _inputs(300, (B, H), S, dqk, dv)     # (B, H, S, d)
    model = [np.ascontiguousarray(a.transpose(0, 2, 1, 3))
             for a in (q, k, v)] + \
        [np.ascontiguousarray(a[..., 0].transpose(0, 2, 1)) for a in (li, lf)]
    tq, tk, tv, tli, tlf = _torch(model, name)
    tli, tlf = tli.to(F32), tlf.to(F32)                    # the model's gates

    def rows(t):                          # (B, S, H, d) -> (B*H, S, d)
        return t.transpose(1, 2).reshape(B * H, S, -1)
    got = ref.mlstm_chunkwise_ref(rows(tq), rows(tk), rows(tv),
                                  rows(tli[..., None]), rows(tlf[..., None]))
    got = got.reshape(B, H, S, dv).transpose(1, 2)
    assert got.shape == (B, S, H, dv) and got.dtype == DTYPES[name]
    flat = [a.reshape(B * H, S, -1) for a in (q, k, v, li, lf)]
    js = _jax_pair(flat, name)
    want = _f32(jref.mlstm_ref(*js)).reshape(B, H, S, dv)
    kernel = _f32(jops.mlstm_chunk(*js, block_s=100)).reshape(B, H, S, dv)
    mine = _f32(got).transpose(0, 2, 1, 3)
    _close(mine, want, name)
    _close(mine, kernel, name)


@pytest.mark.parametrize("chunk", [16, 64, 100])
def test_chunkwise_mirror_chunk_size_changes_only_the_rounding(chunk):
    """In f32 the mirror at any chunk equals the sequential plain version
    of the port (and so every chunk size equals every other)."""
    ts = _torch(_inputs(chunk, (3,), 256, 32, 40), "float32")
    torch.testing.assert_close(ref.mlstm_chunkwise_ref(*ts, chunk=chunk),
                               ref.mlstm_ref(*ts), rtol=5e-4, atol=5e-4)


def test_chunkwise_mirror_rounds_where_the_kernel_rounds():
    """bf16 streams change the mirror by the three roundings (k w, S~,
    C entering a chunk) and no more than the bf16 tolerance; f32 streams
    with the same values are not rounded."""
    bf = _torch(_inputs(7, (2,), 384, 64, 64), "bfloat16")
    bf_vals = [t.to(F32) for t in bf]          # the bf16 values, in f32
    exact = ref.mlstm_chunkwise_ref(*bf_vals)
    rounded = ref.mlstm_chunkwise_ref(*bf).to(F32)
    assert not torch.equal(exact, rounded)
    torch.testing.assert_close(rounded, exact, rtol=5e-2, atol=5e-2)
    torch.testing.assert_close(exact, ref.mlstm_ref(*bf_vals),
                               rtol=5e-4, atol=5e-4)


# -- the route rule (CPU) -----------------------------------------------------

def _strides(*ts):
    """(batch, head, step) strides of (BH, S, d) rows, as mlstm_chunk
    passes them: one head of stride 0."""
    return [x for t in ts for x in (t.stride(0), 0, t.stride(1))]


@pytest.mark.parametrize("dtypes,want", [
    ((BF, BF, BF), "wgmma"),
    ((F32, F32, F32), "simt"),              # f32: the 5e-4 gate
    ((BF, BF, F32), "simt"),                # mixed streams
    ((F32, BF, BF), "simt"),
])
def test_mlstm_route_by_dtype(dtypes, want):
    q = torch.empty((8, 4096, 512), dtype=BF)
    assert ops.mlstm_route(dtypes, 512, 512, _strides(q, q, q, q),
                           ALIGNED) == want


@pytest.mark.parametrize("dqk,dv,want", [
    (512, 512, "wgmma"), (32, 48, "wgmma"), (16, 80, "wgmma"),
    (64, 40, "simt"), (24, 64, "simt"), (8, 8, "simt"), (100, 96, "simt"),
])
def test_mlstm_route_by_width(dqk, dv, want):
    q = torch.empty((2, 256, 8 * dqk), dtype=BF)[..., :dqk]
    v = torch.empty((2, 256, 8 * dv), dtype=BF)[..., :dv]
    assert ops.mlstm_route([BF] * 3, dqk, dv, _strides(q, q, v, v),
                           ALIGNED) == want


def test_mlstm_route_by_strides_and_alignment():
    # the model's (B, S, H, d) views of (B, H, S, d) tensors, as the mLSTM
    # passes them, with (batch, head, step) strides
    t = torch.empty((2, 4, 4096, 512), dtype=BF).transpose(1, 2)
    model = [t.stride(0), t.stride(2), t.stride(1)] * 4
    assert ops.mlstm_route([BF] * 3, 512, 512, model, ALIGNED) == "wgmma"
    # a row stride 4 elements off
    odd = torch.empty((2, 96, 68), dtype=BF)[..., :64]
    assert ops.mlstm_route([BF] * 3, 64, 64, _strides(odd, odd, odd, odd),
                           ALIGNED) == "simt"
    # a base 8 bytes off a 16-byte boundary
    assert ops.mlstm_route([BF] * 3, 512, 512, model,
                           [256, 520, 768, 1024]) == "simt"
    # the kernel layout: (batch = BH, head = 1 with stride 0, step)
    rows = torch.empty((8, 256, 64), dtype=BF)
    kernel = [rows.stride(0), 0, rows.stride(1)] * 4
    assert ops.mlstm_route([BF] * 3, 64, 64, kernel, ALIGNED) == "wgmma"


def test_mlstm_force_route_pins_and_refuses():
    rule_bf = ops.mlstm_route([BF] * 3, 64, 64, [64] * 12, ALIGNED)
    rule_f32 = ops.mlstm_route([F32] * 3, 64, 64, [64] * 12, ALIGNED)
    assert (rule_bf, rule_f32) == ("wgmma", "simt")
    with ops._force_route("mlstm_chunk", "simt"):
        assert ops._pick("mlstm_chunk", rule_bf) == "simt"
        assert ops._pick("moe_gmm", "wgmma") == "wgmma"
    with ops._force_route("mlstm_chunk", "wgmma"):
        assert ops._pick("mlstm_chunk", rule_bf) == "wgmma"
        with pytest.raises(ValueError, match="forced"):
            ops._pick("mlstm_chunk", rule_f32)
    assert ops._pick("mlstm_chunk", rule_f32) == "simt"


def test_mlstm_route_counters_reset():
    assert set(ops.MLSTM_ROUTES) == {"mlstm_chunk.wgmma", "mlstm_chunk.simt"}
    for name in ops.MLSTM_ROUTES:
        ops.MLSTM_ROUTES[name] = 5
    ops.LAUNCHES["mlstm_chunk"] = 10
    ops.reset_launches()
    assert not any(ops.MLSTM_ROUTES.values())
    assert not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("route", ["wgmma", "simt", None])
def test_cpu_mlstm_takes_the_plain_version_whatever_the_route(route):
    """A CPU tensor runs the sequential plain version: no launch, no
    route, whatever is forced, in both layouts."""
    q, k, v, li, lf = _torch(_inputs(1, (2,), 64, 32, 32), "bfloat16")
    ops.reset_launches()
    with ops._force_route("mlstm_chunk", route):
        got = ops.mlstm_chunk(q, k, v, li, lf, block_s=32)
        model = ops.mlstm_chunk_model(
            *(t.reshape(1, 2, 64, -1).transpose(1, 2) for t in (q, k, v)),
            *(t.reshape(1, 2, 64).transpose(1, 2) for t in (li, lf)))
    assert torch.equal(got, ref.mlstm_ref(q, k, v, li, lf))
    assert torch.equal(model.transpose(1, 2).reshape(2, 64, 32), got)
    assert not any(ops.LAUNCHES.values())
    assert not any(ops.MLSTM_ROUTES.values())


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card_inputs(gen, lead, S, dqk, dv, dtype, glead=None):
    def draw(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)
    q, k = draw(*lead, S, dqk), draw(*lead, S, dqk)
    v = draw(*lead, S, dv)
    gshape = glead or (*lead, S, 1)
    li = draw(*gshape) - 5.0
    lf = torch.nn.functional.logsigmoid(draw(*gshape) + 3.0)
    return q.to(dtype), k.to(dtype), v.to(dtype), li, lf


def _routes_for(dtype):
    return ("wgmma", "simt") if dtype == BF else ("simt",)


def _one_launch_on(route, fn):
    before = dict(ops.MLSTM_ROUTES), ops.LAUNCHES["mlstm_chunk"]
    with ops._force_route("mlstm_chunk", route):
        out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_chunk"] == before[1] + 1
    for name, n in ops.MLSTM_ROUTES.items():
        assert n == before[0][name] + (name == f"mlstm_chunk.{route}")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("BH,S,dqk,dv,bs", KERNEL_SHAPES + [
    (2, 256, 64, 80, 128),               # dv off the 128-column tile
    (3, 384, 128, 32, 96),               # chunks of 96
])
def test_mlstm_routes_equal_plain_version(cuda, BH, S, dqk, dv, bs, dtype):
    gen = torch.Generator(device=cuda).manual_seed(BH * S + dqk)
    q, k, v, li, lf = _card_inputs(gen, (BH,), S, dqk, dv, dtype)
    want = ref.mlstm_ref(q, k, v, li, lf).float()
    tol = 5e-4 if dtype == F32 else 5e-2
    for route in _routes_for(dtype):
        got = _one_launch_on(route, lambda: ops.mlstm_chunk(
            q, k, v, li, lf, block_s=bs))
        assert got.dtype == dtype and got.shape == (BH, S, dv)
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 44, 300])
def test_mlstm_wgmma_route_model_layout_matches_the_mirror(cuda, S):
    """The model's strided views (bf16 streams, f32 gates) and a ragged
    last chunk: the tensor-core route against the mirror of its own
    algorithm and against the sequential plain version."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    B, H, dqk, dv = 2, 3, 64, 128
    q, k, v, li, lf = _card_inputs(gen, (B, H), S, dqk, dv, BF,
                                   glead=(B, H, S))
    model = [t.transpose(1, 2) for t in (q, k, v, li, lf)]
    got = _one_launch_on("wgmma", lambda: ops.mlstm_chunk_model(*model))
    mirror = ref.mlstm_chunkwise_ref(q.reshape(B * H, S, dqk),
                                     k.reshape(B * H, S, dqk),
                                     v.reshape(B * H, S, dv),
                                     li.reshape(B * H, S, 1),
                                     lf.reshape(B * H, S, 1))
    got_rows = got.transpose(1, 2).reshape(B * H, S, dv).float()
    torch.testing.assert_close(got_rows, mirror.float(), rtol=5e-2,
                               atol=5e-2)
    torch.testing.assert_close(
        got.float(), ref.mlstm_model_ref(*model).float(), rtol=5e-2,
        atol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF])
def test_mlstm_routes_at_the_xlstm_shape(cuda, dtype):
    """xlstm-350m's mLSTM at B=2: 4 heads, S=4096, dqk=dv=512, f32
    gates, in the model layout, on each route that takes it."""
    gen = torch.Generator(device=cuda).manual_seed(351)
    q, k, v, li, lf = _card_inputs(gen, (2, 4), 4096, 512, 512, dtype,
                                   glead=(2, 4, 4096))
    model = [t.transpose(1, 2) for t in (q, k, v, li, lf)]
    want = ref.mlstm_model_ref(*model).float()
    tol = 5e-4 if dtype == F32 else 5e-2
    for route in _routes_for(dtype):
        got = _one_launch_on(route, lambda: ops.mlstm_chunk_model(*model))
        torch.testing.assert_close(got.float(), want, rtol=tol, atol=tol)


@pytest.mark.cuda
def test_xlstm_forward_takes_the_wgmma_route(cuda):
    """xlstm-350m at full depth in bf16: all 21 mlstm_chunk launches on
    the tensor-core route, and the loss within 1e-2 of the reference
    path's."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_config
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, init_params
    cfg = get_config("xlstm-350m")
    params = init_params(cfg, 0, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (1, 256)).astype(np.int32)).to(cuda)
    batch = {"tokens": tok, "targets": tok}
    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    ops.reset_launches()
    got, _ = forward_loss(params, cfg, batch, compute_dtype=BF, **hooks)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_chunk"] == 21
    assert ops.MLSTM_ROUTES == {"mlstm_chunk.wgmma": 21,
                                "mlstm_chunk.simt": 0}
    want, _ = forward_loss(params, cfg, batch, compute_dtype=BF)
    assert float(got) == pytest.approx(float(want), rel=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["f32", "bf16", "model"])
@pytest.mark.parametrize("N", [1, 8, 16, 17, 32])
def test_mamba_scan_state_sizes(cuda, N, mix):
    """The register-resident scan at every padded state size (8, 16, 32,
    with N = 1 and 17 padded), di = 100 (off the block's 64 channels and
    the 16-byte rows), S = 130 (a ragged last time tile), each stream mix:
    within 1e-5 (f32 y) / 1e-2 (bf16 y) of the plain version's largest
    output, and its worst (b, t) row within the same relative limit."""
    gen = torch.Generator(device=cuda).manual_seed(N)
    B, S, di = 2, 130, 100

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=cuda)
    xc, bm, cm = draw(B, S, di), draw(B, S, N), draw(B, S, N)
    dt = torch.nn.functional.softplus(draw(B, S, di) - 4.0)
    types = {"f32": (F32,) * 4, "bf16": (BF,) * 4,
             "model": (BF, F32, BF, F32)}[mix]
    xc, dt, bm, cm = (t.to(d) for t, d in zip((xc, dt, bm, cm), types))
    a = -torch.rand((di, N), generator=gen, device=cuda) * 4.0 - 0.5
    before = ops.LAUNCHES["mamba_scan"]
    got = ops.mamba_scan(xc, dt, bm, cm, a)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mamba_scan"] == before + 1
    assert got.dtype == xc.dtype and got.shape == (B, S, di)
    want = ref.mamba_scan_ref(xc, dt, bm, cm, a).float()
    tol = 1e-5 if xc.dtype == F32 else 1e-2
    err = (got.float() - want).abs().max() / want.abs().max()
    assert float(err) <= tol
    rows = (got.float() - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rows.max()) <= tol
