"""The CUDA-core ("simt") route of ``mlstm_chunk``: the two-phase chunkwise
mLSTM of ``csrc/mlstm_chunk.cu`` (a gate pass, the states entering every
chunk, then every chunk's outputs), all in f32.

On the CPU: ``ref.mlstm_chunkwise_ref`` is that route's algorithm.  With
f32 streams it rounds nothing; the route rounds no operand of bf16
streams either (it widens them), so its mirror for bf16 inputs is the
chunkwise reference on the f32-widened values, cast back to bf16.  Both
are held to the JAX package's sequential oracle and its Pallas kernel in
interpret mode on shared numpy inputs, elementwise within 5e-4 and by the
worst row's relative error (2-norm over dv) within 1e-4, the gates of
``chip_smoke.py``'s f32 mLSTM check; the cast-back bf16 mirror within the
bf16 gate, 5e-2.  The CPU wrapper forced onto the simt route still runs
the sequential plain version.

On the card (``cuda`` marker, skipped without one): the simt route forced
on the edge shapes of ``chip_smoke.py``'s ``MLSTM_CASES``, on unaligned
rows and bases (the element-by-element loads), on mixed stream types and
at the xlstm shape (f32 B=1, bf16 B=2), against the sequential plain
version (5e-4 / 5e-2, worst row 1e-4 / 3e-2) and against the chunkwise
mirror (``MIRROR_TOL``, tighter than the gate); one launch counted per
call on ``mlstm_chunk.simt``.  The module imports no JAX at top level, so
the card's machine, which has none, collects it:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_mlstm_simt.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

BF, F32 = torch.bfloat16, torch.float32
TOL = 5e-4                      # elementwise, absolute plus relative (f32)
ROW_TOL = 1e-4                  # the worst row's ||err|| / ||want|| (f32)
BF_TOL, BF_ROW_TOL = 5e-2, 3e-2
# the kernel against its chunkwise mirror in f32: the same algorithm, the
# sums in another order
MIRROR_TOL = 5e-5
# (BH, S, dqk, dv, chunk): dqk 16 / 48 / 64, dv 48 / 80, chunks 32 and 128
SHAPES = [(2, 256, 16, 48, 32),
          (2, 256, 48, 80, 128),
          (3, 256, 64, 48, 128),
          (1, 384, 64, 80, 32),
          (2, 128, 48, 48, 128)]


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


def _widened(arrays, kind):
    """The case's inputs as f32 numpy: as drawn ("f32"), or the streams
    rounded to bf16 and widened back ("bf16"), the values the route reads
    from bf16 streams; the gates stay f32."""
    if kind == "f32":
        return list(arrays)
    streams = [torch.from_numpy(a).to(BF).to(F32).numpy() for a in arrays[:3]]
    return streams + list(arrays[3:])


def _jax(arrays):
    jnp = pytest.importorskip("jax.numpy")
    return [jnp.asarray(a) for a in arrays]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().to(F32).cpu().numpy()
    return np.asarray(t, dtype=np.float32)


def _worst_row(got, want):
    got, want = _np(got), _np(want)
    err = np.linalg.norm(got - want, axis=-1)
    return float((err / np.maximum(np.linalg.norm(want, axis=-1),
                                   1e-30)).max())


def _gate(got, want, tol=TOL, row_tol=ROW_TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    assert _worst_row(got, want) <= row_tol


# -- the route's algorithm against the JAX package (CPU) ---------------------

@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("BH,S,dqk,dv,chunk", SHAPES)
def test_simt_mirror_matches_jax(BH, S, dqk, dv, chunk, kind):
    """The chunkwise reference at the route's chunk on f32 inputs, or on
    bf16-widened ones, against the sequential oracle and the Pallas kernel
    (interpret mode, block_s = the chunk) on the same values."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    arrays = _widened(_inputs(BH * S + dqk + dv, (BH,), S, dqk, dv), kind)
    got = ref.mlstm_chunkwise_ref(*map(torch.from_numpy, arrays),
                                  chunk=chunk)
    assert got.dtype == F32 and got.shape == (BH, S, dv)
    js = _jax(arrays)
    _gate(got, jref.mlstm_ref(*js))
    _gate(got, jops.mlstm_chunk(*js, block_s=chunk))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_simt_mirror_model_layout_ragged_last_chunk(kind):
    """The model layout (B, S, H, d) at S=300 through the (B*H, S, d) rows
    the kernel reads: chunks of 128, 128 and 44, against the oracle and the
    Pallas kernel (whose chunk, 100, divides S)."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    B, H, S, dqk, dv = 2, 2, 300, 48, 80
    arrays = _widened(_inputs(301, (B, H), S, dqk, dv), kind)  # (B, H, S, d)
    model = [torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))
             for a in arrays]                                  # (B, S, H, d)

    def rows(t):                          # (B, S, H, d) -> (B*H, S, d)
        return t.transpose(1, 2).reshape(B * H, S, -1)
    got = ref.mlstm_chunkwise_ref(*map(rows, model))
    got = got.reshape(B, H, S, dv).transpose(1, 2)
    assert got.shape == (B, S, H, dv)
    flat = _jax([a.reshape(B * H, S, -1) for a in arrays])
    mine = _np(got).transpose(0, 2, 1, 3).reshape(B * H, S, dv)
    _gate(mine, jref.mlstm_ref(*flat))
    _gate(mine, jops.mlstm_chunk(*flat, block_s=100))


@pytest.mark.parametrize("BH,S,dqk,dv,chunk", SHAPES[:3])
def test_simt_bf16_mirror_casts_back_within_the_bf16_gate(BH, S, dqk, dv,
                                                          chunk):
    """bf16 streams on the simt route: the chunkwise reference on the
    widened values, cast back to bf16 (the route's only rounding, h in
    q's type), against the JAX oracle and Pallas kernel run in bf16, within
    the bf16 gate."""
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    jnp = pytest.importorskip("jax.numpy")
    arrays = _inputs(BH + S + dv, (BH,), S, dqk, dv)
    bf = [torch.from_numpy(a).to(BF) for a in arrays[:3]] + \
        [torch.from_numpy(a) for a in arrays[3:]]
    mirror = ref.mlstm_chunkwise_ref(*(t.to(F32) for t in bf), chunk=chunk)
    got = mirror.to(BF)
    js = [jnp.asarray(a).astype(jnp.bfloat16) for a in arrays[:3]] + \
        [jnp.asarray(a) for a in arrays[3:]]
    want = np.asarray(jnp.asarray(jref.mlstm_ref(*js)).astype(jnp.float32))
    kernel = np.asarray(jnp.asarray(jops.mlstm_chunk(*js, block_s=chunk))
                        .astype(jnp.float32))
    _gate(got, want, BF_TOL, BF_ROW_TOL)
    _gate(got, kernel, BF_TOL, BF_ROW_TOL)
    # and the unrounded mirror is the port's own sequential plain version
    _gate(mirror, ref.mlstm_ref(*(t.to(F32) for t in bf)))


@pytest.mark.parametrize("dtype", [F32, BF])
def test_cpu_wrapper_forced_to_simt_runs_the_plain_version(dtype):
    """A CPU tensor runs the sequential plain version whatever route is
    forced, in both layouts, and counts no launch."""
    q, k, v, li, lf = (torch.from_numpy(a) for a in
                       _inputs(3, (4,), 96, 48, 80))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    ops.reset_launches()
    with ops._force_route("mlstm_chunk", "simt"):
        got = ops.mlstm_chunk(q, k, v, li, lf, block_s=32)
        model = ops.mlstm_chunk_model(
            *(t.reshape(2, 2, 96, -1).transpose(1, 2) for t in (q, k, v)),
            *(t.reshape(2, 2, 96).transpose(1, 2) for t in (li, lf)))
    assert got.dtype == dtype and got.shape == (4, 96, 80)
    assert torch.equal(got, ref.mlstm_ref(q, k, v, li, lf))
    assert torch.equal(model.transpose(1, 2).reshape(4, 96, 80), got)
    assert not any(ops.LAUNCHES.values())
    assert not any(ops.MLSTM_ROUTES.values())


# -- on the card -----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _card(gen, lead, S, dqk, dv, dtypes, model=False):
    """q/k/v normal, logi = normal - 5, logf = log_sigmoid(normal + 3) on
    the card; ``dtypes`` = (q, k, v, gates); ``model``: (B, S, H, d)
    streams and (B, S, H) gates for ``lead`` = (B, H)."""
    def draw(*shape):
        return torch.randn(shape, generator=gen, device=gen.device)
    if model:
        B, H = lead
        shape, gshape = (B, S, H), (B, S, H)
    else:
        shape, gshape = (*lead, S), (*lead, S, 1)
    q, k, v = draw(*shape, dqk), draw(*shape, dqk), draw(*shape, dv)
    li = draw(*gshape) - 5.0
    lf = torch.nn.functional.logsigmoid(draw(*gshape) + 3.0)
    return [t.to(dt) for t, dt in zip((q, k, v, li, lf),
                                      (*dtypes, dtypes[3]))]


def _simt(fn):
    """``fn`` on the forced simt route: one wrapper launch, on simt."""
    before, launches = dict(ops.MLSTM_ROUTES), ops.LAUNCHES["mlstm_chunk"]
    with ops._force_route("mlstm_chunk", "simt"):
        out = fn()
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_chunk"] == launches + 1
    assert ops.MLSTM_ROUTES["mlstm_chunk.simt"] == \
        before["mlstm_chunk.simt"] + 1
    assert ops.MLSTM_ROUTES["mlstm_chunk.wgmma"] == \
        before["mlstm_chunk.wgmma"]
    return out


def _card_gate(got, want, q_dtype):
    assert torch.isfinite(got.float()).all()
    if q_dtype == F32:
        _gate(got, want)
    else:
        _gate(got, want, BF_TOL, BF_ROW_TOL)


def _mirror_rows(q, k, v, li, lf, chunk=128):
    """The chunkwise mirror on f32-widened (BH, S, d) rows."""
    return ref.mlstm_chunkwise_ref(*(t.float() for t in (q, k, v, li, lf)),
                                   chunk=chunk)


# chip_smoke.py's MLSTM_CASES edge shapes, and a chunk of 96
EDGE = [(2, 128, 32, 32, 64), (4, 256, 64, 64, 128), (1, 128, 16, 48, 32),
        (2, 256, 64, 80, 128), (3, 384, 128, 32, 96)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, BF])
@pytest.mark.parametrize("BH,S,dqk,dv,bs", EDGE)
def test_simt_route_at_the_edge_shapes(cuda, BH, S, dqk, dv, bs, dtype):
    gen = torch.Generator(device=cuda).manual_seed(BH * S + dv)
    q, k, v, li, lf = _card(gen, (BH,), S, dqk, dv, (dtype,) * 4)
    got = _simt(lambda: ops.mlstm_chunk(q, k, v, li, lf, block_s=bs))
    assert got.dtype == dtype and got.shape == (BH, S, dv)
    _card_gate(got, ref.mlstm_ref(q, k, v, li, lf), dtype)
    if dtype == F32:
        mirror = _mirror_rows(q, k, v, li, lf, chunk=min(bs, S, 128))
        torch.testing.assert_close(got, mirror, rtol=MIRROR_TOL,
                                   atol=MIRROR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [(F32,) * 4, (BF,) * 4, (BF, BF, BF, F32),
                                    (F32, BF, F32, BF)])
@pytest.mark.parametrize("dqk,dv,cut", [(68, 84, 1), (30, 65, 0),
                                        (64, 64, 2)])
def test_simt_route_on_unaligned_rows(cuda, dtypes, dqk, dv, cut):
    """Row strides and bases off 16 bytes (views that drop ``cut`` leading
    elements of wider rows), widths off a multiple of 4 and mixed stream
    types: the element-by-element loads and stores."""
    gen = torch.Generator(device=cuda).manual_seed(dqk + dv + cut)
    q, k, v, li, lf = _card(gen, (2,), 256, dqk + cut, dv + cut, dtypes)
    q, k, v = (t[..., cut:] for t in (q, k, v))
    got = _simt(lambda: ops.mlstm_chunk(q, k, v, li, lf, block_s=128))
    assert got.dtype == dtypes[0] and got.shape == (2, 256, dv)
    _card_gate(got, ref.mlstm_ref(q, k, v, li, lf), dtypes[0])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 44, 300])
def test_simt_route_model_layout_and_ragged_chunks(cuda, S):
    """The model's strided (B, S, H, d) views in f32 and any S (a ragged
    last chunk): the plain version's gate and the mirror's."""
    gen = torch.Generator(device=cuda).manual_seed(S)
    B, H, dqk, dv = 2, 3, 48, 80
    q, k, v, li, lf = _card(gen, (B, H), S, dqk, dv, (F32,) * 4, model=True)
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in (q, k, v))
    got = _simt(lambda: ops.mlstm_chunk_model(q, k, v, li, lf))
    _card_gate(got, ref.mlstm_model_ref(q, k, v, li, lf), F32)

    def rows(t):
        return t.transpose(1, 2).reshape(B * H, S, -1)
    mirror = _mirror_rows(*map(rows, (q, k, v)), rows(li[..., None]),
                          rows(lf[..., None]))
    torch.testing.assert_close(rows(got), mirror, rtol=MIRROR_TOL,
                               atol=MIRROR_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("B,dtype", [(1, F32), (2, BF)])
def test_simt_route_at_the_xlstm_shape(cuda, B, dtype):
    """xlstm-350m's mLSTM (4 heads, S=4096, dqk=dv=512, f32 gates) in the
    model layout on the simt route: f32 at B=1 (the f32 forward's) and
    bf16 at B=2 forced off the tensor cores; f32 also against the
    mirror."""
    gen = torch.Generator(device=cuda).manual_seed(19 + B)
    q, k, v, li, lf = _card(gen, (B, 4), 4096, 512, 512,
                            (dtype, dtype, dtype, F32), model=True)
    got = _simt(lambda: ops.mlstm_chunk_model(q, k, v, li, lf))
    _card_gate(got, ref.mlstm_model_ref(q, k, v, li, lf), dtype)
    if dtype == F32:
        def rows(t):
            return t.transpose(1, 2).reshape(B * 4, 4096, -1)
        mirror = _mirror_rows(*map(rows, (q, k, v)), rows(li[..., None]),
                              rows(lf[..., None]))
        torch.testing.assert_close(rows(got), mirror, rtol=MIRROR_TOL,
                                   atol=MIRROR_TOL)


@pytest.mark.cuda
def test_f32_xlstm_forward_takes_the_simt_route(cuda):
    """Reduced xlstm-350m in f32 through the kernel hook: every mlstm_chunk
    launch on the simt route, one per mLSTM layer, and the loss within
    1e-4 of the reference path's."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("xlstm-350m")
    params = init_params(cfg, 1, device=cuda)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32)).to(cuda)
    batch = {"tokens": tok, "targets": tok}
    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    ops.reset_launches()
    got, _ = forward_loss(params, cfg, batch, compute_dtype=F32, **hooks)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["mlstm_chunk"] == 7
    assert ops.MLSTM_ROUTES == {"mlstm_chunk.wgmma": 0,
                                "mlstm_chunk.simt": 7}
    want, _ = forward_loss(params, cfg, batch, compute_dtype=F32)
    assert float(got) == pytest.approx(float(want), rel=1e-4)
