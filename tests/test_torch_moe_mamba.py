"""The port's MoE and Mamba pieces against the JAX package's, on shared
numpy inputs: the plain versions of the ``moe_gmm`` and ``mamba_scan``
kernels (against the jnp oracles and the Pallas kernels in interpret
mode, as ``tests/test_kernels.py`` runs them), the wrappers' checks,
and the modules ``models/moe.py`` and ``models/mamba.py``.

On the CPU the wrappers run the plain versions; the CUDA kernels are
held to them on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).  Tolerances: those of ``tests/test_kernels.py``
(2e-5 f32, 2e-2 bf16) for the kernels' functions, 2e-5 (f32) for the
modules.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import MoEConfig as JMoEConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import mamba as jmb
from repro.models import moe as jmoe
from repro_torch.configs import MambaConfig, MoEConfig
from repro_torch.kernels import ops, ref
from repro_torch.models import mamba as mb
from repro_torch.models import moe as moe_mod

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL = dict(rtol=2e-5, atol=2e-5)


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else TOL


def _pair(a, name="float32"):
    """The same numpy values as a torch and a jax array of one dtype."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(np.array(a)).to(tdt), jnp.asarray(a).astype(jdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **(tol or TOL))


# -- moe_gmm: the plain version and the CPU wrapper --------------------------

@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("E,C,D,F", [
    (2, 64, 32, 64),
    (4, 128, 64, 96),
    (3, 72, 40, 56),                    # all-unaligned (padding path)
])
def test_moe_gmm_plain_version_matches_jax(E, C, D, F, name):
    rng = np.random.default_rng(E * C + F)
    (xt, xj), (wt, wj) = (_pair(rng.standard_normal(s).astype(np.float32),
                                name) for s in ((E, C, D), (E, D, F)))
    want = jref.moe_gmm_ref(xj, wj)
    kernel = jops.moe_gmm(xj, wj, block_c=32, block_f=32, block_k=16)
    before = dict(ops.LAUNCHES)
    for got in (ref.moe_gmm_ref(xt, wt), ops.moe_gmm(xt, wt)):
        assert got.dtype == xt.dtype and got.shape == (E, C, F)
        _close(got, want, **_tol(name))
        _close(got, kernel, **_tol(name))
    assert ops.LAUNCHES == before          # CPU: the plain version


def test_moe_gmm_mixed_dtypes_and_decode_rows():
    """bf16 activations against f32 weights, and the decode-sized C = 8:
    f32 math, output in x's dtype."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 8, 40)).astype(np.float32)
    w = rng.standard_normal((3, 40, 24)).astype(np.float32)
    xt, xj = _pair(x, "bfloat16")
    got = ops.moe_gmm(xt, torch.from_numpy(w))
    assert got.dtype == torch.bfloat16
    _close(got, jref.moe_gmm_ref(xj, jnp.asarray(w)), **_tol("bfloat16"))


# -- mamba_scan: the plain version and the CPU wrapper -----------------------

def _scan_inputs(seed, B, S, di, N):
    rng = np.random.default_rng(seed)
    xc = rng.standard_normal((B, S, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, di)))).astype(np.float32)
    bm = rng.standard_normal((B, S, N)).astype(np.float32)
    cm = rng.standard_normal((B, S, N)).astype(np.float32)
    a = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    return xc, dt, bm, cm, a


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("B,S,di,N,bd,bs", [
    (1, 64, 32, 8, 32, 32),
    (2, 128, 64, 16, 32, 64),
    (1, 96, 48, 8, 16, 32),             # padding path
])
def test_mamba_scan_plain_version_matches_jax(B, S, di, N, bd, bs, name):
    xc, dt, bm, cm, a = _scan_inputs(B * S + di, B, S, di, N)
    (xt, xj), (dtt, dtj), (bt, bj), (ct, cj) = (
        _pair(v, name) for v in (xc, dt, bm, cm))
    at, aj = _pair(a)
    want = jref.mamba_scan_ref(xj, dtj, bj, cj, aj)
    kernel = jops.mamba_scan(xj, dtj, bj, cj, aj, block_d=bd, block_s=bs)
    before = dict(ops.LAUNCHES)
    for got in (ref.mamba_scan_ref(xt, dtt, bt, ct, at),
                ops.mamba_scan(xt, dtt, bt, ct, at)):
        assert got.dtype == xt.dtype and got.shape == (B, S, di)
        _close(got, want, **_tol(name))
        _close(got, kernel, **_tol(name))
    assert ops.LAUNCHES == before


def test_mamba_scan_mixed_stream_dtypes():
    """The model's mix: xc and Bm in bf16, dt and Cm in f32."""
    xc, dt, bm, cm, a = _scan_inputs(3, 2, 48, 40, 16)
    (xt, xj), (bt, bj) = _pair(xc, "bfloat16"), _pair(bm, "bfloat16")
    (dtt, dtj), (ct, cj), (at, aj) = _pair(dt), _pair(cm), _pair(a)
    got = ops.mamba_scan(xt, dtt, bt, ct, at)
    assert got.dtype == torch.bfloat16
    _close(got, jref.mamba_scan_ref(xj, dtj, bj, cj, aj), **_tol("bfloat16"))


def _bad_gmm(case):
    x, w = torch.zeros(2, 8, 4), torch.zeros(2, 4, 6)
    return {"dtype": (x.half(), w), "rank": (x[0], w),
            "shape": (x, torch.zeros(2, 5, 6)),
            "strided": (x, torch.zeros(2, 6, 4).transpose(1, 2))}[case]


@pytest.mark.parametrize("case", ["dtype", "rank", "shape", "strided"])
def test_moe_gmm_wrapper_rejects(case):
    with pytest.raises((TypeError, ValueError)):
        ops.moe_gmm(*_bad_gmm(case))


@pytest.mark.parametrize("case", ["a_dtype", "state_too_big", "bm_shape",
                                  "strided", "int_stream"])
def test_mamba_scan_wrapper_rejects(case):
    xc, dt = torch.zeros(1, 6, 5), torch.zeros(1, 6, 5)
    bm, cm, a = torch.zeros(1, 6, 4), torch.zeros(1, 6, 4), torch.zeros(5, 4)
    if case == "a_dtype":
        a = a.double()
    elif case == "state_too_big":
        bm, cm, a = (torch.zeros(1, 6, 33), torch.zeros(1, 6, 33),
                     torch.zeros(5, 33))
    elif case == "bm_shape":
        bm = torch.zeros(1, 5, 4)
    elif case == "strided":
        xc = torch.zeros(1, 5, 6).transpose(1, 2)
    else:
        dt = dt.int()
    with pytest.raises((TypeError, ValueError)):
        ops.mamba_scan(xc, dt, bm, cm, a)


# -- models/moe.py -------------------------------------------------------------

def _moe_params(rng, d, moe, ffn_type):
    E, Fe = moe.num_experts, moe.d_ff_expert
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "wi": rng.standard_normal((E, d, Fe)) / np.sqrt(d),
         "wo": rng.standard_normal((E, Fe, d)) / np.sqrt(Fe)}
    if ffn_type == "swiglu":
        p["wg"] = rng.standard_normal((E, d, Fe)) / np.sqrt(d)
    if moe.num_shared_experts:
        Fs = moe.d_ff_shared * moe.num_shared_experts
        p["shared_wi"] = rng.standard_normal((d, Fs)) / np.sqrt(d)
        p["shared_wo"] = rng.standard_normal((Fs, d)) / np.sqrt(Fs)
        if ffn_type == "swiglu":
            p["shared_wg"] = rng.standard_normal((d, Fs)) / np.sqrt(d)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    return ({k: torch.from_numpy(v) for k, v in p.items()},
            {k: jnp.asarray(v) for k, v in p.items()})


def _jax_route(p, xt, moe, C):
    """The JAX package's routing lines (``_apply_moe_naive``)."""
    logits = (xt @ p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    _, top_e = jax.lax.top_k(probs, moe.top_k)
    eid = top_e.T.reshape(-1)
    onehot = jax.nn.one_hot(eid, moe.num_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - 1,
                              eid[:, None], axis=1)[:, 0]
    return top_e, pos < C


@pytest.mark.parametrize("ffn_type,cf,shared,drops", [
    ("swiglu", 1.25, 0, False),     # jamba's FFN and capacity factor
    ("swiglu", 0.5, 1, True),       # heavy drops, plus a shared expert
    ("squared_relu", 4.0, 0, False),
    ("gelu", 1.0, 1, True),
])
def test_apply_moe_matches_jax(ffn_type, cf, shared, drops):
    kw = dict(num_experts=4, top_k=2, d_ff_expert=32, capacity_factor=cf,
              num_shared_experts=shared, d_ff_shared=24 if shared else 0)
    moe, jmoe_cfg = MoEConfig(**kw), JMoEConfig(**kw)
    rng = np.random.default_rng(int(cf * 8) + shared)
    pt, pj = _moe_params(rng, 48, moe, ffn_type)
    xt, xj = _pair(rng.standard_normal((2, 40, 48)).astype(np.float32))
    T = 80
    C = moe_mod.capacity(T, moe)
    assert C == jmoe.capacity(T, jmoe_cfg)

    y, aux = moe_mod.apply_moe(pt, xt, moe, ffn_type)
    yj, auxj = jmoe._apply_moe_naive(pj, xj, jmoe_cfg, ffn_type)
    _close(y, yj)
    _close(aux, auxj)
    _, _, top_e, _, _, keep = moe_mod._route(pt, xt.reshape(T, 48), moe, C)
    top_ej, keepj = _jax_route(pj, xj.reshape(T, 48), jmoe_cfg, C)
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(top_ej))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(keepj))
    assert bool((~keep).any()) == drops     # the drop path is exercised


@pytest.mark.parametrize("ffn_type", ["swiglu", "squared_relu", "gelu"])
def test_expert_ffn_through_gmm_fn_matches_jax(ffn_type):
    """``_expert_ffn`` through the ``moe_gmm`` wrapper (the plain version
    on the CPU) and through its einsums equals the JAX package's."""
    moe = MoEConfig(num_experts=3, top_k=2, d_ff_expert=40)
    rng = np.random.default_rng(11)
    pt, pj = _moe_params(rng, 24, moe, ffn_type)
    bt, bj = _pair(rng.standard_normal((3, 16, 24)).astype(np.float32))
    want = jmoe._expert_ffn(pj, bj, ffn_type)
    _close(moe_mod._expert_ffn(pt, bt, ffn_type), want)
    _close(moe_mod._expert_ffn(pt, bt, ffn_type, gmm_fn=ops.moe_gmm), want)


# -- models/mamba.py -----------------------------------------------------------

MCFG = MambaConfig(d_state=8, d_conv=4, expand=2)


def _mamba_params(d=32):
    """The JAX package's init (its recipe keeps the scan stable), as a
    jax tree and the same numpy values as a torch tree."""
    pj = jmb.init_mamba(jax.random.PRNGKey(3), d, MCFG)
    pt = {k: torch.from_numpy(np.array(v)) for k, v in pj.items()}
    return pt, pj


@pytest.mark.parametrize("with_carry", [False, True])
def test_causal_conv_matches_jax(with_carry):
    rng = np.random.default_rng(12)
    xt, xj = _pair(rng.standard_normal((2, 9, 16)).astype(np.float32))
    wt, wj = _pair(rng.standard_normal((4, 16)).astype(np.float32))
    bt, bj = _pair(rng.standard_normal(16).astype(np.float32))
    ct, cj = (_pair(rng.standard_normal((2, 3, 16)).astype(np.float32))
              if with_carry else (None, None))
    y, carry = mb._causal_conv(xt, wt, bt, ct)
    yj, carryj = jmb._causal_conv(xj, wj, bj, cj)
    _close(y, yj)
    _close(carry, carryj)


def test_scan_chunk_survives_strong_decay():
    """A_bar near exp(-60) over a 256-step chunk: the log-depth scan
    stays finite and equals the sequential recurrence (a cumprod-divide
    form underflows to 0 and divides by it)."""
    rng = np.random.default_rng(13)
    a_bar = np.exp(-rng.uniform(0, 60, (1, 256, 4, 3))).astype(np.float32)
    bx = rng.standard_normal((1, 256, 4, 3)).astype(np.float32)
    h0 = rng.standard_normal((1, 4, 3)).astype(np.float32)
    h_all, h_last = mb._scan_chunk(torch.from_numpy(h0),
                                   torch.from_numpy(a_bar),
                                   torch.from_numpy(bx))
    h, want = h0, []
    for t in range(256):
        h = a_bar[:, t] * h + bx[:, t]
        want.append(h)
    assert torch.isfinite(h_all).all()
    _close(h_all, np.stack(want, axis=1))
    _close(h_last, want[-1])


@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8)],
                         ids=["chunks", "one_chunk"])
@pytest.mark.parametrize("scan", [False, True], ids=["chunked", "scan_fn"])
def test_mamba_forward_matches_jax(S, chunk, scan):
    pt, pj = _mamba_params()
    rng = np.random.default_rng(S)
    xt, xj = _pair(rng.standard_normal((2, S, 32)).astype(np.float32))
    y, (h_last, conv) = mb.mamba_forward(
        pt, xt, MCFG, chunk=chunk, scan_fn=ops.mamba_scan if scan else None)
    yj, (hj, convj) = jmb.mamba_forward(pj, xj, MCFG, chunk=chunk)
    _close(y, yj)
    _close(conv, convj)
    if scan:
        assert h_last is None           # the kernel returns no state
    else:
        _close(h_last, hj)


def test_mamba_forward_from_a_state_matches_jax():
    """A prompt continued from (h0, conv0) on the chunked path; scan_fn
    refuses a starting state."""
    pt, pj = _mamba_params()
    rng = np.random.default_rng(14)
    xt, xj = _pair(rng.standard_normal((1, 16, 32)).astype(np.float32))
    ht, hj = _pair(rng.standard_normal((1, 64, 8)).astype(np.float32))
    ct, cj = _pair(rng.standard_normal((1, 3, 64)).astype(np.float32))
    y, (h_last, _) = mb.mamba_forward(pt, xt, MCFG, chunk=8, h0=ht, conv0=ct)
    yj, (h_lastj, _) = jmb.mamba_forward(pj, xj, MCFG, chunk=8, h0=hj,
                                         conv0=cj)
    _close(y, yj)
    _close(h_last, h_lastj)
    with pytest.raises(ValueError, match="zero state"):
        mb.mamba_forward(pt, xt, MCFG, h0=ht, scan_fn=ops.mamba_scan)


def test_mamba_decode_matches_jax():
    pt, pj = _mamba_params()
    rng = np.random.default_rng(15)
    state = {"h": rng.standard_normal((2, 64, 8)).astype(np.float32),
             "conv": rng.standard_normal((2, 3, 64)).astype(np.float32)}
    st = {k: torch.from_numpy(v) for k, v in state.items()}
    sj = {k: jnp.asarray(v) for k, v in state.items()}
    for step in range(3):
        x = rng.standard_normal((2, 1, 32)).astype(np.float32)
        y, st = mb.mamba_decode(pt, torch.from_numpy(x), st, MCFG)
        yj, sj = jmb.mamba_decode(pj, jnp.asarray(x), sj, MCFG)
        _close(y, yj)
        for k in ("h", "conv"):
            _close(st[k], sj[k])


def test_init_mamba_follows_the_jax_recipe():
    """A_log = log(1..N), dt = softplus(dt_bias) log-uniform in
    [1e-3, 0.1], D = 1, conv_b = 0, and the JAX tree's leaves and
    shapes."""
    gen = torch.Generator().manual_seed(0)
    p = mb.init_mamba(gen, 64, MCFG, "cpu")
    pj = jmb.init_mamba(jax.random.PRNGKey(0), 64, MCFG)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in pj.items()}
    # log(1..N); XLA's and PyTorch's log may differ by one ulp
    np.testing.assert_allclose(p["A_log"].numpy(), np.asarray(pj["A_log"]),
                               rtol=1e-6, atol=0)
    dt = torch.nn.functional.softplus(p["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-4)
    assert float(dt.max()) <= 0.1 * (1 + 1e-4)
    assert float(torch.log(dt).std()) == pytest.approx(
        (np.log(0.1) - np.log(1e-3)) / np.sqrt(12), rel=0.2)
    assert (p["D"] == 1).all() and (p["conv_b"] == 0).all()
