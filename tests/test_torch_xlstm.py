"""The port's xLSTM (mLSTM + sLSTM) against the JAX package's, on shared
numpy inputs: the plain version of the ``mlstm_chunk`` kernel (against
the sequential jnp oracle and the Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs them), the wrappers' checks, the modules
of ``models/xlstm.py``, and reduced xlstm-350m end to end (one period-8
super-block of seven mLSTM and one sLSTM mixer).

Weights come from the JAX inits and cross as numpy (``params_from_jax``
for the whole model).  Everything runs on the CPU, where the
``chunk_fn`` hook is the wrapper's plain version; the CUDA kernel is
held to it on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).  Tolerances: those of ``tests/test_kernels.py`` for
the kernel's function (5e-4 f32, 5e-2 bf16), 5e-4 between the chunked
path and the sequential form it replaces, 2e-5 (f32) for the modules
and the model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import XLSTMConfig as JXLSTMConfig
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import model as jm
from repro.models import xlstm as jxl
from repro_torch.configs import (REDUCED_SHAPE, RunConfig, XLSTMConfig,
                                 get_config, get_reduced)
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, steps
from repro_torch.models import model as M
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xl
from repro_torch.models.convert import params_from_jax

ARCH = "xlstm-350m"
F32 = torch.float32
TOL = dict(rtol=2e-5, atol=2e-5)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
KERNEL_TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
              "bfloat16": dict(rtol=5e-2, atol=5e-2)}
XCFG, JXCFG = XLSTMConfig(), JXLSTMConfig()
D, H = 64, 4                       # the reduced widths: mLSTM dh = 32


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, **tol):
    np.testing.assert_allclose(_f32(got), _f32(want), **(tol or TOL))


def _pair(a, name="float32"):
    """The same numpy values as a torch and a jax array of one dtype."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(np.array(a)).to(tdt), jnp.asarray(a).astype(jdt)


def _t(a):
    return torch.from_numpy(np.array(a))


def _mlstm_inputs(seed, lead, S, dqk, dv):
    """numpy q/k/v normal, logi = normal - 5, logf = log_sigmoid(normal +
    3): tests/test_kernels.py's draws.  ``lead`` + (S, d) streams and
    ``lead`` + (S, 1) gates."""
    rng = np.random.default_rng(seed)
    q, k = (rng.standard_normal((*lead, S, dqk)).astype(np.float32)
            for _ in range(2))
    v = rng.standard_normal((*lead, S, dv)).astype(np.float32)
    li = (rng.standard_normal((*lead, S, 1)) - 5.0).astype(np.float32)
    lf = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal((*lead, S, 1)).astype(np.float32) + 3.0))
    return q, k, v, li, lf


def _module_params(init, seed):
    """JAX init of one mixer -> (torch dict, jax dict)."""
    pj = init(jax.random.PRNGKey(seed), D, H, JXCFG)
    pt = {k: _t(np.asarray(v)) for k, v in pj.items()}
    return pt, pj


# -- (a) the kernel's plain version and the CPU wrappers ---------------------

KERNEL_SHAPES = [(2, 128, 32, 32, 64),
                 (4, 256, 64, 64, 128),
                 (1, 128, 16, 48, 32)]               # dqk != dv


@pytest.mark.parametrize("name", list(DTYPES))
@pytest.mark.parametrize("BH,S,dqk,dv,bs", KERNEL_SHAPES)
def test_mlstm_plain_version_matches_jax(BH, S, dqk, dv, bs, name):
    """The port's ``mlstm_ref`` and the CPU wrapper against the JAX
    oracle and the Pallas kernel in interpret mode."""
    arrays = _mlstm_inputs(BH * S + dv, (BH,), S, dqk, dv)
    ts, js = zip(*(_pair(a, name) for a in arrays))
    want = jref.mlstm_ref(*js)
    kernel = jops.mlstm_chunk(*js, block_s=bs)
    before = dict(ops.LAUNCHES)
    for got in (ref.mlstm_ref(*ts), ops.mlstm_chunk(*ts, block_s=bs)):
        assert got.dtype == ts[0].dtype and got.shape == (BH, S, dv)
        _close(got, want, **KERNEL_TOL[name])
        _close(got, kernel, **KERNEL_TOL[name])
    assert ops.LAUNCHES == before          # CPU: the plain version


def test_mlstm_model_layout_is_the_kernel_layout():
    """``mlstm_model_ref`` / ``mlstm_chunk_model`` on (B,S,H,d) views
    equal ``mlstm_ref`` on the (B*H,S,d) rows, mixed dtypes included
    (bf16 streams, f32 gates, h in q's dtype)."""
    q, k, v, li, lf = (_t(a) for a in _mlstm_inputs(3, (2, 3), 40, 16, 24))
    rows = ref.mlstm_ref(*(t.reshape(6, 40, -1) for t in (q, k, v, li, lf)))
    model = [t.transpose(1, 2) for t in (q, k, v)] + \
        [t[..., 0].transpose(1, 2) for t in (li, lf)]
    for fn in (ref.mlstm_model_ref, ops.mlstm_chunk_model):
        got = fn(*model)
        assert got.shape == (2, 40, 3, 24)
        torch.testing.assert_close(got.transpose(1, 2).reshape(6, 40, 24),
                                   rows, rtol=0, atol=0)
    bf = [t.to(torch.bfloat16) for t in model[:3]] + model[3:]
    got = ops.mlstm_chunk_model(*bf)
    assert got.dtype == torch.bfloat16
    _close(got.transpose(1, 2).reshape(6, 40, 24), rows,
           **KERNEL_TOL["bfloat16"])


@pytest.mark.parametrize("fault", ["ragged", "int", "shape", "gate", "rank"])
def test_mlstm_wrappers_reject_what_the_kernel_does_not_take(fault):
    q, k, v, li, lf = (_t(a) for a in _mlstm_inputs(0, (2,), 96, 16, 16))
    kw = {}
    if fault == "ragged":                # S not a multiple of the chunk
        kw = {"block_s": 64}
    elif fault == "int":
        q = q.to(torch.int32)
    elif fault == "shape":
        k = k[:, :, :8]
    elif fault == "gate":
        li = li[:, :50]
    else:
        q, k, v = q[None], k[None], v[None]
    with pytest.raises((TypeError, ValueError)):
        ops.mlstm_chunk(q, k, v, li, lf, **kw)


# -- (b) the modules -----------------------------------------------------------

def test_headwise_norm_matches_jax():
    rng = np.random.default_rng(1)
    ht, hj = _pair(3.0 * rng.standard_normal((2, 5, H, 32)).astype(
        np.float32) + 1.0)
    st, sj = _pair(rng.standard_normal(H * 32).astype(np.float32))
    _close(xl._headwise_norm(ht, st, H), jxl._headwise_norm(hj, sj, H))


def test_init_recipe_matches_jax():
    """Leaf shapes as the JAX inits, the gate biases -10 / 3, unit norm
    scales, zero conv biases."""
    gen = torch.Generator().manual_seed(0)
    for init, jinit in ((xl.init_mlstm, jxl.init_mlstm),
                        (xl.init_slstm, jxl.init_slstm)):
        pt = init(gen, D, H, XCFG, "cpu")
        pj = jinit(jax.random.PRNGKey(0), D, H, JXCFG)
        assert {k: tuple(v.shape) for k, v in pt.items()} == \
            {k: tuple(v.shape) for k, v in pj.items()}
        assert all(v.dtype == F32 for v in pt.values())
        assert float(pt["norm_scale"].min()) == float(
            pt["norm_scale"].max()) == 1.0
        assert not pt["conv_b"].any()
    pm = xl.init_mlstm(gen, D, H, XCFG, "cpu")
    assert pm["b_i"].tolist() == [-10.0] * H
    assert pm["b_f"].tolist() == [3.0] * H
    # fan-ins: conv over its kernel taps, w_down over d_inner
    assert float(pm["conv_w"].abs().max()) <= 2 / np.sqrt(4) * (1 + 1e-6)
    assert float(pm["w_down"].abs().max()) <= 2 / np.sqrt(128) * (1 + 1e-6)


@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8), (7, 128)],
                         ids=["chunks", "ragged_one_chunk", "short"])
@pytest.mark.parametrize("start", ["zero", "state"])
def test_mlstm_forward_matches_jax(S, chunk, start):
    """Output and returned state (C, n, m, conv), with the chunked
    scan over several chunks and with ``c = S`` when the chunk does not
    divide S; from a zero state and from a random one."""
    pt, pj = _module_params(jxl.init_mlstm, 2)
    rng = np.random.default_rng(S)
    xt, xj = _pair(rng.standard_normal((2, S, D)).astype(np.float32))
    st = sj = None
    if start == "state":
        state = {"C": 0.1 * rng.standard_normal((2, H, 32, 32)),
                 "n": 0.1 * rng.standard_normal((2, H, 32)),
                 "m": rng.standard_normal((2, H)),
                 "conv": rng.standard_normal((2, 3, 128))}
        state = {k: v.astype(np.float32) for k, v in state.items()}
        st = {k: _t(v) for k, v in state.items()}
        sj = {k: jnp.asarray(v) for k, v in state.items()}
    y, new = xl.mlstm_forward(pt, xt, H, XCFG, chunk=chunk, state=st)
    yj, newj = jxl.mlstm_forward(pj, xj, H, JXCFG, chunk=chunk, state=sj)
    _close(y, yj)
    for key in ("C", "n", "m", "conv"):
        _close(new[key], newj[key])


def test_mlstm_decode_matches_jax():
    pt, pj = _module_params(jxl.init_mlstm, 3)
    rng = np.random.default_rng(4)
    st = xl.init_mlstm_state(2, D, H, XCFG, F32, "cpu")
    sj = jxl.init_mlstm_state(2, D, H, JXCFG, jnp.float32)
    for _ in range(5):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        y, st = xl.mlstm_decode(pt, _t(x), st, H, XCFG)
        yj, sj = jxl.mlstm_decode(pj, jnp.asarray(x), sj, H, JXCFG)
        _close(y, yj)
    for key in ("C", "n", "m", "conv"):
        _close(st[key], sj[key])


@pytest.mark.parametrize("start", ["zero", "state"])
def test_slstm_forward_matches_jax(start):
    pt, pj = _module_params(jxl.init_slstm, 5)
    rng = np.random.default_rng(6)
    xt, xj = _pair(rng.standard_normal((2, 12, D)).astype(np.float32))
    st = sj = None
    if start == "state":
        state = {k: rng.standard_normal((2, H, 16)).astype(np.float32)
                 for k in ("c", "h", "m")}
        state["n"] = rng.uniform(0.5, 2.0, (2, H, 16)).astype(np.float32)
        state["conv"] = rng.standard_normal((2, 3, D)).astype(np.float32)
        st = {k: _t(v) for k, v in state.items()}
        sj = {k: jnp.asarray(v) for k, v in state.items()}
    y, new = xl.slstm_forward(pt, xt, H, XCFG, state=st)
    yj, newj = jxl.slstm_forward(pj, xj, H, JXCFG, state=sj)
    _close(y, yj)
    for key in ("c", "n", "h", "m", "conv"):
        _close(new[key], newj[key])


def test_slstm_decode_matches_jax():
    pt, pj = _module_params(jxl.init_slstm, 7)
    rng = np.random.default_rng(8)
    st = xl.init_slstm_state(2, D, H, XCFG, F32, "cpu")
    sj = jxl.init_slstm_state(2, D, H, JXCFG, jnp.float32)
    for _ in range(5):
        x = rng.standard_normal((2, 1, D)).astype(np.float32)
        y, st = xl.slstm_decode(pt, _t(x), st, H, XCFG)
        yj, sj = jxl.slstm_decode(pj, jnp.asarray(x), sj, H, JXCFG)
        _close(y, yj)
    for key in ("c", "n", "h", "m", "conv"):
        _close(st[key], sj[key])


# -- (c) the chunk_fn hook -----------------------------------------------------

@pytest.mark.parametrize("S,chunk", [(32, 8), (20, 8)])
def test_mlstm_forward_through_chunk_fn(S, chunk):
    """The hook (the wrapper's plain version here: the sequential form)
    gives the chunked path's output within 5e-4 and the JAX output; it
    returns no C, n, m, and refuses a starting state."""
    pt, pj = _module_params(jxl.init_mlstm, 9)
    rng = np.random.default_rng(10)
    xt, xj = _pair(rng.standard_normal((2, S, D)).astype(np.float32))
    y, new = xl.mlstm_forward(pt, xt, H, XCFG, chunk=chunk,
                              chunk_fn=ops.mlstm_chunk_model)
    chunked, ref_state = xl.mlstm_forward(pt, xt, H, XCFG, chunk=chunk)
    _close(y, chunked, **KERNEL_TOL["float32"])
    _close(y, jxl.mlstm_forward(pj, xj, H, JXCFG, chunk=chunk)[0],
           **KERNEL_TOL["float32"])
    assert new["C"] is None and new["n"] is None and new["m"] is None
    _close(new["conv"], ref_state["conv"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="zero state"):
        xl.mlstm_forward(pt, xt, H, XCFG, state=ref_state,
                         chunk_fn=ops.mlstm_chunk_model)


# -- the reduced model ---------------------------------------------------------

@pytest.fixture(scope="module")
def xlstm():
    """(port cfg, jax cfg, jax params, port params) for reduced xlstm."""
    cfg, jcfg = get_reduced(ARCH), jax_get_reduced(ARCH)
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, jp, tp


def test_configs_match_jax_field_for_field():
    for ours, theirs in ((get_config(ARCH), jax_get_config(ARCH)),
                         (get_reduced(ARCH), jax_get_reduced(ARCH))):
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    red = get_reduced(ARCH)
    assert (red.d_model, red.num_heads, red.num_layers, red.vocab_size) == \
        (64, 4, 8, 256)
    assert [m for m, _ in red.block_defs] == ["mlstm"] * 7 + ["slstm"]
    # 530.19 M parameters at full size, counted on the meta device
    full = M.init_params(get_config(ARCH), torch.Generator(), device="meta")
    assert M.param_count(full) == 530_186_408


# (g) weights across

def test_params_from_jax_maps_every_xlstm_leaf(xlstm):
    cfg, _, jp, tp = xlstm
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    leaves = set()
    for path, leaf in flat:
        keys = [p.key for p in path]
        leaves.add("/".join(keys[-2:]))
        node = tp
        for key in keys:
            node = node["stack"][0] if key == "stack" else node[key]
        want = np.asarray(leaf)[0] if keys[0] == "stack" else np.asarray(leaf)
        np.testing.assert_array_equal(node.numpy(), want)
    assert {f"mixer/{k}" for k in ("w_up", "conv_w", "wq", "wk", "wv", "w_if",
                                   "b_i", "b_f", "norm_scale", "w_down",
                                   "r_z", "r_o", "w_up1", "w_up2")} <= leaves
    assert M.param_count(tp) == jm.param_count(jp)


@pytest.mark.parametrize("fault", ["unknown", "missing"])
def test_params_from_jax_raises_on_an_unknown_or_missing_xlstm_leaf(
        xlstm, fault):
    cfg, _, jp, _ = xlstm
    tree = jax.tree.map(np.asarray, jp)
    mixer = tree["stack"]["b7"]["mixer"]
    if fault == "unknown":
        mixer["r_q"] = mixer["r_z"]
    else:
        del mixer["r_f"]
    with pytest.raises(KeyError):
        params_from_jax(tree, cfg, device="cpu")


# (d) the forward

@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_forward_loss_matches_jax(xlstm, impl):
    """Loss and CE within 2e-5 of the JAX package's reference path,
    through the chunked mLSTM and through the ``chunk_fn`` hook (its
    plain version on the CPU)."""
    cfg, jcfg, jp, tp = xlstm
    rng = np.random.default_rng(11)
    tok = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    tgt[:, -1] = -1
    want, wparts = jm.forward_loss(
        jp, jcfg, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
        compute_dtype=jnp.float32)
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="float32",
                    attention_impl=impl)
    hooks = steps._resolve_kernels(run)
    ops.reset_launches()
    got, parts = M.forward_loss(tp, cfg, {"tokens": _t(tok),
                                          "targets": _t(tgt)},
                                compute_dtype=F32, run_cfg=run, **hooks)
    assert not any(ops.LAUNCHES.values())      # CPU: plain versions
    _close(got, want)
    _close(parts["ce"], wparts["ce"])
    assert float(parts["aux"]) == 0.0


# (e) prefill and decode

def test_prefill_and_decode_step_match_jax(xlstm):
    """Prefill's logits and mLSTM / sLSTM states equal the JAX
    package's; decode steps from a zeroed cache equal its decode steps,
    and the last prompt token's decode logits equal prefill's (2e-4, as
    tests/test_archs.py)."""
    cfg, jcfg, jp, tp = xlstm
    rng = np.random.default_rng(12)
    tok = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="float32")
    logits, caches = steps.make_prefill_step(cfg, run)(
        tp, {"tokens": _t(tok[:, :8])})
    jlogits, jcaches = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :8])},
                                  compute_dtype=jnp.float32)
    _close(logits, jlogits)
    for i, (mixer, _) in enumerate(cfg.block_defs):
        names = ("C", "n", "m", "conv") if mixer == "mlstm" else \
            ("c", "n", "h", "m", "conv")
        for name in names:
            _close(caches[0][f"b{i}"][name], jcaches[f"b{i}"][name][0])

    decode = steps.make_decode_step(cfg, run)
    tc = M.init_cache(cfg, 2, 12, F32, device="cpu")
    jc = jm.init_cache(jcfg, 2, 12, jnp.float32)
    jdecode = jax.jit(lambda p, c, tok, pos: jm.decode_step(
        p, jcfg, c, tok, pos, compute_dtype=jnp.float32))
    for t in range(10):
        lt, tc = decode(tp, tc, _t(tok[:, t:t + 1]), t)
        lj, jc = jdecode(jp, jc, jnp.asarray(tok[:, t:t + 1]), jnp.int32(t))
        _close(lt, lj)
        if t == 7:          # the last prompt token: decode == prefill
            _close(lt, logits, rtol=2e-4, atol=2e-4)
    for b, names in (("b0", ("C", "n", "m", "conv")),
                     ("b7", ("c", "n", "h", "m", "conv"))):
        for name in names:
            _close(tc[0][b][name], jc[b][name][0])


def test_init_cache_holds_xlstm_states():
    cfg = get_reduced(ARCH)
    cache = M.init_cache(cfg, 3, 20, torch.bfloat16, device="cpu")
    assert len(cache) == cfg.n_super == 1
    m, s = cache[0]["b0"], cache[0]["b7"]
    assert set(m) == {"C", "n", "m", "conv"}
    assert set(s) == {"c", "n", "h", "m", "conv"}
    assert m["C"].shape == (3, H, 32, 32) and m["C"].dtype == F32
    assert m["n"].shape == (3, H, 32) and m["m"].shape == (3, H)
    assert m["conv"].shape == (3, 3, 128) and m["conv"].dtype == torch.bfloat16
    assert all(s[k].shape == (3, H, 16) and s[k].dtype == F32
               for k in ("c", "n", "h", "m"))
    assert s["conv"].shape == (3, 3, D)


# (h) the kernel serves the forward only

def test_chunk_kernel_serves_the_forward_only(xlstm):
    """The mLSTM kernel returns no final state, so collecting a cache
    through it raises instead of returning a cache without mLSTM
    states."""
    cfg, _, _, tp = xlstm
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="no mLSTM state"):
        tf.apply_stack(tp["stack"], x, cfg, positions=torch.arange(4),
                       collect_cache=True, chunk_fn=ops.mlstm_chunk_model)


# (f) the server

def test_batch_server_greedy_tokens_equal_jax():
    """The JAX server's quirks carried over: prompts fed token by token
    through decode steps that advance every slot, so an mLSTM / sLSTM
    slot also takes zero tokens while another slot prefills."""
    jcfg, cfg = jax_get_reduced(ARCH), get_reduced(ARCH)
    jsrv = jserve.BatchServer(jcfg, slots=3, max_len=40, seed=0)
    tsrv = serve.BatchServer(
        cfg, slots=3, max_len=40, device="cpu",
        params=params_from_jax(jax.tree.map(np.asarray, jsrv.params), cfg,
                               device="cpu"))
    rng = np.random.default_rng(0)
    for i in range(4):
        prompt = rng.integers(0, cfg.vocab_size,
                              int(rng.integers(4, 12))).astype(np.int32)
        jsrv.submit(jserve.Request(i, prompt, 6))
        tsrv.submit(serve.Request(i, prompt.copy(), 6))
    jdone = {r.id: r.out for r in jsrv.run()}
    tdone = {r.id: r.out for r in tsrv.run()}
    assert tdone == jdone
    assert len(tdone) == 4 and all(len(o) == 6 for o in tdone.values())


def test_serve_main_runs_xlstm_on_cpu(capsys):
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert len(done) == 3
    assert all(0 <= t < 256 for r in done for t in r.out)
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_resolve_kernels_gives_the_mlstm_hook(impl):
    run = RunConfig(model=get_reduced(ARCH), shape=REDUCED_SHAPE,
                    attention_impl=impl)
    hooks = steps._resolve_kernels(run)
    assert hooks["chunk_fn"] is (ops.mlstm_chunk_model if impl == "pallas"
                                 else None)
