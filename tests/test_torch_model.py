"""The port's dense LM (layers, attention, stack, model, server) against
the JAX package's on the same weights and inputs.

Weights come from the JAX ``init_params`` and cross as numpy through
``repro_torch.models.convert.params_from_jax``; inputs are numpy draws
from fixed seeds.  Everything runs in f32 on the CPU, where the flash
``flash_fn`` is the plain version on the port's side and the Pallas
kernel in interpret mode on the JAX side.  Tolerance 2e-5 unless stated.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch.configs import ARCHS, RunConfig, get_config, get_reduced
from repro_torch.configs import REDUCED_SHAPE
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.tree import flatten

TOL = dict(rtol=2e-5, atol=2e-5)
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, **tol):
    np.testing.assert_allclose(_np(got), _np(want), **(tol or TOL))


@pytest.fixture(scope="module")
def two_layer():
    """Reduced yi-9b with two layers: (port cfg, jax cfg, jax params,
    port params)."""
    cfg = dataclasses.replace(get_reduced("yi-9b"), num_layers=2)
    jcfg = dataclasses.replace(jax_get_reduced("yi-9b"), num_layers=2)
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, jp, tp


# -- configs -----------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_are_the_jax_configs(arch, which):
    if which == "full":
        ours, theirs = get_config(arch), jax_get_config(arch)
    else:
        ours, theirs = get_reduced(arch), jax_get_reduced(arch)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    full_vocab = {"xlstm-350m": 51200, "qwen3-moe-30b-a3b": 153600,
                  "minicpm3-4b": 73728, "internvl2-2b": 94208,
                  "whisper-large-v3": 53248, "minitron-8b": 256000,
                  "nemotron-4-15b": 256000,
                  "kimi-k2-1t-a32b": 163840}.get(arch, 65536)
    assert ours.padded_vocab() == theirs.padded_vocab() == \
        (full_vocab if which == "full" else 2048)
    assert ours.n_super == theirs.n_super


# -- layers --------------------------------------------------------------------

@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
def test_apply_norm(norm_type):
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jl.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), norm_type)
    got = L.apply_norm({k: _t(v) for k, v in p.items()}, _t(x), norm_type)
    _close(got, want)


@pytest.mark.parametrize("ffn_type", ["swiglu", "squared_relu", "gelu"])
def test_apply_ffn(ffn_type):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    p = {"wi": rng.standard_normal((32, 48)).astype(np.float32) / 6,
         "wg": rng.standard_normal((32, 48)).astype(np.float32) / 6,
         "wo": rng.standard_normal((48, 32)).astype(np.float32) / 7}
    want = jl.apply_ffn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), ffn_type)
    got = L.apply_ffn({k: _t(v) for k, v in p.items()}, _t(x), ffn_type)
    _close(got, want)


def test_inits_draw_the_jax_distributions():
    """The port's own draws (its RNG differs from JAX's): truncated
    normal at +-2 std with std 1/sqrt(fan_in), and N(0, 0.02^2)."""
    gen = torch.Generator().manual_seed(0)
    w = L.dense_init(gen, (256, 64, 8), "cpu")
    std = 1 / np.sqrt(256)
    assert w.dtype == F32 and w.shape == (256, 64, 8)
    assert float(w.abs().max()) <= 2 * std * (1 + 1e-6)
    # the std of a standard normal cut at +-2 is 0.8796
    assert float(w.std()) == pytest.approx(0.8796 * std, rel=0.02)
    wo = L.dense_init(gen, (64, 8, 256), "cpu", in_axis_size=512)
    assert float(wo.abs().max()) <= 2 / np.sqrt(512) * (1 + 1e-6)
    e = L.embed_init(gen, (512, 256), "cpu")
    assert float(e.std()) == pytest.approx(0.02, rel=0.02)
    assert float(e.mean()) == pytest.approx(0.0, abs=1e-3)
    # the MoE expert weights (E, d, F) take fan-in from shape[0] = E, as
    # the JAX package's dense_init does: std 0.25 for jamba's 16 experts
    from repro_torch.configs import MoEConfig
    from repro_torch.models.moe import init_moe
    moe = init_moe(gen, 256, MoEConfig(num_experts=16, top_k=2,
                                       d_ff_expert=64), "cpu")
    for name in ("wi", "wg"):
        assert moe[name].shape == (16, 256, 64)
        assert float(moe[name].abs().max()) <= 2 * 0.25 * (1 + 1e-6)
        assert float(moe[name].std()) == pytest.approx(0.8796 * 0.25,
                                                       rel=0.02)
    assert float(moe["wo"].abs().max()) <= 2 / np.sqrt(64) * (1 + 1e-6)
    assert float(moe["router"].abs().max()) <= 2 / np.sqrt(256) * (1 + 1e-6)
    # MLA's seven matrices and cross-attention draw dense_init (fan-in
    # from shape[0], wo from H * v_head_dim), qk-norm scales are ones,
    # the learned position table draws embed_init
    from repro_torch.configs import MLAConfig
    from repro_torch.models.attention import init_attention
    from repro_torch.models.mla import init_mla
    mla = init_mla(gen, 256, 8, MLAConfig(
        q_lora_rank=192, kv_lora_rank=128, qk_nope_head_dim=32,
        qk_rope_head_dim=16, v_head_dim=32), "cpu")
    for name, fan_in in (("w_dq", 256), ("w_uq", 192), ("w_dkv", 256),
                         ("w_kr", 256), ("w_uk", 128), ("w_uv", 128),
                         ("wo", 8 * 32)):
        w = mla[name]
        assert float(w.abs().max()) <= 2 / np.sqrt(fan_in) * (1 + 1e-6)
        assert float(w.std()) == pytest.approx(0.8796 / np.sqrt(fan_in),
                                               rel=0.05), name
    for name in ("q_norm", "kv_norm"):
        assert torch.equal(mla[name]["scale"], torch.ones_like(
            mla[name]["scale"]))
    qk = init_attention(gen, 256, 8, 4, 32, "cpu", qk_norm=True)
    for name in ("q_norm", "k_norm"):
        assert qk[name].dtype == F32 and torch.equal(qk[name],
                                                     torch.ones(32))
    assert float(qk["wq"].std()) == pytest.approx(0.8796 / 16, rel=0.02)
    cfg = get_reduced("whisper-large-v3")
    p = M.init_params(cfg, 0, device="cpu")
    assert p["pos"]["table"].shape == (4096, 64)
    assert float(p["pos"]["table"].std()) == pytest.approx(0.02, rel=0.05)
    cross = p["stack"][0]["b0"]["cross"]
    assert float(cross["wq"].abs().max()) <= 2 / 8 * (1 + 1e-6)
    assert float(cross["wq"].std()) == pytest.approx(0.8796 / 8, rel=0.05)
    assert torch.equal(p["stack"][0]["b0"]["norm_cross"]["scale"],
                       torch.ones(64))


def test_rope():
    assert np.array_equal(L.rope_freqs(128, 1e4), jl.rope_freqs(128, 1e4))
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.arange(100, 140)
    _close(L.apply_rope(_t(x), _t(pos), 1e4),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))


def test_embed_head_and_loss():
    rng = np.random.default_rng(4)
    vocab, vp, d = 200, 256, 32
    table = rng.standard_normal((vp, d)).astype(np.float32)
    w = rng.standard_normal((d, vp)).astype(np.float32) / 5
    tok = rng.integers(0, vocab, (2, 9)).astype(np.int32)
    tgt = tok.copy()
    tgt[0, :3] = -1                                  # masked positions
    x = L.apply_embed({"table": _t(table)}, _t(tok), F32)
    xj = jl.apply_embed({"table": jnp.asarray(table)}, jnp.asarray(tok),
                        jnp.float32)
    _close(x, xj, rtol=0, atol=0)
    logits = L.apply_lm_head({"w": _t(w)}, x, vocab)
    lj = jl.apply_lm_head({"w": jnp.asarray(w)}, xj, vocab)
    assert (logits[..., vocab:] == torch.finfo(F32).min).all()
    _close(logits, lj)
    _close(L.cross_entropy_loss(logits, _t(tgt), vocab),
           jl.cross_entropy_loss(lj, jnp.asarray(tgt), vocab))


# -- attention -----------------------------------------------------------------

@pytest.mark.parametrize("S,q_chunk,causal,valid", [
    (64, 8, True, None),       # KV-segmented causal path, chunks inside
    (32, 8, False, None),      # q-chunk loop, no mask
    (24, 8, False, 17),        # q-chunk loop, kv_valid_len mask
    (20, 1024, True, None),    # one chunk
])
def test_chunked_attention(S, q_chunk, causal, valid):
    rng = np.random.default_rng(S + q_chunk)
    q = rng.standard_normal((2, S, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, S, 2, 16)).astype(np.float32)
    pos = np.arange(S)
    got = attn.chunked_attention(_t(q), _t(k), _t(v), q_positions=_t(pos),
                                 kv_positions=_t(pos), causal=causal,
                                 kv_valid_len=valid, q_chunk=q_chunk)
    want = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_positions=jnp.asarray(pos), kv_positions=jnp.asarray(pos),
        causal=causal, kv_valid_len=valid, q_chunk=q_chunk)
    _close(got, want)


def test_attention_forward_and_decode(two_layer):
    cfg, _, jp, tp = two_layer
    pj = jax.tree.map(lambda a: a[0], jp["stack"]["b0"]["mixer"])
    pt = tp["stack"][0]["b0"]["mixer"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    pos = np.arange(12)
    got, (kt, vt) = attn.attention_forward(pt, _t(x), positions=_t(pos))
    want, (kj, vj) = jax.jit(
        lambda p, x, pos: jattn.attention_forward(p, x, positions=pos))(
            pj, jnp.asarray(x), jnp.asarray(pos))
    for a, b in ((got, want), (kt, kj), (vt, vj)):
        _close(a, b)

    # one decode step at pos 9 over a cache holding random history
    ck = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    cv = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    got, cache = attn.attention_decode(pt, _t(x1), {"k": _t(ck), "v": _t(cv)},
                                       pos=9)
    want, jcache = jax.jit(
        lambda p, x, c, pos: jattn.attention_decode(p, x, c, pos=pos))(
            pj, jnp.asarray(x1), {"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
            jnp.int32(9))
    _close(got, want)
    for name in ("k", "v"):
        _close(cache[name], jcache[name])
    # every batch slot is written at pos, the rest is untouched
    assert not np.allclose(_np(cache["k"])[:, 9], ck[:, 9])
    np.testing.assert_array_equal(_np(cache["k"])[:, :9], ck[:, :9])


# -- weights across ------------------------------------------------------------

def test_params_from_jax_maps_every_leaf(two_layer):
    cfg, _, jp, tp = two_layer
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        if keys[0] == "stack":
            for i in range(cfg.n_super):
                node = tp["stack"][i]
                for key in keys[1:]:
                    node = node[key]
                np.testing.assert_array_equal(node.numpy(),
                                              np.asarray(leaf)[i])
        else:
            node = tp
            for key in keys:
                node = node[key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert M.param_count(tp) == jm.param_count(jp)


@pytest.mark.parametrize("fault", ["unknown", "missing", "shape", "stack"])
def test_params_from_jax_raises_on_what_it_cannot_map(two_layer, fault):
    cfg, _, jp, _ = two_layer
    tree = jax.tree.map(np.asarray, jp)
    if fault == "unknown":
        tree["stack"]["b0"]["mixer"]["q_norm"] = np.ones((2, 16), np.float32)
    elif fault == "missing":
        del tree["final_norm"]
    elif fault == "shape":
        tree["lm_head"]["w"] = tree["lm_head"]["w"][:, :100]
    else:
        tree["stack"]["b0"]["norm1"]["scale"] = \
            tree["stack"]["b0"]["norm1"]["scale"][:1]
    with pytest.raises((KeyError, ValueError)):
        params_from_jax(tree, cfg, device="cpu")


# -- the model -----------------------------------------------------------------

@pytest.mark.parametrize("flash", [False, True], ids=["chunked", "flash"])
def test_forward_loss_matches_jax(two_layer, flash):
    cfg, jcfg, jp, tp = two_layer
    rng = np.random.default_rng(6)
    tok = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tgt = np.roll(tok, -1, axis=1)
    tgt[:, -1] = -1
    want, wparts = jm.forward_loss(
        jp, jcfg, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)},
        compute_dtype=jnp.float32,
        flash_fn=jops.flash_attention if flash else None)
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="float32",
                    attention_impl="pallas" if flash else "reference")
    flash_fn = steps._resolve_kernels(run)["flash_fn"]
    assert (flash_fn is ops.flash_attention) == flash
    ops.reset_launches()
    got, parts = M.forward_loss(
        tp, cfg, {"tokens": _t(tok), "targets": _t(tgt)},
        compute_dtype=F32, run_cfg=run, flash_fn=flash_fn)
    assert ops.LAUNCHES["flash_attention"] == 0     # CPU: plain version
    _close(got, want)
    _close(parts["ce"], wparts["ce"])
    assert float(parts["aux"]) == 0.0


def test_prefill_and_decode_step_match_jax(two_layer):
    cfg, jcfg, jp, tp = two_layer
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="float32")
    logits, caches = steps.make_prefill_step(cfg, run)(
        tp, {"tokens": _t(tok[:, :8])})
    jlogits, jcaches = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :8])},
                                  compute_dtype=jnp.float32)
    _close(logits, jlogits)
    for name in ("k", "v"):
        stacked = torch.stack([c["b0"][name] for c in caches])
        _close(stacked, jcaches["b0"][name])

    # decode two tokens after the prompt, from a cache seeded by decode
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
    for name in ("k", "v"):
        _close(torch.stack([c["b0"][name] for c in tc]), jc["b0"][name])


def test_batch_server_greedy_tokens_equal_jax():
    jcfg = jax_get_reduced("yi-9b")
    cfg = get_reduced("yi-9b")
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


def test_serve_main_on_cpu(capsys):
    done = serve.main(["--arch", "yi-9b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert len(done) == 3
    assert all(0 <= t < 256 for r in done for t in r.out)
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("part,item", [
    ("qk_norm", "A8"), ("mla", "A9"), ("minitron-8b", None)])
def test_unported_families_raise(part, item):
    """Every family of the JAX package runs in the port: qwen3's qk-norm
    (ROADMAP A8) and MLA (A9) build the JAX package's key set, and
    minitron-8b is in the registry, while a name outside it raises
    KeyError."""
    if item is None:
        assert dataclasses.asdict(get_config(part)) == \
            dataclasses.asdict(jax_get_config(part))
        with pytest.raises(KeyError):
            get_config(part + "-unknown")
        return
    bad = {"qk_norm": dict(qk_norm=True),
           "mla": dict(attention_type="mla",
                       mla=get_reduced("minicpm3-4b").mla)}[part]
    cfg = dataclasses.replace(get_reduced("yi-9b"), **bad)
    jcfg = dataclasses.replace(jax_get_reduced("yi-9b"), **bad)
    jp = jax.eval_shape(lambda: jm.init_params(jcfg, jax.random.PRNGKey(0)))
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {"/".join(map(str, path)): tuple(leaf.shape) for path, leaf in
           flatten(params_to_jax(M.init_params(cfg, 0, device="cpu")))}
    assert got == want
    leaf = {"qk_norm": "stack/b0/mixer/q_norm",
            "mla": "stack/b0/mixer/w_uk"}[part]
    assert leaf in got
