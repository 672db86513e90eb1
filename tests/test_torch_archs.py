"""The rest of the model zoo in the port against the JAX package, on the
CPU at reduced size: qwen3-moe-30b-a3b (qk-norm, 4 experts top-2),
kimi-k2-1t-a32b (a shared expert), minicpm3-4b (MLA), internvl2-2b (VLM
patch inputs), whisper-large-v3 (encoder-decoder, learned positions,
LayerNorm, GELU), nemotron-4-15b and minitron-8b (squared ReLU,
LayerNorm).

For each, on the same weights (the JAX ``init_params`` carried across by
``params_from_jax``) and numpy inputs from a seed (tokens; 0.02 N(0,1)
frame or patch embeds):

  * every JAX leaf maps, and ``params_to_jax`` gives the JAX tree back;
  * ``forward_loss`` within 2e-5 in f32 and 2e-2 relative in bf16 (f32
    weights cast per use, as ``test_torch_bf16_parity.py`` runs it) of
    the JAX package's, on the reference path and through the kernel
    hooks (their plain versions on the CPU);
  * ``prefill``'s logits (internvl2: of the last token after the
    patches) and every cache leaf (whisper: the cross kv too) within
    2e-5;
  * 4 ``decode_step``s within 2e-5 (whisper from a cache whose cross
    part is the JAX prefill's);
  * greedy ``BatchServer`` tokens equal to the JAX server's for qwen3,
    minicpm3 and whisper;
  * qk-norm alone: ``rms_head_norm`` and ``attention_forward`` /
    ``attention_decode`` with ``qk_norm=True`` within 2e-5; likewise
    cross-attention, the sinusoidal table and the tied head.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import model as jm
from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.tree import flatten

NEW_ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "minicpm3-4b",
             "internvl2-2b", "whisper-large-v3", "nemotron-4-15b",
             "minitron-8b")
TOL = dict(rtol=2e-5, atol=2e-5)
B, S = 2, 32
F32, BF16 = torch.float32, torch.bfloat16


def _close(got, want, **tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def _jax_flat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_flat(tree) -> dict:
    return {"/".join(map(str, path)): leaf
            for path, leaf in flatten(params_to_jax(tree))}


def _inputs(cfg, seed, batch=B):
    """numpy tokens (the text part of S positions), targets, and the
    stub frontend's embeds."""
    rng = np.random.default_rng(seed)
    n = S - (cfg.frontend.num_patches if cfg.frontend is not None else 0)
    tok = rng.integers(0, cfg.vocab_size, (batch, n + 1)).astype(np.int32)
    out = {"tokens": tok[:, :-1], "targets": tok[:, 1:]}
    if cfg.is_encdec:
        out["enc_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.encoder.n_frames, cfg.d_model))).astype(np.float32)
    if cfg.frontend is not None:
        out["patch_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.frontend.num_patches, cfg.d_model))).astype(
                np.float32)
    return out


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch(request):
    """(port cfg, jax cfg, jax params, port params)."""
    name = request.param
    cfg, jcfg = get_reduced(name), jax_get_reduced(name)
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, jp, tp


def test_params_from_jax_maps_every_leaf_and_back(arch):
    cfg, _, jp, tp = arch
    want, got = _jax_flat(jp), _port_flat(tp)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert M.param_count(tp) == jm.param_count(jp)
    # the new leaves of each family are in the tree
    new = {"qwen3-moe-30b-a3b": "stack/b0/mixer/k_norm",
           "kimi-k2-1t-a32b": "stack/b0/ffn/shared_wi",
           "minicpm3-4b": "stack/b0/mixer/kv_norm/scale",
           "internvl2-2b": "stack/b0/mixer/wq",
           "whisper-large-v3": "encoder/stack/b0/mixer/wq",
           "nemotron-4-15b": "stack/b0/norm1/bias",
           "minitron-8b": "stack/b0/norm1/bias"}[cfg.name[:-len("-reduced")]]
    assert new in got
    if cfg.is_encdec:
        assert {"pos/table", "stack/b0/cross/wq", "stack/b0/norm_cross/bias",
                "encoder/final_norm/scale"} <= set(got)
        assert len(tp["encoder"]["stack"]) == cfg.encoder.num_layers


@pytest.mark.parametrize("impl", ["reference", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_matches_jax(arch, dtype, impl):
    cfg, jcfg, jp, tp = arch
    batch = _inputs(cfg, 11)
    want, wparts = jm.forward_loss(jp, jcfg, _j(batch),
                                   compute_dtype=getattr(jnp, dtype))
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype=dtype,
                    attention_impl=impl)
    ops.reset_launches()
    got, parts = M.forward_loss(tp, cfg, _t(batch),
                                compute_dtype=getattr(torch, dtype),
                                run_cfg=run, **steps._resolve_kernels(run))
    assert not any(ops.LAUNCHES.values())      # CPU: plain versions
    if dtype == "float32":
        _close(got, want)
        _close(parts["aux"], wparts["aux"])
    else:
        # relative, as test_torch_bf16_parity.py holds its losses; the
        # largest gap measured here, 3.9e-3 (kimi, reference path), is
        # the bf16 router picking other experts for a few tokens
        assert np.isfinite(float(got))
        assert abs(float(got) - float(want)) <= 2e-2 * abs(float(want)), \
            (float(got), float(want))


def test_prefill_matches_jax(arch):
    cfg, jcfg, jp, tp = arch
    batch = _inputs(cfg, 12)
    del batch["targets"]
    want, wcaches = jm.prefill(jp, jcfg, _j(batch), compute_dtype=jnp.float32)
    got, caches = M.prefill(tp, cfg, _t(batch), compute_dtype=F32)
    assert tuple(got.shape) == want.shape == (B, 1, cfg.padded_vocab())
    _close(got[..., :cfg.vocab_size], want[..., :cfg.vocab_size])
    wflat, gflat = _jax_flat(wcaches), _port_flat(caches)
    assert set(gflat) == set(wflat)
    for key in wflat:
        _close(gflat[key], wflat[key])
        if cfg.frontend is not None and key.endswith("/k"):
            # the patches' rows come first in the cache
            assert wflat[key].shape[2] == S


def test_decode_steps_match_jax(arch):
    """4 steps from a zeroed cache (whisper: its cross part the JAX
    prefill's), logits and the cache after them."""
    cfg, jcfg, jp, tp = arch
    batch = _inputs(cfg, 13)
    tok = batch["tokens"]
    jc = jm.init_cache(jcfg, B, 12, jnp.float32)
    tc = M.init_cache(cfg, B, 12, F32, device="cpu")
    if cfg.is_encdec:
        _, pre = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :3]),
                                       "enc_embeds": jnp.asarray(
                                           batch["enc_embeds"])},
                            compute_dtype=jnp.float32)
        jc["b0"]["cross"] = pre["b0"]["cross"]
        for i, c in enumerate(tc):
            for kv in ("k", "v"):
                c["b0"]["cross"][kv] = torch.from_numpy(
                    np.array(pre["b0"]["cross"][kv][i]))
        assert float(np.abs(np.asarray(pre["b0"]["cross"]["k"])).max()) > 0
    jdecode = jax.jit(lambda p, c, t, pos: jm.decode_step(
        p, jcfg, c, t, pos, compute_dtype=jnp.float32))
    for t in range(4):
        want, jc = jdecode(jp, jc, jnp.asarray(tok[:, t:t + 1]),
                           jnp.int32(t))
        got, tc = M.decode_step(tp, cfg, tc, torch.from_numpy(
            np.array(tok[:, t:t + 1])), t, compute_dtype=F32)
        _close(got[..., :cfg.vocab_size], want[..., :cfg.vocab_size])
    wflat, gflat = _jax_flat(jc), _port_flat(tc)
    assert set(gflat) == set(wflat)
    for key in wflat:
        _close(gflat[key], wflat[key])


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "minicpm3-4b",
                                  "whisper-large-v3"])
def test_batch_server_greedy_tokens_equal_jax(name):
    """The JAX server feeds prompts through decode steps, never runs the
    encoder (whisper decodes against its zeroed cross cache) and never
    prepends patches; the port's server mirrors it (ROADMAP C14)."""
    jcfg, cfg = jax_get_reduced(name), get_reduced(name)
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


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "whisper-large-v3",
                                  "internvl2-2b"])
def test_serve_main_on_cpu(name, capsys):
    done = serve.main(["--arch", name, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert len(done) == 3
    assert all(0 <= t < 256 for r in done for t in r.out)
    assert "served 3 requests" in capsys.readouterr().out


# -- qk-norm alone -------------------------------------------------------------

def test_rms_head_norm():
    rng = np.random.default_rng(14)
    x = (3 * rng.standard_normal((2, 5, 4, 16))).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(16)).astype(np.float32)
    _close(L.rms_head_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jl.rms_head_norm(jnp.asarray(x), jnp.asarray(scale)))
    got = L.rms_head_norm(torch.from_numpy(x).to(BF16),
                          torch.from_numpy(scale))
    assert got.dtype == BF16


@pytest.mark.parametrize("flash", [False, True])
def test_attention_with_qk_norm(flash):
    """attention_forward (the chunked path and the flash hook's plain
    version) and attention_decode with qk_norm=True, norm scales drawn
    around 1, within 2e-5."""
    rng = np.random.default_rng(15)
    d, H, Hkv, hd = 64, 4, 2, 16
    p = {"wq": rng.standard_normal((d, H, hd)) / 8,
         "wk": rng.standard_normal((d, Hkv, hd)) / 8,
         "wv": rng.standard_normal((d, Hkv, hd)) / 8,
         "wo": rng.standard_normal((H, hd, d)) / 8,
         "q_norm": 1 + 0.2 * rng.standard_normal(hd),
         "k_norm": 1 + 0.2 * rng.standard_normal(hd)}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    x = rng.standard_normal((2, 24, d)).astype(np.float32)
    pos = np.arange(24)
    want, (wk, wv) = jattn.attention_forward(
        jp, jnp.asarray(x), positions=jnp.asarray(pos), rope_theta=1e6,
        qk_norm=True, q_chunk=8)
    got, (gk, gv) = attn.attention_forward(
        tp, torch.from_numpy(x), positions=torch.from_numpy(pos),
        rope_theta=1e6, qk_norm=True, q_chunk=8,
        flash_fn=ops.flash_attention if flash else None)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)
    # one decode step at position 24 over the prefill's cache
    cache = {"k": np.zeros((2, 30, Hkv, hd), np.float32),
             "v": np.zeros((2, 30, Hkv, hd), np.float32)}
    cache["k"][:, :24], cache["v"][:, :24] = np.asarray(wk), np.asarray(wv)
    x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
    want, jc = jattn.attention_decode(
        jp, jnp.asarray(x1), {k: jnp.asarray(v) for k, v in cache.items()},
        pos=jnp.int32(24), rope_theta=1e6, qk_norm=True)
    got, tc = attn.attention_decode(
        tp, torch.from_numpy(x1),
        {k: torch.from_numpy(v.copy()) for k, v in cache.items()}, pos=24,
        rope_theta=1e6, qk_norm=True)
    _close(got, want)
    _close(tc["k"], jc["k"])


def test_cross_attention_matches_jax():
    """Cross-attention over an encoder's output (no RoPE, not causal,
    the chunked path even with a flash hook) and its decode against the
    static encoder kv."""
    rng = np.random.default_rng(16)
    d, H, hd, F = 64, 4, 16, 20
    p = {n: rng.standard_normal(s) / 8 for n, s in (
        ("wq", (d, H, hd)), ("wk", (d, H, hd)), ("wv", (d, H, hd)),
        ("wo", (H, hd, d)))}
    jp = {k: jnp.asarray(v, jnp.float32) for k, v in p.items()}
    tp = {k: torch.from_numpy(v.astype(np.float32)) for k, v in p.items()}
    x = rng.standard_normal((2, 10, d)).astype(np.float32)
    enc = rng.standard_normal((2, F, d)).astype(np.float32)
    want, (wk, wv) = jattn.attention_forward(
        jp, jnp.asarray(x), positions=jnp.arange(10), use_rope=False,
        causal=False, x_cross=jnp.asarray(enc))
    ops.reset_launches()
    got, (gk, gv) = attn.attention_forward(
        tp, torch.from_numpy(x), positions=torch.arange(10), use_rope=False,
        causal=False, x_cross=torch.from_numpy(enc),
        flash_fn=ops.flash_attention)
    _close(got, want)
    _close(gk, wk)
    assert tuple(gk.shape) == (2, F, H, hd)
    cache = {"k": gk, "v": gv}
    x1 = rng.standard_normal((2, 1, d)).astype(np.float32)
    want, _ = jattn.attention_decode(
        jp, jnp.asarray(x1), {"k": wk, "v": wv}, pos=jnp.int32(3),
        use_rope=False, cross=True)
    got, tc = attn.attention_decode(tp, torch.from_numpy(x1), cache, pos=3,
                                    use_rope=False, cross=True)
    _close(got, want)
    assert tc["k"] is gk and torch.equal(tc["k"], gk)


def test_sinusoidal_table_is_the_jax_table():
    np.testing.assert_array_equal(L.sinusoidal_table(1500, 64, "cpu").numpy(),
                                  np.asarray(jl.sinusoidal_table(1500, 64)))


def test_tied_head_matches_jax():
    """No config ties its embeddings, but the JAX package can: with
    ``tie_embeddings`` there is no ``lm_head`` leaf and the logits are
    ``x @ embed^T`` (padded entries unmasked, as in the JAX package);
    the f32 loss and the prefill's logits within 2e-5."""
    import dataclasses
    cfg = dataclasses.replace(get_reduced("yi-9b"), tie_embeddings=True)
    jcfg = dataclasses.replace(jax_get_reduced("yi-9b"), tie_embeddings=True)
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    assert "lm_head" not in tp and "lm_head" not in jp
    batch = _inputs(cfg, 17)
    want, _ = jm.forward_loss(jp, jcfg, _j(batch), compute_dtype=jnp.float32)
    got, _ = M.forward_loss(tp, cfg, _t(batch), compute_dtype=F32)
    _close(got, want)
    del batch["targets"]
    want, _ = jm.prefill(jp, jcfg, _j(batch), compute_dtype=jnp.float32)
    got, _ = M.prefill(tp, cfg, _t(batch), compute_dtype=F32)
    _close(got, want)
