"""The port's hybrid model (jamba-v0.1-52b, reduced: one period-8
super-block of seven Mamba and one attention mixer, MoE FFNs on the odd
layers) against the JAX package's on the same weights and inputs.

Weights come from the JAX ``init_params`` and cross as numpy through
``params_from_jax``; inputs are numpy draws from fixed seeds.  Everything
runs in f32 on the CPU, where the kernel hooks (``flash_fn``, ``gmm_fn``,
``scan_fn``) are the wrappers' plain versions.  Tolerance 2e-5 unless
stated.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_get_reduced
from repro.launch import serve as jserve
from repro.models import model as jm
from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
from repro_torch.kernels import ops
from repro_torch.launch import serve, steps
from repro_torch.models import model as M
from repro_torch.models.convert import params_from_jax

ARCH = "jamba-v0.1-52b"
TOL = dict(rtol=2e-5, atol=2e-5)
F32 = torch.float32


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


@pytest.fixture(scope="module")
def jamba():
    """(port cfg, jax cfg, jax params, port params) for reduced jamba."""
    cfg, jcfg = get_reduced(ARCH), jax_get_reduced(ARCH)
    jp = jax.jit(jm.init_params, static_argnums=0)(jcfg,
                                                   jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, jp, tp


def test_params_from_jax_maps_every_jamba_leaf(jamba):
    cfg, _, jp, tp = jamba
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
    assert {f"mixer/{k}" for k in ("w_in", "conv_w", "conv_b", "w_x", "w_dt",
                                   "dt_bias", "A_log", "D", "w_out")} | \
        {f"ffn/{k}" for k in ("router", "wi", "wg", "wo")} <= leaves
    assert M.param_count(tp) == jm.param_count(jp)
    assert [m for m, _ in cfg.block_defs].count("mamba") == 7


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_forward_loss_matches_jax(jamba, impl):
    """Loss, CE and the MoE aux loss within 2e-5 of the JAX package's
    reference path, through the reference path and through the three
    kernel hooks (their plain versions on the CPU)."""
    cfg, jcfg, jp, tp = jamba
    rng = np.random.default_rng(6)
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
    _close(parts["aux"], wparts["aux"])
    assert float(parts["aux"]) > 0


def test_prefill_and_decode_step_match_jax(jamba):
    """Prefill's logits, KV caches and Mamba states equal the JAX
    package's; decode steps from a zeroed cache equal its decode steps,
    and the last prompt token's decode logits equal prefill's (2e-4, as
    tests/test_archs.py)."""
    cfg, jcfg, jp, tp = jamba
    rng = np.random.default_rng(7)
    tok = rng.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE, compute_dtype="float32")
    logits, caches = steps.make_prefill_step(cfg, run)(
        tp, {"tokens": _t(tok[:, :8])})
    jlogits, jcaches = jm.prefill(jp, jcfg, {"tokens": jnp.asarray(tok[:, :8])},
                                  compute_dtype=jnp.float32)
    _close(logits, jlogits)
    for i, (mixer, _) in enumerate(cfg.block_defs):
        for name in (("k", "v") if mixer == "attn" else ("h", "conv")):
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
    for name in ("h", "conv"):
        _close(tc[0]["b0"][name], jc["b0"][name][0])


def test_init_cache_holds_mamba_states_beside_kv_caches():
    cfg = get_reduced(ARCH)
    cache = M.init_cache(cfg, 3, 20, torch.bfloat16, device="cpu")
    assert len(cache) == cfg.n_super == 1
    for i, (mixer, _) in enumerate(cfg.block_defs):
        st = cache[0][f"b{i}"]
        if mixer == "attn":
            assert st["k"].shape == (3, 20, cfg.num_kv_heads, cfg.head_dim)
            assert st["k"].dtype == torch.bfloat16
        else:
            d_inner = cfg.mamba.expand * cfg.d_model
            assert st["h"].shape == (3, d_inner, cfg.mamba.d_state)
            assert st["h"].dtype == F32
            assert st["conv"].shape == (3, cfg.mamba.d_conv - 1, d_inner)
            assert st["conv"].dtype == torch.bfloat16


def test_scan_kernel_serves_the_forward_only(jamba):
    """The scan kernel returns no final state, so collecting a cache
    through it raises instead of returning a cache without Mamba
    states."""
    from repro_torch.models import transformer as tf
    cfg, _, _, tp = jamba
    x = torch.zeros((1, 4, cfg.d_model))
    with pytest.raises(ValueError, match="no Mamba state"):
        tf.apply_stack(tp["stack"], x, cfg, positions=torch.arange(4),
                       collect_cache=True, scan_fn=ops.mamba_scan)


def test_batch_server_greedy_tokens_equal_jax():
    """The JAX server's quirks carried over: prompts fed token by token
    through decode steps that advance every slot, so a Mamba slot also
    takes zero tokens while another slot prefills."""
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


def test_serve_main_runs_jamba_on_cpu(capsys):
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--max-new", "4"])
    assert len(done) == 3
    assert all(0 <= t < 256 for r in done for t in r.out)
    assert "served 3 requests" in capsys.readouterr().out


@pytest.mark.parametrize("impl", ["reference", "pallas"])
def test_resolve_kernels(impl):
    run = RunConfig(model=get_reduced(ARCH), shape=REDUCED_SHAPE,
                    attention_impl=impl)
    hooks = steps._resolve_kernels(run)
    want = (ops.flash_attention, ops.moe_gmm, ops.mamba_scan) \
        if impl == "pallas" else (None, None, None)
    assert (hooks["flash_fn"], hooks["gmm_fn"], hooks["scan_fn"]) == want
