"""The port's distributed layer against the JAX package's, on the CPU:
the expert-parallel MoE (``models/moe_sharded.py``) and the int8
gradient compression (``optim/compress.py``).

One module fixture runs both sides at once, from the same numpy inputs:
  * the port: one spawn of 4 gloo ranks (``tests/torch_dist_workers.py
    moe``, a ``file://`` store under ``tmp_path``: no port is taken),
    each writing its results to npz;
  * the JAX package: one subprocess on 4 forced host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count=4``, as
    ``tests/test_system.py`` runs its mesh tests).

Cases, on the (2, 2) ("data", "model") and (2, 1, 2) ("pod", "data",
"model") meshes, swiglu and gelu experts:
  * no drops (capacity factor 8): ``apply_moe`` under the mesh (the
    sharded path) equals the JAX ``_apply_moe_naive`` and the JAX
    ``apply_moe_sharded`` within 3e-5 (output and aux);
  * drops (capacity factor 1, local capacity factor 1): equal to the JAX
    ``apply_moe_sharded`` within 3e-5, and the slots kept at both
    capacity stages on every rank equal those of a numpy model of the
    JAX plan on the JAX routing; drops happen;
  * int8 dispatch: within 3e-5 of the JAX int8 path;
  * the gradients of the output's sum with respect to the input and
    every weight equal ``jax.grad`` of the JAX sharded function's sum
    within 1e-4;
  * weights given as DTensors placed by ``sharding.param_shardings``
    give the output of the plain tensors exactly;
  * ``compressed_psum_mean`` over a 4-rank "pod" axis, 3 steps with
    error feedback: mean and residual within 1e-6 of the JAX one inside
    ``shard_map``.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.configs.base import MoEConfig as JMoEConfig
from repro.models import moe_sharded as jms
from repro.optim import compress as jcompress
from repro.sharding_ctx import abstract_mesh as jabstract_mesh
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe_sharded as ms
from repro_torch.optim import compress
from repro_torch.sharding_ctx import abstract_mesh

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
CASES = W.moe_cases()
WEIGHTS = ("router", "wi", "wg", "wo")

JAX_SIDE = """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.configs.base import MoEConfig
from repro.models import moe as moe_mod
from repro.models.moe_sharded import apply_moe_sharded
from repro.optim.compress import compressed_psum_mean
from repro.sharding_ctx import make_mesh, shard_map

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[3])
out = {}
x = jnp.asarray(inp["x"])
for key, shape, names, ffn, cf, lcf, quant, grads in spec["cases"]:
    mesh = make_mesh(tuple(shape), tuple(names))
    moe = MoEConfig(**spec["moe"], capacity_factor=cf,
                    local_capacity_factor=lcf, dispatch_quant=quant)
    p = {k: jnp.asarray(inp[f"{ffn}/{k}"])
         for k in ("router", "wi", "wg", "wo") if f"{ffn}/{k}" in inp}
    f = lambda p, x: apply_moe_sharded(p, x, moe, ffn, mesh)
    y, aux = jax.jit(f)(p, x)
    out[f"{key}/y"], out[f"{key}/aux"] = np.asarray(y), np.asarray(aux)
    if key.endswith("nodrop"):
        y0, aux0 = moe_mod._apply_moe_naive(p, x, moe, ffn)
        out[f"{key}/naive_y"] = np.asarray(y0)
        out[f"{key}/naive_aux"] = np.asarray(aux0)
    if grads:
        gp, gx = jax.jit(jax.grad(lambda p, x: f(p, x)[0].sum(),
                                  argnums=(0, 1)))(p, x)
        out[f"{key}/gx"] = np.asarray(gx)
        for k, v in gp.items():
            out[f"{key}/g{k}"] = np.asarray(v)

pod = make_mesh((4,), ("pod",))

def body(g, r):
    m, nr = compressed_psum_mean(g[0], "pod", r[0])
    return m[None], nr[None]

fn = jax.jit(shard_map(body, pod, in_specs=(P("pod"), P("pod")),
                       out_specs=(P("pod"), P("pod"))))
resid = jnp.zeros_like(inp["grads"][0])
for s in range(inp["grads"].shape[0]):
    m, resid = fn(jnp.asarray(inp["grads"][s]), resid)
    out[f"compress/mean{s}"] = np.asarray(m)
    out[f"compress/resid{s}"] = np.asarray(resid)
np.savez(sys.argv[2], **out)
"""


def _inputs(path):
    rng = np.random.default_rng(2021)
    E, F, D = W.MOE["num_experts"], W.MOE["d_ff_expert"], W.D_MODEL
    inp = {"x": rng.standard_normal(W.X_SHAPE).astype(np.float32),
           # 3 steps x 4 ranks of a gradient
           "grads": rng.standard_normal((3, 4, 5, 7)).astype(np.float32)}
    for ffn in W.FFNS:
        inp[f"{ffn}/router"] = rng.standard_normal((D, E)).astype(
            np.float32) / np.sqrt(D)
        inp[f"{ffn}/wi"] = rng.standard_normal((E, D, F)).astype(
            np.float32) / np.sqrt(D)
        inp[f"{ffn}/wo"] = rng.standard_normal((E, F, D)).astype(
            np.float32) / np.sqrt(F)
        if ffn == "swiglu":
            inp[f"{ffn}/wg"] = rng.standard_normal((E, D, F)).astype(
                np.float32) / np.sqrt(D)
    np.savez(path, **inp)
    return inp


def _check(proc, what):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, f"{what} failed:\n{err[-4000:]}"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs(d / "in.npz")
    spec = {"moe": W.MOE,
            "cases": [[key, *W.MESHES[m], ffn, cf, lcf, quant, grads]
                      for key, m, ffn, (_, cf, lcf, quant, grads) in CASES]}
    env = dict(os.environ, PYTHONPATH=SRC)
    jax_env = dict(env, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
    procs = [
        (subprocess.Popen([sys.executable, "-c", textwrap.dedent(JAX_SIDE),
                           str(d / "in.npz"), str(d / "jax.npz"),
                           json.dumps(spec)], env=jax_env, text=True,
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE),
         "the JAX side"),
        (subprocess.Popen([sys.executable,
                           os.path.join(ROOT, "tests", "torch_dist_workers.py"),
                           "moe", str(d / "in.npz"), str(d / "port")],
                          env=env, text=True, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE),
         "the port's 4 gloo ranks")]
    for proc, what in procs:
        _check(proc, what)
    ranks = [dict(np.load(d / "port" / f"rank{r}.npz"))
             for r in range(W.WORLD)]
    return inp, ranks, dict(np.load(d / "jax.npz"))


def _global(ranks, key, leaf):
    """The global array of per-rank rows ``leaf`` (batch order, model
    coordinate 0)."""
    rows = {int(r[f"{key}/b_idx"]): r[f"{key}/{leaf}"] for r in ranks
            if int(r[f"{key}/model"]) == 0}
    return np.concatenate([rows[i] for i in sorted(rows)])


def _jax_plan(inp, key, mkey, ffn, cf, lcf):
    """The slots kept at both capacity stages of the JAX package's
    sharded dispatch, modelled in numpy on the JAX routing: {batch
    index: (send keep (K*T,), local keep (nd*C_send,))}."""
    shape = dict(zip(W.MESHES[mkey][1], W.MESHES[mkey][0]))
    nd, n_pod = shape["data"], shape.get("pod", 1)
    E, K = W.MOE["num_experts"], W.MOE["top_k"]
    E_loc = E // nd
    x = inp["x"]
    rows = x.shape[0] // (nd * n_pod)
    T = rows * x.shape[1]
    logits = jnp.asarray(x.reshape(-1, x.shape[-1])) \
        @ jnp.asarray(inp[f"{ffn}/router"])
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    top_e = np.asarray(top_e).reshape(nd * n_pod, T, K)
    C_send = jms._round8(T * K / nd * cf)
    C_e = jms._round8(nd * C_send / E_loc * lcf)
    send = {}
    for b in range(nd * n_pod):
        eid = top_e[b].T.reshape(-1)
        dest, count = eid // E_loc, np.zeros(nd, int)
        keep, slot = np.zeros(K * T, bool), {}
        for j, dst in enumerate(dest):
            keep[j] = count[dst] < C_send
            if keep[j]:
                slot[(dst, count[dst])] = eid[j] % E_loc
            count[dst] += 1
        send[b] = (keep, slot)
    out = {}
    for b in range(nd * n_pod):
        pod, dst = divmod(b, nd)
        count, local = np.zeros(E_loc, int), np.zeros(nd * C_send, bool)
        for src in range(nd):
            slots = send[pod * nd + src][1]
            for pos in range(C_send):
                le = slots.get((dst, pos))
                if le is not None:
                    local[src * C_send + pos] = count[le] < C_e
                    count[le] += 1
        out[b] = (send[b][0], local)
    return out


@pytest.mark.parametrize("key,mkey,ffn,variant", CASES,
                         ids=[c[0] for c in CASES])
def test_sharded_moe_matches_jax(runs, key, mkey, ffn, variant):
    inp, ranks, jx = runs
    name, cf, lcf, quant, _ = variant
    y = _global(ranks, key, "y")
    np.testing.assert_allclose(y, jx[f"{key}/y"], **TOL)
    for r in ranks:                    # aux: the same on every rank
        np.testing.assert_allclose(r[f"{key}/aux"], jx[f"{key}/aux"], **TOL)
    drops = sum(int(r[f"{key}/send_drops"]) + int(r[f"{key}/local_drops"])
                for r in ranks)
    if name == "drops":
        assert drops > 0
        plan = _jax_plan(inp, key, mkey, ffn, cf, lcf)
        for r in ranks:
            send, local = plan[int(r[f"{key}/b_idx"])]
            np.testing.assert_array_equal(r[f"{key}/send_keep"], send)
            np.testing.assert_array_equal(r[f"{key}/local_keep"], local)
        if mkey == "d2m2":             # both stages drop on this mesh
            assert sum(int(r[f"{key}/send_drops"]) for r in ranks) > 0
    else:
        assert drops == 0
    if name == "nodrop":
        np.testing.assert_allclose(y, jx[f"{key}/naive_y"], **TOL)
        np.testing.assert_allclose(ranks[0][f"{key}/aux"],
                                   jx[f"{key}/naive_aux"], **TOL)
        np.testing.assert_array_equal(_global(ranks, key, "y_dtensor"), y)
    if name == "int8":                 # the int8 wire format is lossy
        plain = key.replace("int8", "nodrop")
        assert np.abs(y - _global(ranks, plain, "y")).max() > 1e-4


@pytest.mark.parametrize("key,mkey,ffn,variant",
                         [c for c in CASES if c[3][4]],
                         ids=[c[0] for c in CASES if c[3][4]])
def test_sharded_moe_gradients_match_jax(runs, key, mkey, ffn, variant):
    """Each rank's gradients: its rows of x, the router over its rows,
    its experts' slices (zero elsewhere).  The router's sum over the
    batch ranks and the experts' sum over all ranks are the whole
    gradients."""
    _, ranks, jx = runs
    np.testing.assert_allclose(_global(ranks, key, "gx"), jx[f"{key}/gx"],
                               **GRAD_TOL)
    router = sum(r[f"{key}/grouter"] for r in ranks
                 if int(r[f"{key}/model"]) == 0)
    np.testing.assert_allclose(router, jx[f"{key}/grouter"], **GRAD_TOL)
    for w in WEIGHTS[1:]:
        if f"{key}/g{w}" in jx:
            got = sum(r[f"{key}/g{w}"] for r in ranks)
            np.testing.assert_allclose(got, jx[f"{key}/g{w}"], **GRAD_TOL)


def test_compressed_psum_mean_matches_jax(runs):
    inp, ranks, jx = runs
    steps = inp["grads"].shape[0]
    for s in range(steps):
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[f"compress/mean{s}"],
                                       jx[f"compress/mean{s}"][r],
                                       rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(res[f"compress/resid{s}"],
                                       jx[f"compress/resid{s}"][r],
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3, "ties"])
def test_quantize_int8_is_the_jax_arithmetic(scale):
    rng = np.random.default_rng(5)
    if scale == "ties":
        # max |x| = 127 makes the scale 1: the halves round to even
        x = np.clip(rng.standard_normal((33, 17)) * 30, -120, 120)
        x[0, :6] = [127.0, 0.5, -0.5, 2.5, 1.5, -126.5]
    else:
        x = rng.standard_normal((33, 17)) * scale
    x = x.astype(np.float32)
    q, s = compress.quantize_int8(torch.from_numpy(x))
    jq, js = jcompress.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(
        compress.dequantize_int8(q, s).numpy(),
        np.asarray(jcompress.dequantize_int8(jq, js)))
    if scale == "ties":
        assert q[0, :6].tolist() == [127, 0, 0, 2, 2, -126]
    zq, zs = compress.quantize_int8(torch.zeros(4))
    assert not zq.any() and float(zs) == float(np.float32(1e-20))


def test_wire_bytes_is_the_jax_count():
    shapes = [(3, 4), (7,), (2, 2, 2)]
    tree = {f"l{i}": torch.zeros(s) for i, s in enumerate(shapes)}
    jtree = {f"l{i}": jnp.zeros(s) for i, s in enumerate(shapes)}
    for n_pod in (2, 4):
        for comp in (True, False):
            assert compress.wire_bytes(tree, n_pod, comp) \
                == jcompress.wire_bytes(jtree, n_pod, comp)


@pytest.mark.parametrize("sizes,names", [
    ((2, 2), ("data", "model")), ((2, 1, 2), ("pod", "data", "model")),
    ((4, 3), ("data", "model")), ((16, 16), ("data", "model")),
    ((2, 16, 16), ("pod", "data", "model")), ((4,), ("model",))])
def test_sharded_moe_available_is_the_jax_rule(sizes, names):
    mesh, jmesh = abstract_mesh(sizes, names), jabstract_mesh(sizes, names)
    for E, F in ((8, 32), (128, 768), (16, 14336), (6, 30)):
        for tokens in (8, 24, 96, 8192):
            kw = dict(num_experts=E, top_k=2, d_ff_expert=F)
            assert ms.sharded_moe_available(mesh, MoEConfig(**kw), tokens) \
                == jms.sharded_moe_available(jmesh, JMoEConfig(**kw), tokens)
    assert not ms.sharded_moe_available(None, MoEConfig(8, 2, 32), 64)
