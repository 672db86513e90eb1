"""The mesh steps split the sub-blocks whose heads "model" does not
divide, on the CPU: reduced xlstm-350m and minicpm3-4b with one head and
whisper-large-v3 with three, on the (2, 2) mesh ("model" of two ranks:
one head group on both ranks); and the three with two heads on the
(1, 4) mesh ("model" of four ranks: two head groups, each on a block of
two ranks with a process group of its own, as at (16, 16) where 4, 20
or 40 heads make 4 or 8 groups).

The mLSTM splits its cell on dh (each "model" rank a slice of the head's
dh: partial q.k and n.q summed over the head's ranks, C and n in blocks
of k rows), the sLSTM its input-side projections and its GLU (its
recurrence stays whole on every rank, recorded as "slstm_recurrence"),
MLA and whisper's attention and cross-attention their query rows
(``tp.HeadGroups``: k and v joined over the ranks of a head group).

One module fixture starts every program at once, from numpy inputs the
test makes (seeded):
  * the port: one spawn of 4 gloo ranks (``python
    tests/torch_tp_workers.py --undivided IN.npz DIR``) and one dry-run
    process (``--dry-undivided OUT.json``, torch's fake process group);
  * the JAX package on 4 forced host devices: ``jax.jit(make_train_step,
    in_shardings=...)`` of the same forms on the same meshes
    (``JAX_TRAIN``), and
    ``hlo.analyze`` of their compiled (2, 2) train, prefill and decode
    steps (``JAX_FLOPS``).

Cases:
  * on (1, 4), each rank's head group, its place in its block and the
    block's ranks (``tp.HeadGroups``);
  * training: 3 f32 steps (``grad_accum`` 2) against the JAX mesh step
    (loss and grad norm within 1e-4 relative, parameters and AdamW
    moments within 1e-5 x max(1, max |leaf|)) and against the port's
    plain step (1e-5); nothing computed whole but the sLSTM's
    recurrence;
  * prefill and decode equal the plain steps within 1e-5 of the largest
    value, the caches placed by ``cache_shardings``;
  * per-device dot FLOPs of the (2, 2) forms on a fake (2, 2) world
    (bf16, remat off; train B=8 S=128, prefill and decode B=8 S=64)
    within 1 % of ``hlo.analyze``
    of the JAX step, or, where the port does less, equal to its pinned
    count (``BELOW_JAX``, naming the sub-block).
"""
import json
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import torch_tp_workers as W
from repro_torch.models import init_params
from repro_torch.models.convert import params_to_jax
from repro_torch.tree import flatten

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ENV = dict(os.environ, PYTHONPATH=SRC)
JAX_ENV = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
METRIC_RTOL = 1e-4
STATE_TOL = 1e-5
STEP_TOL = 1e-5
FLOPS_TOL = 0.01
FLOPS_ARCHS = W.UNDIVIDED_JAX_ARCHS
ARCHS = FLOPS_ARCHS + W.UNDIVIDED_M4_ARCHS
# the mesh each form runs on
MESH = dict({a: "d2m2" for a in FLOPS_ARCHS},
            **{a: W.MESH_M4[0] for a in W.UNDIVIDED_M4_ARCHS})
MESH_SHAPES = {"d2m2": (2, 2), W.MESH_M4[0]: W.MESH_M4[1]}
# what each form still computes whole on every "model" rank
WHOLE = {"xlstm-350m-1h": ("slstm_recurrence",),
         "minicpm3-4b-1h": (), "whisper-large-v3-3h": (),
         "xlstm-350m-2h": ("slstm_recurrence",),
         "minicpm3-4b-2h": (), "whisper-large-v3-2h": ()}
# cells where the port does more than 1 % less than the JAX step: the
# port's count, pinned, and the sub-block that does less
BELOW_JAX = {
    # JAX 1,836,023,808: its train step runs the sLSTM's GLU whole on
    # both "model" ranks (3 products, 50,135,040 FLOPs with their
    # gradients); the port's "rec" split runs half of it on each
    # (25,067,520 less); the other 4,194,304 are the mLSTM's, as in the
    # four-head form's -0.52 % (ROADMAP A14c)
    "xlstm-350m-1h/train": (1806761984, "sLSTM GLU"),
    # JAX 326,926,336: its prefill runs the 7 mLSTM layers' cells on every
    # row of the batch (both "data" ranks' rows); the port's "dh" cell
    # keeps the rank's rows (``xlstm.mlstm_forward``), half of them
    "xlstm-350m-1h/prefill": (253591552, "mLSTM cell"),
    # JAX 253,558,784 / 8,617,984: GSPMD runs MLA's attention whole on
    # both "model" ranks (the prefill's scores f32[4,64,64] a device);
    # the port's ranks each take half of its query rows
    "minicpm3-4b-1h/train": (249495552, "MLA attention"),
    "minicpm3-4b-1h/prefill": (8306688, "MLA attention"),
    # JAX 333,447,168 / 26,869,760: GSPMD runs the decoder's
    # self-attention on every row of the batch with all heads on every
    # device (the prefill's scores f32[8,3,64,64], its q projection
    # f32[512,48] a device); the port's on the rank's rows, half the
    # query rows each
    "whisper-large-v3-3h/train": (281739264, "attention"),
    "whisper-large-v3-3h/prefill": (15073280, "attention"),
}

# the forms as ``torch_tp_workers.config`` derives them, in the JAX
# package's configs
CONFIG = """
import dataclasses
from repro.configs import get_reduced


def config(arch):
    n = {"-1h": 1, "-2h": 2, "-3h": 3}.get(arch[-3:])
    cfg = get_reduced(arch[:-3] if n else arch)
    if n:
        cfg = dataclasses.replace(cfg, num_heads=n, num_kv_heads=n)
    return cfg
"""

JAX_TRAIN = CONFIG + """
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding as sh
from repro.configs import RunConfig, ShapeConfig
from repro.launch import steps as st
from repro.optim import adamw_init
from repro.sharding_ctx import make_mesh, use_mesh

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[2])
b, s, accum, steps = spec["batch"]
out = {}


def key(path):
    return "/".join(str(p.key) for p in path)


for arch, mkey, mshape in spec["cases"]:
    mesh = make_mesh(tuple(mshape), ("data", "model"))
    cfg = config(arch)
    shape = ShapeConfig("tp", seq_len=s, global_batch=b, kind="train",
                        grad_accum=accum)
    run = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(inp[f"{arch}/param/{key(path)}"]),
        st.params_struct(cfg, jnp.float32))
    names_b = sorted({k.split("/")[-1] for k in inp
                      if k.startswith(f"{arch}/step0/")})
    with use_mesh(mesh):
        opt = adamw_init(params)
        psh = sh.param_shardings(params, mesh)
        osh = sh.opt_shardings(opt, mesh)
        params = jax.device_put(params, psh)
        opt = jax.device_put(opt, osh)
        batch0 = {k: jnp.asarray(inp[f"{arch}/step0/{k}"]) for k in names_b}
        fn = jax.jit(st.make_train_step(cfg, run), in_shardings=(
            psh, osh, sh.batch_shardings(batch0, mesh)),
            out_shardings=(psh, osh, None))
        metrics = []
        for i in range(steps):
            batch = {k: jnp.asarray(inp[f"{arch}/step{i}/{k}"])
                     for k in names_b}
            params, opt, m = fn(params, opt, batch)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    base = f"train/{mkey}/{arch}"
    out[f"{base}/metrics"] = np.array(metrics)
    for name, tree in (("params", params), ("mu", opt["mu"]),
                       ("nu", opt["nu"])):
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{base}/{name}/{key(path)}"] = np.asarray(x)
np.savez(sys.argv[3], **out)
"""

JAX_FLOPS = CONFIG + """
import json, sys
import jax, jax.numpy as jnp
from repro import sharding as sh
from repro.analysis import hlo
from repro.configs import RunConfig, ShapeConfig
from repro.launch import steps as st
from repro.sharding_ctx import make_mesh, use_mesh

archs, sizes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
with use_mesh(mesh):
    for arch in archs:
        cfg = config(arch)
        for kind, (b, s) in sizes.items():
            shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind)
            run = RunConfig(model=cfg, shape=shape, remat=False)
            ps = st.params_struct(cfg, jnp.bfloat16)
            specs = st.input_specs(cfg, shape)
            psh = sh.param_shardings(ps, mesh)
            if kind == "train":
                opt = st.opt_struct(cfg, ps)
                fn = jax.jit(st.make_train_step(cfg, run), in_shardings=(
                    psh, sh.opt_shardings(opt, mesh),
                    sh.batch_shardings(specs, mesh)))
                args = (ps, opt, specs)
            elif kind == "prefill":
                fn = jax.jit(st.make_prefill_step(cfg, run), in_shardings=(
                    psh, sh.batch_shardings(specs, mesh)))
                args = (ps, specs)
            else:
                fn = jax.jit(st.make_decode_step(cfg, run), in_shardings=(
                    psh, sh.cache_shardings(specs["caches"], mesh),
                    sh.batch_shardings(specs["token"], mesh),
                    sh.replicated(mesh)))
                args = (ps, specs["caches"], specs["token"], specs["pos"])
            a = hlo.analyze(fn.lower(*args).compile().as_text())
            out[f"{arch}/{kind}"] = {"dot_flops": a["dot_flops"],
                                     "collective_bytes":
                                         a["collective_bytes"]}
print("RESULT " + json.dumps(out))
"""


def _inputs(path):
    """The seeded weights (the port's ``init_params``, JAX layout) and
    batches of every case."""
    rng = np.random.default_rng(2029)
    arrays = {}
    for arch in ARCHS:
        cfg = W.config(arch)
        for p, a in flatten(params_to_jax(init_params(cfg, 0,
                                                      device="cpu"))):
            arrays[f"{arch}/param/" + "/".join(map(str, p))] = a
        for i in range(W.STEPS):
            for k, v in W.batch_arrays(cfg, rng, W.BATCH, W.SEQ).items():
                arrays[f"{arch}/step{i}/{k}"] = v
    np.savez(path, **arrays)


def _start(argv, env, d, name):
    err = open(d / f"{name}.stderr", "w")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err,
                            text=True, env=env, start_new_session=True)
    err.close()
    return proc


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp_undivided")
    inputs = d / "inputs.npz"
    _inputs(inputs)
    workers = os.path.join(ROOT, "tests", "torch_tp_workers.py")
    spec = {"cases": [[a, MESH[a], MESH_SHAPES[MESH[a]]] for a in ARCHS],
            "batch": [W.BATCH, W.SEQ, W.ACCUM, W.STEPS]}
    started = {
        "ranks": _start([sys.executable, workers, "--undivided", str(inputs),
                         str(d / "ranks")], ENV, d, "ranks"),
        "jax_train": _start([sys.executable, "-c", JAX_TRAIN, str(inputs),
                             json.dumps(spec), str(d / "jax_train.npz")],
                            JAX_ENV, d, "jax_train"),
        "jax_flops": _start([sys.executable, "-c", JAX_FLOPS,
                             json.dumps(list(FLOPS_ARCHS)),
                             json.dumps(W.FLOPS_SIZES)], JAX_ENV, d,
                            "jax_flops"),
        "dry": _start([sys.executable, workers, "--dry-undivided",
                       str(d / "dry.json")], ENV, d, "dry"),
    }
    yield started, d
    for proc in started.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _wait(procs, name, timeout=900):
    started, d = procs
    proc = started[name]
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (d / f"{name}.stderr").read_text()[-4000:]
    return out, d


@pytest.fixture(scope="module")
def ranks(procs):
    _, d = _wait(procs, "ranks")
    return [dict(np.load(d / "ranks" / f"rank{r}.npz"))
            for r in range(W.WORLD)]


@pytest.fixture(scope="module")
def jax_train(procs):
    _, d = _wait(procs, "jax_train")
    return dict(np.load(d / "jax_train.npz"))


@pytest.fixture(scope="module")
def flops(procs):
    out, _ = _wait(procs, "jax_flops")
    want = json.loads(out.split("RESULT ", 1)[1])
    _, d = _wait(procs, "dry")
    return want, json.loads((d / "dry.json").read_text())


def _state_gaps(got, want, prefix_got, prefix_want):
    keys = sorted(k[len(prefix_want):] for k in want
                  if k.startswith(prefix_want))
    assert keys, prefix_want
    out = []
    for k in keys:
        a, b = got[prefix_got + k], want[prefix_want + k]
        assert a.shape == b.shape, k
        out.append((k, float(np.abs(a - b).max()),
                    max(1.0, float(np.abs(b).max()))))
    return out


@pytest.mark.parametrize("arch", W.UNDIVIDED_M4_ARCHS)
def test_undivided_head_groups_on_1x4(ranks, arch):
    """Two head groups of a block of two ranks each: ranks 0 and 1 take
    heads [0, 1) in the block {0, 1}, ranks 2 and 3 heads [1, 2) in the
    block {2, 3}."""
    key = f"groups/{W.MESH_M4[0]}/{arch}"
    for r, res in enumerate(ranks):
        index, j = divmod(r, 2)
        assert res[f"{key}/layout"].tolist() == [2, 2, index, j, index,
                                                 index + 1], r
        assert res[f"{key}/block"].tolist() == [2 * index, 2 * index + 1]


@pytest.mark.parametrize("arch", ARCHS)
def test_undivided_train_steps_match_the_jax_mesh_step(ranks, jax_train,
                                                       arch):
    base = f"train/{MESH[arch]}/{arch}"
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{base}/metrics"],
                                   jax_train[f"{base}/metrics"],
                                   rtol=METRIC_RTOL, atol=0, err_msg=str(r))
    for name in ("params", "mu", "nu"):
        for leaf, gap, scale in _state_gaps(
                ranks[0], jax_train, f"{base}/{name}/", f"{base}/{name}/"):
            assert gap <= STATE_TOL * scale, (name, leaf, gap, scale)
    assert int(ranks[0][f"{base}/step"]) == W.STEPS


@pytest.mark.parametrize("arch", ARCHS)
def test_undivided_train_steps_match_the_plain_step(ranks, arch):
    base = f"train/{MESH[arch]}/{arch}"
    res = ranks[0]
    np.testing.assert_allclose(res[f"{base}/metrics"],
                               res[f"{base}/plain_metrics"], rtol=STEP_TOL,
                               atol=0)
    for name in ("params", "mu", "nu"):
        for leaf, gap, scale in _state_gaps(
                res, res, f"{base}/{name}/", f"{base}/plain_{name}/"):
            assert gap <= STEP_TOL * scale, (name, leaf, gap, scale)
    assert {tuple(r[f"{base}/whole"]) for r in ranks} == {WHOLE[arch]}


@pytest.mark.parametrize("arch", ARCHS)
def test_undivided_prefill_and_decode_equal_the_plain_steps(ranks, arch):
    key = f"steps/{MESH[arch]}/{arch}"
    for r, res in enumerate(ranks):
        for what in ("prefill_logits", "prefill_caches", "decode_logits",
                     "decode_caches"):
            gap, scale = res[f"{key}/{what}"]
            assert gap <= STEP_TOL * max(1.0, scale), (r, what, gap, scale)
        assert res[f"{key}/prefill_placed"]
        assert res[f"{key}/decode_placed"]
        assert tuple(res[f"{key}/prefill_whole"]) == WHOLE[arch]


@pytest.mark.parametrize("kind", list(W.FLOPS_SIZES))
@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_undivided_dot_flops_on_2x2_against_jax(flops, arch, kind):
    want, got = flops
    key = f"{arch}/{kind}"
    jax_flops, port = want[key]["dot_flops"], got[key]["dot_flops"]
    assert jax_flops > 0 and got[key]["collective_bytes"] > 0
    assert tuple(got[key]["tp_whole"]) == WHOLE[arch]
    if key in BELOW_JAX:
        assert port == BELOW_JAX[key][0], (port, jax_flops, BELOW_JAX[key])
        assert port < (1 - FLOPS_TOL) * jax_flops
    else:
        # the sLSTM's recurrence, whole on every rank, may add its count
        rec = recurrence_flops(arch, kind)
        assert (1 - FLOPS_TOL) * jax_flops <= port <= \
            (1 + FLOPS_TOL) * jax_flops + rec, \
            (port, jax_flops, rec, port / jax_flops - 1)


def recurrence_flops(arch, kind) -> int:
    """The dot FLOPs a device of the sLSTM's recurrence (``h @ R`` each
    step: 2 B H dh 4dh, and as much again for each of its two gradients
    in train) where it stays whole on every rank; 0 elsewhere."""
    if "slstm_recurrence" not in WHOLE[arch]:
        return 0
    cfg = W.config(arch)
    b, s = W.FLOPS_SIZES[kind]
    rows = b // 2                                     # "data" of two
    dh = cfg.d_model // cfg.num_heads
    layers = sum(m == "slstm" for m, _ in cfg.block_defs) * (
        cfg.num_layers // len(cfg.block_defs))
    steps = 1 if kind == "decode" else s
    return layers * steps * 2 * rows * cfg.num_heads * dh * 4 * dh * (
        3 if kind == "train" else 1)
