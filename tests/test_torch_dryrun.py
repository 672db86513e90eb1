"""The port's dry run (``launch/dryrun.py``, the abstract structures and
mesh steps of ``launch/steps.py``) against the JAX package's, on the CPU.

  * ``params_struct`` / ``opt_struct`` / ``cache_struct`` / ``input_specs``
    of all ten archs at full size equal the JAX package's ``eval_shape``
    structures leaf for leaf in shape and dtype, each JAX stack's leading
    ``n_super`` axis unstacked into the port's list;
  * argument bytes: on the (2, 2) mesh the port's dry run of reduced
    archs gives exactly the JAX train, prefill and decode steps'
    ``memory_analysis().argument_size_in_bytes`` (a subprocess on 4
    forced host devices; jitted with ``keep_unused=True``, since the
    port's step holds every input it is handed, where ``jax.jit`` by
    default drops an input the step does not read); on the production
    meshes (16, 16) and
    (2, 16, 16) the port's argument bytes of all 40 cells equal the sum
    of the JAX rules' shard shapes;
  * ``make_mesh_prefill_step`` / ``make_mesh_decode_step`` on 4 gloo
    ranks (``tests/torch_dist_workers.py steps``) equal the plain steps
    on the global batch within f32 rounding (1e-5 of the largest value),
    their caches placed by ``cache_shardings``;
  * ``python -m repro_torch.launch.dryrun`` on whisper-large-v3's
    decode_32k cell on the 256-rank fake mesh ends ``[OK]`` with a sane
    result; its skip rule is the JAX package's; the MoE flags configure
    the expert-parallel dispatch of qwen3's decode_32k cell (int8 wire
    bytes, local buffers), through the CLI and ``run_cell``.

The port-side programs run in processes of their own, started together
when the module starts (``tests/torch_dryrun_cells.py``).
"""
import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
import torch_dryrun_cells as C
from repro import sharding as jsh
from repro import sharding_ctx as jctx
from repro.configs import ARCH_IDS, cells as jcells
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import steps as jsteps
from repro_torch.configs import SHAPES, cells, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.launch import steps as st
from repro_torch.tree import flatten

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ENV = dict(os.environ, PYTHONPATH=SRC)
STEP_TOL = 1e-5

# the JAX side of the (2, 2) argument bytes: the JAX dry run's jit of
# each step with its in_shardings, on reduced archs (keep_unused: below)
JAX_MESH22 = """
import functools, json, sys
import jax, jax.numpy as jnp
from repro import sharding as sh
from repro.configs import RunConfig, ShapeConfig, get_reduced
from repro.launch import steps as st
from repro.sharding_ctx import make_mesh, use_mesh

spec = json.loads(sys.argv[1])
mesh = make_mesh((2, 2), ("data", "model"))
# every input counts, as the port's step is handed (and gathers) every
# input: jit's default drops the unused ones (xlstm's decode reads no
# position, whisper's no encoder weight) from the executable's arguments
jit = functools.partial(jax.jit, keep_unused=True)
out = {}
with use_mesh(mesh):
    for arch in spec["archs"]:
        cfg = get_reduced(arch)
        for kind, (b, s, accum) in spec["shapes"].items():
            shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind,
                                grad_accum=accum)
            run = RunConfig(model=cfg, shape=shape, remat=False)
            ps = st.params_struct(cfg, jnp.bfloat16)
            psh = sh.param_shardings(ps, mesh)
            specs = st.input_specs(cfg, shape)
            if kind == "train":
                os_ = st.opt_struct(cfg, ps)
                fn = jit(st.make_train_step(cfg, run), in_shardings=(
                    psh, sh.opt_shardings(os_, mesh),
                    sh.batch_shardings(specs, mesh)))
                args = (ps, os_, specs)
            elif kind == "prefill":
                fn = jit(st.make_prefill_step(cfg, run), in_shardings=(
                    psh, sh.batch_shardings(specs, mesh)))
                args = (ps, specs)
            else:
                tsh = sh.batch_shardings({"t": specs["token"]}, mesh)["t"]
                fn = jit(st.make_decode_step(cfg, run), in_shardings=(
                    psh, sh.cache_shardings(specs["caches"], mesh), tsh,
                    sh.replicated(mesh)))
                args = (ps, specs["caches"], specs["token"], specs["pos"])
            mem = fn.lower(*args).compile().memory_analysis()
            out[f"{arch}/{kind}"] = mem.argument_size_in_bytes
print("RESULT " + json.dumps(out))
"""


def _start(argv, env, d, name):
    err = open(d / f"{name}.stderr", "w")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err,
                            text=True, env=env, start_new_session=True)
    err.close()
    return proc


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    """Every subprocess of the module, started together before its first
    test; killed with their children at the module's end if no test
    waited for them."""
    d = tmp_path_factory.mktemp("dryrun")
    cells_py = os.path.join(ROOT, "tests", "torch_dryrun_cells.py")
    spec = {"archs": list(C.MESH22_ARCHS), "shapes": C.MESH22_SHAPE}
    jax_env = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4",
                   JAX_PLATFORMS="cpu")
    started = {
        "mesh22": _start([sys.executable, cells_py, "mesh22",
                          str(d / "mesh22.json")], ENV, d, "mesh22"),
        "production": _start([sys.executable, cells_py, "production",
                              str(d / "production.json")], ENV, d,
                             "production"),
        "steps": _start([sys.executable,
                         os.path.join(ROOT, "tests", "torch_dist_workers.py"),
                         "steps", "-", str(d / "steps")], ENV, d, "steps"),
        "jax22": _start([sys.executable, "-c", JAX_MESH22, json.dumps(spec)],
                        jax_env, d, "jax22"),
        "cli": _start([sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", "whisper-large-v3", "--shape", "decode_32k",
                       "--device", "cpu", "--out", str(d / "cli")], ENV, d,
                      "cli"),
    }
    yield started, d
    for proc in started.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _wait(procs, name, timeout=600):
    started, d = procs
    proc = started[name]
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, (d / f"{name}.stderr").read_text()[-4000:]
    return out, d


# -- the abstract structures ------------------------------------------------

def _port_layout(tree):
    """{JAX path: (shape, dtype name)} of a port tree: each list (a stack)
    re-stacked along a new leading axis, as ``params_to_jax`` does."""
    out = {}
    for path, t in flatten(tree):
        key = tuple(p for p in path if not isinstance(p, int))
        lead = tuple(1 for p in path if isinstance(p, int))
        shape = (tuple(t.shape), str(t.dtype).removeprefix("torch."))
        out.setdefault(key, []).append((lead, shape))
    layout = {}
    for key, items in out.items():
        n = len(items)
        shapes = {s for _, s in items}
        assert len(shapes) == 1, (key, shapes)   # every super-block alike
        (shape, dtype), = shapes
        layout[key] = ((n,) + shape if items[0][0] else shape, dtype)
    return layout


def _jax_layout(tree):
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(getattr(p, "key", getattr(p, "idx", None)) for p in path):
            (tuple(x.shape), jnp.dtype(x.dtype).name)
            for path, x in leaves}


@pytest.fixture(scope="module", params=ARCH_IDS)
def structs(request):
    arch = request.param
    cfg, jcfg = get_config(arch), jget_config(arch)
    ps, jps = st.params_struct(cfg), jsteps.params_struct(jcfg)
    return arch, cfg, jcfg, ps, jps


def test_params_and_opt_structs_equal_jax(structs):
    _, cfg, jcfg, ps, jps = structs
    assert all(t.device.type == "meta" for _, t in flatten(ps))
    assert _port_layout(ps) == _jax_layout(jps)
    opt, jopt = st.opt_struct(cfg, ps), jsteps.opt_struct(jcfg, jps)
    assert "master" in opt
    assert _port_layout(opt) == _jax_layout(jopt)


def test_cache_struct_and_input_specs_equal_jax(structs):
    _, cfg, jcfg, _, _ = structs
    for name, shape in SHAPES.items():
        specs = st.input_specs(cfg, shape)
        jspecs = jsteps.input_specs(jcfg, JSHAPES[name])
        assert set(specs) == set(jspecs), name
        if shape.kind != "decode":
            assert _port_layout(specs) == _jax_layout(jspecs), name
            continue
        assert _port_layout(specs["caches"]) \
            == _jax_layout(jspecs["caches"]), name
        for k in ("token", "pos"):
            assert _port_layout({k: specs[k]}) \
                == _jax_layout({k: jspecs[k]}), (name, k)
    caches = st.cache_struct(cfg, 2, 64, torch.float32)
    assert _port_layout(caches) \
        == _jax_layout(jsteps.cache_struct(jcfg, 2, 64, jnp.float32))


# -- argument bytes ---------------------------------------------------------

def test_argument_bytes_equal_the_jax_steps_on_a_2x2_mesh(procs):
    out, d = _wait(procs, "jax22")
    want = json.loads(out.split("RESULT ", 1)[1])
    _wait(procs, "mesh22")
    got = json.loads((d / "mesh22.json").read_text())
    assert set(got) == set(want)
    for key, r in got.items():
        assert r["status"] == "ok" and r["n_chips"] == 4
        assert r["memory"]["argument_bytes"] == want[key], key
        m = r["memory"]
        assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
        assert m["temp_bytes"] > 0 and r["counted"]["dot_flops"] > 0


def _jax_shard_bytes(tree, shardings, sizes):
    """Sum over leaves of the bytes of one device's shard under the JAX
    rules (every split is even: the rules fall back to unsharded)."""
    total = 0
    leaves = jax.tree.leaves(tree)
    specs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    assert len(leaves) == len(specs)
    for x, s in zip(leaves, specs):
        n = int(np.prod(x.shape, dtype=np.int64))
        for part in tuple(s.spec):
            for a in (part if isinstance(part, tuple) else (part,)):
                if a is not None:
                    n //= sizes[a]
        total += n * jnp.dtype(x.dtype).itemsize
    return total


@pytest.fixture(scope="module")
def production(procs):
    _, d = _wait(procs, "production")
    return json.loads((d / "production.json").read_text())


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_argument_bytes_are_the_jax_shard_sizes_on_production_meshes(
        production, arch):
    jcfg = jget_config(arch)
    ps = jsteps.params_struct(jcfg, jnp.bfloat16)
    opt = jsteps.opt_struct(jcfg, ps)
    for sizes, names in (((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        mesh = jctx.abstract_mesh(sizes, names)
        by = dict(zip(names, sizes))
        label = "x".join(map(str, sizes))
        params = _jax_shard_bytes(ps, jsh.param_shardings(ps, mesh), by)
        for name, shape in JSHAPES.items():
            specs = jsteps.input_specs(jcfg, shape)
            if shape.kind == "train":
                want = params + _jax_shard_bytes(
                    opt, jsh.opt_shardings(opt, mesh), by) + \
                    _jax_shard_bytes(specs, jsh.batch_shardings(specs, mesh),
                                     by)
            elif shape.kind == "prefill":
                want = params + _jax_shard_bytes(
                    specs, jsh.batch_shardings(specs, mesh), by)
            else:
                tok = {"t": specs["token"]}
                want = params + _jax_shard_bytes(
                    specs["caches"],
                    jsh.cache_shardings(specs["caches"], mesh), by) + \
                    _jax_shard_bytes(tok, jsh.batch_shardings(tok, mesh),
                                     by) + 4          # pos, int32
            assert production[f"{arch}/{name}/{label}"] == want, \
                (arch, name, label)


# -- the mesh steps on 4 gloo ranks -----------------------------------------

@pytest.fixture(scope="module")
def step_ranks(procs):
    _, d = _wait(procs, "steps")
    return [dict(np.load(d / "steps" / f"rank{r}.npz"))
            for r in range(W.WORLD)]


@pytest.mark.parametrize("mesh_key", list(W.MESHES))
@pytest.mark.parametrize("arch", W.STEP_ARCHS)
def test_mesh_prefill_and_decode_equal_the_plain_steps(step_ranks, arch,
                                                       mesh_key):
    for r, res in enumerate(step_ranks):
        for what in ("prefill_logits", "prefill_caches", "decode_logits",
                     "decode_caches"):
            gap, scale = res[f"{mesh_key}/{arch}/{what}"]
            assert gap <= STEP_TOL * max(1.0, scale), (r, what, gap, scale)
        assert res[f"{mesh_key}/{arch}/prefill_placed"]
        assert res[f"{mesh_key}/{arch}/decode_placed"]


# -- the command line -------------------------------------------------------

def test_dryrun_cli_whisper_decode_on_the_256_rank_mesh(procs):
    out, d = _wait(procs, "cli")
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert lines[-2].startswith("[OK] whisper-large-v3/decode_32k/16x16 ")
    assert lines[-1].startswith("wrote ")
    (r,) = json.loads((d / "cli" / "dryrun_whisper-large-v3_decode_32k_no"
                       ".json").read_text())
    assert r["status"] == "ok" and r["n_chips"] == 256
    assert r["mesh"] == "16x16" and r["trace_s"] >= 0
    assert r["counted"]["dot_flops"] > 0
    assert r["roofline"]["bottleneck"] in ("compute", "memory",
                                           "collective")
    assert set(r["counted"]["collective_bytes_by_kind"]) <= set(
        ("all-gather", "reduce-scatter", "all-reduce", "all-to-all"))
    assert r["counted"]["collective_bytes"] == sum(
        r["counted"]["collective_bytes_by_kind"].values())
    m = r["memory"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"] > 0
    assert "hlo_parsed" not in r and "xla_cost" not in r


def test_skip_rule_is_the_jax_one(capsys):
    assert list(cells()) == list(jcells())
    assert list(cells(include_skipped=False)) \
        == list(jcells(include_skipped=False))
    # a skipped cell makes no world and traces nothing
    assert dr.main(["--arch", "yi-9b", "--shape", "long_500k",
                    "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "[SKIP] yi-9b/long_500k/16x16"


MOE_ARCH, MOE_SHAPE = "qwen3-moe-30b-a3b", "decode_32k"
MOE_FLAGS = {"int8": ["--moe-quant", "int8"],
             "local_cf": ["--moe-local-cf", "1.0"]}
MOE_OVERRIDES = {"int8": {"dispatch_quant": "int8"},
                 "local_cf": {"local_capacity_factor": 1.0}}
RUN_CELL = """
import json, sys
from repro_torch.launch import dryrun as dr
out = {k: dr.run_cell(sys.argv[1], sys.argv[2], device="cpu",
                      moe_overrides=v)
       for k, v in json.loads(sys.argv[3]).items()}
json.dump(out, open(sys.argv[4], "w"))
"""


@pytest.fixture(scope="module")
def moe_flag_runs(tmp_path_factory):
    """qwen3's decode_32k cell on (16, 16) through the CLI without and
    with each MoE flag, and through ``run_cell(moe_overrides=...)``, in
    processes of their own, started together."""
    d = tmp_path_factory.mktemp("moe_flags")
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
           MOE_ARCH, "--shape", MOE_SHAPE, "--device", "cpu"]
    started = {name: _start(cli + flags + ["--out", str(d / name)], ENV, d,
                            name)
               for name, flags in [("base", [])] + list(MOE_FLAGS.items())}
    started["run_cell"] = _start(
        [sys.executable, "-c", RUN_CELL, MOE_ARCH, MOE_SHAPE,
         json.dumps(MOE_OVERRIDES), str(d / "run_cell.json")], ENV, d,
        "run_cell")
    out = {}
    try:
        for name, proc in started.items():
            proc.communicate(timeout=600)
            assert proc.returncode == 0, \
                (d / f"{name}.stderr").read_text()[-4000:]
        for name in ["base"] + list(MOE_FLAGS):
            (out[name],) = json.loads(
                (d / name / f"dryrun_{MOE_ARCH}_{MOE_SHAPE}_no.json")
                .read_text())
        out["run_cell"] = json.loads((d / "run_cell.json").read_text())
    finally:
        for proc in started.values():
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
    return out


@pytest.mark.parametrize("flag", [["--moe-quant", "int8"],
                                  ["--moe-local-cf", "1.0"]])
def test_moe_flags_configure_the_sharded_dispatch(moe_flag_runs, flag):
    """The flags configure the expert-parallel dispatch that the mesh
    steps run (until ROADMAP A14b they raised, naming it, while the
    steps ran the naive dispatch; the test keeps its name): int8 shrinks each MoE layer's dispatch all-to-all
    by the int8 wire format's count (1 byte an element and an f32 scale
    a slot against 2 bytes an element); a local capacity factor of 1.0
    shrinks the local expert buffers against 1.25, and with them the
    grouped products.  ``run_cell(moe_overrides=...)`` gives the CLI's
    counts."""
    from repro_torch.models.moe_sharded import _round8

    flag = next(k for k, v in MOE_FLAGS.items() if v == flag)
    cfg = get_config(MOE_ARCH)
    moe = cfg.moe
    base, got = moe_flag_runs["base"], moe_flag_runs[flag]
    assert base["status"] == got["status"] == "ok"
    nd = nm = 16
    layers = cfg.num_layers
    tokens = SHAPES[MOE_SHAPE].global_batch // nd         # a rank's rows
    c_send = _round8(tokens * moe.top_k / nd * moe.capacity_factor)
    a2a = {r["counted"]["collective_bytes_by_kind"]["all-to-all"]
           for r in (base, got)}
    flops = (base["counted"]["dot_flops"], got["counted"]["dot_flops"])
    if flag == "int8":
        wire = nd * c_send * (cfg.d_model * (2 - 1) - 4)   # a layer
        assert (base["counted"]["collective_bytes_by_kind"]["all-to-all"]
                - got["counted"]["collective_bytes_by_kind"]["all-to-all"]
                == layers * wire > 0)
        assert flops[0] == flops[1]
    else:
        e_loc = moe.num_experts // nd
        c_e = [_round8(nd * c_send / e_loc * f)
               for f in (moe.local_capacity_factor, 1.0)]
        assert c_e[1] < c_e[0]
        gmm = 3 * 2 * e_loc * cfg.d_model * (moe.d_ff_expert // nm)
        assert flops[0] - flops[1] == layers * gmm * (c_e[0] - c_e[1])
        assert len(a2a) == 1
        assert got["memory"]["temp_bytes"] <= base["memory"]["temp_bytes"]
    via = moe_flag_runs["run_cell"][flag]
    assert via["counted"] == got["counted"]
    assert via["memory"] == got["memory"]


def test_dry_run_needs_the_fake_backend_and_defaults_to_the_card(
        monkeypatch):
    import torch.distributed as dist
    # importing the module registers the backend: import it before the
    # backend is taken away below
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    from repro_torch.configs import RunConfig, get_reduced

    cfg = get_reduced("yi-9b")
    shape = SHAPES["decode_32k"]
    if not torch.cuda.is_available():
        # no device given: the card, which this machine lacks
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dr.dry_run(cfg, shape, RunConfig(model=cfg, shape=shape))
    assert not dist.is_initialized()
    monkeypatch.setattr(dist.Backend, "backend_list",
                        [b for b in dist.Backend.backend_list
                         if b != "fake"])
    try:
        with pytest.raises(RuntimeError,
                           match="'fake' process-group backend"):
            dr.fake_world()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
