"""The port's mesh steps computing the way the rules store the state
(``models/tp.py``, ``launch/steps.make_mesh_*_step``) against the JAX
package's jitted mesh steps, on the CPU.

One module fixture starts every program at once, from numpy inputs the
test makes (seeded):
  * the port: one spawn of 4 gloo ranks (``tests/torch_tp_workers.py``);
  * the JAX package: ``jax.jit(make_train_step, in_shardings=...)`` on 4
    forced host devices, one subprocess for the training runs and one
    for ``hlo.analyze`` of the compiled (2, 2) train steps;
  * the port's dry runs (``tests/torch_tp_workers.py --dry``, torch's
    fake process group in a process of its own).

Cases:
  * training: on (2, 2) ("data", "model") and (2, 1, 2) ("pod", "data",
    "model"), 3 f32 steps (``grad_accum`` 2, remat) of six reduced
    archs and of reduced yi-9b with one kv head (each "model" rank's q
    heads select it): loss and grad norm within 1e-4 relative of the JAX step's,
    the final parameters and AdamW moments within 1e-5 x max(1, max
    |leaf|); against the port's plain step on the global batch within
    1e-5 (the same scale); no sub-block computed whole on a "model"
    rank;
  * prefill and decode of qwen3, whisper, internvl2, minicpm3 and the
    one-kv-head yi-9b equal
    the plain steps within 1e-5 of the largest value, caches placed by
    ``cache_shardings``;
  * the (2, 2) mesh prefill with ``attention_impl="pallas"`` (flash on
    the rank's heads, ``moe_gmm`` on ``moe_sharded``'s local experts;
    on the CPU the wrappers take their plain versions) equals the
    reference path within 1e-5 of the largest logit, and calls each
    wrapper as often as the plain pallas prefill does;
  * the vocabulary-parallel loss (padded vocabulary, -1 targets) equals
    ``cross_entropy_loss`` within 1e-6, its gradient too;
  * a remat forward's gradient taken outside the mesh context (where
    the card's autograd thread takes it) equals the one taken inside;
  * ``Trainer(mesh=...)`` equals ``Trainer()`` and writes a checkpoint
    that a plain trainer restores;
  * per-device train dot FLOPs on a fake (2, 2) world within 1 % of
    ``hlo.analyze`` of the JAX step (B=8, S=128, bf16, remat off);
  * the yardstick: yi-9b at full width on (16, 16): train_4k, 2 of 48
    layers, peaks under 80 GB with a useful ratio of 0.5 or more;
    decode_32k at full depth moves under 4.45 GB of collectives a
    device.
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
METRIC_RTOL = 1e-4          # loss and grad norm against the JAX step
STATE_TOL = 1e-5            # x max(1, max |leaf|)
STEP_TOL = 1e-5
LOSS_TOL = 1e-6
FLOPS_ARCHS = ("yi-9b", "minitron-8b", "nemotron-4-15b", "internvl2-2b",
               "whisper-large-v3")
FLOPS_TOL = 0.01
CARD_BYTES = 80e9
DECODE_COLL_LIMIT = 4.45e9   # a tenth of the gathering decode step's 44.53 GB

JAX_TRAIN = """
import dataclasses, json, sys
import jax, jax.numpy as jnp, numpy as np
from repro import sharding as sh
from repro.configs import RunConfig, ShapeConfig, get_reduced
from repro.launch import steps as st
from repro.optim import adamw_init
from repro.sharding_ctx import make_mesh, use_mesh

inp = dict(np.load(sys.argv[1]))
spec = json.loads(sys.argv[2])
b, s, accum, steps = spec["batch"]
out = {}


def key(path):
    return "/".join(str(p.key) for p in path)


for mkey, (shape_, names) in spec["meshes"].items():
    mesh = make_mesh(tuple(shape_), tuple(names))
    for arch in spec["archs"]:
        cfg = get_reduced(arch.removesuffix("-mqa"))
        if arch.endswith("-mqa"):
            cfg = dataclasses.replace(cfg, num_kv_heads=1)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
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
            batch0 = {k: jnp.asarray(inp[f"{arch}/step0/{k}"])
                      for k in names_b}
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

JAX_FLOPS = """
import json, sys
import jax, jax.numpy as jnp
from repro import sharding as sh
from repro.analysis import hlo
from repro.configs import RunConfig, ShapeConfig, get_reduced
from repro.launch import steps as st
from repro.sharding_ctx import make_mesh, use_mesh

mesh = make_mesh((2, 2), ("data", "model"))
out = {}
with use_mesh(mesh):
    for arch in json.loads(sys.argv[1]):
        cfg = get_reduced(arch)
        shape = ShapeConfig("train", seq_len=128, global_batch=8,
                            kind="train")
        run = RunConfig(model=cfg, shape=shape, remat=False)
        ps = st.params_struct(cfg, jnp.bfloat16)
        opt = st.opt_struct(cfg, ps)
        specs = st.input_specs(cfg, shape)
        fn = jax.jit(st.make_train_step(cfg, run), in_shardings=(
            sh.param_shardings(ps, mesh), sh.opt_shardings(opt, mesh),
            sh.batch_shardings(specs, mesh)))
        text = fn.lower(ps, opt, specs).compile().as_text()
        out[arch] = hlo.analyze(text)["dot_flops"]
print("RESULT " + json.dumps(out))
"""


def _inputs(path):
    """The seeded weights (the port's ``init_params``, JAX layout) and
    batches of every training case, and the loss case's logits."""
    rng = np.random.default_rng(2025)
    arrays = {}
    for arch in W.TRAIN_ARCHS:
        cfg = W.config(arch)
        for p, a in flatten(params_to_jax(init_params(cfg, 0,
                                                      device="cpu"))):
            arrays[f"{arch}/param/" + "/".join(map(str, p))] = a
        for i in range(W.STEPS):
            for k, v in W.batch_arrays(cfg, rng, W.BATCH, W.SEQ).items():
                arrays[f"{arch}/step{i}/{k}"] = v
    b, s, vp = W.LOSS_SHAPE
    logits = rng.standard_normal((b, s, vp)).astype(np.float32) * 3
    logits[..., W.LOSS_VOCAB:] = np.finfo(np.float32).min
    targets = rng.integers(0, W.LOSS_VOCAB, (b, s)).astype(np.int32)
    targets[0, :3] = -1
    targets[1, -2:] = -1
    arrays["loss/logits"] = logits
    arrays["loss/targets"] = targets
    np.savez(path, **arrays)


def _start(argv, env, d, name):
    err = open(d / f"{name}.stderr", "w")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, stderr=err,
                            text=True, env=env, start_new_session=True)
    err.close()
    return proc


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    inputs = d / "inputs.npz"
    _inputs(inputs)
    workers = os.path.join(ROOT, "tests", "torch_tp_workers.py")
    spec = {"meshes": W.MESHES, "archs": list(W.TRAIN_ARCHS),
            "batch": [W.BATCH, W.SEQ, W.ACCUM, W.STEPS]}
    started = {
        "ranks": _start([sys.executable, workers, str(inputs),
                         str(d / "ranks")], ENV, d, "ranks"),
        "jax_train": _start([sys.executable, "-c", JAX_TRAIN, str(inputs),
                             json.dumps(spec), str(d / "jax_train.npz")],
                            JAX_ENV, d, "jax_train"),
        "jax_flops": _start([sys.executable, "-c", JAX_FLOPS,
                             json.dumps(FLOPS_ARCHS)], JAX_ENV, d,
                            "jax_flops"),
        "dry": _start([sys.executable, workers, "--dry",
                       str(d / "dry.json")] + list(FLOPS_ARCHS), ENV, d,
                      "dry"),
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
def dry(procs):
    _, d = _wait(procs, "dry")
    return json.loads((d / "dry.json").read_text())


def _state_gaps(got, want, prefix_got, prefix_want):
    """(leaf, |got - want| max, scale) for every leaf under the prefixes."""
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


MESH_ARCH = [(m, a) for m in W.MESHES for a in W.TRAIN_ARCHS]


@pytest.mark.parametrize("mesh_key,arch", MESH_ARCH)
def test_mesh_train_steps_match_the_jax_mesh_step(ranks, jax_train,
                                                  mesh_key, arch):
    base = f"train/{mesh_key}/{arch}"
    want = jax_train[f"{base}/metrics"]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{base}/metrics"], want,
                                   rtol=METRIC_RTOL, atol=0, err_msg=str(r))
    for name in ("params", "mu", "nu"):
        for leaf, gap, scale in _state_gaps(
                ranks[0], jax_train, f"{base}/{name}/", f"{base}/{name}/"):
            assert gap <= STATE_TOL * scale, (name, leaf, gap, scale)
    assert int(ranks[0][f"{base}/step"]) == W.STEPS


@pytest.mark.parametrize("mesh_key,arch", MESH_ARCH)
def test_mesh_train_steps_match_the_plain_step(ranks, mesh_key, arch):
    base = f"train/{mesh_key}/{arch}"
    got, want = ranks[0][f"{base}/metrics"], ranks[0][f"{base}/plain_metrics"]
    np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=0)
    for name in ("params", "mu", "nu"):
        for leaf, gap, scale in _state_gaps(
                ranks[0], ranks[0], f"{base}/{name}/",
                f"{base}/plain_{name}/"):
            assert gap <= STEP_TOL * scale, (name, leaf, gap, scale)
    # every "model" rank splits every sub-block, Mamba included: none is
    # computed whole
    whole = {tuple(res[f"{base}/whole"]) for res in ranks}
    assert whole == {()}


@pytest.mark.parametrize("mesh_key", list(W.MESHES))
@pytest.mark.parametrize("arch", W.STEP_ARCHS)
def test_mesh_prefill_and_decode_equal_the_plain_steps(ranks, arch,
                                                       mesh_key):
    key = f"steps/{mesh_key}/{arch}"
    for r, res in enumerate(ranks):
        for what in ("prefill_logits", "prefill_caches", "decode_logits",
                     "decode_caches"):
            gap, scale = res[f"{key}/{what}"]
            assert gap <= STEP_TOL * max(1.0, scale), (r, what, gap, scale)
        assert res[f"{key}/prefill_placed"]
        assert res[f"{key}/decode_placed"]
        # MLA's heads split over "model" as the rule splits them
        assert set(res[f"{key}/prefill_whole"]) == set()


@pytest.mark.parametrize("arch", W.HOOK_ARCHS)
def test_mesh_prefill_runs_the_kernel_hooks_on_the_ranks_shapes(ranks, arch):
    key = f"hooks/{arch}"
    for r, res in enumerate(ranks):
        scale = max(1.0, float(res[f"{key}/scale"]))
        assert float(res[f"{key}/logits"]) <= STEP_TOL * scale, r
        assert float(res[f"{key}/caches"]) <= STEP_TOL * scale, r
        # (flash_attention, moe_gmm) calls of the mesh pallas, mesh
        # reference and plain pallas prefills
        pallas, reference, plain = res[f"{key}/calls"].tolist()
        assert pallas == plain and not any(reference), (r, pallas, plain)
        moe = arch.startswith("qwen3")
        assert pallas[0] > 0 and (pallas[1] > 0) == moe, (r, pallas)


def test_vocab_parallel_loss_equals_cross_entropy(ranks):
    for res in ranks:
        assert abs(float(res["loss/got"]) - float(res["loss/want"])) \
            <= LOSS_TOL
        assert float(res["loss/grad_gap"]) <= LOSS_TOL


def test_remat_recompute_reenters_the_mesh(ranks):
    for res in ranks:
        assert float(res["remat/gap"]) == 0.0


def test_mesh_trainer_equals_the_plain_trainer_and_checkpoints(ranks):
    r0 = ranks[0]
    for res in ranks:
        np.testing.assert_allclose(res["trainer/mesh_losses"],
                                   r0["trainer/plain_losses"],
                                   rtol=STEP_TOL, atol=0)
    assert int(r0["trainer/restored_step"]) == W.STEPS
    keys = [k[len("trainer/held/"):] for k in r0
            if k.startswith("trainer/held/")]
    assert keys
    for k in keys:
        held = r0["trainer/held/" + k]
        np.testing.assert_array_equal(r0["trainer/restored/" + k], held)
        scale = max(1.0, float(np.abs(held).max()))
        assert float(np.abs(r0["trainer/plain/" + k] - held).max()) \
            <= STEP_TOL * scale, k


@pytest.mark.parametrize("arch", FLOPS_ARCHS)
def test_train_dot_flops_on_2x2_within_one_percent_of_jax(procs, dry, arch):
    out, _ = _wait(procs, "jax_flops")
    want = json.loads(out.split("RESULT ", 1)[1])[arch]
    got = dry["flops"][arch]
    assert want > 0
    assert abs(got - want) <= FLOPS_TOL * want, (got, want, got / want - 1)


def test_yi9b_train_4k_fits_a_card_with_useful_ratio_a_half(dry):
    r = dry["train"]
    assert r["peak_bytes"] < CARD_BYTES, r
    assert r["useful_ratio"] >= 0.5, r
    assert r["tp_whole"] == []


def test_yi9b_decode_32k_moves_under_a_tenth_of_the_collectives(dry):
    r = dry["decode"]
    assert 0 < r["collective_bytes"] < DECODE_COLL_LIMIT, r
    assert r["peak_bytes"] < CARD_BYTES, r


def test_report_compares_two_dry_runs():
    from repro_torch.analysis import report

    def cell(peak, useful, coll, whole):
        return {"status": "ok", "memory": {"peak_bytes": peak},
                "roofline": {"useful_ratio": useful,
                             "bottleneck": "collective"},
                "counted": {"collective_bytes": coll}, "tp_whole": whole}
    key = ("yi-9b", "train_4k", "16x16")
    skip = ("yi-9b", "long_500k", "16x16")
    before = {key: cell(201.14e9, 0.046, 166.71e9, [])}
    after = {key: cell(5.548e9, 0.693, 161.1e9, []),
             skip: {"status": "skipped"},
             ("jamba-v0.1-52b", "train_4k", "16x16"):
                 cell(1e9, 0.5, 1e9, ["mamba"])}
    rows = report.compare_md(after, before).splitlines()
    assert len(rows) == 4                 # header, rule, two cells
    assert rows[2].startswith("| jamba-v0.1-52b | train_4k | ERROR")
    assert rows[3] == ("| yi-9b | train_4k | 201.14GB | 5.55GB | yes | "
                       "0.046 | 0.693 | 166.71GB | 161.10GB | collective "
                       "| - |")
