"""The mesh steps' Mamba, xLSTM and MLA split over "model" as the JAX
package's compiled mesh steps split them, on the CPU.

One module fixture starts every program at once, from numpy inputs the
test makes (seeded):
  * the port: one spawn of 4 gloo ranks (``python
    tests/torch_tp_workers.py --mixers IN.npz DIR``) and one dry-run
    process (``--dry-mixers OUT.json``, torch's fake process group);
  * the JAX package on 4 forced host devices: ``jax.jit(make_train_step,
    in_shardings=...)`` (``test_torch_tp.JAX_TRAIN``), and ``hlo.analyze``
    of the compiled (2, 2) train, prefill and decode steps.

Cases:
  * training: on (2, 2) and (2, 1, 2), 3 f32 steps (``grad_accum`` 2) of
    reduced xlstm-350m, minicpm3-4b and kimi-k2-1t-a32b against the JAX
    step (loss and grad norm within 1e-4 relative, parameters and AdamW
    moments within 1e-5 x max(1, max |leaf|)) and against the port's
    plain step (1e-5); no sub-block computed whole on a "model" rank;
  * C15: reduced qwen3 fed its batches as DTensors placed by
    ``batch_shardings`` against the JAX step and the plain step, at the
    same gates;
  * prefill and decode of jamba and xlstm equal the plain steps within
    1e-5 of the largest value, the caches and states placed by
    ``cache_shardings``, nothing computed whole;
  * one-head forms of xlstm and minicpm3 ("model" cannot split the
    heads: the mLSTM, the sLSTM and MLA whole on every "model" rank,
    their weights gathered): train, prefill and decode equal the plain
    steps;
  * ``tp.halves`` (the split [x | z] product) and ``tp.slice_of`` (a
    leaf stored split on another dim than the compute's) with their
    gradients;
  * per-device dot FLOPs on a fake (2, 2) world: train within 1 % of
    ``hlo.analyze`` of the JAX step for jamba, xlstm, minicpm3 and kimi
    (B=8, S=128, bf16, remat off); prefill and decode within 1 % for
    jamba, xlstm and minicpm3 (B=8, S=64).
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
from test_torch_tp import JAX_TRAIN

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
ENV = dict(os.environ, PYTHONPATH=SRC)
JAX_ENV = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu")
METRIC_RTOL = 1e-4
STATE_TOL = 1e-5
STEP_TOL = 1e-5
FLOPS_TOL = 0.01
TRAIN_ARCHS = W.MIXER_TRAIN_ARCHS + (W.C15_ARCH,)
# the sub-blocks each "model" rank computes whole where the heads do not
# divide "model"
WHOLE_MIXERS = {"xlstm-350m-1h": ("mlstm", "slstm"),
                "minicpm3-4b-1h": ("mla",)}
STEP_FLOPS_ARCHS = ("jamba-v0.1-52b", "xlstm-350m", "minicpm3-4b")

JAX_FLOPS = """
import json, sys
import jax, jax.numpy as jnp
from repro import sharding as sh
from repro.analysis import hlo
from repro.configs import RunConfig, ShapeConfig, get_reduced
from repro.launch import steps as st
from repro.sharding_ctx import make_mesh, use_mesh

archs, sizes = json.loads(sys.argv[1]), json.loads(sys.argv[2])
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
with use_mesh(mesh):
    for arch in archs:
        cfg = get_reduced(arch)
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
            text = fn.lower(*args).compile().as_text()
            out[f"{arch}/{kind}"] = hlo.analyze(text)["dot_flops"]
print("RESULT " + json.dumps(out))
"""


def _inputs(path):
    """The seeded weights (the port's ``init_params``, JAX layout) and
    batches of every training case."""
    rng = np.random.default_rng(2026)
    arrays = {}
    for arch in TRAIN_ARCHS + W.UNDIVIDED_ARCHS:
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
    d = tmp_path_factory.mktemp("tp_mixers")
    inputs = d / "inputs.npz"
    _inputs(inputs)
    workers = os.path.join(ROOT, "tests", "torch_tp_workers.py")
    spec = {"meshes": W.MESHES, "archs": list(TRAIN_ARCHS),
            "batch": [W.BATCH, W.SEQ, W.ACCUM, W.STEPS]}
    started = {
        "ranks": _start([sys.executable, workers, "--mixers", str(inputs),
                         str(d / "ranks")], ENV, d, "ranks"),
        "jax_train": _start([sys.executable, "-c", JAX_TRAIN, str(inputs),
                             json.dumps(spec), str(d / "jax_train.npz")],
                            JAX_ENV, d, "jax_train"),
        "jax_flops": _start([sys.executable, "-c", JAX_FLOPS,
                             json.dumps(W.FLOPS_ARCHS),
                             json.dumps(W.FLOPS_SIZES)], JAX_ENV, d,
                            "jax_flops"),
        "dry": _start([sys.executable, workers, "--dry-mixers",
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
    out, d = _wait(procs, "jax_flops")
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


def _against_jax(ranks, jax_train, got, want, tol):
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{got}/metrics"],
                                   jax_train[f"{want}/metrics"],
                                   rtol=METRIC_RTOL, atol=0, err_msg=str(r))
    for name in ("params", "mu", "nu"):
        for leaf, gap, scale in _state_gaps(
                ranks[0], jax_train, f"{got}/{name}/", f"{want}/{name}/"):
            assert gap <= tol * scale, (name, leaf, gap, scale)


def _against_plain(res, base):
    np.testing.assert_allclose(res[f"{base}/metrics"],
                               res[f"{base}/plain_metrics"], rtol=STEP_TOL,
                               atol=0)
    for name in ("params", "mu", "nu"):
        for leaf, gap, scale in _state_gaps(
                res, res, f"{base}/{name}/", f"{base}/plain_{name}/"):
            assert gap <= STEP_TOL * scale, (name, leaf, gap, scale)


MESH_ARCH = [(m, a) for m in W.MESHES for a in W.MIXER_TRAIN_ARCHS]


@pytest.mark.parametrize("mesh_key,arch", MESH_ARCH)
def test_mixer_train_steps_match_the_jax_mesh_step(ranks, jax_train,
                                                   mesh_key, arch):
    base = f"train/{mesh_key}/{arch}"
    _against_jax(ranks, jax_train, base, base, STATE_TOL)
    assert int(ranks[0][f"{base}/step"]) == W.STEPS


@pytest.mark.parametrize("mesh_key,arch", MESH_ARCH)
def test_mixer_train_steps_match_the_plain_step(ranks, mesh_key, arch):
    base = f"train/{mesh_key}/{arch}"
    _against_plain(ranks[0], base)
    # every "model" rank splits the mixers: nothing is computed whole
    assert {tuple(res[f"{base}/whole"]) for res in ranks} == {()}


@pytest.mark.parametrize("mesh_key", list(W.MESHES))
@pytest.mark.parametrize("arch", W.UNDIVIDED_ARCHS)
def test_undivided_heads_train_steps_match_the_plain_step(ranks, arch,
                                                          mesh_key):
    """One head, which "model" cannot split: the mLSTM, the sLSTM and
    MLA run whole on every "model" rank on their gathered weights, their
    gradients counted once."""
    base = f"train/{mesh_key}/{arch}"
    _against_plain(ranks[0], base)
    assert {tuple(res[f"{base}/whole"]) for res in ranks} == \
        {WHOLE_MIXERS[arch]}


@pytest.mark.parametrize("mesh_key", list(W.MESHES))
def test_dtensor_batch_microbatches_match_the_jax_step(ranks, jax_train,
                                                       mesh_key):
    """C15: microbatch i of a batch given as DTensors is the rank's share
    of global microbatch i, as the JAX step reshapes the global batch
    (an MoE takes capacity and its aux loss per microbatch)."""
    got = f"c15/{mesh_key}/{W.C15_ARCH}"
    want = f"train/{mesh_key}/{W.C15_ARCH}"
    _against_jax(ranks, jax_train, got, want, STATE_TOL)
    _against_plain(ranks[0], got)
    # and the plain global batch through the same mesh step
    np.testing.assert_allclose(ranks[0][f"{got}/metrics"],
                               ranks[0][f"{want}/metrics"], rtol=STEP_TOL,
                               atol=0)


@pytest.mark.parametrize("mesh_key", list(W.MESHES))
@pytest.mark.parametrize("arch",
                         W.MIXER_STEP_ARCHS + W.UNDIVIDED_ARCHS)
def test_mixer_prefill_and_decode_equal_the_plain_steps(ranks, arch,
                                                        mesh_key):
    key = f"steps/{mesh_key}/{arch}"
    for r, res in enumerate(ranks):
        for what in ("prefill_logits", "prefill_caches", "decode_logits",
                     "decode_caches"):
            gap, scale = res[f"{key}/{what}"]
            assert gap <= STEP_TOL * max(1.0, scale), (r, what, gap, scale)
        assert res[f"{key}/prefill_placed"]
        assert res[f"{key}/decode_placed"]
        assert set(res[f"{key}/prefill_whole"]) == set(
            WHOLE_MIXERS.get(arch, ()))


def test_halves_gives_each_rank_its_slice_of_x_and_z(ranks):
    for res in ranks:
        assert float(res["units/halves"]) == 0.0
        assert float(res["units/halves_grad"]) == 0.0


def test_slice_of_sums_the_gradient_over_model(ranks):
    for res in ranks:
        assert float(res["units/shared_slice_grad"]) <= 1e-6
    # a plain gather then a slice loses the other rank's rows (the trap)
    assert max(float(res["units/whole_slice_grad"]) for res in ranks) > 0.1


@pytest.mark.parametrize("arch", W.FLOPS_ARCHS)
def test_train_dot_flops_on_2x2_within_one_percent_of_jax(flops, arch):
    want, got = flops
    key = f"{arch}/train"
    assert want[key] > 0
    assert abs(got[key]["dot_flops"] - want[key]) <= FLOPS_TOL * want[key], \
        (got[key], want[key], got[key]["dot_flops"] / want[key] - 1)
    assert got[key]["tp_whole"] == []


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", STEP_FLOPS_ARCHS)
def test_serve_dot_flops_on_2x2_within_one_percent_of_jax(flops, arch,
                                                          kind):
    want, got = flops
    key = f"{arch}/{kind}"
    assert want[key] > 0
    assert abs(got[key]["dot_flops"] - want[key]) <= FLOPS_TOL * want[key], \
        (got[key], want[key], got[key]["dot_flops"] / want[key] - 1)
    assert got[key]["tp_whole"] == []
