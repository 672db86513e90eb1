"""The port's dry-run dot FLOPs on one device against the JAX package's
count, ``analysis/hlo.analyze`` of the compiled JAX step, on the CPU.

The port side is ``tests/torch_dryrun_cells.py flops``: ``dry_run`` of
each reduced arch on a mesh of one rank (the fake process group, in a
process of its own), bf16, the reference path, remat off.

  * prefill and decode: equal, exactly, on all ten reduced archs;
  * train (remat off) on yi-9b, jamba-v0.1-52b and xlstm-350m: within
    1 % at B=2, S=128.  The two autodiffs need not run the same
    products: jamba's and xlstm's gaps are not zero.

Run as a script, it prints the train gaps at every shape of
``GAP_SHAPES`` (``python tests/test_torch_dryrun_flops.py``, with
``PYTHONPATH=src:tests``); ``PERF.md`` records them.
"""
import json
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import pytest

import torch_dryrun_cells as C
from repro.analysis import hlo
from repro.configs import ARCH_IDS, RunConfig, ShapeConfig, get_reduced
from repro.launch import steps as jsteps

ROOT = os.path.join(os.path.dirname(__file__), "..")
TRAIN_TOL = 0.01


def _port_counts(case):
    """The port side's JSON for ``case`` (``tests/torch_dryrun_cells.py``),
    run in a process of its own."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"{case}.json")
        proc = subprocess.run(
            [sys.executable,
             os.path.join(ROOT, "tests", "torch_dryrun_cells.py"), case,
             path], capture_output=True, text=True, timeout=1200,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
        if proc.returncode != 0:
            raise RuntimeError(proc.stderr[-4000:])
        with open(path) as f:
            return json.load(f)


@pytest.fixture(scope="module")
def port_flops():
    return _port_counts("flops")


def _jax_dot_flops(arch, kind, sizes=C.FLOPS_SHAPE):
    """hlo.analyze's dot FLOPs of the compiled JAX step of the cell that
    the port side dry-runs (one CPU device)."""
    cfg = get_reduced(arch)
    b, s, accum = sizes[kind]
    shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind,
                        grad_accum=accum)
    run = RunConfig(model=cfg, shape=shape, remat=False)
    ps = jsteps.params_struct(cfg, jnp.bfloat16)
    specs = jsteps.input_specs(cfg, shape)
    if kind == "train":
        fn = jsteps.make_train_step(cfg, run)
        args = (ps, jsteps.opt_struct(cfg, ps), specs)
    elif kind == "prefill":
        fn, args = jsteps.make_prefill_step(cfg, run), (ps, specs)
    else:
        fn = jsteps.make_decode_step(cfg, run)
        args = (ps, specs["caches"], specs["token"], specs["pos"])
    text = jax.jit(fn).lower(*args).compile().as_text()
    return hlo.analyze(text)["dot_flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_dot_flops_equal_the_jax_count(port_flops, arch, kind):
    want = _jax_dot_flops(arch, kind)
    assert want > 0
    assert port_flops[f"{arch}/{kind}"] == want


@pytest.mark.parametrize("arch", C.TRAIN_ARCHS)
def test_train_dot_flops_within_one_percent(port_flops, arch):
    want = _jax_dot_flops(arch, "train")
    got = port_flops[f"{arch}/train"]
    assert abs(got - want) <= TRAIN_TOL * want, (got, want,
                                                 got / want - 1)


if __name__ == "__main__":
    port = _port_counts("gaps")
    print("arch | B | S | port dot FLOPs | JAX dot FLOPs | port / JAX - 1")
    for arch in C.TRAIN_ARCHS:
        for b, s in C.GAP_SHAPES:
            want = _jax_dot_flops(arch, "train", {"train": (b, s, 1)})
            got = port[f"{arch}/{b}/{s}"]
            print(f"{arch} | {b} | {s} | {got} | {want} | "
                  f"{100 * (got / want - 1):+.2f} %")
