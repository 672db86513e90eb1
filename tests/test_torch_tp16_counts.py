"""The (16, 16) mesh steps of the reduced archs whose heads (16, 16)'s
"model" does not divide (xlstm-350m's 4, minicpm3-4b's 4, whisper's 4;
at full size 4, 40 and 20): per-device dot FLOPs and collective bytes of
the port's dry run against the JAX step's, on the CPU.

The JAX step's counts (``hlo.analyze`` of ``jax.jit(...,
in_shardings=...)`` compiled on 256 forced host devices, B=32, S=64,
bf16, remat off) are pinned in ``tests/data/jax_dots16.json``, written by
``python tests/torch_dots16.py --jax --pin``; one cell (xlstm train) is
compiled live here, so that the pin cannot drift from the reference.
The port's six cells run in three dry-run processes (``python
tests/torch_dots16.py ARCH train,prefill 32 64``, torch's fake process
group of 256 ranks), started together with the JAX one.

Gates: the port's dot FLOPs at most 1.01x the JAX step's (the sLSTM's
recurrence, whole on every "model" rank, may add its own count,
``RECURRENCE``), and never above the port's counts before these splits
(``PORT_BEFORE``); nothing computed whole on a "model" rank but that
recurrence.  Collective bytes are reported beside the JAX step's.
"""
import json
import os
import signal
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
SCRIPT = os.path.join(ROOT, "tests", "torch_dots16.py")
ENV = dict(os.environ, PYTHONPATH=SRC)
JAX_ENV = dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=256",
               JAX_PLATFORMS="cpu")
PIN = json.loads(open(os.path.join(ROOT, "tests", "data",
                                   "jax_dots16.json")).read())
ARCHS = ("xlstm-350m", "minicpm3-4b", "whisper-large-v3")
CELLS = [(a, k) for a in ARCHS for k in ("train", "prefill")]
CAP = 1.01
# the port's dot FLOPs a device before it split these sub-blocks (each
# mixer whole on every "model" rank)
PORT_BEFORE = {"xlstm-350m/train": 591462400,
               "xlstm-350m/prefill": 202588160,
               "minicpm3-4b/train": 18874368,
               "minicpm3-4b/prefill": 4227072,
               "whisper-large-v3/train": 42860544,
               "whisper-large-v3/prefill": 12222464}
# the sLSTM's recurrence (``h @ R``, 2 B H dh 4dh a step; in train as
# much again for each of its two gradients) on a rank's 2 rows, S=64:
# reduced xlstm's one sLSTM layer, d_model 64, 4 heads of 16
RECURRENCE = {"xlstm-350m/train": 3 * 64 * 2 * 2 * 4 * 16 * 4 * 16,
              "xlstm-350m/prefill": 64 * 2 * 2 * 4 * 16 * 4 * 16}
WHOLE = {"xlstm-350m": ["slstm_recurrence"]}


def _start(argv, env):
    return subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)


@pytest.fixture(scope="module")
def procs():
    started = {arch: _start([sys.executable, SCRIPT, arch, "train,prefill",
                             str(PIN["global_batch"]), str(PIN["seq_len"])],
                            ENV) for arch in ARCHS}
    started["jax"] = _start([sys.executable, SCRIPT, "--jax", "xlstm-350m",
                             "train", str(PIN["global_batch"]),
                             str(PIN["seq_len"])], JAX_ENV)
    yield started
    for proc in started.values():
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()


def _result(proc):
    out, err = proc.communicate(timeout=900)
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.split("RESULT ", 1)[1])


@pytest.fixture(scope="module")
def port(procs):
    out = {}
    for arch in ARCHS:
        out.update(_result(procs[arch]))
    return out


def test_pin_is_the_live_jax_count(procs):
    """The pinned JAX counts are what the JAX step compiles to now (one
    cell, live), from the JAX version the pin names."""
    import jax
    live = _result(procs["jax"])["xlstm-350m/train"]
    assert live == PIN["cells"]["xlstm-350m/train"]
    assert PIN["jax"] == jax.__version__
    assert PIN["mesh"] == [16, 16]


@pytest.mark.parametrize("arch,kind", CELLS)
def test_dot_flops_at_16x16_within_the_jax_step(port, arch, kind):
    key = f"{arch}/{kind}"
    got = port[key]["dot_flops"]
    cap = CAP * PIN["cells"][key]["dot_flops"] + RECURRENCE.get(key, 0)
    assert 0 < got <= cap, (got, cap, PIN["cells"][key])
    assert got <= PORT_BEFORE[key], (got, PORT_BEFORE[key])


@pytest.mark.parametrize("arch,kind", CELLS)
def test_nothing_whole_at_16x16_but_the_slstm_recurrence(port, arch, kind):
    got = port[f"{arch}/{kind}"]
    assert got["tp_whole"] == WHOLE.get(arch, [])
    # collective bytes are reported beside the JAX step's (PERF.md)
    assert got["collective_bytes"] > 0
