"""The port's elastic layer (``core/events.py``, ``core/elastic.py``,
``launch/steps.make_mesh_train_step``) against the JAX package's:

  * the JAX outage campaign's trace (``scenarios.outage_burst()``, seed
    2021, 114,643 events) read by the port's ``CampaignTrace.from_jsonl``
    from the JAX ``to_jsonl``, and written back byte for byte;
  * ``PodPool``, ``SimulatedElasticRunner`` and ``drive_pool`` on that
    trace: every ``GoodputReport`` field and runner counter equal to the
    JAX package's, with and without preemption notices, for the
    ``providers=("azure",)`` filter, and on the same-size swap trace of
    ``tests/test_elastic_pool.py``;
  * ``tests/data/outage_burst.instances.jsonl.gz``, the trace's launch /
    preempt / stop events (what ``drive_pool`` reads; ``chip_smoke.py``
    replays it on the card): regenerated from the JAX package, its
    decompressed text equal byte for byte, and the JAX ``drive_pool``'s
    reports on it equal to those on the full trace;
  * ``ElasticRunner`` on 4 gloo ranks (one spawn of
    ``tests/torch_dist_workers.py elastic``): ``tests/test_system.py``'s
    reduced yi-9b, f32, ``pod_shape=(2, 1)``, 2 pods -> preemption -> 1
    pod, through ``make_mesh_train_step``: 3 rebuilds, losses within
    1e-5 of the single-process ``make_train_step`` on the same global
    batches, the ``handle_preemption`` checkpoint read back equal by the
    port's ``restore``, and ranks outside the 1-pod mesh idle.
"""
import dataclasses
import gzip
import os
import signal
import subprocess
import sys

import numpy as np
import pytest

import torch_dist_workers as W
from repro.core import elastic as jel
from repro.core import events as jev
from repro.core import scenarios
from repro.core.api import run
from repro.core.fleet import checkpoint_floor as jcheckpoint_floor
from repro_torch.core import elastic as el
from repro_torch.core import events as ev

ROOT = os.path.join(os.path.dirname(__file__), "..")
INSTANCES = os.path.join(ROOT, "tests", "data",
                         "outage_burst.instances.jsonl.gz")
KINDS = ("launch", "preempt", "stop")          # what drive_pool reads
# (label, PodPool kwargs, drive_pool kwargs, SimulatedElasticRunner's
# rebuild_s)
REPLAYS = (("notice", {"max_pods": 128}, {"notice": True}, 45.0),
           ("hard-kill", {"max_pods": 128}, {"notice": False}, 45.0),
           ("azure", {"max_pods": 100000}, {"providers": ("azure",)}, 30.0),
           ("slow-steps", {"min_pods": 4, "max_pods": 64},
            {"step_time_s": 7.5, "checkpoint_period_s": 300.0,
             "notice": False}, 12.5))


def instances_text(trace) -> str:
    """The JSONL of ``trace``'s launch / preempt / stop events (the
    committed file's text)."""
    return jev.CampaignTrace(trace.name, trace.seed, trace.duration_h,
                             trace.dt_h, trace.filter(*KINDS)).to_jsonl()


@pytest.fixture(scope="module")
def jtrace():
    return run(scenarios.outage_burst(), seeds=2021, collect="trace").trace


@pytest.fixture(scope="module")
def trace(jtrace):
    return ev.CampaignTrace.from_jsonl(jtrace.to_jsonl())


def test_trace_reads_and_writes_the_jax_jsonl(jtrace, trace):
    text = jtrace.to_jsonl()
    assert trace.to_jsonl() == text
    assert len(trace) == len(jtrace) == 114643
    assert trace.counts() == jtrace.counts()
    for kinds in (("launch",), KINDS, ("timeline", "job_done")):
        assert [ev.event_to_dict(e) for e in trace.filter(*kinds)] \
            == [jev.event_to_dict(e) for e in jtrace.filter(*kinds)]
    with pytest.raises(ValueError, match="unknown trace event kinds"):
        trace.filter("nope")


def test_every_event_kind_crosses():
    events = (jev.InstanceLaunched(0.25, 3, "azure", "eastus"),
              jev.InstanceStopped(1.0, 3, "azure", "eastus"),
              jev.InstancePreempted(1.5, 4, "gcp", "us-central1"),
              jev.PilotRegistered(0.5, 1, 3, "azure"),
              jev.NatDrop(2.0, 1, 3, "azure"),
              jev.StageInStarted(0.75, 1, 2.5, True, "aws"),
              jev.StageInFinished(1.0, 1),
              jev.EgressBilled(1.0, "aws", 12.5, 1.125),
              jev.JobFinished(3.0, 17, 2),
              jev.PriceChanged(4.0, 1.25, "aws", True),
              jev.TimelineEventFired(5.0, "scale", {"target": 1000}))
    assert set(ev.TRACE_EVENT_KINDS) == set(jev.TRACE_EVENT_KINDS)
    for e in events:
        d = jev.event_to_dict(e)
        ported = ev.event_from_dict(d)
        assert type(ported).__name__ == type(e).__name__
        assert ev.event_to_dict(ported) == d
    jt = jev.CampaignTrace("all", 7, 6.0, 0.25, events)
    assert ev.CampaignTrace.from_jsonl(jt.to_jsonl()).to_jsonl() \
        == jt.to_jsonl()
    with pytest.raises(ValueError, match="unknown trace event kind"):
        ev.event_from_dict({"kind": "nope", "t": 0.0})


@pytest.mark.parametrize("text,match", [
    ("", "empty trace stream"),
    ('{"kind":"other"}\n', "not a campaign trace"),
    ('{"kind":"campaign_trace","schema_version":2}\n', "schema_version"),
    (jev.CampaignTrace("t", 0, 1.0, 0.25, (
        jev.JobFinished(0.5, 1, 1),)).to_jsonl().splitlines()[0] + "\n",
     "truncated trace")])
def test_from_jsonl_refuses_what_the_jax_one_refuses(text, match):
    with pytest.raises(ValueError, match=match):
        jev.CampaignTrace.from_jsonl(text)
    with pytest.raises(ValueError, match=match):
        ev.CampaignTrace.from_jsonl(text)


def _replay(mod, trace, pool_kw, kw, rebuild_s):
    pool = mod.PodPool(**pool_kw)
    runner = mod.SimulatedElasticRunner(rebuild_s=rebuild_s)
    rep = mod.drive_pool(trace, pool, runner, **kw)
    counters = (runner.n_pods, runner.rebuilds, runner.lost_steps,
                runner.rebuild_s, runner.checkpoints,
                runner.blocking_checkpoints, pool.size,
                pool.rejected_joins, sorted(pool.pods), sorted(pool.draining))
    return rep.to_dict(), counters


@pytest.mark.parametrize("label,pool_kw,kw,rebuild_s", REPLAYS,
                         ids=[r[0] for r in REPLAYS])
def test_drive_pool_reports_equal_the_jax_ones(jtrace, trace, label,
                                               pool_kw, kw, rebuild_s):
    got = _replay(el, trace, pool_kw, kw, rebuild_s)
    want = _replay(jel, jtrace, pool_kw, kw, rebuild_s)
    assert got == want
    assert got[0]["rebuilds"] > 0 and got[0]["preemptions"] > 0


def test_drive_pool_same_size_member_swap_equals_the_jax_one():
    def swap(mod):
        return mod.CampaignTrace(
            name="swap", seed=0, duration_h=2.0, dt_h=0.25,
            events=(mod.InstanceLaunched(0.0, 0, "azure", "eastus"),
                    mod.InstanceLaunched(0.0, 1, "azure", "eastus"),
                    mod.InstanceLaunched(1.0, 2, "azure", "eastus"),
                    mod.InstancePreempted(1.0, 0, "azure", "eastus")))
    for notice in (True, False):
        got = _replay(el, swap(ev), {"max_pods": 8}, {"notice": notice},
                      30.0)
        want = _replay(jel, swap(jev), {"max_pods": 8}, {"notice": notice},
                       30.0)
        assert got == want
        assert got[0]["rebuilds"] == 2           # the initial fill + swap


def test_podpool_and_simulated_runner_behave_as_the_jax_ones():
    def script(mod):
        pool, seen = mod.PodPool(max_pods=2), []
        pool.on_change(seen.append)
        log = [pool.join("a"), pool.join("b"), pool.join("c"),
               pool.join("a"), pool.rejected_joins]
        pool.preemption_notice("a", 3.0)
        log += [dict(pool.draining)]
        pool.leave("a")
        pool.leave("zz")
        log += [pool.join("c", 4.0), dict(pool.pods), pool.size, seen]
        sim = mod.SimulatedElasticRunner(rebuild_s=7.0)
        log += [sim.ensure(4), sim.ensure(4), sim.ensure(4, force=True),
                sim.rebuilds, sim.rebuild_s]
        sim.checkpoint(1)
        sim.handle_preemption(2)
        log += [sim.checkpoints, sim.blocking_checkpoints]
        rep = mod.GoodputReport(1.0, 2.0, 3.0, 0.0, 1, 7.0, 0, 0, 2, 0, 2,
                                0.5)
        return log + [rep.to_dict()]
    assert script(el) == script(jel)
    fields = [f.name for f in dataclasses.fields(el.GoodputReport)]
    assert fields == [f.name for f in dataclasses.fields(jel.GoodputReport)]


@pytest.mark.parametrize("done,ckpt", [(0.0, 300.0), (299.9, 300.0),
                                       (300.0, 300.0), (12345.67, 300.0),
                                       (7.5, 2.5), (1e9 + 0.5, 450.0)])
def test_checkpoint_floor_is_the_jax_one(done, ckpt):
    assert float(el.checkpoint_floor(done, ckpt)) \
        == float(jcheckpoint_floor(done, ckpt))


def test_committed_instance_trace_is_the_jax_trace(jtrace):
    with gzip.open(INSTANCES, "rt") as f:
        text = f.read()
    assert text == instances_text(jtrace)
    small = ev.CampaignTrace.from_jsonl(text)
    assert len(small) == 10377
    assert small.counts()["launch"] + small.counts()["preempt"] \
        + small.counts()["stop"] == 10377
    # drive_pool reads only these kinds: the JAX reports on the filtered
    # and the full trace agree, and the port's on the file equals them
    jsmall = jev.CampaignTrace.from_jsonl(text)
    for _, pool_kw, kw, rebuild_s in REPLAYS:
        full = _replay(jel, jtrace, pool_kw, kw, rebuild_s)[0]
        assert _replay(jel, jsmall, pool_kw, kw, rebuild_s)[0] == full
        assert _replay(el, small, pool_kw, kw, rebuild_s)[0] == full


def test_elastic_runner_surface():
    runner = el.ElasticRunner(lambda mesh: None, {}, {}, device_type="cpu")
    assert runner.rebuild_s == 0.0
    assert runner.rebuilds == 0 and runner.lost_steps == 0
    sim = el.SimulatedElasticRunner()
    for attr in ("ensure", "handle_preemption", "checkpoint", "rebuilds",
                 "rebuild_s", "lost_steps", "n_pods"):
        assert hasattr(sim, attr) and hasattr(runner, attr), attr
        assert hasattr(jel.ElasticRunner(None, {}, {}), attr), attr


@pytest.fixture(scope="module", autouse=True)
def elastic_proc(tmp_path_factory):
    """The 4-rank elastic run, started before the module's first test so
    that it runs beside the trace tests.  It writes its errors to a file
    and runs in a session of its own, so that a run that no test waits
    for (a selection without the runner's test) is killed with its ranks
    at the module's end."""
    d = tmp_path_factory.mktemp("elastic")
    with open(d / "stderr.txt", "w") as err:
        proc = subprocess.Popen(
            [sys.executable,
             os.path.join(ROOT, "tests", "torch_dist_workers.py"),
             "elastic", "-", str(d)], stdout=subprocess.DEVNULL,
            stderr=err, start_new_session=True,
            env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    yield proc, d
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


@pytest.fixture(scope="module")
def elastic_ranks(elastic_proc):
    proc, d = elastic_proc
    proc.wait(timeout=600)
    assert proc.returncode == 0, (d / "stderr.txt").read_text()[-4000:]
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(W.WORLD)]


def _single_process_run():
    """Losses, grad norms and the final (params, opt) of the plain
    ``make_train_step`` on the elastic run's global batches."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    cfg = get_reduced("yi-9b")
    shape = ShapeConfig("smoke", seq_len=32, global_batch=W.ELASTIC_BATCH,
                        kind="train")
    run_cfg = RunConfig(model=cfg, shape=shape, compute_dtype="float32",
                        remat=False)
    params = init_params(cfg, 0, device="cpu")
    opt, step = adamw_init(params), make_train_step(cfg, run_cfg)
    losses, gnorms = [], []
    for s in range(2 * W.ELASTIC_STEPS):
        params, opt, m = step(params, opt, make_batch(cfg, shape, s,
                                                      device="cpu"))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return np.array(losses), np.array(gnorms), {"params": params,
                                                "opt": opt}


def test_elastic_runner_two_pods_to_one_matches_the_plain_step(
        elastic_ranks):
    from repro_torch.tree import flatten
    want, want_gn, trees = _single_process_run()
    n = W.ELASTIC_STEPS
    for r, res in enumerate(elastic_ranks):
        assert int(res["rebuilds"]) == 3              # 1 pod -> 2 -> 1
        inside = r < 2                  # the 1-pod mesh is ranks 0 and 1
        assert int(res["nones"]) == (0 if inside else n)
        np.testing.assert_allclose(res["losses"],
                                   want if inside else want[:n],
                                   rtol=1e-5, atol=1e-5)
        # the gradients' average over the data-parallel ranks: the norm
        # is taken before clipping, so a sum or a wrong divisor moves it
        np.testing.assert_allclose(res["grad_norms"],
                                   want_gn if inside else want_gn[:n],
                                   rtol=1e-5, atol=1e-6)
    # the final parameters and optimizer state, gathered over the 1-pod
    # mesh, leaf for leaf: a rank that steps on its own gradients drifts
    # (a uniform scale of the gradients is clipped away before AdamW, so
    # only the norms above show it)
    final = elastic_ranks[0]
    n_leaves = 0
    for name, tree in trees.items():
        for path, t in flatten(tree):
            key = "final/" + "/".join(map(str, (name,) + path))
            np.testing.assert_allclose(final[key], t.detach().numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
            n_leaves += 1
    assert n_leaves == sum(k.startswith("final/") for k in final)
    assert float(elastic_ranks[0]["restore_err"]) == 0.0
