"""The examples' counterparts (``examples/*_torch.py``), the control-plane
modules they need and the port's ``campaigns run`` CLI, against the JAX
package:

  * ``core/budget.py``, ``core/provisioner.py``, ``core/overlay.py``,
    ``straggler.SpeculativeScheduler`` and ``provider.tpu_catalog``: the
    same seeded call scripts (charges, thresholds and spend rates;
    ``scale_to`` / ``bill`` / ``PriceShift`` / ``PriceCurve`` /
    ``CapacityShift`` / preemptions / de-provisioning; ``submit`` /
    ``register_pilot`` / ``match`` / ``advance`` with NAT drops, lost
    pilots and outages) through both packages' classes, every view and
    every recorder call equal; the pod-slice table equal field by field;
  * ``serve_overlay_torch.main(device="cpu")`` prints
    ``examples/serve_overlay.py``'s lines (the JAX example in a
    subprocess), line for line;
  * ``elastic_cloud_train_torch.main`` on 4 gloo ranks (one spawn of
    ``tests/torch_dist_workers.py example``, pods (2, 1)), fed the JAX
    example's initial weights (``init_params(cfg, PRNGKey(0))`` through
    ``params_from_jax``) and batches (``make_batch(cfg, REDUCED_SHAPE,
    step)``), since the RNG streams differ (ROADMAP C3): its fleet,
    preemption / spend and ledger lines and its rebuild count equal the
    JAX example's (a subprocess on 4 forced host devices), and its first
    and last loss lie within 1e-3 of the printed ones;
  * ``quickstart_torch.main(device="cpu", steps=100)``: the spec's JSON
    line count and the fired timeline equal ``campaign_quickstart()``'s
    of the JAX example, cost and GPU-days within ``STAT_BANDS``; the
    loss falls, the checkpoint restores at step 100, 6 requests are
    served, 72 tokens;
  * ``python -m repro_torch.campaigns run ... --device cpu``: its JSON
    payload has the key structure of ``python -m repro.campaigns run
    ... --engine jax``'s, with ``"engine": "torch"``, for one run and
    for a sweep (whose CSV has the same header);
  * the examples' ``main`` and the CLI raise without a card unless told
    to run on the CPU;
  * ``tests/data/jax_examples.json``, the JAX examples' printed lines that
    ``chip_smoke.py`` holds the examples on the card to (it imports no
    JAX), equals what the JAX examples print here.
"""
import ast
import contextlib
import dataclasses
import io
import json
import os
import re
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from engine_equivalence import STAT_BANDS
from repro.core import budget as jbudget
from repro.core import overlay as joverlay
from repro.core import provider as jprovider
from repro.core import provisioner as jprov
from repro.core import straggler as jstraggler
from repro_torch.core import budget, overlay, provider, provisioner, straggler
from torch_dist_workers import load_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
SEEDS = (0, 1, 2, 3)
QUICKSTART_STEPS = 100
ENV = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
           JAX_PLATFORMS="cpu")


def _popen(args, **kw):
    """A subprocess in a session of its own, its output piped."""
    return subprocess.Popen(args, cwd=ROOT, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            start_new_session=True, **kw)


def _finish(procs, name, timeout=600):
    """The standard output of the fixture's subprocess ``name``, which
    must exit 0; read once, then kept."""
    if name not in procs["out"]:
        proc = procs["procs"][name]
        out, err = proc.communicate(timeout=timeout)
        assert proc.returncode == 0, err[-4000:]
        procs["out"][name] = out
    return procs["out"][name]


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.communicate()


# -- the subprocesses, started together before the module's first test -----

JAX_ELASTIC = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location(
    "jax_elastic", "examples/elastic_cloud_train.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
mod.CKPT = sys.argv[1]
mod.main()
"""


def _elastic_inputs(path):
    """The JAX example's initial weights and its 30 batches, as npz."""
    import jax

    from repro.configs import REDUCED_SHAPE, get_reduced
    from repro.data import make_batch
    from repro.models import init_params
    cfg = get_reduced("yi-9b")
    out = {}

    def walk(t, pre):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, pre + (k,))
        else:
            out["param/" + "/".join(pre)] = np.asarray(t)
    walk(jax.device_get(init_params(cfg, jax.random.PRNGKey(0))), ())
    for s in range(30):
        b = make_batch(cfg, REDUCED_SHAPE, s)
        for k in ("tokens", "targets"):
            out[f"batch/{s}/{k}"] = np.asarray(b[k])
    np.savez(path, **out)


@pytest.fixture(scope="module", autouse=True)
def procs(tmp_path_factory):
    d = tmp_path_factory.mktemp("examples")
    _elastic_inputs(d / "elastic_in.npz")
    (d / "ranks").mkdir()
    cli = {}
    started = [
        ("elastic_port", [sys.executable,
                          os.path.join(ROOT, "tests", "torch_dist_workers.py"),
                          "example", str(d / "elastic_in.npz"),
                          str(d / "ranks")], ENV),
        ("elastic_jax", [sys.executable, "-c", JAX_ELASTIC,
                         str(d / "jax_ckpt")],
         dict(ENV, XLA_FLAGS="--xla_force_host_platform_device_count=4")),
        ("serve_jax", [sys.executable,
                       os.path.join(ROOT, "examples", "serve_overlay.py")],
         ENV)]
    runs = {"solo": (["paper_replay"], "2021"),
            "sweep": (["paper_replay", "outage_burst"], "2021,2022")}
    for kind, (names, seeds) in runs.items():
        specs = [os.path.join(DATA, f"{n}.spec.json") for n in names]
        for side, args in (("torch", ["-m", "repro_torch.campaigns", "run",
                                      *specs, "--device", "cpu"]),
                           ("jax", ["-m", "repro.campaigns", "run", *specs,
                                    "--engine", "jax"])):
            out = d / f"cli_{kind}_{side}"
            cli[kind, side] = out
            started.append((f"cli_{kind}_{side}", [
                sys.executable, *args, "--seeds", seeds, "--json",
                f"{out}.json", "--csv", f"{out}.csv"], ENV))
    running = {name: _popen(args, env=env) for name, args, env in started}
    yield {"dir": d, "procs": running, "cli": cli, "out": {}}
    _kill(running.values())


# -- the control plane -------------------------------------------------------

class Recorder:
    """Records every hook call by name and arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        return lambda *args: self.calls.append((name,) + args)


@pytest.mark.parametrize("seed", SEEDS)
def test_budget_ledger_matches_jax(seed):
    rng = np.random.default_rng(seed)
    total = float(rng.uniform(500.0, 5000.0))
    ledgers = [jbudget.BudgetLedger(total), budget.BudgetLedger(total)]
    fired = [[], []]
    for led, got in zip(ledgers, fired):
        led.on_threshold(lambda *a, got=got: got.append(a))
    t, views = 0.0, [[], []]
    for _ in range(200):
        t += float(rng.exponential(1.0))
        at = t - float(rng.uniform(0, 5)) if rng.random() < 0.1 else t
        prov = f"p{int(rng.integers(0, 3))}"
        amount = float(rng.exponential(total / 150))
        for led, view in zip(ledgers, views):
            led.charge(prov, amount, at, note="n")
            view.append((led.report(), led.spend_rate(t),
                         led.spend_rate(t, window_h=24.0)))
    assert views[0] == views[1]
    assert fired[0] == fired[1] and fired[0]
    assert [dataclasses.astuple(e) for e in ledgers[0].events] \
        == [dataclasses.astuple(e) for e in ledgers[1].events]
    for led in ledgers:
        with pytest.raises(ValueError, match="non-negative"):
            led.charge("p0", -1.0, t)


def test_tpu_catalog_equals_jax_field_by_field():
    want, got = jprovider.tpu_catalog(), provider.tpu_catalog()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) \
            == dataclasses.asdict(want[name]), name
        assert got[name].total_capacity == want[name].total_capacity


CATALOGS = {"tpu": ("tpu_catalog", {}), "t4": ("t4_catalog", {}),
            "heterogeneous": ("heterogeneous_catalog",
                              {"capacity_scale": 0.02})}


def _instances(prov):
    return [(i.id, i.provider, i.region, i.started_at, i.preempted_at,
             i.stopped_at, i.last_charged) for i in prov.all_instances()]


@pytest.mark.parametrize("catalog", sorted(CATALOGS))
@pytest.mark.parametrize("seed", SEEDS)
def test_provisioner_matches_jax(catalog, seed):
    fn, kw = CATALOGS[catalog]
    rng = np.random.default_rng(seed)
    spot = bool(seed % 2 == 0)
    cap = sum(p.total_capacity for p in getattr(jprovider, fn)(**kw)
              .values())
    sides = []
    for prov_mod, cat_mod, bud in ((jprov, jprovider, jbudget),
                                   (provisioner, provider, budget)):
        led = bud.BudgetLedger(2e5)
        rec = Recorder()
        sides.append((prov_mod.MultiCloudProvisioner(
            getattr(cat_mod, fn)(**kw), led, spot=spot, recorder=rec),
            led, rec))
    names = list(getattr(jprovider, fn)(**kw))
    t = 0.0
    for _ in range(60):
        t += float(rng.uniform(0.1, 3.0))
        op = rng.choice(["scale", "bill", "price", "curve", "capacity",
                         "preempt", "deprovision"],
                        p=[0.3, 0.25, 0.1, 0.1, 0.05, 0.15, 0.05])
        n = int(rng.integers(0, cap + 3))
        factor = float(rng.uniform(0.5, 1.8))
        who = None if rng.random() < 0.3 else names[
            int(rng.integers(0, len(names)))]
        pick = float(rng.random())
        for prov, _, _ in sides:
            if op == "scale":
                prov.scale_to(n, now=t)
            elif op == "bill":
                prov.bill(now=t)
            elif op == "price":
                prov.scale_prices(factor)
            elif op == "curve":
                prov.set_price_factor(who, factor)
            elif op == "capacity":
                prov.scale_capacity(factor)
            elif op == "deprovision":
                prov.deprovision_all(now=t)
            else:
                live = sorted((i.id, g_i) for g_i, g in enumerate(prov.groups)
                              for i in g.running)
                if live:
                    iid, gi = live[int(pick * len(live))]
                    prov.groups[gi].preempt(iid, now=t)
        (jp, jl, jr), (pp, pl, pr) = sides
        assert pp.running_by_provider() == jp.running_by_provider()
        assert pp.total_running() == jp.total_running()
        assert pl.report() == jl.report()
        assert [(g.provider.name, dataclasses.astuple(g.region), g.target)
                for g in pp.groups] \
            == [(g.provider.name, dataclasses.astuple(g.region), g.target)
                for g in jp.groups]
    assert _instances(pp) == _instances(jp)
    assert [(i.id, i.provider) for i in pp.live_instances()] \
        == [(i.id, i.provider) for i in jp.live_instances()]
    assert pr.calls == jr.calls and pr.calls
    assert pl.spent > 0 and pl.report() == jl.report()


@pytest.mark.parametrize("lease", [120.0, 300.0])
@pytest.mark.parametrize("seed", SEEDS)
def test_overlay_matches_jax(lease, seed):
    rng = np.random.default_rng(seed)
    recs = [Recorder(), Recorder()]
    ces = [mod.ComputeElement(accept_policy="icecube",
                              lease_interval_s=lease, recorder=rec)
           for mod, rec in ((joverlay, recs[0]), (overlay, recs[1]))]
    t, jid, views = 0.0, 0, [[], []]
    for _ in range(150):
        op = rng.choice(["submit", "pilot", "match", "advance", "lost",
                         "outage"], p=[0.25, 0.1, 0.25, 0.3, 0.05, 0.05])
        wall = float(rng.uniform(0.5, 6.0))
        period = float(rng.choice([0.5, 1.0, 2.0]))
        nat = float(rng.choice([240.0, float("inf")]))
        prov = f"cloud-{'abc'[int(rng.integers(0, 3))]}"
        pick = float(rng.random())
        dt = float(rng.uniform(0.25, 1.5))
        for mod, ce, view in ((joverlay, ces[0], views[0]),
                              (overlay, ces[1], views[1])):
            if op == "submit":
                ce.submit(mod.Job(jid + 1, wall_h=wall,
                                  checkpoint_period_h=period))
            elif op == "pilot":
                ce.register_pilot(len(ce.pilots), prov, nat_timeout_s=nat,
                                  now_h=t)
            elif op == "match":
                view.append(("match", ce.match(t)))
            elif op == "advance":
                ce.advance(dt, t)
            elif op == "lost" and ce.pilots:
                ce.pilot_lost(sorted(ce.pilots)[int(pick * len(ce.pilots))],
                              t)
            elif op == "outage":
                ce.outage = not ce.outage
            view.append((ce.stats(), ce.busy_by_provider(),
                         [(j.id, j.done_h, j.attempts) for j in ce.queue],
                         [(j.id, j.done_h, j.attempts, j.finished_at)
                          for j in ce.finished]))
        if op == "submit":
            jid += 1
        if op == "advance":
            t += dt
    assert views[0] == views[1]
    assert recs[0].calls == recs[1].calls
    assert ces[1].stats()["finished"] > 0
    if lease > 240.0:
        assert ces[1].stats()["nat_drops"] > 0
    for mod, ce in ((joverlay, ces[0]), (overlay, ces[1])):
        with pytest.raises(PermissionError, match="rejects"):
            ce.submit(mod.Job(999, wall_h=1.0, policy="other"))


@pytest.mark.parametrize("seed", SEEDS)
def test_speculative_scheduler_matches_jax(seed):
    rng = np.random.default_rng(seed)
    kw = dict(spec_factor=float(rng.uniform(1.5, 3.0)),
              min_samples=int(rng.integers(1, 6)))
    scheds = [jstraggler.SpeculativeScheduler(**kw),
              straggler.SpeculativeScheduler(**kw)]
    answers = [[], []]
    for _ in range(100):
        done = rng.random() < 0.5
        x = float(rng.exponential(4.0))
        for s, a in zip(scheds, answers):
            if done:
                s.record_completion(x)
            else:
                a.append(s.should_speculate(x))
    assert answers[0] == answers[1]
    assert scheds[1].speculated == scheds[0].speculated > 0
    assert scheds[1].completed_times == scheds[0].completed_times


# -- the examples ------------------------------------------------------------

def test_serve_overlay_prints_the_jax_examples_lines(procs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        server, ce, spec = load_example("serve_overlay_torch").main(
            device="cpu")
    want = _finish(procs, "serve_jax")
    assert buf.getvalue().splitlines() == want.splitlines()
    assert len(want.splitlines()) == 2
    assert len(server.done) == 10 and ce.stats()["finished"] == 10


@pytest.fixture(scope="module")
def elastic(procs):
    _finish(procs, "elastic_port")
    jax_lines = _finish(procs, "elastic_jax").splitlines()
    ranks = [dict(np.load(procs["dir"] / "ranks" / f"rank{r}.npz"))
             for r in range(4)]
    return ranks, jax_lines


def test_elastic_example_lines_equal_the_jax_examples(elastic):
    ranks, jax_lines = elastic
    got = [str(x) for x in ranks[0]["lines"]]
    want = [ln for ln in jax_lines
            if ln.startswith(("fleet:", "preempted", "30 elastic", "ledger:"))]
    assert len(want) == 4
    # the loss figures are held below, within 1e-3; every other
    # character, the rebuild count included, is equal
    strip = re.compile(r"loss [0-9.]+ -> [0-9.]+")
    assert [strip.sub("loss", ln) for ln in got] \
        == [strip.sub("loss", ln) for ln in want]
    assert "-> 2 pods" in got[0] and "spent $530" in got[1]
    assert "4 mesh rebuilds" in got[2] and "1104.17" in got[3]
    assert all(int(r["rebuilds"]) == 4 for r in ranks)


def test_elastic_example_first_and_last_loss_within_1e_3(elastic):
    ranks, jax_lines = elastic
    line = next(ln for ln in jax_lines if ln.startswith("30 elastic"))
    first, last = map(float, re.search(r"loss ([0-9.]+) -> ([0-9.]+)",
                                       line).groups())
    losses = ranks[0]["losses"]
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert abs(losses[0] - first) <= 1e-3 and abs(losses[-1] - last) <= 1e-3
    # the ranks outside the one-pod mesh sat out its 10 steps
    assert [len(r["losses"]) for r in ranks] == [30, 30, 20, 20]


@pytest.fixture(scope="module")
def quickstart(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    handler = signal.getsignal(signal.SIGTERM)
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            got = load_example("quickstart_torch").main(
                device="cpu", steps=QUICKSTART_STEPS,
                ckpt_dir=str(tmp_path_factory.mktemp("quickstart")))
    finally:
        torch.set_num_threads(threads)
    got["sigterm_after"] = (handler, signal.getsignal(signal.SIGTERM))
    return got, buf.getvalue()


@pytest.fixture(scope="module")
def jax_quickstart():
    """The JAX example's ``campaign_quickstart()`` lines."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        sys.path.insert(0, os.path.join(ROOT, "examples"))
        try:
            load_example("quickstart").campaign_quickstart()
        finally:
            sys.path.remove(os.path.join(ROOT, "examples"))
    return buf.getvalue().splitlines()


def test_quickstart_campaign_lines_match_jax(quickstart, jax_quickstart):
    """The six timeline records fire at the JAX example's hours, but the
    budget floor's: its tick is data-driven (it depends on the spend of
    the torch engine's own draws, ROADMAP C3), so it is held within two
    hours, as ``tests/test_torch_sweep.py`` holds it, with its target
    equal; cost and GPU-days within ``STAT_BANDS``."""
    got, text = quickstart
    want = jax_quickstart
    lines = text.splitlines()
    assert lines[0] == want[0] == "spec round-trips to JSON: 45 lines"
    fired = [ln for ln in lines if ln.startswith("  fired: ")]
    want_fired = [ln for ln in want if ln.startswith("  fired: ")]
    assert len(fired) == len(want_fired) == 6
    assert fired[:5] == want_fired[:5]
    floor = got["campaign"].events_fired[5]
    want_floor = ast.literal_eval(want_fired[5][len("  fired: "):])
    assert floor["event"] == want_floor["event"] == "budget_floor"
    assert floor["target"] == want_floor["target"] == 150
    assert abs(floor["t"] - want_floor["t"]) <= 2.0
    cost, days = (float(x.replace(",", "")) for x in re.search(
        r"\$([0-9,]+) for ([0-9,.]+) GPU-days", want[1]).groups())
    res = got["campaign"]
    assert abs(res.cost - cost) <= STAT_BANDS["cost"] * cost + 0.5
    assert abs(res.accel_days - days) \
        <= STAT_BANDS["accel_days"] * days + 0.05
    assert len(got["sweep"].rows) == 4


def test_quickstart_trains_restores_and_serves(quickstart):
    got, text = quickstart
    losses = got["losses"]
    assert len(losses) == QUICKSTART_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert got["restored_step"] == QUICKSTART_STEPS
    assert f"latest durable checkpoint: step {QUICKSTART_STEPS}" in text
    served = got["served"]
    assert len(served) == 6 and sum(len(r.out) for r in served) == 72
    assert "served 6 requests, 72 tokens" in text


def test_quickstart_puts_back_the_sigterm_handler(quickstart):
    """The trainer's preemption handler lasts as long as the training:
    afterwards SIGTERM does what it did before ``main`` ran."""
    before, after = quickstart[0]["sigterm_after"]
    assert after is before


@pytest.mark.parametrize("name", ["quickstart", "serve_overlay",
                                  "elastic_cloud_train"])
def test_recorded_jax_outputs_equal_the_jax_examples(procs, jax_quickstart,
                                                     name):
    with open(os.path.join(DATA, "jax_examples.json")) as f:
        recorded = json.load(f)[name]
    live = {"quickstart": lambda: jax_quickstart,
            "serve_overlay": lambda: _finish(procs, "serve_jax").splitlines(),
            "elastic_cloud_train": lambda: _finish(
                procs, "elastic_jax").splitlines()}[name]()
    assert recorded == live


# -- the CLI -----------------------------------------------------------------

NUMBER = re.compile(r"[-+$]*[0-9][0-9,.]*%?")


def _keys(x, path=""):
    """Every key path of a JSON value; list items share one path."""
    if isinstance(x, dict):
        out = set()
        for k, v in x.items():
            out |= {f"{path}/{k}"} | _keys(v, f"{path}/{k}")
        return out
    if isinstance(x, list):
        return set().union(*(_keys(v, path + "[]") for v in x))
    return set()


@pytest.mark.parametrize("kind", ["solo", "sweep"])
def test_cli_payload_has_the_jax_clis_key_structure(procs, kind):
    out = {}
    for side in ("torch", "jax"):
        text = _finish(procs, f"cli_{kind}_{side}")
        with open(f"{procs['cli'][kind, side]}.json") as f:
            out[side] = (json.load(f), text)
    (got, text), (want, want_text) = out["torch"], out["jax"]
    assert _keys(got) == _keys(want)
    assert got["kind"] == want["kind"] == ("campaign" if kind == "solo"
                                           else "sweep")
    if kind == "solo":
        assert got["engine"] == "torch" and want["engine"] == "jax"
        assert got["spec"] == want["spec"]
        # the same summary lines, the figures aside
        def labels(t):
            return [NUMBER.sub("#", ln) for ln in t.splitlines()[1:]]
        assert labels(text) == labels(want_text)
        assert text.splitlines()[0] == \
            "campaign 'paper' seed=2021 engine=torch"
    else:
        assert got["specs"] == want["specs"] and got["seeds"] == want["seeds"]
        assert text.splitlines()[0] == \
            "swept 4 lanes (2 specs x 2 seeds, engine=torch)"
        assert want_text.splitlines()[0] == \
            "swept 4 lanes (2 specs x 2 seeds, engine=jax)"
        heads = []
        for side in ("torch", "jax"):
            with open(f"{procs['cli'][kind, side]}.csv") as f:
                heads.append(f.readline())
        assert heads[0] == heads[1]


# -- the entry points --------------------------------------------------------

SPEC = os.path.join(DATA, "paper_replay.spec.json")
ENTRY_POINTS = {
    "quickstart": lambda: load_example("quickstart_torch").main(),
    "serve_overlay": lambda: load_example("serve_overlay_torch").main(),
    "elastic": lambda: load_example("elastic_cloud_train_torch").main(),
    "cli": lambda: _cli_main(["run", SPEC]),
    "cli sweep": lambda: _cli_main(["run", SPEC, "--seeds", "1,2"])}


def _cli_main(argv):
    from repro_torch import campaigns
    return campaigns.main(argv)


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_examples_and_cli_default_to_the_card(monkeypatch, entry):
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[entry]()
    assert not dist.is_initialized()


def test_cli_reports_an_invalid_spec_in_one_line(tmp_path, capsys):
    from repro_torch import campaigns
    bad = tmp_path / "bad.spec.json"
    bad.write_text('{"schema_version": 99, "name": "x"}\n')
    assert campaigns.main(["run", str(bad), "--device", "cpu"]) == 2
    assert capsys.readouterr().err.startswith("error: ")
