"""The port's planning front door against the JAX package:

  * every entry of ``core/scenarios.py`` at its defaults and at one
    non-default argument set: ``to_json()`` of each spec byte for byte
    the JAX package's; ``MARKET_CURVES``, ``WORKLOAD_CURVES`` and
    ``DATA_PLANES`` equal key by key; the legacy ramp constants equal;
  * ``spec.lint_spec`` and ``campaigns lint [--registry] --json -`` on the
    bad-spec fixtures ``tests/data/*.lint.json`` (every SPEC rule but
    SPEC101, which no JSON can reach and a Python-built spec covers):
    the same findings, exit code, human lines and payload (its
    ``"tool"`` aside);
  * ``analysis.pareto.frontier`` on shared rows (seeded, with ties,
    duplicates, one scenario, other axes, a missing metric): the JAX
    ``frontier``'s ``to_dict()`` and table;
  * fed the JAX engine's threefry uniforms, a ``pareto_grid()`` sweep at
    its full 336 h x 2 seeds: integer counters, ``by_provider`` and the
    fired events equal to ``run_jax_detailed(..., use_pallas=False)`` in
    every lane (the sliced squeeze lanes after both ``azure/4`` points
    and the CE outage), cost, accelerator hours and egress within 1e-5
    relative, and the same frontier members as the JAX ``frontier`` over
    the JAX sweep;
  * a provider-targeted curve under slicing targets the sliced provider
    (``par-azure-squeeze-s4-*``: the planner's ``azure/4`` rates move at
    120 h, the others do not);
  * ``campaigns show`` and ``paper`` print the JAX CLI's bytes;
    ``pareto --device cpu --duration-h 24`` prints the JAX CLI's
    scenarios and writes its payload keys;
  * ``examples/whatif_sweep_torch.py`` prints the JAX example's lines
    around its numbers;
  * the CLI's new commands and the example raise without a card unless
    told to run on the CPU.
"""
import contextlib
import io
import json
import os
import sys
from dataclasses import asdict, dataclass, replace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro import campaigns as jcampaigns
from repro.analysis import pareto as jpareto
from repro.core import scenarios as jscen
from repro.core.spec import CampaignSpec as JaxSpec
from repro.core.spec import lint_spec as jax_lint_spec
from repro.core.sweep_jax import run_jax_detailed
from repro_torch import campaigns
from repro_torch.analysis import pareto
from repro_torch.core import scenarios
from repro_torch.core.spec import CampaignSpec, lint_spec, paper_spec
from repro_torch.core.sweep_result import _prepare
from repro_torch.core.sweep_torch import TorchSweepEngine, run_torch_detailed
from repro_torch.core.timeline import event_to_dict
from test_torch_train import one_cpu_thread  # noqa: F401
from torch_dist_workers import load_example

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join("tests", "data")
GOLDENS = [os.path.join(DATA, f) for f in sorted(os.listdir(
    os.path.join(ROOT, DATA))) if f.endswith(".spec.json")]
LINT_FIXTURES = [os.path.join(DATA, f) for f in sorted(os.listdir(
    os.path.join(ROOT, DATA))) if f.endswith(".lint.json")]
INT_COUNTERS = ("preemptions", "jobs_finished", "nat_drops")
# cost, accelerator hours and egress on the JAX draws: the same f32
# arithmetic in another order
REL = 1e-5


@pytest.fixture(autouse=True)
def _at_root(monkeypatch):
    """The CLIs print the paths they are given: run both from the root."""
    monkeypatch.chdir(ROOT)


# -- the library -------------------------------------------------------------

# entry -> (one non-default argument set, or None where it takes none)
ENTRIES = {
    "paper_baseline": None,
    "ondemand_fallback": dict(budget=40000.0),
    "spot_ondemand_mixes": dict(fracs=(0.05, 0.75)),
    "heterogeneous_burst": dict(capacity_scale=0.5),
    "outage_grid": dict(times_h=(24.0, 180.0), durations_h=(1.0,)),
    "outage_burst": dict(at_h=100.0, duration_h=3.0),
    "budget_floor_variants": dict(floors=(0.05, 0.5)),
    "price_perturbations": dict(factors=(0.5, 1.5)),
    "price_curve_scenarios": dict(curves=("weekend-dip",)),
    "workload_curve_scenarios": dict(curves=("flash-crowd",)),
    "workload_burst": None,
    "gpu_slicing_variants": dict(slices=(3,)),
    "curve_sliced_burst": dict(slices=2),
    "data_heavy_mix": dict(sizes_gb=(10.0,), plane="no-cache"),
    "origin_outage_grid": dict(times_h=(30.0,), durations_h=(12.0,),
                               provider="gcp", size_gb=5.0),
    "egress_cost_scenarios": dict(size_gb=100.0),
    "dataplane_burst": None,
    "planning_grid": dict(price_scales=(0.9,), floors=(0.2, 0.3),
                          budgets=(50000.0,)),
    "pareto_grid": dict(curves=("weekend-dip", "azure-squeeze"),
                        slices=(2,), planes=("no-cache",), size_gb=10.0),
    "default_suite": None,
}
CALLS = [(name, "defaults") for name in ENTRIES] + \
    [(name, "args") for name, kw in ENTRIES.items() if kw is not None]


def _jsons(x):
    return [s.to_json() for s in (x if isinstance(x, list) else [x])]


def test_library_exports_every_jax_entry():
    assert set(ENTRIES) <= set(scenarios.__all__)
    assert set(ENTRIES) == {n for n in vars(jscen) if callable(
        getattr(jscen, n)) and not n.startswith("_")
        and getattr(getattr(jscen, n), "__module__", "") == jscen.__name__
        and n not in ("Scenario", "build_catalog", "sim_config",
                      "run_scenario")}


@pytest.mark.parametrize("name,how", CALLS,
                         ids=[f"{n}-{h}" for n, h in CALLS])
def test_library_entry_json_equals_the_jax_packages(name, how):
    kw = ENTRIES[name] if how == "args" else {}
    want = _jsons(getattr(jscen, name)(**kw))
    got = _jsons(getattr(scenarios, name)(**kw))
    assert len(got) == len(want) > 0
    assert got == want


@pytest.mark.parametrize("table", ["MARKET_CURVES", "WORKLOAD_CURVES",
                                   "DATA_PLANES"])
def test_axis_tables_equal_key_by_key(table):
    got, want = getattr(scenarios, table), getattr(jscen, table)
    assert list(got) == list(want)
    for key in want:
        if table == "DATA_PLANES":
            assert got[key].to_dict() == want[key].to_dict(), key
        else:
            assert event_to_dict(got[key]) == {
                "kind": want[key].kind, **asdict(want[key])}, key


def test_legacy_ramp_constants_equal_the_jax_packages():
    assert (scenarios.OUTAGE_AT_H, scenarios.OUTAGE_DURATION_H,
            scenarios.POST_OUTAGE_TARGET) == (
        jscen.OUTAGE_AT_H, jscen.OUTAGE_DURATION_H, jscen.POST_OUTAGE_TARGET)
    assert [asdict(r) for r in scenarios.PAPER_RAMP] == \
        [asdict(r) for r in jscen.PAPER_RAMP]
    from repro.core.campaign import _timeline as jax_timeline
    for outage in (True, False):
        got = scenarios._timeline(scenarios.PAPER_RAMP, outage,
                                  outage_at_h=90.0, resume_target=700)
        want = jax_timeline(jscen.PAPER_RAMP, outage, outage_at_h=90.0,
                            resume_target=700)
        assert [event_to_dict(e) for e in got] == \
            [{"kind": e.kind, **asdict(e)} for e in want]
    # the paper timeline rebuilt from the constants is the spec's own
    assert scenarios._timeline(scenarios.PAPER_RAMP, True) == \
        paper_spec().timeline


def test_library_batches_by_structural_key():
    """``default_suite()``: 19 specs in 6 engine batches;
    ``pareto_grid()``: 12 in 4 (one fused launch each on the card)."""
    for lib, n_specs, n_batches in ((scenarios.default_suite, 19, 6),
                                    (scenarios.pareto_grid, 12, 4)):
        specs = lib()
        assert len(specs) == n_specs
        assert len({repr(_prepare(s, 0)[0]) for s in specs}) == n_batches


def test_sliced_squeeze_curve_targets_the_sliced_provider():
    """``par-azure-squeeze-s4-*``: the curve names ``azure/4``, the name
    slicing gives the provider, so the planner's azure/4 rates are 1.5x
    from 120 h to 216 h and 1.1x after, and no other group moves."""
    for plane in ("nodata", "federated"):
        spec = next(s for s in scenarios.pareto_grid()
                    if s.name == f"par-azure-squeeze-s4-{plane}")
        curve, = [e for e in spec.timeline if e.kind == "price_curve"]
        assert curve.provider == "azure/4"
        eng = TorchSweepEngine([_prepare(spec, 0)[1]], device="cpu")
        flat = TorchSweepEngine([_prepare(replace(
            spec, timeline=paper_spec().timeline), 0)[1]], device="cpu")
        seg = eng.seg_of_tick
        rate, base = eng.planes["rate"], flat.planes["rate"]
        azure = np.array([p == "azure/4" for p in eng.g_provider])
        assert azure.any() and not azure.all()
        for t_h, f in ((100.0, 1.0), (150.0, 1.5), (230.0, 1.1)):
            i = int(t_h / spec.dt_h)
            a, b = rate[seg[i], 0], base[flat.seg_of_tick[i], 0]
            np.testing.assert_allclose(a[azure], f * b[azure], rtol=1e-6)
            np.testing.assert_array_equal(a[~azure], b[~azure])


# -- lint ----------------------------------------------------------------------

@pytest.mark.parametrize("path", [p for p in LINT_FIXTURES
                                  if "unloadable" not in p
                                  and "malformed" not in p])
def test_lint_spec_findings_equal_the_jax_packages(path):
    text = open(path).read()
    want = jax_lint_spec(JaxSpec.from_json(text))
    got = lint_spec(CampaignSpec.from_json(text))
    assert want and got == want


def test_lint_spec_reports_an_unknown_event_as_the_jax_package_does():
    """SPEC101: an event of an unregistered kind (no JSON can carry
    one), on a spec with a data plane."""
    @dataclass(frozen=True)
    class Bogus:
        at_h: float
        kind = "bogus"

    want = jax_lint_spec(replace(jscen.dataplane_burst(), timeline=(
        jscen.PAPER_RAMP_EVENTS[0], Bogus(3.0))))
    got = lint_spec(replace(scenarios.dataplane_burst(), timeline=(
        paper_spec().timeline[0], Bogus(3.0))))
    assert got == want and any(f.startswith("SPEC101") for f in got)


def test_lint_rule_table_equals_the_jax_packages():
    from repro.core.spec import SPEC_RULES as JAX_RULES
    from repro_torch.core.spec import SPEC_RULES
    assert SPEC_RULES == JAX_RULES
    fired = set()
    for path in LINT_FIXTURES:
        try:
            spec = CampaignSpec.from_json(open(path).read())
        except ValueError:
            fired.add("SPEC100")
            continue
        fired |= {f.split(":")[0] for f in lint_spec(spec)}
    assert fired == set(SPEC_RULES) - {"SPEC101"}


def _cli(main, argv):
    """(exit code, stdout, stderr) of a CLI's ``main`` in this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("registry", [False, True])
def test_lint_cli_json_equals_the_jax_clis(registry):
    files = LINT_FIXTURES + GOLDENS + [os.path.join(DATA, "missing.json")]
    flags = ["--json", "-"] + (["--registry"] if registry else [])
    want = _cli(jcampaigns.main, ["lint", *files, *flags])
    got = _cli(campaigns.main, ["lint", *files, *flags, "--device", "cpu"])
    assert got[0] == want[0] == 1
    assert got[2] == want[2]                     # the human lines
    jw, jg = json.loads(want[1]), json.loads(got[1])
    assert jw.pop("tool") == "repro.campaigns lint"
    assert jg.pop("tool") == "repro_torch.campaigns lint"
    assert jg == jw
    assert got[1].replace("repro_torch.campaigns", "repro.campaigns") \
        == want[1]


def test_lint_cli_passes_the_goldens_and_the_registry(tmp_path):
    out = tmp_path / "lint.json"
    rc, text, _ = _cli(campaigns.main, ["lint", *GOLDENS, "--registry",
                                        "--json", str(out), "--device",
                                        "cpu"])
    assert rc == 0
    assert text.splitlines()[0] == "registry: OK (10 event kinds on all " \
        "engines)"
    body = json.loads(out.read_text())
    assert body["ok"] and body["findings"] == [] and body["counts"] == {}


# -- the frontier --------------------------------------------------------------

def _rows(case):
    """Shared sweep rows: seeded costs and values, with ties (one price
    step), duplicate scenarios and repeated seeds."""
    rng = np.random.default_rng({"seeded": 0, "ties": 1, "duplicates": 2,
                                 "single": 3, "axes": 4}[case])
    n_scen = 1 if case == "single" else 9
    rows = []
    for s in range(n_scen):
        for seed in range(3):
            if case == "ties":
                cost = 1000.0 * int(rng.integers(1, 4))
                value = float(rng.integers(1, 4))
            else:
                cost = float(rng.uniform(500, 5000))
                value = float(rng.uniform(10, 300))
            rows.append({"scenario": f"s{s}", "seed": seed, "cost": cost,
                         "accel_days": value,
                         "jobs_finished": int(rng.integers(1, 10 ** 5)),
                         "egress_usd": float(rng.uniform(0, 50))})
    if case == "duplicates":
        rows += [dict(r, scenario="copy") for r in rows
                 if r["scenario"] == "s3"]
    return rows


@pytest.mark.parametrize("case", ["seeded", "ties", "duplicates", "single",
                                  "axes"])
def test_frontier_equals_the_jax_frontier_on_shared_rows(case):
    rows = _rows(case)
    kw = dict(x="egress_usd", y="jobs_finished") if case == "axes" else {}
    want = jpareto.frontier(rows, **kw)
    got = pareto.frontier(rows, **kw)
    assert got.to_dict() == want.to_dict()
    assert got.table() == want.table()
    assert [p.scenario for p in got.frontier] == \
        [p.scenario for p in want.frontier]
    assert [p.scenario for p in got.dominated] == \
        [p.scenario for p in want.dominated]
    if case == "duplicates":
        on = {p.scenario for p in got.frontier}
        assert ("s3" in on) == ("copy" in on)


def test_frontier_refuses_what_the_jax_frontier_refuses():
    rows = [{"scenario": "a", "cost": 1.0}]
    with pytest.raises(ValueError) as want:
        jpareto.frontier(rows)
    with pytest.raises(ValueError) as got:
        pareto.frontier(rows)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="at least one"):
        pareto.frontier([])


# -- the pareto grid on the JAX engine's draws ---------------------------------

PARETO_SEEDS = (2021, 2022)
# the events after which the sliced squeeze lanes are compared: both
# points of the "azure/4" price curve and the CE outage
SQUEEZE_S4_EVENTS = [(120.0, "price_curve"), (216.0, "price_curve"),
                     (252.0, "outage_on"), (254.0, "outage_off")]


def _jax_uniforms(eng):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(eng.consts["seeds"]))
    G = eng.G
    draw = jax.jit(lambda i: jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, i), (G,)))(keys))
    return lambda i: np.array(draw(jnp.int32(i)))


def test_fed_jax_uniforms_pareto_sweep_equals_the_jax_engine():
    """At full duration (336 h), so that every lane is compared after the
    squeeze points, the CE outage and the drift points have fired."""
    jspecs, specs = jscen.pareto_grid(), scenarios.pareto_grid()
    assert {s.duration_h for s in specs} == {336.0}
    want = run_jax_detailed([(s, sd) for s in jspecs for sd in PARETO_SEEDS],
                            use_pallas=False)
    got = run_torch_detailed([(s, sd) for s in specs for sd in PARETO_SEEDS],
                             device="cpu", uniforms=_jax_uniforms)
    lanes = [(s.name, sd) for s in specs for sd in PARETO_SEEDS]
    assert len(got) == len(want) == 24
    for lane, (g, g_ev), (w, w_ev, _) in zip(lanes, got, want):
        for k in INT_COUNTERS:
            assert g[k] == w[k], (lane, k)
        assert g["by_provider"] == w["by_provider"], lane
        assert g_ev == w_ev, lane
        for k in ("cost", "accel_hours", "egress_usd"):
            assert g[k] == pytest.approx(w[k], rel=REL, abs=1e-6), (lane, k)
        if lane[0].startswith("par-azure-squeeze-s4-"):
            curve = [e for e in g_ev if e["event"] == "price_curve"]
            assert {e["provider"] for e in curve} == {"azure/4"}, lane
            fired = {(e["t"], e["event"]) for e in g_ev}
            assert fired >= set(SQUEEZE_S4_EVENTS), lane
            assert "azure/4" in g["by_provider"], lane
    got = [g for g, _ in got]
    want = [w for w, _, _ in want]
    rows = [{"scenario": n, "seed": sd, **r} for (n, sd), r in
            zip(lanes, got)]
    jrows = [{"scenario": n, "seed": sd, **r} for (n, sd), r in
             zip(lanes, want)]
    fg, fw = pareto.frontier(rows), jpareto.frontier(jrows)
    assert [p.scenario for p in fg.frontier] == \
        [p.scenario for p in fw.frontier]
    for a, b in zip(fg.points, fw.points):
        assert a.scenario == b.scenario
        assert a.cost == pytest.approx(b.cost, rel=REL)
        assert a.value == pytest.approx(b.value, rel=REL)


# -- show, paper, pareto ----------------------------------------------------

def test_show_prints_the_jax_clis_bytes():
    want = _cli(jcampaigns.main, ["show", *GOLDENS])
    got = _cli(campaigns.main, ["show", *GOLDENS, "--device", "cpu"])
    assert got == want and want[0] == 0


def test_paper_prints_and_writes_the_jax_clis_bytes(tmp_path):
    want = _cli(jcampaigns.main, ["paper"])
    got = _cli(campaigns.main, ["paper", "--device", "cpu"])
    assert got == want and want[1] == open(
        os.path.join(DATA, "paper_replay.spec.json")).read()
    a, b = tmp_path / "jax.json", tmp_path / "torch.json"
    _cli(jcampaigns.main, ["paper", "--out", str(a)])
    rc, _, err = _cli(campaigns.main, ["paper", "--out", str(b), "--device",
                                       "cpu"])
    assert rc == 0 and err == f"# wrote {b}\n"
    assert b.read_bytes() == a.read_bytes()


def test_pareto_cli_has_the_jax_clis_payload_and_lines(tmp_path):
    a, b = tmp_path / "jax.json", tmp_path / "torch.json"
    rc_w, want, _ = _cli(jcampaigns.main, ["pareto", "--duration-h", "24",
                                           "--json", str(a)])
    rc_g, got, err = _cli(campaigns.main, ["pareto", "--duration-h", "24",
                                           "--json", str(b), "--device",
                                           "cpu"])
    assert rc_w == rc_g == 0 and err == f"# wrote {b}\n"
    jw, jg = json.loads(a.read_text()), json.loads(b.read_text())
    assert set(jg) == set(jw)
    assert {k: jg[k] for k in ("schema_version", "kind", "x", "y", "seeds")} \
        == {k: jw[k] for k in ("schema_version", "kind", "x", "y", "seeds")}
    assert sorted(p["scenario"] for p in jg["points"]) == \
        sorted(p["scenario"] for p in jw["points"])
    assert all(set(p) == set(jw["points"][0]) for p in jg["points"])
    gl, wl = got.splitlines(), want.splitlines()
    assert len(gl) == len(wl) == 18
    assert gl[:4] == wl[:4] and gl[-1].startswith("non-dominated: ")
    assert all(p["cost"] > 0 and p["value"] > 0 for p in jg["points"])


# -- the what-if example ------------------------------------------------------

def _jax_whatif(argv):
    example = load_example("whatif_sweep")
    old = sys.argv
    sys.argv = ["whatif_sweep.py", *argv]
    try:
        return _cli(lambda _: example.main(), None)[1]
    finally:
        sys.argv = old


def test_whatif_example_prints_the_jax_examples_lines():
    """The paper spec at 2 seeds: the lines around the numbers equal the
    JAX example's (its engine's name aside), the table's header and rows
    in the same order."""
    argv = ["--scenarios", "paper", "--seeds", "2"]
    want = _jax_whatif(argv).splitlines()
    example = load_example("whatif_sweep_torch")
    _, text, _ = _cli(lambda a: example.main(a), argv + ["--device", "cpu"])
    got = text.splitlines()
    assert got[0] == want[0].replace("(batched engine)", "(torch engine)")
    assert len(got) == len(want) == 7
    assert got[1].startswith("done in ") and got[2] == want[2] == ""
    assert got[3] == want[3]                      # the table's header
    assert got[4].split()[0] == want[4].split()[0] == "paper"
    assert got[5:] == want[5:]


# -- no card ------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["show", os.path.join(DATA, "paper_replay.spec.json")], ["paper"],
    ["lint", os.path.join(DATA, "paper_replay.spec.json")],
    ["pareto", "--duration-h", "1"]], ids=lambda a: a[0])
def test_cli_commands_raise_without_a_card(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cli(campaigns.main, argv)


def test_whatif_example_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    example = load_example("whatif_sweep_torch")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cli(lambda a: example.main(a), ["--scenarios", "paper",
                                         "--seeds", "1"])
