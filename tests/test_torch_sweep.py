"""The torch sweep engine (``repro_torch``) against the JAX package.

Everything runs on the CPU (``device="cpu"``: the plain versions of the
tick ops), at reduced duration where the reference allows it:

  * the planner: ``TorchSweepEngine``'s numpy ``planes`` / ``consts``
    equal ``JaxSweepEngine``'s, array by array, on every
    ``default_suite`` member;
  * fed the JAX engine's threefry uniforms through the ``uniforms``
    hook, the torch engine's integer counters equal
    ``run_jax(..., use_pallas=False)`` in every lane, and cost and hours
    agree to 1e-5 relative (the f32 sums may associate differently);
  * on its own Philox draws it meets ``STAT_BANDS`` against the
    bit-identical batched engine;
  * ``events_fired`` matches the batched engine's records;
  * the data-plane golden spec runs end to end.
"""
import json
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from engine_equivalence import STAT_BANDS
from repro.core import scenarios
from repro.core.api import sweep as jax_sweep
from repro.core.spec import CampaignSpec as JaxSpec
from repro.core.sweep_jax import JaxSweepEngine, run_jax
from repro.core.sweep_jax import _prepare as jax_prepare
from repro_torch.core import api
from repro_torch.core.spec import CampaignResult, CampaignSpec
from repro_torch.core.sweep_result import _prepare
from repro_torch.core.sweep_torch import (TorchSweepEngine, philox4x32,
                                          philox_uniforms, run_torch)

DATA = Path(__file__).parent / "data"
INT_COUNTERS = ("preemptions", "jobs_finished", "nat_drops")
REL = 1e-5


def _short(name="paper", **kw):
    sc = next(s for s in scenarios.default_suite() if s.name == name)
    return replace(sc, **kw) if kw else sc


def _port(spec):
    """The JAX package's spec, carried across as JSON."""
    return CampaignSpec.from_json(spec.to_json())


def _jax_uniforms(eng):
    """The JAX engine's draws for this batch:
    ``uniform(fold_in(PRNGKey(seed), i), (G,))`` per lane."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(eng.consts["seeds"]))
    G = eng.G
    draw = jax.jit(lambda i: jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, i), (G,)))(keys))
    return lambda i: np.array(draw(jnp.int32(i)))


def _assert_counters_match(got, want):
    for k in INT_COUNTERS:
        assert got[k] == want[k], k
    assert got["by_provider"] == want["by_provider"]
    for k in ("cost", "accel_hours", "busy_hours", "egress_usd",
              "stagein_hours"):
        assert got[k] == pytest.approx(want[k], rel=REL, abs=0.05), k


# -- the planner -----------------------------------------------------------

@pytest.mark.parametrize("name", [s.name for s in scenarios.default_suite()])
def test_planner_planes_and_consts_match_jax(name):
    sc = next(s for s in scenarios.default_suite() if s.name == name)
    lanes = [jax_prepare(sc, seed)[1] for seed in (0, 7)]
    want = JaxSweepEngine(lanes, use_pallas=False)
    got = TorchSweepEngine([_prepare(_port(sc), seed)[1]
                            for seed in (0, 7)], device="cpu")
    for attr in ("N", "W", "L", "nat_any", "dp_active", "dp_staging"):
        assert getattr(got, attr) == getattr(want, attr), attr
    np.testing.assert_array_equal(got.tick_times, want.tick_times)
    np.testing.assert_array_equal(got.seg_of_tick, want.seg_of_tick)
    np.testing.assert_array_equal(got.is_seg_start, want.is_seg_start)
    for table in ("planes", "consts"):
        a, b = getattr(got, table), getattr(want, table)
        assert set(a) == set(b), table
        for key in b:
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


# -- parity with the JAX engine on the JAX draws ---------------------------

_TRIO = {"paper": {}, "floor30": {"budget": 16000.0}, "load-diurnal": {}}
_SEEDS = (0, 1, 2)


@pytest.fixture(scope="module")
def trio_runs():
    specs = [_short(n, duration_h=96.0, **kw) for n, kw in _TRIO.items()]
    lanes = [(s, seed) for s in specs for seed in _SEEDS]
    want = run_jax(lanes, use_pallas=False)
    got = run_torch([(_port(s), seed) for s, seed in lanes], device="cpu",
                    uniforms=_jax_uniforms)
    return {(s.name, seed): (g, w)
            for (s, seed), g, w in zip(lanes, got, want)}


@pytest.mark.parametrize("name", list(_TRIO))
def test_fed_jax_uniforms_counters_equal_jax_engine(trio_runs, name):
    for seed in _SEEDS:
        got, want = trio_runs[(name, seed)]
        _assert_counters_match(got, want)
        assert got["budget"]["by_provider"].keys() \
            == want["budget"]["by_provider"].keys()


def test_dataplane_golden_runs_on_cpu():
    """The full two-week data-plane golden (stage-in planes, origin
    outage gating, cache flush) on the JAX draws: counters equal the
    JAX engine's, data-plane columns within 1e-5."""
    sc = JaxSpec.from_json((DATA / "dataplane.spec.json").read_text())
    lanes = [(sc, 2021)]
    want, = run_jax(lanes, use_pallas=False)
    got, = run_torch([(_port(sc), 2021)], device="cpu",
                     uniforms=_jax_uniforms)
    _assert_counters_match(got, want)
    assert got["cache_hit_fraction"] == pytest.approx(
        want["cache_hit_fraction"], rel=REL)
    assert got["egress_usd"] > 0 and got["stagein_hours"] > 0


# -- own randomness --------------------------------------------------------

def test_philox_matches_known_answers():
    """Random123's published philox4x32_10 known-answer vectors."""
    z = torch.zeros(1, dtype=torch.int64)
    f = torch.full((1,), 0xFFFFFFFF, dtype=torch.int64)
    got = [int(x) for x in philox4x32((z, z, z, z), (z, z))]
    assert got == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]
    got = [int(x) for x in philox4x32((f, f, f, f), (f, f))]
    assert got == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_lane_draws_do_not_depend_on_batch():
    ticks = torch.arange(5, 9, dtype=torch.int64)
    both = philox_uniforms(torch.tensor([3, 2 ** 40 + 9]), ticks, 10)
    alone = philox_uniforms(torch.tensor([2 ** 40 + 9]), ticks, 10)
    assert torch.equal(both[:, 1], alone[:, 0])
    assert not torch.equal(both[:, 0], both[:, 1])
    assert both.dtype == torch.float32
    assert 0.0 <= float(both.min()) and float(both.max()) < 1.0
    assert abs(float(philox_uniforms(torch.tensor([1]),
                                     torch.arange(4000), 10).mean())
               - 0.5) < 0.01


def test_own_rng_meets_stat_bands_against_batched():
    """Local twin of ``engine_equivalence.assert_statistically_equivalent``
    (which dispatches by engine name inside the JAX package's api)."""
    specs = [_short(n, duration_h=96.0, **kw) for n, kw in _TRIO.items()]
    seeds = list(range(6))
    ref = jax_sweep(specs, seeds, engine="batched")
    got = api.sweep([_port(s) for s in specs], seeds, device="cpu")
    rs, gs = ref.summary(tuple(STAT_BANDS)), got.summary(tuple(STAT_BANDS))
    assert set(gs) == set(rs)
    for scen in sorted(rs):
        for metric, rel in STAT_BANDS.items():
            a, b = rs[scen][metric], gs[scen][metric]
            margin = rel * max(abs(a["mean"]), 1e-9)
            assert abs(b["mean"] - a["mean"]) <= margin, \
                (scen, metric, "mean", a, b)
            assert a["p5"] - margin <= b["p5"] and \
                b["p95"] <= a["p95"] + margin, (scen, metric, "band", a, b)


# -- event provenance ------------------------------------------------------

def test_events_fired_match_batched_on_paper():
    sc = JaxSpec()
    want = jax_sweep([sc], [0], engine="batched").rows[0]["events_fired"]
    got = api.sweep([_port(sc)], [0], device="cpu").rows[0]["events_fired"]
    assert got == want


def test_events_fired_match_batched_when_floor_fires():
    """The budget-floor cap tick is data-driven (its spend depends on
    the draws), so the cap record's time may differ by a few ticks;
    every other record and the cap's target are equal."""
    sc = _short("floor30", duration_h=168.0, budget=20000.0)
    want = jax_sweep([sc], [3], engine="batched").rows[0]["events_fired"]
    got = api.run(_port(sc), seeds=3, device="cpu").events_fired
    cap_w = next(e for e in want if e["event"] == "budget_floor")
    cap_g = next(e for e in got if e["event"] == "budget_floor")
    assert cap_g["target"] == cap_w["target"]
    assert abs(cap_g["t"] - cap_w["t"]) <= 2.0
    assert [e for e in got if e is not cap_g] \
        == [e for e in want if e is not cap_w]


# -- the front door --------------------------------------------------------

def test_run_returns_campaign_result_with_batched_schema():
    sc = _short(duration_h=48.0)
    res = api.run(_port(sc), seeds=11, device="cpu")
    assert isinstance(res, CampaignResult)
    assert res.engine == "torch" and res.seed == 11
    assert res.cost > 0 and res.accel_days > 0
    ref = jax_sweep([sc], [11], engine="batched").rows[0]
    row = api.sweep([_port(sc)], [11], device="cpu").rows[0]
    assert set(row) == set(ref)
    assert set(row["budget"]) == set(ref["budget"])
    assert json.loads(json.dumps(row)) == row


def test_trace_collection_is_refused():
    sc = _port(_short(duration_h=24.0))
    with pytest.raises(ValueError, match="statistical"):
        api.run(sc, seeds=1, device="cpu", collect="trace")
    with pytest.raises(ValueError, match="statistical"):
        api.sweep([sc], [1, 2], device="cpu", collect="stream")


def test_sweep_batches_by_structural_key_and_is_deterministic():
    a = _port(_short(duration_h=24.0))
    b = _port(_short("hetero", duration_h=24.0))
    r1 = api.sweep([a, b], [0, 1], device="cpu")
    r2 = api.sweep([a, b], [0, 1], device="cpu")
    assert r1.rows == r2.rows
    assert r1.to_csv() == r2.to_csv()
    costs = {(r["scenario"], r["seed"]): r["cost"] for r in r1.rows}
    assert costs[("paper", 0)] != costs[("hetero", 0)]
    assert "paper" in r1.table()
