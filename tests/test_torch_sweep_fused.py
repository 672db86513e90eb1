"""The campaign sweep's fused route: one persistent kernel per engine batch.

On the CPU (here):

  * the planner's index planes are the argmax of its one-hot planes,
    each one-hot row holding exactly one 1, on every ``default_suite``
    member and the data-plane golden spec;
  * ``ref.campaign_sweep_ref``, the kernel's plain version, run on the
    engine's packed arguments (the fused route forced on the CPU)
    equals the eager engine's ``out``: integer fields and flags exactly,
    f32 fields within 1e-6 relative.  Cases: the 96 h trio of
    ``test_torch_sweep.py``, the data-plane golden spec, a NAT case, a
    case where the budget floor fires, a planted case whose Poisson
    rates pass 8 (the draw's normal branch), one of 40 groups (more than
    a warp) and one whose cells do not fit in shared memory; and every
    engine batch of ``default_suite()`` and ``pareto_grid()`` (10
    batches, 2 seeds, full 336 h);
  * fed the JAX engine's draws, its integer counters equal the JAX
    engine's (the planted lam > 8 case on the "ops" route too);
  * the route rule ``ops.sweep_route``, the wrapper's checks, the
    kernel's argument order, and that an engine with no card and no CPU
    request raises.

On the card (``cuda``-marked): the fused route against the "ops" and
plain routes on the same cases, on the engine's own draws and on a
uniforms hook, the kernel against its plain version on the packed
arguments, and on each planning batch the fused route against the plain
route.  The module imports neither JAX nor the JAX package at the
top, so the card's machine (no JAX) runs it with ``--noconftest``:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_sweep_fused.py
"""
import re
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import api, scenarios
from repro_torch.core.spec import (PAPER_TIMELINE, CampaignSpec,
                                   ProviderSpec, RegionSpec, SetTarget,
                                   WorkloadCurve, paper_spec)
from repro_torch.core.sweep_result import _prepare
from repro_torch.core.sweep_torch import TorchSweepEngine, run_torch
from repro_torch.kernels import ops, ref
from test_torch_train import one_cpu_thread  # noqa: F401

DATA = Path(__file__).parent / "data"
CSRC = Path(__file__).parents[1] / "src" / "repro_torch" / "kernels" / "csrc"
INT_COUNTERS = ("preemptions", "jobs_finished", "nat_drops")

# a planted case whose per-group Poisson rate lam = live * hazard passes 8
# (up to 135 here: 600 live in r1 at 0.3 per hour, tripled at full use),
# so the draw takes its rounded-normal branch, which the paper grid (lam
# at most ~0.3) never reaches
_HOT = ProviderSpec(name="hot", accel="t4", spot_price_per_day=2.0,
                    ondemand_price_per_day=6.0,
                    regions=(RegionSpec("r1", 600, 0.3),
                             RegionSpec("r2", 400, 0.2)))
# 40 groups: more than a warp's 32 threads, so each thread takes two
_WIDE = ProviderSpec(name="wide", accel="t4", spot_price_per_day=2.0,
                     ondemand_price_per_day=6.0,
                     regions=tuple(RegionSpec(f"r{i:02d}", 40 + i,
                                              0.02 + 0.001 * i)
                                   for i in range(40)))


def _suite_specs():
    """The JAX package's ``default_suite``, carried across as JSON (the
    card's machine has no JAX: there the list is empty, and only the
    ``cuda`` tests, which need none of it, run)."""
    try:
        from repro.core.scenarios import default_suite
    except ImportError:
        return []
    return [CampaignSpec.from_json(s.to_json()) for s in default_suite()]


def _trio():
    """The 96 h trio of ``test_torch_sweep.py`` built from the port's own
    spec types: paper, floor30 at a $16k budget, load-diurnal."""
    diurnal = WorkloadCurve(tuple(
        p for d in range(14)
        for p in ((24.0 * d + 8.0, 1.0), (24.0 * d + 20.0, 0.02))))
    return [paper_spec(duration_h=96.0),
            paper_spec(name="floor30", budget_floor_fraction=0.3,
                       budget=16000.0, duration_h=96.0),
            paper_spec(name="load-diurnal", duration_h=96.0, timeline=tuple(
                sorted(PAPER_TIMELINE + (diurnal,), key=lambda e: e.at_h)))]


def _cases():
    """name -> (specs, seeds)."""
    return {
        "trio": (_trio(), (0, 1, 2)),
        "dataplane": ([CampaignSpec.from_json(
            (DATA / "dataplane.spec.json").read_text())], (2021, 2022)),
        "nat": ([paper_spec(duration_h=96.0, lease_interval_s=300.0)],
                (0, 1)),
        "floor": ([paper_spec(name="floor30", budget_floor_fraction=0.3,
                              duration_h=168.0, budget=20000.0)], (3, 4)),
        "hot": ([CampaignSpec(name="hot", providers=(_HOT,),
                              timeline=(SetTarget(0.0, 800),),
                              duration_h=48.0)], (0, 1)),
        "wide": ([CampaignSpec(name="wide", providers=(_WIDE,),
                               timeline=(SetTarget(0.0, 1500),),
                               duration_h=48.0)], (0, 1)),
        # 380 h jobs: 1,520 progress steps, so four lanes' cells (243 KB)
        # pass a block's shared memory and the kernel keeps them in its
        # global scratch
        "long-jobs": ([paper_spec(name="long-jobs", job_wall_h=380.0,
                                  job_checkpoint_h=20.0, duration_h=48.0)],
                      (0, 1)),
    }


def test_trio_is_the_jax_packages_trio():
    """The port-built trio equals ``test_torch_sweep.py``'s, member by
    member, as JSON."""
    suite = {s.name: s for s in _suite_specs()}
    want = [replace(suite["paper"], duration_h=96.0),
            replace(suite["floor30"], duration_h=96.0, budget=16000.0),
            replace(suite["load-diurnal"], duration_h=96.0)]
    assert [s.to_json() for s in _trio()] == [s.to_json() for s in want]


def _engines(specs, seeds, device):
    """One engine per structural batch, as ``run_torch_detailed`` makes
    them."""
    batches = {}
    for s in specs:
        for seed in seeds:
            key, lane = _prepare(s, seed)
            batches.setdefault(repr(key), []).append(lane)
    return [TorchSweepEngine(lanes, device=device)
            for lanes in batches.values()]


def _assert_state_equal(got: dict, want: dict, rel: float):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=rel, atol=0, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


# -- the index planes ------------------------------------------------------

def _one_hot_index(onehot: np.ndarray, index: np.ndarray, what: str):
    assert (onehot.sum(-1) == 1).all() and \
        set(np.unique(onehot)) <= {0.0, 1.0}, what
    np.testing.assert_array_equal(onehot.argmax(-1), index, err_msg=what)
    assert index.dtype == np.int32, what


@pytest.mark.parametrize("name", [s.name for s in _suite_specs()]
                         + ["dataplane-golden"])
def test_index_planes_are_the_argmax_of_the_one_hot_planes(name):
    spec = CampaignSpec.from_json((DATA / "dataplane.spec.json")
                                  .read_text()) \
        if name == "dataplane-golden" else \
        next(s for s in _suite_specs() if s.name == name)
    eng = TorchSweepEngine([_prepare(spec, seed)[1] for seed in (0, 7)],
                           device="cpu")
    ix, k = eng.index, eng.consts
    _one_hot_index(k["M_wl"], ix["lvl_of_w"], "lvl_of_w")
    _one_hot_index(k["M_jw"], ix["w0_of_j"], "w0_of_j")
    assert ("pos_hit" in ix) == eng.dp_staging
    if eng.dp_staging:
        _one_hot_index(k["E_hit"], ix["pos_hit"], "pos_hit")
        _one_hot_index(eng.planes["E_miss"], ix["pos_miss"], "pos_miss")


# -- the plain version against the eager engine ----------------------------

@pytest.mark.parametrize("case", list(_cases()))
def test_sweep_ref_equals_eager_engine(case):
    specs, seeds = _cases()[case]
    for eager in _engines(specs, seeds, "cpu"):
        eager.run()
        assert eager.route == "ops"
        fused = TorchSweepEngine(eager.lanes, device="cpu")
        ops.reset_launches()
        with ops._force_route("campaign_sweep", "fused"):
            fused.run()
        assert fused.route == "fused"
        assert not any(ops.LAUNCHES.values())       # CPU: the plain version
        _assert_state_equal(fused.out, eager.out, rel=1e-6)
        if case == "floor":                          # the floor fires
            assert (eager.out["cap_tick"] >= 0).all()
        if case == "nat":
            assert eager.nat_any and (eager.out["nat_ct"] > 0).all()
        if case == "dataplane":
            assert eager.dp_staging and (eager.out["egress_g"] > 0).any()


# every engine batch of the planning library, at full duration (336 h),
# so that each batch is compared after its last timeline event
PLANNING_SEEDS = (0, 1)


def _planning_batches():
    """label -> the lanes of one engine batch, for every batch of
    ``default_suite()`` ("suite-i") and ``pareto_grid()`` ("pareto-i")."""
    out = {}
    for tag, lib in (("suite", scenarios.default_suite),
                     ("pareto", scenarios.pareto_grid)):
        batches = {}
        for spec in lib():
            for seed in PLANNING_SEEDS:
                key, lane = _prepare(spec, seed)
                batches.setdefault(repr(key), []).append(lane)
        out.update({f"{tag}-{i}": lanes
                    for i, lanes in enumerate(batches.values())})
    return out


PLANNING_BATCHES = _planning_batches()


def test_planning_library_spans_ten_engine_batches():
    assert sorted(PLANNING_BATCHES) == [f"pareto-{i}" for i in range(4)] + \
        [f"suite-{i}" for i in range(6)]
    names = {lane.spec.name for lanes in PLANNING_BATCHES.values()
             for lane in lanes}
    assert len(names) == 19 + 12


@pytest.mark.parametrize("batch", sorted(PLANNING_BATCHES))
def test_sweep_ref_equals_eager_engine_on_planning_batches(batch):
    """Integer fields and flags exactly, f32 fields within 1e-6
    relative, on each batch of the planning library."""
    lanes = PLANNING_BATCHES[batch]
    eager = TorchSweepEngine(lanes, device="cpu")
    eager.run()
    assert eager.route == "ops"
    fused = TorchSweepEngine(lanes, device="cpu")
    ops.reset_launches()
    with ops._force_route("campaign_sweep", "fused"):
        fused.run()
    assert fused.route == "fused"
    assert not any(ops.LAUNCHES.values())           # CPU: the plain version
    _assert_state_equal(fused.out, eager.out, rel=1e-6)
    for b in range(eager.B):
        assert fused.lane_events(b) == eager.lane_events(b)


def test_planted_case_reaches_the_normal_branch(monkeypatch):
    """The "hot" case draws with lam > 8 (the rounded-normal branch)."""
    from repro_torch.core import sweep_torch
    seen = []

    def poisson(u, lam):
        seen.append(float(lam.max()))
        return ref.poisson(u, lam)
    monkeypatch.setattr(sweep_torch, "_poisson", poisson)
    specs, seeds = _cases()["hot"]
    eng, = _engines(specs, seeds, "cpu")
    eng.run()
    assert max(seen) > 8 and eng.out["pre_ct"].min() > 0


def test_sweep_ref_direct_call_equals_the_fused_route():
    """``campaign_sweep_ref`` called on ``pack_args`` is the route's
    state before the settle (the route adds the settle to it)."""
    specs, seeds = _cases()["floor"]
    eng, = _engines(specs, seeds, "cpu")
    kw = dict(dt=float(eng.consts["dt"]), nat_any=eng.nat_any,
              dp_active=eng.dp_active, dp_staging=eng.dp_staging)
    state = ref.campaign_sweep_ref(eng.pack_args(), **kw)
    assert set(state) == {name for name, _, _ in ops.SWEEP_STATE}
    with ops._force_route("campaign_sweep", "fused"):
        eng.run()
    for k in ("pre_ct", "fin_ct", "cap_tick", "idle", "busy", "lv"):
        np.testing.assert_array_equal(state[k].numpy(), eng.out[k])


# -- on the JAX engine's draws ---------------------------------------------

def _jax_uniforms(eng):
    import jax
    import jax.numpy as jnp
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(eng.consts["seeds"]))
    G = eng.G
    draw = jax.jit(lambda i: jax.vmap(
        lambda k: jax.random.uniform(jax.random.fold_in(k, i), (G,)))(keys))
    return lambda i: np.array(draw(jnp.int32(i)))


def _assert_fed_jax_counters_equal(case, route):
    from repro.core.spec import CampaignSpec as JaxSpec
    from repro.core.sweep_jax import run_jax
    specs, seeds = _cases()[case]
    lanes = [(JaxSpec.from_json(s.to_json()), seed)
             for s in specs for seed in seeds]
    want = run_jax(lanes, use_pallas=False)
    with ops._force_route("campaign_sweep", route):
        got = run_torch([(s, seed) for s in specs for seed in seeds],
                        device="cpu", uniforms=_jax_uniforms)
    for g, w in zip(got, want):
        for k in INT_COUNTERS:
            assert g[k] == w[k], k
        assert g["by_provider"] == w["by_provider"]
        for k in ("cost", "accel_hours", "egress_usd"):
            assert g[k] == pytest.approx(w[k], rel=1e-5, abs=0.05), k


@pytest.mark.parametrize("case", ["trio", "dataplane"])
def test_fed_jax_uniforms_fused_counters_equal_jax_engine(case):
    _assert_fed_jax_counters_equal(case, "fused")


@pytest.mark.parametrize("route", ["fused", "ops"])
def test_fed_jax_uniforms_hot_case_counters_equal_jax_engine(route):
    """The planted lam > 8 case (the Poisson draw's rounded-normal
    branch, ROADMAP C12) on JAX's draws: the JAX engine's integer
    counters and by_provider on both CPU routes."""
    _assert_fed_jax_counters_equal("hot", route)


# -- the route rule, the wrapper, the entry's argument order ---------------

def test_sweep_route_rule():
    assert ops.sweep_route(torch.device("cuda")) == "fused"
    assert ops.sweep_route("cuda:0") == "fused"
    assert ops.sweep_route(torch.device("cpu")) == "ops"
    assert ops.sweep_route("cuda", use_kernels=False) == "plain"
    assert ops.sweep_route("cpu", use_kernels=False) == "plain"
    with ops._force_route("campaign_sweep", "ops"):
        assert ops.sweep_route("cuda") == "ops"
        assert ops.sweep_route("cuda", use_kernels=False) == "plain"
    with ops._force_route("campaign_sweep", "fused"):
        assert ops.sweep_route("cpu") == "fused"
    assert ops.sweep_route("cuda") == "fused"
    for bad in ("wgmma", "simt", "plain"):
        with pytest.raises(ValueError):
            with ops._force_route("campaign_sweep", bad):
                pass


def test_reset_launches_clears_the_sweep_route_counts():
    assert set(ops.SWEEP_ROUTES) == {"campaign_sweep.fused",
                                     "campaign_sweep.ops"}
    ops.SWEEP_ROUTES["campaign_sweep.ops"] = 4
    ops.LAUNCHES["campaign_sweep"] = 2
    ops.reset_launches()
    assert not any(ops.SWEEP_ROUTES.values())
    assert not any(ops.LAUNCHES.values())


def test_engine_without_a_card_or_a_cpu_request_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    spec = paper_spec(duration_h=24.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchSweepEngine([_prepare(spec, 0)[1]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.sweep([spec], [0])


def test_kernel_argument_order_matches_the_python_tables():
    """The C entry reads its pointers by the Arg enum of
    campaign_sweep_fused.cu: the same names, in the same order, as
    SWEEP_INPUTS, then SWEEP_STATE, then the cells scratch."""
    src = (CSRC / "campaign_sweep_fused.cu").read_text()
    body = re.search(r"enum Arg \{(.*?)\};", src, re.S).group(1)
    names = [n.strip()[1:].lower() for n in
             re.sub(r"//[^\n]*", "", body).split(",") if n.strip()]
    want = [n for n, _, _ in ops.SWEEP_INPUTS + ops.SWEEP_STATE] + \
        ["cells_scratch", "num_args"]
    assert names == [n.replace("_", "").lower() for n in want]


def _packed(case="floor"):
    specs, seeds = _cases()[case]
    eng, = _engines(specs, seeds, "cpu")
    return eng, eng.pack_args(), dict(
        dt=float(eng.consts["dt"]), nat_any=eng.nat_any,
        dp_active=eng.dp_active, dp_staging=eng.dp_staging)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device",
                                 "missing", "both_draws", "no_draws"])
def test_campaign_sweep_rejects_what_the_kernel_does_not_take(bad):
    eng, args, kw = _packed()
    if bad == "dtype":
        args["cap"] = args["cap"].to(torch.int64)
    elif bad == "shape":
        args["rate"] = args["rate"][:, :1]
    elif bad == "contiguity":
        args["nat_g"] = args["nat_g"].t().contiguous().t()
    elif bad == "device":
        args["budget"] = args["budget"].to("meta")
    elif bad == "missing":
        args["minq"] = None
    elif bad == "both_draws":
        args["uniforms"] = torch.zeros((eng.N, eng.B, eng.G))
    else:
        args["seeds"] = None
    with pytest.raises((TypeError, ValueError)):
        ops.campaign_sweep(args, **kw)


def test_campaign_sweep_needs_the_data_plane_inputs_it_is_told_of():
    eng, args, kw = _packed("dataplane")
    assert kw["dp_staging"] and kw["dp_active"]
    for name in ("pos_hit", "pos_miss", "origin_up", "dp_r_g"):
        missing = dict(args, **{name: None})
        with pytest.raises(ValueError, match=name):
            ops.campaign_sweep(missing, **kw)


def test_sweep_reports_its_stage_timings():
    split = {}
    api.sweep([paper_spec(duration_h=24.0)], [0, 1], device="cpu",
              timings=split)
    assert set(split) == {"prepare", "planner", "run", "results"}
    assert all(v >= 0.0 for v in split.values())
    assert split["run"] > 0.0


# -- on the card -------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _numpy_draws(eng):
    draws = np.random.default_rng(eng.B * 7 + eng.N).random(
        (eng.N, eng.B, eng.G), dtype=np.float32)
    return lambda i: draws[i]


@pytest.mark.cuda
@pytest.mark.parametrize("draws", ["own", "hook"])
@pytest.mark.parametrize("case", list(_cases()))
def test_fused_route_equals_ops_and_plain_routes(cuda, case, draws):
    specs, seeds = _cases()[case]
    kw = {} if draws == "own" else {"uniforms": _numpy_draws}
    n_batches = len({repr(_prepare(s, 0)[0]) for s in specs})
    ops.reset_launches()
    fused = api.sweep(specs, seeds, **kw)
    assert ops.LAUNCHES["campaign_sweep"] == n_batches
    assert ops.SWEEP_ROUTES["campaign_sweep.fused"] == n_batches
    assert sum(ops.LAUNCHES.values()) == n_batches    # no per-op launch
    with ops._force_route("campaign_sweep", "ops"):
        by_ops = api.sweep(specs, seeds, **kw)
    assert ops.SWEEP_ROUTES["campaign_sweep.ops"] == n_batches
    plain = api.sweep(specs, seeds, use_kernels=False, **kw)
    for other in (by_ops, plain):
        for a, b in zip(fused.rows, other.rows):
            for k in INT_COUNTERS + ("by_provider", "events_fired"):
                assert a[k] == b[k], k
            for k in ("cost", "accel_hours", "egress_usd"):
                assert a[k] == pytest.approx(b[k], rel=1e-5), k


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_cases()))
def test_fused_kernel_equals_plain_version_on_packed_args(cuda, case):
    """Integer fields and flags exactly; f32 fields within 1e-6 relative
    (the kernel and the plain version sum the egress in the same order,
    so they have read equal)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    specs, seeds = _cases()[case]
    for eng in _engines(specs, seeds, cuda):
        args = eng.pack_args()
        kw = dict(dt=float(eng.consts["dt"]), nat_any=eng.nat_any,
                  dp_active=eng.dp_active, dp_staging=eng.dp_staging)
        before = ops.LAUNCHES["campaign_sweep"]
        got = ops.campaign_sweep(args, **kw)
        torch.cuda.synchronize()
        assert ops.LAUNCHES["campaign_sweep"] == before + 1
        want = ref.campaign_sweep_ref(args, **kw)
        _assert_state_equal({k: v.cpu().numpy() for k, v in got.items()},
                            {k: v.cpu().numpy() for k, v in want.items()},
                            rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", sorted(PLANNING_BATCHES))
def test_fused_route_equals_plain_route_on_planning_batches(cuda, batch):
    """One fused launch a batch; every lane's integer counters,
    by_provider and fired events equal the plain route's, cost,
    accelerator hours and egress within 1e-5 relative."""
    lanes = PLANNING_BATCHES[batch]
    ops.reset_launches()
    fused = TorchSweepEngine(lanes, device=cuda).run()
    assert ops.LAUNCHES["campaign_sweep"] == 1
    assert sum(ops.LAUNCHES.values()) == 1           # no per-op launch
    plain = TorchSweepEngine(lanes, device=cuda, use_kernels=False).run()
    assert plain.route == "plain" and sum(ops.LAUNCHES.values()) == 1
    for b in range(fused.B):
        a, w = fused.lane_results(b), plain.lane_results(b)
        for k in INT_COUNTERS + ("by_provider",):
            assert a[k] == w[k], (batch, b, k)
        assert fused.lane_events(b) == plain.lane_events(b)
        for k in ("cost", "accel_hours", "egress_usd"):
            assert a[k] == pytest.approx(w[k], rel=1e-5), (batch, b, k)
