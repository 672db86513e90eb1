"""What-if campaign specs for pre-burst planning sweeps.

The port's copy of the JAX package's scenario library: every entry
returns ready-made :class:`~repro_torch.core.spec.CampaignSpec`
variants (catalog, spot mix, budget floor, and declarative timeline
events: ramp steps, CE outages, price and workload curves, data-plane
events) with the same names, defaults and spec names, so each spec's
``to_json()`` is byte for byte the JAX package's.  Sweep them with
``api.run(specs, seeds=...)``; on the card each engine batch is one
launch of the fused ``campaign_sweep`` kernel.

The JAX package's deprecated ``Scenario`` dataclass and its
``build_catalog`` / ``sim_config`` / ``run_scenario`` shims feed that
package's numpy object engine, which the port does not carry; they
stay there.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.spec import (PAPER_RAMP_EVENTS, PAPER_TIMELINE,
                                   CacheFlush, CampaignSpec, CEOutage,
                                   DataOrigin, DataPlane, GpuSlicing,
                                   OriginDegrade, OriginOutage, PriceCurve,
                                   SetTarget, WorkloadCurve, paper_spec)

__all__ = ["RampStage", "PAPER_RAMP", "OUTAGE_AT_H", "OUTAGE_DURATION_H",
           "POST_OUTAGE_TARGET", "paper_baseline", "ondemand_fallback",
           "spot_ondemand_mixes", "heterogeneous_burst", "outage_grid",
           "outage_burst", "budget_floor_variants", "price_perturbations",
           "MARKET_CURVES", "price_curve_scenarios", "WORKLOAD_CURVES",
           "workload_curve_scenarios", "workload_burst",
           "gpu_slicing_variants", "curve_sliced_burst", "DATA_PLANES",
           "data_heavy_mix", "origin_outage_grid", "egress_cost_scenarios",
           "dataplane_burst", "planning_grid", "pareto_grid",
           "default_suite"]


# -- the legacy ramp constants, derived from spec.PAPER_TIMELINE -----------

@dataclass
class RampStage:
    start_h: float
    target: int


PAPER_RAMP: Tuple[RampStage, ...] = tuple(
    RampStage(ev.at_h, ev.target) for ev in PAPER_RAMP_EVENTS)
_PAPER_OUTAGE: CEOutage = PAPER_TIMELINE[-1]
OUTAGE_AT_H = _PAPER_OUTAGE.at_h           # the CE host outage (d10.5)
OUTAGE_DURATION_H = _PAPER_OUTAGE.duration_h
POST_OUTAGE_TARGET = _PAPER_OUTAGE.resume_target   # ~20% budget left


def _timeline(ramp: Tuple[RampStage, ...], outage: bool, *,
              outage_at_h: float = OUTAGE_AT_H,
              outage_duration_h: float = OUTAGE_DURATION_H,
              resume_target: int = POST_OUTAGE_TARGET):
    """A ramp (and optionally the CE outage) as timeline events."""
    events = tuple(SetTarget(st.start_h, st.target) for st in ramp)
    if outage:
        events += (CEOutage(outage_at_h, outage_duration_h, resume_target),)
    return events


def _sorted_timeline(*events):
    """Anchor-time-sorted (lint-clean) timeline; engines tie-break
    stably by declaration position either way."""
    return tuple(sorted(events, key=lambda e: e.at_h))


# -- the library (all entries are CampaignSpecs) ---------------------------

def paper_baseline() -> CampaignSpec:
    return paper_spec()


def ondemand_fallback(budget: float = 58000.0) -> CampaignSpec:
    """All on-demand: zero preemptions, ~4.4x the $/GPU-day."""
    return paper_spec(name="ondemand", spot=False, budget=budget)


def spot_ondemand_mixes(fracs: Sequence[float] = (0.1, 0.25, 0.5)
                        ) -> List[CampaignSpec]:
    return [paper_spec(name=f"mix-od{int(f * 100):02d}",
                       ondemand_fraction=f) for f in fracs]


def heterogeneous_burst(capacity_scale: float = 1.0) -> CampaignSpec:
    """The §III mixed T4/V100/P100/M60 pool under the paper's controller."""
    return paper_spec(name="hetero", catalog="heterogeneous",
                      capacity_scale=capacity_scale)


def outage_grid(times_h: Sequence[float] = (60.0, 252.0, 300.0),
                durations_h: Sequence[float] = (2.0, 12.0)
                ) -> List[CampaignSpec]:
    """What if the CE had died earlier / stayed down longer?  The outage
    lands mid-ramp in a time-sorted timeline (lint SPEC103)."""
    return [paper_spec(name=f"outage-t{int(t)}-d{int(d)}",
                       timeline=tuple(sorted(
                           PAPER_RAMP_EVENTS + (
                               CEOutage(t, d, POST_OUTAGE_TARGET),),
                           key=lambda ev: ev.at_h)))
            for t in times_h for d in durations_h]


def outage_burst(at_h: float = 60.0, duration_h: float = 6.0
                 ) -> CampaignSpec:
    """One outage-grid member as a single named spec; the defaults are
    the ``outage-t60-d6`` entry of :func:`default_suite`."""
    return outage_grid((at_h,), (duration_h,))[0]


def budget_floor_variants(floors: Sequence[float] = (0.1, 0.2, 0.3)
                          ) -> List[CampaignSpec]:
    """How early the 'downscale to 1k' tripwire fires vs GPU-days kept."""
    return [paper_spec(name=f"floor{int(f * 100):02d}",
                       budget_floor_fraction=f) for f in floors]


def price_perturbations(factors: Sequence[float] = (0.8, 1.0, 1.25)
                        ) -> List[CampaignSpec]:
    """Uniform spot-price shifts (market drift between planning and
    burst day)."""
    return [paper_spec(name=f"price{int(f * 100):03d}", price_scale=f)
            for f in factors]


#: named multi-day market curves for the two-week window (piecewise-
#: constant daily factors)
MARKET_CURVES: Dict[str, PriceCurve] = {
    # steady upward drift as the burst itself tightens the spot pools
    "drift-up": PriceCurve(((72.0, 1.1), (144.0, 1.25), (240.0, 1.4))),
    # weekday-peak / weekend-dip rhythm
    "weekend-dip": PriceCurve(((96.0, 0.85), (144.0, 1.0),
                               (264.0, 0.85))),
    # the favored provider gets squeezed mid-burst, others stay flat
    "azure-squeeze": PriceCurve(((120.0, 1.5), (216.0, 1.1)),
                                provider="azure"),
}


def price_curve_scenarios(curves: Sequence[str] = tuple(MARKET_CURVES)
                          ) -> List[CampaignSpec]:
    """The paper burst priced under a drifting spot market: one named
    ``PriceCurve`` woven into the paper timeline per variant."""
    return [paper_spec(name=f"curve-{name}",
                       timeline=_sorted_timeline(*PAPER_TIMELINE,
                                                 MARKET_CURVES[name]))
            for name in curves]


#: named request-rate curves (piecewise-constant factors on the CE queue
#: top-up level); factors below ~0.03 starve the queue at full fleet
WORKLOAD_CURVES: Dict[str, WorkloadCurve] = {
    # office-hours rhythm: full demand from 08:00, near-idle from 20:00
    "diurnal": WorkloadCurve(tuple(
        p for d in range(14)
        for p in ((24.0 * d + 8.0, 1.0), (24.0 * d + 20.0, 0.02)))),
    # near-idle background, then a 12 h flash crowd mid-burst
    "flash-crowd": WorkloadCurve(((0.0, 0.05), (120.0, 1.0),
                                  (132.0, 0.05))),
}


def workload_curve_scenarios(curves: Sequence[str] = tuple(WORKLOAD_CURVES)
                             ) -> List[CampaignSpec]:
    """The paper burst serving time-varying demand: one named
    ``WorkloadCurve`` woven into the paper timeline per variant."""
    return [paper_spec(name=f"load-{name}",
                       timeline=_sorted_timeline(*PAPER_TIMELINE,
                                                 WORKLOAD_CURVES[name]))
            for name in curves]


def workload_burst() -> CampaignSpec:
    """Demand and market shifting at once (the golden
    tests/data/workload_curve.spec.json): a drifting spot market and a
    flash-crowd demand profile."""
    return paper_spec(
        name="workload-burst",
        timeline=_sorted_timeline(*PAPER_TIMELINE,
                                  MARKET_CURVES["drift-up"],
                                  WORKLOAD_CURVES["flash-crowd"]))


def gpu_slicing_variants(slices: Sequence[int] = (2, 4, 7)
                         ) -> List[CampaignSpec]:
    """Sub-GPU accounting (Sfiligoi 2022): the same burst planned in
    1/2..1/7-GPU slices instead of whole devices."""
    return [paper_spec(name=f"slice{k}",
                       gpu_slicing=GpuSlicing(slices=k)) for k in slices]


def curve_sliced_burst(slices: int = 4) -> CampaignSpec:
    """The golden tests/data/curve_sliced.spec.json: the §III pool in
    1/4-GPU slices under a drifting market plus a squeeze on the sliced
    Azure T4 pool."""
    return paper_spec(
        name="curve-sliced", catalog="heterogeneous",
        gpu_slicing=GpuSlicing(slices=slices),
        timeline=_sorted_timeline(
            *PAPER_TIMELINE, MARKET_CURVES["drift-up"],
            PriceCurve(((120.0, 1.5), (216.0, 1.1)),
                       provider=f"azure-t4/{slices}")))


#: named data-plane layouts for the t4 catalog (azure/gcp/aws): per-job
#: stage-in bandwidth, cache tiers and per-GB egress
DATA_PLANES: Dict[str, DataPlane] = {
    # one origin per cloud, regional caches on the two majority
    # providers; azure pays the steepest egress on misses
    "federated": DataPlane({
        "azure": DataOrigin(bandwidth_gbps=4.0, egress_usd_per_gb=0.087,
                            cache_hit_rate=0.7,
                            cache_bandwidth_gbps=16.0),
        "gcp": DataOrigin(bandwidth_gbps=3.0, egress_usd_per_gb=0.12,
                          cache_hit_rate=0.5, cache_bandwidth_gbps=12.0),
        "aws": DataOrigin(bandwidth_gbps=3.0, egress_usd_per_gb=0.09),
    }),
    # cache-less worst case: every stage-in streams from the origin
    "no-cache": DataPlane({
        "azure": DataOrigin(bandwidth_gbps=4.0, egress_usd_per_gb=0.087),
        "gcp": DataOrigin(bandwidth_gbps=3.0, egress_usd_per_gb=0.12),
        "aws": DataOrigin(bandwidth_gbps=3.0, egress_usd_per_gb=0.09),
    }),
}


def data_heavy_mix(sizes_gb: Sequence[float] = (2.0, 25.0, 100.0),
                   plane: str = "federated") -> List[CampaignSpec]:
    """The paper burst with per-job input data at photon-table (~2 GB),
    simulation (~25 GB) and raw-readout (~100 GB) sizes."""
    return [paper_spec(name=f"data{int(s):03d}gb", job_input_gb=s,
                       dataplane=DATA_PLANES[plane])
            for s in sizes_gb]


def origin_outage_grid(times_h: Sequence[float] = (60.0, 252.0),
                       durations_h: Sequence[float] = (6.0, 24.0),
                       provider: str = "azure",
                       size_gb: float = 25.0) -> List[CampaignSpec]:
    """What if the favored provider's data origin, not the CE, went
    dark?  Pilots stay up and billed but take no new jobs."""
    return [paper_spec(
                name=f"origin-{provider}-t{int(t)}-d{int(d)}",
                job_input_gb=size_gb,
                dataplane=DATA_PLANES["federated"],
                timeline=_sorted_timeline(*PAPER_RAMP_EVENTS,
                                          OriginOutage(t, d, provider)))
            for t in times_h for d in durations_h]


def egress_cost_scenarios(size_gb: float = 25.0) -> List[CampaignSpec]:
    """The same data-heavy burst with and without regional caches, plus
    a mid-burst cache flush on the favored provider."""
    flush = paper_spec(
        name="egress-flushed", job_input_gb=size_gb,
        dataplane=DATA_PLANES["federated"],
        timeline=_sorted_timeline(*PAPER_TIMELINE,
                                  CacheFlush(180.0, "azure")))
    return [paper_spec(name="egress-cached", job_input_gb=size_gb,
                       dataplane=DATA_PLANES["federated"]),
            paper_spec(name="egress-nocache", job_input_gb=size_gb,
                       dataplane=DATA_PLANES["no-cache"]),
            flush]


def dataplane_burst() -> CampaignSpec:
    """The golden tests/data/dataplane.spec.json: 25 GB a job through the
    federated origins, an azure origin outage, an aws WAN degrade and a
    late azure cache flush."""
    return paper_spec(
        name="dataplane-burst", job_input_gb=25.0,
        dataplane=DATA_PLANES["federated"],
        timeline=_sorted_timeline(*PAPER_TIMELINE,
                                  OriginOutage(98.0, 12.0, "azure"),
                                  OriginDegrade(168.0, 0.5, "aws"),
                                  CacheFlush(250.0, "azure")))


def planning_grid(price_scales: Sequence[float] = (0.8, 0.9, 1.0,
                                                   1.1, 1.25),
                  floors: Sequence[float] = (0.1, 0.2, 0.3, 0.4),
                  budgets: Sequence[float] = (40000.0, 58000.0, 80000.0)
                  ) -> List[CampaignSpec]:
    """Every (price drift x budget floor x budget) paper variant: 60
    specs by default, 1,020 lanes at 17 seeds.  Every member keeps the
    paper catalog and capacity, so the whole grid shares one structural
    batch key and runs as one engine batch."""
    return [paper_spec(
                name=f"grid-p{int(p * 100):03d}-f{int(f * 100):02d}"
                     f"-b{int(b / 1000)}k",
                price_scale=p, budget_floor_fraction=f, budget=b)
            for p in price_scales for f in floors for b in budgets]


def pareto_grid(curves: Sequence[Optional[str]] = (None, "drift-up",
                                                   "azure-squeeze"),
                slices: Sequence[int] = (1, 4),
                planes: Sequence[Optional[str]] = (None, "federated"),
                size_gb: float = 25.0) -> List[CampaignSpec]:
    """The cost-vs-value frontier's candidates: every (market curve x
    GPU slicing x data plane) paper variant, for
    ``analysis.pareto.frontier()`` and ``campaigns pareto``.  ``None``
    means the paper baseline on that axis; 12 specs, 4 engine batches
    by default."""
    specs = []
    for c in curves:
        for k in slices:
            for plane in planes:
                kw = {}
                if c is not None:
                    curve = MARKET_CURVES[c]
                    if curve.provider is not None and k > 1:
                        # slicing renames catalog providers to "name/k";
                        # a provider-targeted curve must follow
                        curve = replace(curve,
                                        provider=f"{curve.provider}/{k}")
                    kw["timeline"] = _sorted_timeline(*PAPER_TIMELINE,
                                                      curve)
                if k > 1:
                    kw["gpu_slicing"] = GpuSlicing(slices=k)
                if plane is not None:
                    kw["dataplane"] = DATA_PLANES[plane]
                    kw["job_input_gb"] = size_gb
                specs.append(paper_spec(
                    name=f"par-{c or 'flat'}-s{k}-{plane or 'nodata'}",
                    **kw))
    return specs


def default_suite() -> List[CampaignSpec]:
    """A representative pre-burst planning suite: the paper baseline plus
    one of each what-if family; 19 specs, 6 engine batches."""
    return [paper_baseline(),
            ondemand_fallback(),
            *spot_ondemand_mixes((0.25,)),
            heterogeneous_burst(),
            *outage_grid((60.0, 300.0), (6.0,)),
            *budget_floor_variants((0.3,)),
            *price_perturbations((0.8, 1.25)),
            *price_curve_scenarios(("drift-up", "azure-squeeze")),
            *workload_curve_scenarios(),
            *gpu_slicing_variants((4,)),
            *data_heavy_mix((25.0,)),
            *origin_outage_grid((60.0,), (6.0,)),
            *egress_cost_scenarios()]
