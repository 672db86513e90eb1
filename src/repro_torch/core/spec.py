"""One declarative, serializable description of a campaign: CampaignSpec.

The port's copy of the JAX package's spec surface.  ``CampaignSpec()``
with no arguments is the paper replay: T4 catalog, $58k budget, staged
ramp to 2k GPUs, the d10.5 CE outage and the 20 %-budget-floor
downscale.  Specs round-trip through JSON byte for byte with the JAX
package's ``to_json`` output, which is how the two packages exchange
campaigns.  Results come back typed as :class:`CampaignResult`.
"""
from __future__ import annotations

import json
from collections.abc import Mapping as MappingABC
from dataclasses import asdict, dataclass, fields, replace
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core.dataplane import DataOrigin, DataPlane  # noqa: F401
from repro_torch.core.provider import (T4_FP32_TFLOPS, ProviderSpec,
                                       RegionSpec, heterogeneous_catalog,
                                       slice_provider, t4_catalog)
from repro_torch.core.timeline import (BudgetFloor, CacheFlush,  # noqa: F401
                                       CapacityShift, CEOutage, Event,
                                       OriginDegrade, OriginOutage,
                                       PriceCurve, PriceShift, SetTarget,
                                       WorkloadCurve, event_from_dict,
                                       event_to_dict, validate_event)

SCHEMA_VERSION = 1

#: the budget ledger's alert levels (remaining fraction), descending;
#: the budget-floor tripwire is checked when one of them is crossed
LEDGER_THRESHOLDS: Tuple[float, ...] = (0.5, 0.25, 0.2, 0.1, 0.05)

# IceCube baseline for the "approximate doubling" claim (abstract/Fig 2):
# ~9M GPU-h/yr of IceCube's own and OSG resources -> ~350k per 2 weeks
ICECUBE_BASELINE_GPUH_PER_2W = 9e6 * (14 / 365.0)

# §V summary claims a paper replay is compared against
PAPER_CLAIMS = {"cost": 58000.0, "accel_days": 16000.0,
                "eflop_hours_fp32": 3.1, "doubling": 2.0}


@dataclass(frozen=True)
class GpuSlicing:
    """Sub-GPU slicing (Sfiligoi 2022): each matched provider becomes a
    ``name/k`` variant whose regions hold ``k`` slices per physical GPU,
    priced and rated at ``1/k`` of the device times the overhead
    factors.  ``providers=None`` slices the whole catalog."""
    slices: int = 2
    providers: Optional[Tuple[str, ...]] = None
    price_factor: float = 1.0    # per-slice $ = price/slices * this
    tflops_factor: float = 1.0   # per-slice peak = tflops/slices * this


# the paper's staged ramp (§IV), then the CE host's outage at d10.5 and
# the resume at 1k GPUs
PAPER_RAMP_EVENTS: Tuple[SetTarget, ...] = (
    SetTarget(0.0, 40), SetTarget(12.0, 400), SetTarget(48.0, 900),
    SetTarget(96.0, 1200), SetTarget(144.0, 1600), SetTarget(192.0, 2000))
PAPER_TIMELINE: Tuple[Event, ...] = PAPER_RAMP_EVENTS + (
    CEOutage(252.0, 2.0, 1000),)


@dataclass(frozen=True)
class CampaignSpec:
    """One campaign, fully declared; defaults reproduce the paper replay."""
    name: str = "paper"
    # catalog: named ("t4" | "heterogeneous") or inline provider tuple
    catalog: str = "t4"
    providers: Optional[Tuple[ProviderSpec, ...]] = None
    capacity_scale: float = 1.0          # multiply every region's capacity
    spot: bool = True                    # spot (paper) vs on-demand pricing
    ondemand_fraction: float = 0.0       # capacity share carved into
    #                                      preemption-free on-demand pools
    price_scale: float = 1.0             # static price perturbation
    budget: float = 58000.0
    budget_floor_fraction: float = 0.2   # initial tripwire arming ...
    downscale_target: int = 1000         # ... and its cap target
    duration_h: float = 14 * 24.0
    dt_h: float = 0.25                   # 15-minute ticks
    lease_interval_s: float = 120.0      # < Azure NAT 240 s (post-fix)
    job_wall_h: float = 4.0
    job_checkpoint_h: float = 1.0
    min_queue: int = 4000                # CE queue top-up level per tick
    overhead_per_day: float = 390.0      # CE VM, storage, egress
    accel_tflops: float = T4_FP32_TFLOPS
    gpu_slicing: Optional[GpuSlicing] = None
    timeline: Tuple[Event, ...] = PAPER_TIMELINE
    # data plane: per-job input staged in before compute starts, against
    # the per-provider origins (None = pure-compute jobs)
    job_input_gb: float = 0.0
    dataplane: Optional[DataPlane] = None

    def to_spec(self) -> "CampaignSpec":
        return self

    def validate(self) -> "CampaignSpec":
        if self.providers is None and self.catalog not in (
                "t4", "heterogeneous"):
            raise ValueError(f"unknown catalog {self.catalog!r}")
        if self.duration_h <= 0 or self.dt_h <= 0:
            raise ValueError("duration_h and dt_h must be positive")
        if self.budget <= 0:
            raise ValueError("campaigns need a positive budget")
        if self.gpu_slicing is not None:
            if not isinstance(self.gpu_slicing, GpuSlicing):
                raise ValueError(
                    f"gpu_slicing must be a GpuSlicing, "
                    f"got {self.gpu_slicing!r}")
            if self.gpu_slicing.slices < 1:
                raise ValueError("gpu_slicing.slices must be >= 1")
        if self.job_input_gb < 0:
            raise ValueError("job_input_gb must be >= 0")
        if self.dataplane is not None:
            if not isinstance(self.dataplane, DataPlane):
                raise ValueError(
                    f"dataplane must be a DataPlane, got {self.dataplane!r}")
            for name, o in self.dataplane.origins:
                if o.bandwidth_gbps <= 0:
                    raise ValueError(
                        f"origin {name!r} needs a positive bandwidth_gbps")
                if o.egress_usd_per_gb < 0 or o.cache_bandwidth_gbps < 0:
                    raise ValueError(
                        f"origin {name!r} has a negative price/bandwidth")
                if not 0.0 <= o.cache_hit_rate <= 1.0:
                    raise ValueError(
                        f"origin {name!r} cache_hit_rate outside [0, 1]")
        for ev in self.timeline:
            validate_event(ev)
        return self

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        d = {"schema_version": SCHEMA_VERSION}
        for f in fields(self):
            v = getattr(self, f.name)
            if f.name == "timeline":
                d[f.name] = [event_to_dict(ev) for ev in v]
            elif f.name == "providers":
                # JSON has no infinity: an unset NAT timeout is null
                d[f.name] = None if v is None else [
                    {**asdict(p), "nat_idle_timeout_s":
                     None if p.nat_idle_timeout_s == float("inf")
                     else p.nat_idle_timeout_s} for p in v]
            elif f.name == "gpu_slicing":
                d[f.name] = None if v is None else asdict(v)
            elif f.name == "dataplane":
                if v is not None:          # omitted at default
                    d[f.name] = v.to_dict()
            elif f.name == "job_input_gb":
                if v != 0.0:
                    d[f.name] = v
            else:
                d[f.name] = v
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent,
                          allow_nan=False) + "\n"

    @classmethod
    def from_dict(cls, d: Mapping) -> "CampaignSpec":
        d = dict(d)
        version = d.pop("schema_version", SCHEMA_VERSION)
        if version != SCHEMA_VERSION:
            raise ValueError(f"unsupported spec schema_version {version!r}")
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown CampaignSpec fields {sorted(unknown)}")
        if d.get("timeline") is not None:
            d["timeline"] = tuple(event_from_dict(ev)
                                  for ev in d["timeline"])
        if d.get("dataplane") is not None and not isinstance(
                d["dataplane"], DataPlane):
            d["dataplane"] = DataPlane.from_dict(d["dataplane"])
        if d.get("gpu_slicing") is not None:
            g = dict(d["gpu_slicing"])
            if g.get("providers") is not None:
                g["providers"] = tuple(g["providers"])
            d["gpu_slicing"] = GpuSlicing(**g)
        if d.get("providers") is not None:
            d["providers"] = tuple(
                ProviderSpec(**{
                    **p,
                    "nat_idle_timeout_s":
                        float("inf")
                        if p.get("nat_idle_timeout_s") is None
                        else p["nat_idle_timeout_s"],
                    "regions": tuple(RegionSpec(**r)
                                     for r in p["regions"])})
                for p in d["providers"])
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "CampaignSpec":
        return cls.from_dict(json.loads(s))


def paper_spec(**overrides) -> CampaignSpec:
    """The paper's two-week exercise as a spec; overrides replace fields."""
    return replace(CampaignSpec(), **overrides) if overrides \
        else CampaignSpec()


# -- catalog construction --------------------------------------------------

def _scale_capacity(cat: Dict[str, ProviderSpec],
                    f: float) -> Dict[str, ProviderSpec]:
    if f == 1.0:
        return cat
    return {name: replace(p, regions=tuple(
        replace(r, capacity=max(1, int(r.capacity * f)))
        for r in p.regions)) for name, p in cat.items()}


def _scale_prices(cat: Dict[str, ProviderSpec],
                  f: float) -> Dict[str, ProviderSpec]:
    if f == 1.0:
        return cat
    return {name: replace(p, spot_price_per_day=p.spot_price_per_day * f,
                          ondemand_price_per_day=p.ondemand_price_per_day * f)
            for name, p in cat.items()}


def _apply_slicing(cat: Dict[str, ProviderSpec], sl: Optional[GpuSlicing],
                   default_tflops: float) -> Dict[str, ProviderSpec]:
    """Replace each matched provider with its ``name/k`` slice variant;
    unmatched providers keep offering whole GPUs."""
    if sl is None or sl.slices == 1:
        return cat
    out: Dict[str, ProviderSpec] = {}
    for name, p in cat.items():
        if sl.providers is None or name in sl.providers:
            sp = slice_provider(p, sl.slices,
                                price_factor=sl.price_factor,
                                tflops_factor=sl.tflops_factor,
                                default_tflops=default_tflops)
            out[sp.name] = sp
        else:
            out[name] = p
    return out


def _split_ondemand(cat: Dict[str, ProviderSpec],
                    frac: float) -> Dict[str, ProviderSpec]:
    """Carve ``frac`` of every region's capacity into a preemption-free
    on-demand pool beside the remaining spot capacity."""
    if frac <= 0.0:
        return cat
    out: Dict[str, ProviderSpec] = {}
    for name, p in cat.items():
        spot_regions = []
        od_regions = []
        for r in p.regions:
            od_cap = max(1, int(r.capacity * frac))
            spot_cap = max(1, r.capacity - od_cap)
            spot_regions.append(replace(r, capacity=spot_cap))
            od_regions.append(RegionSpec(r.name, od_cap, 0.0, 1.0))
        out[name] = replace(p, regions=tuple(spot_regions))
        out[f"{name}-od"] = replace(
            p, name=f"{p.name}-od",
            spot_price_per_day=p.ondemand_price_per_day,
            regions=tuple(od_regions))
    return out


def build_catalog(spec) -> Dict[str, ProviderSpec]:
    """The spec's provider catalog with its static transforms applied."""
    spec = spec.to_spec()
    if spec.providers is not None:
        cat = {p.name: p for p in spec.providers}
    elif spec.catalog == "t4":
        cat = t4_catalog()
    elif spec.catalog == "heterogeneous":
        cat = heterogeneous_catalog()
    else:
        raise ValueError(f"unknown catalog {spec.catalog!r}")
    cat = _apply_slicing(cat, spec.gpu_slicing, spec.accel_tflops)
    cat = _scale_capacity(cat, spec.capacity_scale)
    cat = _scale_prices(cat, spec.price_scale)
    cat = _split_ondemand(cat, spec.ondemand_fraction)
    return cat


# -- typed results ---------------------------------------------------------

@dataclass(frozen=True)
class BudgetReport:
    """The CloudBank 'single window' totals."""
    total_spent: float
    by_provider: Mapping[str, float]
    remaining: float
    remaining_fraction: float
    overdraft: float

    def to_dict(self) -> dict:
        return {"total_spent": self.total_spent,
                "by_provider": dict(self.by_provider),
                "remaining": self.remaining,
                "remaining_fraction": self.remaining_fraction,
                "overdraft": self.overdraft}


_RESULT_KEYS = ("accel_hours", "accel_days", "busy_hours",
                "busy_hours_by_provider", "eflop_hours_fp32", "cost",
                "cost_per_accel_day", "preemptions", "nat_drops",
                "jobs_finished", "egress_usd", "stagein_hours",
                "cache_hit_fraction", "budget", "by_provider")


@dataclass(frozen=True)
class CampaignResult(MappingABC):
    """Typed campaign totals; also a read-only mapping with the engines'
    ``results()`` keys (``res["cost"]``)."""
    accel_hours: float
    accel_days: float
    busy_hours: float
    busy_hours_by_provider: Mapping[str, float]
    eflop_hours_fp32: float
    cost: float
    cost_per_accel_day: float
    preemptions: int
    nat_drops: int
    jobs_finished: int
    egress_usd: float
    stagein_hours: float
    cache_hit_fraction: float
    budget: BudgetReport
    by_provider: Mapping[str, int]
    # provenance (not part of the results mapping)
    spec: Optional[CampaignSpec] = None
    seed: Optional[int] = None
    engine: str = "torch"
    events_fired: Tuple[dict, ...] = ()

    @classmethod
    def from_results(cls, res: Mapping, *, spec=None, seed=None,
                     engine: str = "torch",
                     events_fired: Tuple[dict, ...] = ()
                     ) -> "CampaignResult":
        """Wrap an engine's ``results()`` dict."""
        return cls(budget=BudgetReport(**res["budget"]),
                   spec=spec, seed=seed, engine=engine,
                   events_fired=events_fired,
                   **{k: res[k] for k in _RESULT_KEYS if k != "budget"})

    def to_dict(self) -> dict:
        d = {k: getattr(self, k) for k in _RESULT_KEYS}
        d["budget"] = self.budget.to_dict()
        d["busy_hours_by_provider"] = dict(self.busy_hours_by_provider)
        d["by_provider"] = dict(self.by_provider)
        return d

    def doubling_factor(self) -> float:
        """Cloud GPU-hours on top of IceCube's contemporaneous baseline
        ('approximate doubling', abstract/Fig 2)."""
        return 1 + self.busy_hours / ICECUBE_BASELINE_GPUH_PER_2W

    def compare_paper(self) -> Dict[str, dict]:
        """{claim: {sim, paper, err_pct}} for the §V summary numbers."""
        sims = {"cost": self.cost, "accel_days": self.accel_days,
                "eflop_hours_fp32": self.eflop_hours_fp32,
                "doubling": self.doubling_factor()}
        return {k: {"sim": sims[k], "paper": PAPER_CLAIMS[k],
                    "err_pct": round(
                        100 * (sims[k] - PAPER_CLAIMS[k]) / PAPER_CLAIMS[k],
                        2)}
                for k in PAPER_CLAIMS}

    def __getitem__(self, k):
        if k not in _RESULT_KEYS:
            raise KeyError(k)
        return self.budget.to_dict() if k == "budget" else getattr(self, k)

    def __iter__(self):
        return iter(_RESULT_KEYS)

    def __len__(self):
        return len(_RESULT_KEYS)
