"""One declarative registry for every timed campaign event.

Each timed spec event is registered once: its frozen dataclass, its
compiled ``(t, op_kind, arg)`` form, its JSON decode coercions and its
validation.  Each compiled op is registered once too, as an ``apply``
body that drives an :class:`EngineOps` adapter and returns the
provenance record body.  The sweep engine's planner adapter
(``sweep_torch.TorchLaneOps``) runs these bodies ahead of time to bake
per-segment parameter planes, and again after the run to rebuild
``events_fired``, so the records match the JAX package's engines record
for record.  The registry contents mirror the JAX package's
``core/timeline.py`` (same kinds, same op order, same record bodies).
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import (Any, Callable, Dict, List, Mapping, Optional, Protocol,
                    Sequence, Tuple, Union)

__all__ = ["EngineOps", "SetTarget", "CEOutage", "PriceShift",
           "BudgetFloor", "CapacityShift", "PriceCurve", "WorkloadCurve",
           "OriginOutage", "OriginDegrade", "CacheFlush", "Event",
           "OpSpec", "EventType", "REGISTRY", "OPS",
           "register_op", "register_event", "compile_event",
           "compile_timeline", "apply_op", "apply_budget_cap",
           "event_to_dict", "event_from_dict", "validate_event"]


class EngineOps(Protocol):
    """What an engine must expose for the timeline to drive it."""

    budget_capped: bool       # has the budget floor fired?
    downscale_target: int     # cap applied to targets once fired

    def scale_to(self, n: int) -> None: ...
    def deprovision_all(self) -> None: ...
    def set_outage(self, on: bool) -> None: ...
    def scale_prices(self, factor: float) -> None: ...
    def set_price_factor(self, provider: Optional[str],
                         factor: float) -> None: ...
    def scale_capacity(self, factor: float) -> None: ...
    def arm_budget_floor(self, fraction: float, target: int) -> None: ...
    def set_workload_factor(self, factor: float) -> None: ...
    def set_origin_outage(self, provider: str, on: bool) -> None: ...
    def degrade_origin(self, provider: str, factor: float) -> None: ...
    def flush_cache(self, provider: str) -> None: ...


# -- the event dataclasses -------------------------------------------------

@dataclass(frozen=True)
class SetTarget:
    """Scale the global fleet target (staged-ramp step); capped at the
    downscale target once the budget floor has fired."""
    at_h: float
    target: int

    kind = "set_target"


@dataclass(frozen=True)
class CEOutage:
    """Total CE backend collapse at ``at_h``: deprovision everything,
    resume at ``resume_target`` once the outage clears."""
    at_h: float
    duration_h: float = 2.0
    resume_target: int = 1000

    kind = "ce_outage"


@dataclass(frozen=True)
class PriceShift:
    """Uniform market drift: every $/day is multiplied by ``factor``."""
    at_h: float
    factor: float

    kind = "price_shift"


@dataclass(frozen=True)
class BudgetFloor:
    """(Re)arm the budget tripwire: once remaining budget crosses
    ``fraction``, cap the fleet at ``downscale_target``."""
    at_h: float
    fraction: float
    downscale_target: int

    kind = "budget_floor"


@dataclass(frozen=True)
class CapacityShift:
    """Every region's spot capacity is multiplied by ``factor``
    (floored at 1 instance)."""
    at_h: float
    factor: float

    kind = "capacity_shift"


@dataclass(frozen=True)
class PriceCurve:
    """Piecewise-constant price factors, *set* (absolute) at each
    ``(t_h, factor)`` breakpoint; ``provider=None`` drives every
    provider, a name drives that provider's groups only."""
    points: Tuple[Tuple[float, float], ...]
    provider: Optional[str] = None

    kind = "price_curve"

    @property
    def at_h(self) -> float:
        return self.points[0][0] if self.points else 0.0


@dataclass(frozen=True)
class WorkloadCurve:
    """Request rate over time: the CE queue tops up to
    ``int(min_queue * factor)`` from each breakpoint on."""
    points: Tuple[Tuple[float, float], ...]

    kind = "workload_curve"

    @property
    def at_h(self) -> float:
        return self.points[0][0] if self.points else 0.0


@dataclass(frozen=True)
class OriginOutage:
    """The ``provider``'s data origin goes dark: its pilots take no new
    jobs for ``duration_h``."""
    at_h: float
    duration_h: float = 2.0
    provider: str = "azure"

    kind = "origin_outage"


@dataclass(frozen=True)
class OriginDegrade:
    """The ``provider`` origin's miss bandwidth is multiplied by
    ``factor`` (cumulative)."""
    at_h: float
    factor: float = 0.5
    provider: str = "azure"

    kind = "origin_degrade"


@dataclass(frozen=True)
class CacheFlush:
    """The ``provider``'s regional cache is flushed: every pilot's hit
    rotation restarts."""
    at_h: float
    provider: str = "azure"

    kind = "cache_flush"


# -- registry plumbing -----------------------------------------------------

@dataclass(frozen=True)
class OpSpec:
    """One compiled timeline operation: ``apply(ops, arg)`` drives an
    :class:`EngineOps` adapter and returns the provenance-record body;
    ``requires`` names the EngineOps members it uses."""
    kind: str                              # compiled op tag
    event: str                             # record "event" field value
    requires: Tuple[str, ...]              # EngineOps members used
    apply: Callable[[Any, Any], dict]


@dataclass(frozen=True)
class EventType:
    """One registered timed-event kind."""
    kind: str
    cls: type
    compile: Callable[[Any], List[tuple]]  # ev -> [(t, op_kind, arg)]
    ops: Tuple[str, ...]                   # op kinds compile may emit
    decode: Callable[[dict], dict]         # JSON kwargs coercion
    validate: Callable[[Any], None]        # raises ValueError


REGISTRY: Dict[str, EventType] = {}
OPS: Dict[str, OpSpec] = {}


def register_op(op: OpSpec) -> OpSpec:
    if op.kind in OPS:
        raise ValueError(f"duplicate op kind {op.kind!r}")
    OPS[op.kind] = op
    return op


def register_event(et: EventType) -> EventType:
    if et.kind in REGISTRY:
        raise ValueError(f"duplicate event kind {et.kind!r}")
    unknown = set(et.ops) - set(OPS)
    if unknown:
        raise ValueError(f"event {et.kind!r} compiles to unregistered "
                         f"ops {sorted(unknown)}")
    REGISTRY[et.kind] = et
    return et


def _identity(d: dict) -> dict:
    return d


def _no_validate(ev):
    return None


def _decode_points(d: dict) -> dict:
    d = dict(d)
    d["points"] = tuple((float(t), float(f)) for t, f in d["points"])
    return d


def _validate_points(ev):
    for p in ev.points:
        if len(p) != 2:
            raise ValueError(f"{type(ev).__name__} points must be "
                             f"(t_h, factor) pairs, got {p!r}")


# -- the operations --------------------------------------------------------

def _apply_scale(ops, arg) -> dict:
    tgt = min(int(arg), int(ops.downscale_target)) \
        if ops.budget_capped else int(arg)
    ops.scale_to(tgt)
    return {"event": "scale", "target": int(tgt)}


def _apply_outage_on(ops, arg) -> dict:
    ops.set_outage(True)
    ops.deprovision_all()
    return {"event": "outage_on"}


def _apply_outage_off(ops, arg) -> dict:
    ops.set_outage(False)
    ops.scale_to(int(arg))
    return {"event": "outage_off", "target": int(arg)}


def _apply_price(ops, arg) -> dict:
    ops.scale_prices(arg)
    return {"event": "price", "factor": float(arg)}


def _apply_curve(ops, arg) -> dict:
    provider, f = arg
    ops.set_price_factor(provider, f)
    return {"event": "price_curve", "provider": provider,
            "factor": float(f)}


def _apply_capacity(ops, arg) -> dict:
    ops.scale_capacity(arg)
    return {"event": "capacity", "factor": float(arg)}


def _apply_floor(ops, arg) -> dict:
    fraction, tgt = arg
    ops.arm_budget_floor(fraction, tgt)
    return {"event": "floor", "fraction": float(fraction),
            "target": int(tgt)}


def _apply_workload(ops, arg) -> dict:
    ops.set_workload_factor(arg)
    return {"event": "workload", "factor": float(arg)}


def _apply_origin_on(ops, arg) -> dict:
    ops.set_origin_outage(arg, True)
    return {"event": "origin_outage_on", "provider": str(arg)}


def _apply_origin_off(ops, arg) -> dict:
    ops.set_origin_outage(arg, False)
    return {"event": "origin_outage_off", "provider": str(arg)}


def _apply_origin_degrade(ops, arg) -> dict:
    provider, f = arg
    ops.degrade_origin(provider, f)
    return {"event": "origin_degrade", "provider": str(provider),
            "factor": float(f)}


def _apply_cache_flush(ops, arg) -> dict:
    ops.flush_cache(arg)
    return {"event": "cache_flush", "provider": str(arg)}


register_op(OpSpec("scale", "scale",
                   ("scale_to", "budget_capped", "downscale_target"),
                   _apply_scale))
register_op(OpSpec("outage_on", "outage_on",
                   ("set_outage", "deprovision_all"), _apply_outage_on))
register_op(OpSpec("outage_off", "outage_off",
                   ("set_outage", "scale_to"), _apply_outage_off))
register_op(OpSpec("price", "price", ("scale_prices",), _apply_price))
register_op(OpSpec("curve", "price_curve", ("set_price_factor",),
                   _apply_curve))
register_op(OpSpec("capacity", "capacity", ("scale_capacity",),
                   _apply_capacity))
register_op(OpSpec("floor", "floor", ("arm_budget_floor",), _apply_floor))
register_op(OpSpec("workload", "workload", ("set_workload_factor",),
                   _apply_workload))
register_op(OpSpec("origin_on", "origin_outage_on", ("set_origin_outage",),
                   _apply_origin_on))
register_op(OpSpec("origin_off", "origin_outage_off",
                   ("set_origin_outage",), _apply_origin_off))
register_op(OpSpec("origin_degrade", "origin_degrade", ("degrade_origin",),
                   _apply_origin_degrade))
register_op(OpSpec("cache_flush", "cache_flush", ("flush_cache",),
                   _apply_cache_flush))


# -- the event registrations -----------------------------------------------

register_event(EventType(
    SetTarget.kind, SetTarget,
    compile=lambda ev: [(ev.at_h, "scale", ev.target)],
    ops=("scale",), decode=_identity, validate=_no_validate))
register_event(EventType(
    CEOutage.kind, CEOutage,
    compile=lambda ev: [(ev.at_h, "outage_on", 0),
                        (ev.at_h + ev.duration_h, "outage_off",
                         ev.resume_target)],
    ops=("outage_on", "outage_off"), decode=_identity,
    validate=_no_validate))
register_event(EventType(
    PriceShift.kind, PriceShift,
    compile=lambda ev: [(ev.at_h, "price", ev.factor)],
    ops=("price",), decode=_identity, validate=_no_validate))
register_event(EventType(
    BudgetFloor.kind, BudgetFloor,
    compile=lambda ev: [(ev.at_h, "floor",
                         (ev.fraction, ev.downscale_target))],
    ops=("floor",), decode=_identity, validate=_no_validate))
register_event(EventType(
    CapacityShift.kind, CapacityShift,
    compile=lambda ev: [(ev.at_h, "capacity", ev.factor)],
    ops=("capacity",), decode=_identity, validate=_no_validate))
register_event(EventType(
    PriceCurve.kind, PriceCurve,
    # one op per breakpoint, at its own time
    compile=lambda ev: [(t, "curve", (ev.provider, f))
                        for t, f in ev.points],
    ops=("curve",), decode=_decode_points, validate=_validate_points))
register_event(EventType(
    WorkloadCurve.kind, WorkloadCurve,
    compile=lambda ev: [(t, "workload", f) for t, f in ev.points],
    ops=("workload",), decode=_decode_points, validate=_validate_points))
register_event(EventType(
    OriginOutage.kind, OriginOutage,
    compile=lambda ev: [(ev.at_h, "origin_on", ev.provider),
                        (ev.at_h + ev.duration_h, "origin_off",
                         ev.provider)],
    ops=("origin_on", "origin_off"), decode=_identity,
    validate=_no_validate))
register_event(EventType(
    OriginDegrade.kind, OriginDegrade,
    compile=lambda ev: [(ev.at_h, "origin_degrade",
                         (ev.provider, ev.factor))],
    ops=("origin_degrade",), decode=_identity, validate=_no_validate))
register_event(EventType(
    CacheFlush.kind, CacheFlush,
    compile=lambda ev: [(ev.at_h, "cache_flush", ev.provider)],
    ops=("cache_flush",), decode=_identity, validate=_no_validate))


Event = Union[SetTarget, CEOutage, PriceShift, BudgetFloor, CapacityShift,
              PriceCurve, WorkloadCurve, OriginOutage, OriginDegrade,
              CacheFlush]


# -- registry-derived operations -------------------------------------------

def compile_event(ev) -> List[tuple]:
    """One event's ``(t, op_kind, arg)`` expansion, in declaration
    order (CEOutage becomes on/off at its declaration point)."""
    et = REGISTRY.get(getattr(ev, "kind", None))
    if et is None or type(ev) is not et.cls:
        raise ValueError(f"unknown timeline event {ev!r}")
    return et.compile(ev)


def compile_timeline(timeline: Sequence) -> List[tuple]:
    """Flatten an event timeline into stably time-sorted
    ``(t, op_kind, arg)`` tuples (ties keep timeline position)."""
    evs: List[tuple] = []
    for ev in timeline:
        evs.extend(compile_event(ev))
    evs.sort(key=lambda e: e[0])
    return evs


def apply_op(ops: EngineOps, op_kind: str, arg, now: float) -> dict:
    """Execute one compiled op against an engine adapter; returns the
    provenance record."""
    body = OPS[op_kind].apply(ops, arg)
    return {"t": float(now), **body}


def apply_budget_cap(ops: EngineOps, now: float) -> dict:
    """The budget-floor tripwire's deferred cap: cap the fleet at the
    armed downscale target."""
    tgt = int(ops.downscale_target)
    ops.scale_to(tgt)
    return {"t": float(now), "event": "budget_floor", "target": tgt}


def event_to_dict(ev) -> dict:
    """JSON form: ``{"kind": ..., **fields}``."""
    return {"kind": ev.kind, **asdict(ev)}


def event_from_dict(d: Mapping):
    d = dict(d)
    kind = d.pop("kind")
    et = REGISTRY.get(kind)
    if et is None:
        raise ValueError(f"unknown timeline event kind {kind!r}")
    return et.cls(**et.decode(d))


def validate_event(ev):
    """Raise ValueError on unregistered or malformed events."""
    et = REGISTRY.get(getattr(ev, "kind", None))
    if et is None or type(ev) is not et.cls:
        raise ValueError(f"unknown timeline event {ev!r}")
    et.validate(ev)
