"""Typed, replayable campaign event traces: the ``CampaignTrace`` type.

A copy of what the elastic replay needs from the JAX package's
``core/events.py`` (which imports no JAX; the port keeps its own copy
all the same): one frozen dataclass per event kind, each with a stable
``kind`` tag and field schema; ``event_to_dict`` / ``event_from_dict``;
and :class:`CampaignTrace`, every event of one (spec, seed) campaign in
canonical order, serializable to JSONL.  ``CampaignTrace.from_jsonl``
reads the JAX package's ``to_jsonl`` output, and ``to_jsonl`` gives it
back byte for byte.  The port's engines collect no trace yet: the
recorder is not copied.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, Iterator, Mapping, Optional, Tuple, Union

TRACE_SCHEMA_VERSION = 1

# -- the typed events ------------------------------------------------------

@dataclass(frozen=True)
class InstanceLaunched:
    """A cloud instance (one group-provisioned VM/slice) started."""
    t: float
    instance: int
    provider: str
    region: str

    kind = "launch"


@dataclass(frozen=True)
class InstanceStopped:
    """Graceful scale-down/deprovision stop (not a preemption): the
    instance was billed to ``t`` and its pilot drained normally."""
    t: float
    instance: int
    provider: str
    region: str

    kind = "stop"


@dataclass(frozen=True)
class InstancePreempted:
    """Spot preemption: the provider reclaimed the instance at ``t``
    (cloud notice semantics: 30 s - 2 min warning before the kill)."""
    t: float
    instance: int
    provider: str
    region: str

    kind = "preempt"


@dataclass(frozen=True)
class PilotRegistered:
    """A pilot on ``instance`` registered with the Compute Element.
    ``pilot`` is the 1-based global registration order — identical
    across engines."""
    t: float
    pilot: int
    instance: int
    provider: str

    kind = "pilot"


@dataclass(frozen=True)
class NatDrop:
    """The pilot's idle lease connection outlived the provider NAT
    timeout mid-job (the paper's Azure 240 s bug); its job re-queued."""
    t: float
    pilot: int
    instance: int
    provider: str

    kind = "nat_drop"


@dataclass(frozen=True)
class StageInStarted:
    """A matched pilot began staging its job's input: ``gb`` at the
    origin (``cache_hit=False``, billable egress) or the regional cache
    tier (``cache_hit=True``) — the data-plane provenance behind the
    ``cache_hit_fraction`` result column."""
    t: float
    pilot: int
    gb: float
    cache_hit: bool
    provider: str

    kind = "stagein"


@dataclass(frozen=True)
class StageInFinished:
    """The pilot's stage-in completed; its job starts progressing this
    tick."""
    t: float
    pilot: int

    kind = "stagein_done"


@dataclass(frozen=True)
class EgressBilled:
    """One tick's cache-miss egress for one provider, charged to the
    budget ledger next to the GPU-hour billing (``usd = gb *
    egress_usd_per_gb``, the engine-shared float contract)."""
    t: float
    provider: str
    gb: float
    usd: float

    kind = "egress"


@dataclass(frozen=True)
class JobFinished:
    """A job completed its wall hours at ``t`` (``attempts`` counts
    matches, i.e. 1 + re-queues survived)."""
    t: float
    job: int
    attempts: int

    kind = "job_done"


@dataclass(frozen=True)
class PriceChanged:
    """A billing-rate change fired from the spec timeline: cumulative
    ``PriceShift`` (``absolute=False``, uniform) or a ``PriceCurve``
    breakpoint (``absolute=True``, optionally per-provider)."""
    t: float
    factor: float
    provider: Optional[str] = None
    absolute: bool = False

    kind = "price"


@dataclass(frozen=True)
class TimelineEventFired:
    """Any other executed controller event (``scale`` / ``outage_on`` /
    ``outage_off`` / ``capacity`` / ``floor`` / ``budget_floor``) with
    its structured payload — the events_fired provenance, typed."""
    t: float
    event: str
    payload: Mapping = field(default_factory=dict)

    kind = "timeline"


TraceEvent = Union[InstanceLaunched, InstanceStopped, InstancePreempted,
                   PilotRegistered, NatDrop, StageInStarted,
                   StageInFinished, EgressBilled, JobFinished,
                   PriceChanged, TimelineEventFired]

TRACE_EVENT_KINDS: Dict[str, type] = {
    cls.kind: cls for cls in (InstanceLaunched, InstanceStopped,
                              InstancePreempted, PilotRegistered, NatDrop,
                              StageInStarted, StageInFinished, EgressBilled,
                              JobFinished, PriceChanged, TimelineEventFired)}


def event_to_dict(ev: TraceEvent) -> dict:
    d = asdict(ev)
    if ev.kind == "timeline":
        d["payload"] = dict(d["payload"])
    return {"kind": ev.kind, **d}


def event_from_dict(d: Mapping) -> TraceEvent:
    d = dict(d)
    kind = d.pop("kind", None)
    cls = TRACE_EVENT_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown trace event kind {kind!r}")
    return cls(**d)


# -- canonical JSONL lines ---------------------------------------------------

def dump_line(obj: Mapping) -> str:
    """One canonical compact JSON line: sorted keys, fixed separators,
    no NaN — equal dicts always serialize to equal bytes."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)


def trace_header(name: str, seed: int, duration_h: float, dt_h: float,
                 n_events: int) -> dict:
    """The JSONL meta header dict (first line of every serialized
    trace; carries the campaign identity, never the engine)."""
    return {"schema_version": TRACE_SCHEMA_VERSION,
            "kind": "campaign_trace", "name": name, "seed": int(seed),
            "duration_h": float(duration_h), "dt_h": float(dt_h),
            "events": int(n_events)}


# -- the frozen artifact ---------------------------------------------------

@dataclass(frozen=True)
class CampaignTrace:
    """Every event of one (spec, seed) campaign, in canonical order.

    The serialized form carries no engine tag: the JAX package's three
    engines emit the same bytes."""
    name: str
    seed: int
    duration_h: float
    dt_h: float
    events: Tuple[TraceEvent, ...] = ()

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[TraceEvent]:
        return iter(self.events)

    def filter(self, *kinds: str) -> Tuple[TraceEvent, ...]:
        """Events of the given kind tag(s), trace order preserved."""
        unknown = set(kinds) - set(TRACE_EVENT_KINDS)
        if unknown:
            raise ValueError(f"unknown trace event kinds {sorted(unknown)}")
        return tuple(ev for ev in self.events if ev.kind in kinds)

    def counts(self) -> Dict[str, int]:
        """{kind: occurrences}, every known kind present (0 included)."""
        out = {k: 0 for k in TRACE_EVENT_KINDS}
        for ev in self.events:
            out[ev.kind] += 1
        return out

    # -- serialization -----------------------------------------------------
    def to_jsonl(self) -> str:
        """One meta header line + one compact JSON object per event.
        ``sort_keys`` + fixed separators make the bytes canonical: equal
        traces serialize to equal strings, whichever engine emitted them."""
        lines = [dump_line(trace_header(self.name, self.seed,
                                        self.duration_h, self.dt_h,
                                        len(self.events)))]
        lines.extend(dump_line(event_to_dict(ev)) for ev in self.events)
        return "\n".join(lines) + "\n"

    @classmethod
    def from_jsonl(cls, text: str) -> "CampaignTrace":
        lines = [ln for ln in text.splitlines() if ln.strip()]
        if not lines:
            raise ValueError("empty trace stream")
        head = json.loads(lines[0])
        if head.get("kind") != "campaign_trace":
            raise ValueError("not a campaign trace (missing meta header)")
        version = head.get("schema_version")
        if version != TRACE_SCHEMA_VERSION:
            raise ValueError(f"unsupported trace schema_version {version!r}")
        events = tuple(event_from_dict(json.loads(ln)) for ln in lines[1:])
        if len(events) != head.get("events"):
            raise ValueError(
                f"truncated trace: header promises {head.get('events')} "
                f"events, stream has {len(events)}")
        return cls(name=head["name"], seed=head["seed"],
                   duration_h=head["duration_h"], dt_h=head["dt_h"],
                   events=events)
