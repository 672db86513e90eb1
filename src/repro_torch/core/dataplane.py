"""Data-plane spec surface: per-provider origins and the stage-in math.

The port's copy of the frozen spec types a campaign declares its data
plane with (:class:`DataOrigin`, :class:`DataPlane`) and the one
stage-length expression (:func:`stage_ticks`).  A matched job first
stages ``job_input_gb`` in at the origin's (or its cache tier's)
bandwidth, rounded up to whole ticks; each cache miss pays the origin's
per-GB egress price.  The sweep engine models stage-in as a front
extension of the progress axis (see core/sweep_torch.py).
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass
from typing import Mapping, Optional, Tuple

__all__ = ["DataOrigin", "DataPlane", "stage_ticks"]


@dataclass(frozen=True)
class DataOrigin:
    """The data origin serving one provider's regions: WAN bandwidth in
    Gbit/s per pilot transfer, per-GB egress price for cache misses,
    the regional cache's hit rate in [0, 1] (0 disables it) and the
    cache tier's bandwidth (0 falls back to the origin bandwidth)."""
    bandwidth_gbps: float
    egress_usd_per_gb: float = 0.0
    cache_hit_rate: float = 0.0
    cache_bandwidth_gbps: float = 0.0


@dataclass(frozen=True)
class DataPlane:
    """Provider name -> :class:`DataOrigin`.  Accepts a mapping or an
    iterable of (name, origin) pairs and normalizes to a name-sorted
    tuple so equal planes compare and serialize identically."""
    origins: Tuple[Tuple[str, DataOrigin], ...] = ()

    def __post_init__(self):
        items = (self.origins.items()
                 if isinstance(self.origins, Mapping) else self.origins)
        norm = []
        for name, origin in items:
            if isinstance(origin, Mapping):
                origin = DataOrigin(**origin)
            norm.append((str(name), origin))
        norm.sort(key=lambda kv: kv[0])
        object.__setattr__(self, "origins", tuple(norm))

    def origin_for(self, provider: str) -> Optional[DataOrigin]:
        """The origin serving ``provider`` (sliced pools like
        ``azure/4`` inherit their base provider's origin), or None."""
        base = provider.split("/", 1)[0]
        for name, origin in self.origins:
            if name == provider or name == base:
                return origin
        return None

    def to_dict(self) -> dict:
        return {"origins": {name: asdict(o) for name, o in self.origins}}

    @classmethod
    def from_dict(cls, d: Mapping) -> "DataPlane":
        d = dict(d)
        origins = d.pop("origins", {})
        if d:
            raise ValueError(f"unknown DataPlane fields {sorted(d)}")
        items = origins.items() if isinstance(origins, Mapping) else origins
        return cls(tuple((name, DataOrigin(**dict(o)))
                         for name, o in items))


def stage_ticks(size_gb: float, gbps: float, dt_h: float) -> int:
    """Whole ticks to stage ``size_gb`` at ``gbps``: transfer hours =
    GB * 8 bits / (Gbit/s) / 3600, rounded up to ticks (>= 1 for any
    positive transfer — a job never starts the tick it matched)."""
    if size_gb <= 0.0 or gbps <= 0.0 or dt_h <= 0.0:
        return 0
    hours = size_gb * 8.0 / gbps / 3600.0
    return max(1, int(math.ceil(hours / dt_h - 1e-9)))
