"""Straggler detection and mitigation.

The port's own copy of the JAX package's ``core/straggler.py`` (which
needs no JAX).  Two consumers:
  * the job overlay (IceCube-style independent tasks): speculative
    re-execution — if a job's elapsed time exceeds ``spec_factor`` x the
    running median of completed jobs, clone it onto an idle pilot and let
    the first copy win (classic backup tasks; ``SpeculativeScheduler``),
  * synchronous training: a per-pod step-time EWMA; a pod persistently
    slower than ``evict_factor`` x the fleet median is proposed for
    eviction from the pool (elastic shrink beats a permanently slow
    step, since a synchronous step runs at the slowest pod's speed;
    ``StragglerMonitor``).  The trainer records its step times here.
"""
from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class SpeculativeScheduler:
    spec_factor: float = 2.0
    min_samples: int = 5
    completed_times: List[float] = field(default_factory=list)
    speculated: int = 0

    def record_completion(self, wall_h: float):
        self.completed_times.append(wall_h)

    def should_speculate(self, elapsed_h: float) -> bool:
        if len(self.completed_times) < self.min_samples:
            return False
        med = statistics.median(self.completed_times)
        if elapsed_h > self.spec_factor * med:
            self.speculated += 1
            return True
        return False


@dataclass
class StragglerMonitor:
    """Per-pod step-time EWMA for synchronous training.

    ``min_pods`` is the eviction floor: shrinking below it would stall
    the whole SPMD job, so :meth:`stragglers` proposes at most
    ``active - min_pods`` evictions (slowest first) and :meth:`evict`
    refuses (returns False) rather than cross the floor."""
    evict_factor: float = 1.5
    ewma_alpha: float = 0.2
    min_steps: int = 10
    min_pods: int = 1
    times: Dict[str, float] = field(default_factory=dict)   # pod -> ewma
    counts: Dict[str, int] = field(default_factory=dict)
    evicted: List[str] = field(default_factory=list)

    def record(self, pod_id: str, step_s: float):
        prev = self.times.get(pod_id)
        self.times[pod_id] = step_s if prev is None else \
            (1 - self.ewma_alpha) * prev + self.ewma_alpha * step_s
        self.counts[pod_id] = self.counts.get(pod_id, 0) + 1

    def active_pods(self) -> List[str]:
        return [p for p in self.times if p not in self.evicted]

    def fleet_median(self) -> Optional[float]:
        vals = [v for k, v in self.times.items() if k not in self.evicted]
        return statistics.median(vals) if vals else None

    def stragglers(self) -> List[str]:
        med = self.fleet_median()
        if med is None:
            return []
        out = []
        for pod, t in self.times.items():
            if pod in self.evicted or self.counts.get(pod, 0) < self.min_steps:
                continue
            if t > self.evict_factor * med:
                out.append(pod)
        # never propose shrinking below the floor: slowest first, at
        # most (active - min_pods) of them
        room = max(0, len(self.active_pods()) - self.min_pods)
        out.sort(key=lambda p: self.times[p], reverse=True)
        return out[:room]

    def evict(self, pod_id: str) -> bool:
        """Evict ``pod_id`` unless already evicted, unknown, or the
        active fleet is at the ``min_pods`` floor; True if evicted."""
        if pod_id in self.evicted or pod_id not in self.times:
            return False
        if len(self.active_pods()) <= self.min_pods:
            return False
        self.evicted.append(pod_id)
        return True
