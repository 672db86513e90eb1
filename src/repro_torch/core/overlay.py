"""OSG Compute Element + glideinWMS-style overlay workload management.

The port's own copy of the JAX package's ``core/overlay.py`` (which needs
no JAX; the port imports nothing of that package).  Federation principle
(paper §II): resources — wherever provisioned — run a standard pilot
that registers with a single Compute Element; user jobs only ever see
the CE. The CE matchmaker hands queued jobs to idle pilots holding a
live lease.

Leases model the HTCondor TCP connections: a pilot renews its lease every
``lease_interval_s``; if the instance's provider NAT drops idle connections
sooner (Azure: 240 s) the pilot is disconnected and its job preempted — the
paper's one real operational bug. The fix is the paper's fix: configure
``lease_interval_s`` below the provider NAT timeout.

The JAX package's CE also takes a data-plane runtime (stage-in, origin
outages) that only its per-instance engines drive; the port's sweep
engine models the data plane in its count planes, so this copy has no
data-plane hook.  ``recorder`` takes any object with the JAX package's
``TraceRecorder`` methods (``pilot_registered``, ``nat_drop``,
``job_finished``).

Invariants:
  * a job is never running on a pilot without a live lease
  * a pilot runs at most one job; a job runs on at most one pilot
  * every preempted job returns to the queue (nothing is lost silently)
"""
from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Job:
    id: int
    wall_h: float                     # remaining work (checkpoint-aware)
    policy: str = "icecube"           # CE access policy tag
    checkpoint_period_h: float = 1.0  # work is durable in these increments
    done_h: float = 0.0
    attempts: int = 0
    finished_at: Optional[float] = None

    @property
    def finished(self) -> bool:
        return self.finished_at is not None


@dataclass
class Pilot:
    id: int
    instance_id: int
    provider: str
    lease_interval_s: float
    nat_timeout_s: float
    registered_at: float = 0.0
    last_renew: float = 0.0
    job: Optional[Job] = None
    dead: bool = False

    @property
    def connected(self) -> bool:
        """Registration always succeeds (the initial TCP handshake is not
        idle); the connection SURVIVES a running job only if lease renewals
        beat the NAT idle timeout — the drop manifests mid-job, exactly as
        the paper observed ('constant preemption of the user jobs')."""
        return self.lease_interval_s < self.nat_timeout_s

    @property
    def idle(self) -> bool:
        return not self.dead and self.job is None


class ComputeElement:
    """HTCondor-CE analogue with a single stated policy (paper §II:
    'registered it in OSG with the stated policy of only accepting IceCube
    jobs')."""

    def __init__(self, accept_policy: str = "icecube",
                 lease_interval_s: float = 120.0, recorder=None):
        self.accept_policy = accept_policy
        self.lease_interval_s = lease_interval_s
        # optional recorder; RNG-free, attaching it never changes the run
        self.recorder = recorder
        self.queue: collections.deque = collections.deque()
        self.pilots: Dict[int, Pilot] = {}
        self.finished: List[Job] = []
        self.preemption_events = 0
        self.nat_drop_events = 0
        self._pilot_ids = 0
        self._job_ids = 0
        self.outage = False

    # -- job / pilot lifecycle -------------------------------------------
    def next_job_id(self) -> int:
        """Monotonic job-ID source, unique across re-queues."""
        self._job_ids += 1
        return self._job_ids

    def submit(self, job: Job):
        if job.policy != self.accept_policy:
            raise PermissionError(
                f"CE policy {self.accept_policy!r} rejects {job.policy!r}")
        self._job_ids = max(self._job_ids, job.id)
        self.queue.append(job)

    def register_pilot(self, instance_id: int, provider: str,
                       nat_timeout_s: float, now_h: float) -> Pilot:
        self._pilot_ids += 1
        p = Pilot(self._pilot_ids, instance_id, provider,
                  self.lease_interval_s, nat_timeout_s,
                  registered_at=now_h, last_renew=now_h)
        self.pilots[p.id] = p
        if self.recorder is not None:
            self.recorder.pilot_registered(now_h, p.id, instance_id,
                                           provider)
        return p

    def pilot_lost(self, pilot_id: int, now_h: float):
        """Instance preempted / NAT dropped: job returns to queue; work since
        the last checkpoint is lost (graceful spot handling, paper §II)."""
        p = self.pilots.get(pilot_id)
        if p is None or p.dead:
            return
        p.dead = True
        if p.job is not None and not p.job.finished:
            j = p.job
            j.done_h = (j.done_h // j.checkpoint_period_h) \
                * j.checkpoint_period_h
            self.queue.appendleft(j)
            self.preemption_events += 1
        p.job = None

    # -- matchmaking / progress -------------------------------------------
    def match(self, now_h: float) -> int:
        """Assign queued jobs to idle connected pilots. Returns #matches."""
        if self.outage:
            return 0
        n = 0
        for p in self.pilots.values():
            if not self.queue:
                break
            if not p.idle:
                continue
            job = self.queue.popleft()
            job.attempts += 1
            p.job = job
            n += 1
        return n

    def advance(self, dt_h: float, now_h: float):
        """Progress running jobs by dt; handle NAT-dropped pilots."""
        for p in list(self.pilots.values()):
            if p.dead:
                continue
            if not p.connected and p.job is not None:
                # idle TCP connection outlived the NAT timeout mid-job
                self.nat_drop_events += 1
                if self.recorder is not None:
                    self.recorder.nat_drop(now_h, p.id, p.instance_id,
                                           p.provider)
                self.pilot_lost(p.id, now_h)
                continue
            if p.job is not None:
                j = p.job
                j.done_h += dt_h
                if j.done_h >= j.wall_h:
                    j.finished_at = now_h
                    self.finished.append(j)
                    if self.recorder is not None:
                        self.recorder.job_finished(now_h, j.id, j.attempts)
                    p.job = None

    # -- views ---------------------------------------------------------------
    def busy_by_provider(self) -> Dict[str, int]:
        """#pilots currently running a job, per provider."""
        out: Dict[str, int] = {}
        for p in self.pilots.values():
            if not p.dead and p.job is not None:
                out[p.provider] = out.get(p.provider, 0) + 1
        return out

    def stats(self) -> dict:
        live = [p for p in self.pilots.values() if not p.dead]
        return {"pilots_live": len(live),
                "pilots_busy": sum(1 for p in live if p.job is not None),
                "queued": len(self.queue),
                "finished": len(self.finished),
                "preemptions": self.preemption_events,
                "nat_drops": self.nat_drop_events}
