"""Elastic pod-pool -> mesh management: the elastic VM fleet of the
paper, as pods of a synchronous training mesh.

The port of the JAX package's ``core/elastic.py``.  The provisioning
unit is a pod slice. Preemption granularity == provisioning granularity
== the "pod" mesh axis, so synchronous training survives fleet changes
by:

  1. PodPool: membership ledger fed by the provisioner/pilots (join, leave,
     preemption-notice) with listener callbacks,
  2. ElasticRunner: on membership change — drain (gather the state to the
     host), checkpoint, rebuild the mesh for the new pod count, re-shard
     state (``distribute_tensor`` with the rules' placements; checkpoints
     are sharding-agnostic), rebuild the step (cached by pod count),
     resume at the same global batch size.

Goodput accounting mirrors the paper's operational stance: preempted work
since the last checkpoint is lost, everything else is durable.

``drive_pool(trace, pool, runner)`` replays a campaign's
preemption/join stream (a :class:`~repro_torch.core.events.CampaignTrace`,
e.g. read from the JAX package's ``to_jsonl``) into a :class:`PodPool` +
runner, turning a what-if campaign into an elastic-training goodput
study (:class:`GoodputReport`).  ``PodPool``, ``SimulatedElasticRunner``,
``GoodputReport`` and ``drive_pool`` are the JAX package's, line for
line: their reports equal its reports on the same trace.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import sharding as sh
from repro_torch.core.events import (InstanceLaunched, InstancePreempted,
                                     InstanceStopped)
from repro_torch.launch.mesh import make_elastic_mesh
from repro_torch.sharding_ctx import check_device_type
from repro_torch.tree import map_tree


def checkpoint_floor(done, ckpt):
    """Work surviving a preemption: floored to the last durable
    checkpoint increment (the JAX package's ``core/fleet.py``)."""
    return np.floor_divide(done, ckpt) * ckpt


@dataclass
class PodPool:
    """Membership of healthy pods (slices). Thread-free; callers drive it."""
    min_pods: int = 1
    max_pods: int = 64
    pods: Dict[str, float] = field(default_factory=dict)  # id -> joined_at
    draining: Dict[str, float] = field(default_factory=dict)
    listeners: List[Callable[[int], None]] = field(default_factory=list)
    rejected_joins: int = 0      # joins refused because the pool was full

    def on_change(self, cb: Callable[[int], None]):
        self.listeners.append(cb)

    def _notify(self):
        n = self.size
        for cb in self.listeners:
            cb(n)

    @property
    def size(self) -> int:
        return len(self.pods)

    def join(self, pod_id: str, now: float = 0.0) -> bool:
        """Admit a pod; returns whether membership actually changed.
        A join refused at ``max_pods`` is observable (False +
        ``rejected_joins``) so capacity-bound provisioning loops can see
        the clip instead of silently over-offering."""
        if pod_id in self.pods:
            return False
        if len(self.pods) >= self.max_pods:
            self.rejected_joins += 1
            return False
        self.pods[pod_id] = now
        self._notify()
        return True

    def preemption_notice(self, pod_id: str, now: float = 0.0):
        """Cloud 30s-2min warning: mark draining; runner checkpoints before
        the pod disappears."""
        if pod_id in self.pods:
            self.draining[pod_id] = now

    def leave(self, pod_id: str, now: float = 0.0):
        self.draining.pop(pod_id, None)
        if self.pods.pop(pod_id, None) is not None:
            self._notify()


def _host(tree):
    """A host copy of a tree of DTensors or tensors, leaf by leaf (each
    DTensor gathered over its mesh: every rank of the mesh calls it)."""
    def one(t):
        if isinstance(t, DTensor):
            t = t.full_tensor()
        return t.detach().to("cpu", copy=True)
    return map_tree(one, tree)


class ElasticRunner:
    """Owns sharded train state across pod-count changes.

    Every rank of the world runs the same program and drives its own
    runner identically (the ``PodPool`` and its callbacks included).  A
    mesh of ``n_pods`` pods covers the world's first ``n_pods *
    prod(pod_shape)`` ranks; a rank outside the current mesh holds no
    state, and its ``step`` returns ``None``."""

    def __init__(self, step_builder, params_host, opt_host, *,
                 pod_shape=(16, 16), checkpointer=None,
                 device_type: str = "cuda"):
        """step_builder(mesh) -> fn(params, opt, batch) -> (p', o', m) on
        trees of DTensors (``launch.steps.make_mesh_train_step``).
        params_host/opt_host: host trees of full tensors — the
        sharding-agnostic source of truth at rebuild time (only the
        mesh's first rank's values are read: ``distribute_tensor``
        scatters from it)."""
        self.device_type = check_device_type(device_type)
        self.step_builder = step_builder
        self.pod_shape = pod_shape
        self.checkpointer = checkpointer
        self._host = {"params": params_host, "opt": opt_host}
        self._step_cache = {}
        self._mesh_cache = {}
        self._formed = False
        self.mesh = None
        self.params = None
        self.opt = None
        self.n_pods = 0
        self.rebuilds = 0
        self.lost_steps = 0
        # last rebuild's wall time; 0.0 before the first ensure()
        self.rebuild_s = 0.0

    # -- (re)build ------------------------------------------------------------
    def ensure(self, n_pods: int, force: bool = False):
        """Drain/rebuild for ``n_pods`` pods; no-op when the count is
        unchanged.  ``force=True`` rebuilds even at the same count — a
        same-size member *swap* (pod preempted, replacement joined)
        changes the device set, so the state re-shards and the step
        re-forms.  A mesh is made once per pod count and reused: the
        world's ranks are fixed, so a swap cannot change the ranks a mesh
        covers.  Collective over the whole world."""
        if not force and n_pods == self.n_pods and self._formed:
            return False
        t0 = time.time()
        if self.params is not None:
            # drain: pull current state to host before the fleet changes,
            # and free the device copy before the new one is placed
            self._host = {"params": _host(self.params),
                          "opt": _host(self.opt)}
            self.params = self.opt = None
            if self.device_type == "cuda":
                torch.cuda.empty_cache()
        if n_pods not in self._mesh_cache:
            # the world is fixed, so a mesh over the same first ranks is
            # the same mesh: one per pod count, its groups made once
            self._mesh_cache[n_pods] = make_elastic_mesh(
                n_pods, pod_shape=self.pod_shape,
                device_type=self.device_type)
        self.mesh = self._mesh_cache[n_pods]
        if self.mesh is not None:          # else this rank sits it out
            self.params = self._place(self._host["params"],
                                      sh.param_shardings)
            self.opt = self._place(self._host["opt"], sh.opt_shardings)
        if force or n_pods not in self._step_cache:
            # a forced rebuild means a new device set: a cached step
            # built against the old mesh would be stale
            self._step_cache[n_pods] = (None if self.mesh is None
                                        else self.step_builder(self.mesh))
        self.n_pods = n_pods
        self._formed = True
        self.rebuilds += 1
        if self.device_type == "cuda":
            torch.cuda.synchronize()
        self.rebuild_s = time.time() - t0
        return True

    def _place(self, host, rules):
        """The host tree as DTensors placed by ``rules``; a copy, so that
        the steps' in-place updates never reach the host tree (on a CPU
        mesh ``distribute_tensor`` would keep the host storage)."""
        shardings = rules(host, self.mesh)
        return map_tree(
            lambda x, s: distribute_tensor(
                x.to(self.device_type, copy=True), self.mesh, s.placements),
            host, shardings)

    def step(self, batch):
        fn = self._step_cache[self.n_pods]
        if fn is None:
            return None
        self.params, self.opt, metrics = fn(self.params, self.opt, batch)
        return metrics

    def _trees(self):
        """The full state on the host (collective over the mesh), or None
        on every rank but the mesh's first, which writes checkpoints."""
        trees = {"params": _host(self.params), "opt": _host(self.opt)}
        first = int(self.mesh.mesh.flatten()[0])
        return trees if dist.get_rank() == first else None

    def checkpoint(self, step):
        if self.checkpointer is not None and self.mesh is not None:
            trees = self._trees()
            if trees is not None:
                self.checkpointer.save_async(step, trees)

    def handle_preemption(self, step):
        """Preemption notice: durable state NOW (blocking — the pod may
        vanish in 30 s)."""
        if self.checkpointer is not None and self.mesh is not None:
            trees = self._trees()
            if trees is not None:
                self.checkpointer.save_blocking(step, trees)


class SimulatedElasticRunner:
    """Accounting-only stand-in for :class:`ElasticRunner`: the same
    counters and control surface ``drive_pool`` needs (``ensure`` /
    ``handle_preemption`` / ``rebuilds`` / ``rebuild_s`` /
    ``lost_steps``), with a fixed per-rebuild cost instead of real
    mesh/re-shard work — so campaign traces replay into elastic-training
    what-ifs without devices.  Swap in a real ``ElasticRunner`` and the
    same ``drive_pool`` call drives actual mesh rebuilds."""

    def __init__(self, *, rebuild_s: float = 30.0):
        self._fixed_rebuild_s = rebuild_s
        self.n_pods = 0
        self.rebuilds = 0
        self.lost_steps = 0
        self.rebuild_s = 0.0
        self.checkpoints = 0
        self.blocking_checkpoints = 0

    def ensure(self, n_pods: int, force: bool = False) -> bool:
        if not force and n_pods == self.n_pods:
            return False
        self.n_pods = n_pods
        self.rebuilds += 1
        self.rebuild_s = self._fixed_rebuild_s
        return True

    def checkpoint(self, step):
        self.checkpoints += 1

    def handle_preemption(self, step):
        """Preemption-notice response: one blocking checkpoint."""
        self.blocking_checkpoints += 1


@dataclass(frozen=True)
class GoodputReport:
    """Elastic-training accounting for one replayed campaign trace.

    Steps are global synchronous-SPMD steps; ``goodput_fraction``
    compares net completed steps against an ideal uninterrupted run of
    the same wall-clock length (so fleet-empty gaps — e.g. a CE outage
    — and rebuild downtime and lost work all show up as goodput)."""
    wall_h: float
    pod_hours: float
    steps_done: float
    steps_lost: float
    rebuilds: int
    rebuild_downtime_s: float
    preemptions: int
    graceful_leaves: int
    joins: int
    joins_rejected: int
    peak_pods: int
    goodput_fraction: float

    def to_dict(self) -> dict:
        return asdict(self)


def drive_pool(trace, pool: PodPool, runner, *, step_time_s: float = 2.0,
               checkpoint_period_s: float = 600.0, notice: bool = True,
               providers: Optional[tuple] = None) -> GoodputReport:
    """Replay a campaign's instance stream into an elastic pod pool.

    ``trace`` is a :class:`~repro_torch.core.events.CampaignTrace`
    (the JAX package's ``api.run(spec, collect="trace")``); every ``InstanceLaunched``
    offers a pod to ``pool`` (clips observably at ``max_pods``), every
    ``InstancePreempted`` runs the preemption-notice path
    (notice -> blocking checkpoint -> leave -> drain/rebuild via
    ``runner.ensure``), and every ``InstanceStopped`` is a graceful
    leave.  Between events the global training step advances whenever
    the pool holds at least ``pool.min_pods`` pods, minus pending
    rebuild downtime; async checkpoints land every
    ``checkpoint_period_s`` of progress.

    ``notice=True`` models the cloud's 30 s-2 min warning being honored
    (checkpoint completes, nothing is lost); ``notice=False`` models
    hard kills — work since the last periodic checkpoint is lost, the
    simulator's own ``checkpoint_floor`` stance.  ``providers``
    optionally restricts which trace instances become pods (e.g. only
    the on-demand carve-out).  Membership changes sharing one timestamp
    coalesce into a single drain -> rebuild (``runner.ensure(size,
    force=True)``), mirroring how a staged ramp joins hundreds of pods
    behind one mesh rebuild — and a same-size member *swap*
    (k preemptions + k replacement launches in one tick) still rebuilds:
    the device set changed even though the pod count did not.
    """
    ckpt_steps = max(checkpoint_period_s, step_time_s) / step_time_s
    min_active = max(1, pool.min_pods)
    steps = 0.0
    lost = 0.0
    last_ckpt = 0.0
    pod_hours = 0.0
    downtime_pending = 0.0
    downtime_total = 0.0
    joins = rejected = preempts = leaves = peak = rebuilds = 0
    t = 0.0

    def advance(to_h: float):
        nonlocal t, steps, last_ckpt, pod_hours, downtime_pending
        dt_h = to_h - t
        if dt_h <= 0:
            return
        pod_hours += pool.size * dt_h
        if pool.size >= min_active:
            active_s = dt_h * 3600.0
            used = min(downtime_pending, active_s)
            downtime_pending -= used
            steps += (active_s - used) / step_time_s
            last_ckpt = max(last_ckpt,
                            float(checkpoint_floor(steps, ckpt_steps)))
        t = to_h

    evs = trace.events
    i, n = 0, len(evs)
    while i < n:
        t_ev = evs[i].t
        advance(t_ev)
        changed = False            # any membership churn this timestamp
        while i < n and evs[i].t == t_ev:
            ev = evs[i]
            i += 1
            if isinstance(ev, InstanceLaunched):
                if providers is not None and ev.provider not in providers:
                    continue
                pod_id = f"i{ev.instance}"
                if pod_id in pool.pods:      # idempotent re-offer, not a
                    continue                 # capacity refusal
                if pool.join(pod_id, now=t_ev):
                    joins += 1
                    changed = True
                else:
                    rejected += 1
            elif isinstance(ev, InstancePreempted):
                pod_id = f"i{ev.instance}"
                if pod_id not in pool.pods:
                    continue
                preempts += 1
                changed = True
                pool.preemption_notice(pod_id, t_ev)
                if notice:
                    runner.handle_preemption(int(steps))
                    last_ckpt = steps
                else:
                    dropped = steps - last_ckpt
                    lost += dropped
                    steps = last_ckpt
                    runner.lost_steps += int(dropped)
                pool.leave(pod_id, t_ev)
            elif isinstance(ev, InstanceStopped):
                pod_id = f"i{ev.instance}"
                if pod_id in pool.pods:
                    leaves += 1
                    changed = True
                    pool.leave(pod_id, t_ev)
        peak = max(peak, pool.size)
        if changed and pool.size >= min_active:
            # any membership change re-forms the mesh — force covers the
            # same-size member swap, where the device set changed but
            # the pod count did not
            if runner.ensure(pool.size, force=True):
                rebuilds += 1
                downtime_pending += runner.rebuild_s
                downtime_total += runner.rebuild_s
    advance(trace.duration_h)
    ideal_steps = trace.duration_h * 3600.0 / step_time_s
    return GoodputReport(
        wall_h=round(trace.duration_h, 2),
        pod_hours=round(pod_hours, 1),
        steps_done=round(steps, 1),
        steps_lost=round(lost, 1),
        rebuilds=rebuilds,
        rebuild_downtime_s=round(downtime_total, 1),
        preemptions=preempts,
        graceful_leaves=leaves,
        joins=joins,
        joins_rejected=rejected,
        peak_pods=peak,
        goodput_fraction=round(steps / max(ideal_steps, 1e-9), 4))
