"""Multi-cloud group provisioning with the paper's semantics (§II).

The port's own copy of the JAX package's ``core/provisioner.py`` (which
needs no JAX; the port imports nothing of that package):

  "All three Cloud providers offer group provisioning mechanisms with very
   similar semantics. [...] All three allowed us to set the desired number
   of instances in a specific region, and they would provision as many as
   available at that point in time; no further operator intervention was
   needed. [...] we would typically instantiate one group mechanism per
   region."

``InstanceGroup`` is that uniform abstraction (VMSS / InstanceGroups /
SpotFleet behind one interface); ``MultiCloudProvisioner`` spreads a global
target across groups by price priority (the paper "heavily favored Azure" —
cheapest spot T4 with spare capacity), charges the budget ledger per
instance-hour, and supports instant fleet-wide de-provisioning ("instructing
the various Cloud-native group mechanisms to keep zero active instances" —
the paper's CE-outage response).

``recorder`` takes any object with ``launched`` / ``stopped`` /
``preempted`` methods of the JAX package's ``TraceRecorder`` signature;
the port keeps no recorder of its own.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field, replace
from typing import Dict, Iterator, List, Optional

from repro_torch.core.budget import BudgetLedger
from repro_torch.core.provider import ProviderSpec, RegionSpec


@dataclass
class Instance:
    id: int
    provider: str
    region: str
    started_at: float            # hours
    preempted_at: Optional[float] = None
    stopped_at: Optional[float] = None
    last_charged: float = 0.0    # hours already billed

    @property
    def alive(self) -> bool:
        return self.preempted_at is None and self.stopped_at is None

    def runtime_h(self, now: float) -> float:
        end = self.preempted_at if self.preempted_at is not None else \
            (self.stopped_at if self.stopped_at is not None else now)
        return max(0.0, end - self.started_at)


@dataclass
class InstanceGroup:
    """One Cloud-native group mechanism in one region."""
    provider: ProviderSpec
    region: RegionSpec
    target: int = 0
    instances: Dict[int, Instance] = field(default_factory=dict)
    retired: List[Instance] = field(default_factory=list)
    # ID source; a standalone group numbers from 0, a provisioner hands
    # every group one shared counter so IDs are engine-unique and each
    # sim starts from 0 regardless of process history
    ids: Iterator[int] = field(default_factory=itertools.count)
    # optional recorder (shared across groups by the provisioner);
    # RNG-free, so attaching it never changes the campaign
    recorder: Optional[object] = None

    @property
    def running(self) -> List[Instance]:
        return [i for i in self.instances.values() if i.alive]

    def compact(self):
        """Move dead, fully-billed instances out of the live dict so
        ``bill()``/``running`` stop rescanning every instance ever
        created (a two-week replay creates ~100k of them)."""
        dead = [i for i in self.instances.values()
                if not i.alive and i.last_charged >= (
                    i.preempted_at if i.preempted_at is not None
                    else i.stopped_at)]
        if len(dead) * 4 > len(self.instances):
            for i in dead:
                del self.instances[i.id]
            self.retired.extend(dead)

    def set_target(self, n: int, now: float):
        """Provider semantics: fill to min(target, capacity available),
        immediately, no operator intervention."""
        self.target = max(0, n)
        live = self.running
        fillable = min(self.target, self.region.capacity)
        if len(live) < fillable:
            for _ in range(fillable - len(live)):
                inst = Instance(next(self.ids), self.provider.name,
                                self.region.name, now, last_charged=now)
                self.instances[inst.id] = inst
                if self.recorder is not None:
                    self.recorder.launched(now, inst.id,
                                           self.provider.name,
                                           self.region.name)
        elif len(live) > self.target:
            for inst in live[self.target:]:
                inst.stopped_at = now
                if self.recorder is not None:
                    self.recorder.stopped(now, inst.id,
                                          self.provider.name,
                                          self.region.name)

    def preempt(self, inst_id: int, now: float):
        inst = self.instances.get(inst_id)
        if inst is not None and inst.alive:
            inst.preempted_at = now
            if self.recorder is not None:
                self.recorder.preempted(now, inst.id, self.provider.name,
                                        self.region.name)

    def utilization(self) -> float:
        return len(self.running) / max(1, self.region.capacity)


class MultiCloudProvisioner:
    """Price-priority distribution of a global instance target across all
    (provider, region) groups, with per-hour spot billing into the ledger."""

    def __init__(self, catalog: Dict[str, ProviderSpec],
                 ledger: Optional[BudgetLedger] = None,
                 spot: bool = True, recorder=None):
        self.catalog = catalog
        self.ledger = ledger
        self.spot = spot
        ids = itertools.count()
        self.groups: List[InstanceGroup] = [
            InstanceGroup(prov, region, ids=ids, recorder=recorder)
            for prov in catalog.values() for region in prov.regions]
        # cheapest first; stable for determinism
        self.groups.sort(key=lambda g: (self._price(g.provider),
                                        g.provider.name, g.region.name))
        self.global_target = 0
        # cumulative uniform market drift (spec.PriceShift events); kept
        # as one scalar so the price-priority group order is unaffected
        self.price_scale = 1.0
        # absolute per-provider curve factors (spec.PriceCurve events);
        # stack multiplicatively on the uniform scalar
        self.curve_factor: Dict[str, float] = {}

    def _price(self, prov: ProviderSpec) -> float:
        return (prov.spot_price_per_day if self.spot
                else prov.ondemand_price_per_day)

    def scale_prices(self, factor: float):
        """Uniform price shift from now on (already-billed hours keep
        their old price) — the spec timeline's ``PriceShift`` op."""
        self.price_scale *= factor

    def set_price_factor(self, provider: Optional[str], factor: float):
        """Set the absolute curve factor for one provider (or all, when
        ``provider`` is None) — the spec timeline's ``PriceCurve`` op.
        Unlike ``scale_prices`` this *replaces* the previous curve value
        rather than compounding on it."""
        if provider is None:
            for name in self.catalog:
                self.curve_factor[name] = factor
        else:
            self.curve_factor[provider] = factor

    def scale_capacity(self, factor: float):
        """Multiply every region's capacity (floored at 1 instance);
        shrinking below the live count does not evict running instances —
        the spec timeline's ``CapacityShift`` op."""
        for g in self.groups:
            g.region = replace(
                g.region,
                capacity=max(1, int(g.region.capacity * factor)))

    # -- control ------------------------------------------------------------
    def scale_to(self, n: int, now: float):
        """Greedy fill cheapest regions first (the paper's Azure bias is an
        emergent consequence of its price)."""
        self.global_target = max(0, n)
        remaining = self.global_target
        for g in self.groups:
            want = min(remaining, g.region.capacity)
            g.set_target(want, now)
            remaining -= len(g.running)
        return self.total_running()

    def deprovision_all(self, now: float):
        """The CE-outage response: zero instances everywhere, instantly."""
        for g in self.groups:
            g.set_target(0, now)

    # -- accounting ----------------------------------------------------------
    def bill(self, now: float):
        """Charge the ledger for instance-hours since the last billing."""
        if self.ledger is None:
            return 0.0
        total = 0.0
        for g in self.groups:
            # ((price/24) * shift scalar) * curve factor — the exact
            # float expression every engine must share for bit-identical
            # billing (curve defaults to x1.0, an exact no-op)
            rate_h = self._price(g.provider) / 24.0 * self.price_scale \
                * self.curve_factor.get(g.provider.name, 1.0)
            for inst in g.instances.values():
                end = now
                if inst.preempted_at is not None:
                    end = inst.preempted_at
                elif inst.stopped_at is not None:
                    end = inst.stopped_at
                dh = max(0.0, end - inst.last_charged)
                if dh > 0:
                    amount = dh * rate_h
                    self.ledger.charge(g.provider.name, amount, now,
                                       note=f"{g.region.name}")
                    inst.last_charged = end
                    total += amount
            g.compact()
        return total

    # -- views ---------------------------------------------------------------
    def total_running(self) -> int:
        return sum(len(g.running) for g in self.groups)

    def running_by_provider(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for g in self.groups:
            out[g.provider.name] = out.get(g.provider.name, 0) \
                + len(g.running)
        return out

    def all_instances(self):
        for g in self.groups:
            yield from g.retired
            yield from g.instances.values()

    def live_instances(self):
        for g in self.groups:
            yield from g.running
