"""CloudBank analogue: multi-provider ledger, spend-rate, threshold alerts.

The port's own copy of the JAX package's ``core/budget.py`` (which needs
no JAX; the port imports nothing of that package).  The paper (§III)
used two CloudBank services, and this module provides both:
  1. a "single window" aggregate view: total + per-provider spend, remaining
     budget, fraction of total (``BudgetLedger.report()``),
  2. threshold e-mails: callbacks fired as remaining fraction crosses
     configured levels, carrying the spend rate over the past few days
     (``on_threshold``).

Invariants (held to the JAX package's ledger on the same charges by
tests/test_torch_examples.py):
  * conservation: total spent == sum of per-provider spend == sum of events
  * remaining == budget - spent, never silently negative
  * each threshold fires exactly once, in descending order
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


@dataclass
class SpendEvent:
    t: float                    # hours since campaign start
    provider: str
    amount: float
    note: str = ""


@dataclass
class BudgetLedger:
    total_budget: float
    thresholds: Tuple[float, ...] = (0.5, 0.25, 0.2, 0.1, 0.05)
    events: List[SpendEvent] = field(default_factory=list)
    by_provider: Dict[str, float] = field(default_factory=dict)
    spent: float = 0.0
    _fired: set = field(default_factory=set)
    _callbacks: List[Callable] = field(default_factory=list)
    overdraft: float = 0.0
    # prefix sums over events, parallel to `events`, for O(log n)
    # spend_rate (a two-week array-engine replay logs ~20k charge events;
    # the object engine, millions)
    _times: List[float] = field(default_factory=list)
    _cum: List[float] = field(default_factory=list)
    _monotonic: bool = True

    def on_threshold(self, cb: Callable[[float, float, float], None]):
        """cb(remaining_fraction, remaining_amount, spend_rate_per_day)."""
        self._callbacks.append(cb)

    def charge(self, provider: str, amount: float, t: float, note: str = ""):
        if amount < 0:
            raise ValueError("charges must be non-negative")
        self.events.append(SpendEvent(t, provider, amount, note))
        if self._times and t < self._times[-1]:
            self._monotonic = False
        self._times.append(t)
        self._cum.append((self._cum[-1] if self._cum else 0.0) + amount)
        self.by_provider[provider] = self.by_provider.get(provider, 0.) + amount
        self.spent += amount
        if self.spent > self.total_budget:
            self.overdraft = self.spent - self.total_budget
        frac = self.remaining_fraction()
        for th in sorted(self.thresholds, reverse=True):
            if frac <= th and th not in self._fired:
                self._fired.add(th)
                rate = self.spend_rate(t, window_h=72.0)
                for cb in self._callbacks:
                    cb(frac, self.remaining(), rate)

    def remaining(self) -> float:
        return max(0.0, self.total_budget - self.spent)

    def remaining_fraction(self) -> float:
        return self.remaining() / self.total_budget if self.total_budget else 0.

    def spend_rate(self, now_h: float, window_h: float = 72.0) -> float:
        """$/day over the past `window_h` hours (the periodic e-mail's
        'spending rate over the past few days')."""
        lo = now_h - window_h
        if self._monotonic:
            i = bisect.bisect_left(self._times, lo)
            recent = (self._cum[-1] if self._cum else 0.0) \
                - (self._cum[i - 1] if i else 0.0)
        else:   # charges arrived out of order: fall back to a scan
            recent = sum(e.amount for e in self.events if e.t >= lo)
        span_days = min(window_h, max(now_h, 1e-9)) / 24.0
        return recent / max(span_days, 1e-9)

    def report(self) -> dict:
        """The 'single window' web page."""
        return {
            "total_spent": round(self.spent, 2),
            "by_provider": {k: round(v, 2)
                            for k, v in sorted(self.by_provider.items())},
            "remaining": round(self.remaining(), 2),
            "remaining_fraction": round(self.remaining_fraction(), 4),
            "overdraft": round(self.overdraft, 2),
        }
