"""Cost-vs-value Pareto frontiers over campaign sweeps.

"Which point on the cost / throughput frontier should we buy?"  The
port's sweep makes the candidate set cheap (``scenarios.pareto_grid()``
composes the price-curve x GPU-slicing x data-plane axes into one grid;
on the card each engine batch is one fused ``campaign_sweep`` launch),
and this module turns its :class:`~repro_torch.core.sweep_result.
SweepResult` into the answer:

    result = api.run(scenarios.pareto_grid(), seeds=[2021, 2022])
    front = pareto.frontier(result)            # cost vs accel_days
    print(front.table())

:func:`frontier` aggregates rows per scenario (mean over seeds),
computes the exact non-dominated set under (minimize cost, maximize
value), and returns every candidate with its frontier membership: the
dominated points are what not to buy.  ``cost`` is the ledger total,
which already includes metered egress.  The value axis is any numeric
row metric (``accel_days``, ``jobs_finished``, ...).  The results equal
the JAX package's ``analysis.pareto.frontier`` on the same rows.

The JAX package's ``goodput_rows`` replays per-lane event traces into
the elastic pod-pool model; the port's engine is statistical and keeps
no trace, so it has no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

__all__ = ["ParetoPoint", "ParetoFrontier", "frontier"]


@dataclass(frozen=True)
class ParetoPoint:
    """One aggregated sweep candidate on the (cost, value) plane."""
    scenario: str
    cost: float
    value: float
    seeds: int
    on_frontier: bool

    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "cost": self.cost,
                "value": self.value, "seeds": self.seeds,
                "on_frontier": self.on_frontier}


@dataclass(frozen=True)
class ParetoFrontier:
    """All candidates plus their non-dominated subset, sorted by cost."""
    x: str
    y: str
    points: Tuple[ParetoPoint, ...]

    @property
    def frontier(self) -> Tuple[ParetoPoint, ...]:
        return tuple(p for p in self.points if p.on_frontier)

    @property
    def dominated(self) -> Tuple[ParetoPoint, ...]:
        return tuple(p for p in self.points if not p.on_frontier)

    def to_dict(self) -> dict:
        return {"kind": "pareto_frontier", "x": self.x, "y": self.y,
                "points": [p.to_dict() for p in self.points]}

    def table(self) -> str:
        """Markdown-ish frontier report, cheapest candidate first;
        frontier members are starred."""
        rows = [f"| {'':1s} | {'scenario':24s} | {self.x:>12s} "
                f"| {self.y:>14s} |",
                "|---|" + "-" * 26 + "|" + "-" * 14 + "|"
                + "-" * 16 + "|"]
        for p in self.points:
            star = "*" if p.on_frontier else " "
            rows.append(f"| {star} | {p.scenario:24s} "
                        f"| {p.cost:>12,.2f} | {p.value:>14,.3f} |")
        return "\n".join(rows)


def _aggregate(rows: Sequence[dict], x: str, y: str
               ) -> List[Tuple[str, float, float, int]]:
    """Per-scenario (mean x, mean y, n seeds) in first-seen order."""
    order: List[str] = []
    acc: Dict[str, List[Tuple[float, float]]] = {}
    for row in rows:
        name = row.get("scenario", "?")
        for axis in (x, y):
            if axis not in row:
                have = sorted(k for k, v in row.items()
                              if isinstance(v, (int, float))
                              and not isinstance(v, bool))
                raise ValueError(
                    f"row for scenario {name!r} has no {axis!r} metric "
                    f"(numeric metrics: {', '.join(have)})")
        if name not in acc:
            order.append(name)
            acc[name] = []
        acc[name].append((float(row[x]), float(row[y])))
    out = []
    for name in order:
        pts = acc[name]
        n = len(pts)
        out.append((name, sum(p[0] for p in pts) / n,
                    sum(p[1] for p in pts) / n, n))
    return out


def _non_dominated(pts: Sequence[Tuple[float, float]]) -> List[bool]:
    """Exact weak-dominance filter: p is dominated iff some q has
    ``q.cost <= p.cost`` and ``q.value >= p.value`` with at least one
    strict.  Duplicate (cost, value) points are all kept."""
    flags = []
    for i, (cx, cy) in enumerate(pts):
        dominated = any(
            (qx <= cx and qy >= cy) and (qx < cx or qy > cy)
            for j, (qx, qy) in enumerate(pts) if j != i)
        flags.append(not dominated)
    return flags


def frontier(sweep_or_rows, x: str = "cost", y: str = "accel_days"
             ) -> ParetoFrontier:
    """The Pareto frontier of a sweep on (minimize ``x``, maximize
    ``y``).  ``sweep_or_rows`` is a ``SweepResult`` or a sequence of row
    dicts; rows are averaged per scenario before the dominance test.
    Returns every candidate sorted by cost (ties by scenario name) with
    its frontier flag."""
    rows = getattr(sweep_or_rows, "rows", sweep_or_rows)
    if not rows:
        raise ValueError("frontier() needs at least one sweep row")
    agg = _aggregate(rows, x, y)
    flags = _non_dominated([(c, v) for _n, c, v, _s in agg])
    points = [ParetoPoint(scenario=name, cost=round(c, 6),
                          value=round(v, 6), seeds=n, on_frontier=f)
              for (name, c, v, n), f in zip(agg, flags)]
    points.sort(key=lambda p: (p.cost, p.scenario))
    return ParetoFrontier(x=x, y=y, points=tuple(points))
