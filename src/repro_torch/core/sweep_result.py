"""Sweep lanes, their batch key, and the sweep result table.

``_prepare`` turns one (spec, seed) into a :class:`_Lane` plus the
structural key lanes are batched by: lanes that share tick size,
duration, the price-ordered (provider, region) group list and the
data-plane geometry run as one engine batch.  The key is the same
tuple the JAX package's engines batch by, so both packages chunk a
sweep identically.  :class:`SweepResult` holds the per-lane rows and
their per-scenario bands.
"""
from __future__ import annotations

import csv
import io
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.spec import CampaignSpec, build_catalog

__all__ = ["SweepResult"]


@dataclass
class _Lane:
    """One (spec, seed) campaign prepared for batching."""
    spec: CampaignSpec
    seed: int
    pairs: list          # (ProviderSpec, RegionSpec), price-ordered


def _prepare(sc, seed: int) -> Tuple[tuple, _Lane]:
    sc = sc.to_spec().validate()
    cat = build_catalog(sc)
    pairs = [(p, r) for p in cat.values() for r in p.regions]
    pairs.sort(key=lambda pr: (
        pr[0].spot_price_per_day if sc.spot else
        pr[0].ondemand_price_per_day, pr[0].name, pr[1].name))
    key = (sc.dt_h, sc.duration_h, tuple(
        (p.name, r.name, r.capacity, r.preempt_rate_per_hour,
         r.preempt_scale_at_full, p.nat_idle_timeout_s, p.fp32_tflops)
        for p, r in pairs),
        # stage geometry is a batch-level constant
        sc.job_input_gb, sc.dataplane)
    return key, _Lane(sc, seed, pairs)


_BAND_METRICS = ("cost", "accel_days", "eflop_hours_fp32", "preemptions",
                 "jobs_finished")


def _flatten_row(row: dict) -> dict:
    """Dotted-key flattening for CSV export; events_fired becomes one
    compact deterministic cell."""
    out: dict = {}

    def walk(prefix, v):
        if isinstance(v, dict):
            for k in sorted(v):
                walk(f"{prefix}.{k}" if prefix else str(k), v[k])
        else:
            out[prefix] = v

    for k, v in row.items():
        if k == "events_fired":
            out[k] = "|".join(
                ";".join(f"{kk}={ev[kk]}" for kk in sorted(ev))
                for ev in v)
        else:
            walk(k, v)
    return out


@dataclass
class SweepResult:
    """Per-lane campaign totals plus per-scenario summary bands.  Rows
    are ``results()`` dicts extended with ``scenario`` / ``seed`` /
    ``events_fired``."""
    rows: List[dict]

    def to_csv(self, path: Optional[str] = None) -> str:
        """Deterministic CSV of the rows: sorted by (scenario, seed),
        columns sorted by dotted key."""
        flat = sorted((_flatten_row(r) for r in self.rows),
                      key=lambda r: (str(r.get("scenario", "")),
                                     r.get("seed", 0)))
        cols = ["scenario", "seed"] + sorted(
            {k for r in flat for k in r} - {"scenario", "seed"})
        buf = io.StringIO()
        w = csv.DictWriter(buf, fieldnames=cols, restval="",
                           lineterminator="\n")
        w.writeheader()
        w.writerows(flat)
        text = buf.getvalue()
        if path is not None:
            with open(path, "w") as f:
                f.write(text)
        return text

    def scenario_names(self) -> List[str]:
        seen: List[str] = []
        for r in self.rows:
            if r["scenario"] not in seen:
                seen.append(r["scenario"])
        return seen

    def summary(self, metrics: Sequence[str] = _BAND_METRICS
                ) -> Dict[str, dict]:
        """Per-scenario {metric: {mean, p5, p95}} across seeds."""
        out: Dict[str, dict] = {}
        for name in self.scenario_names():
            vals = {m: np.array([r[m] for r in self.rows
                                 if r["scenario"] == name])
                    for m in metrics}
            out[name] = {
                "seeds": int(len(next(iter(vals.values())))),
                **{m: {"mean": float(np.mean(v)),
                       "p5": float(np.percentile(v, 5)),
                       "p95": float(np.percentile(v, 95))}
                   for m, v in vals.items()}}
        return out

    def table(self, metrics: Sequence[str] = ("cost", "accel_days",
                                              "preemptions")) -> str:
        """Plain-text planning table: one row per scenario, mean
        [p5, p95] bands per metric."""
        summ = self.summary(metrics)
        if not summ:
            return "(no sweep rows)"
        width = max(len(n) for n in summ) + 2
        cols = [f"{m} mean [p5, p95]" for m in metrics]
        lines = ["scenario".ljust(width) + "  ".join(c.rjust(30)
                                                     for c in cols)]
        for name, stats in summ.items():
            cells = []
            for m in metrics:
                s = stats[m]
                cells.append(f"{s['mean']:,.1f} "
                             f"[{s['p5']:,.1f}, {s['p95']:,.1f}]".rjust(30))
            lines.append(name.ljust(width) + "  ".join(cells))
        return "\n".join(lines)
