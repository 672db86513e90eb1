"""Campaign CLI of the port: run, inspect and plan CampaignSpecs on the card.

    PYTHONPATH=src python -m repro_torch.campaigns run spec.json
    PYTHONPATH=src python -m repro_torch.campaigns run spec.json \\
        --seeds 2021,2022,2023 --csv sweep.csv --json sweep.json
    PYTHONPATH=src python -m repro_torch.campaigns show spec.json
    PYTHONPATH=src python -m repro_torch.campaigns lint spec.json \\
        --registry --json -
    PYTHONPATH=src python -m repro_torch.campaigns pareto \\
        --seeds 2021,2022
    PYTHONPATH=src python -m repro_torch.campaigns paper --out p.json

The counterpart of the JAX package's ``python -m repro.campaigns``
with ``--engine jax``: ``run`` executes the spec(s) through
:func:`repro_torch.core.api.run` (one spec and one seed -> a
``CampaignResult``, anything else -> one batched sweep; on the card each
engine batch is one launch of the fused ``campaign_sweep`` kernel),
prints the same summary lines, and writes the same JSON payload with
``"engine": "torch"``, and the sweep's row CSV.  ``pareto`` sweeps a
candidate grid (default: ``scenarios.pareto_grid()``, four engine
batches) and prints the cost-vs-value frontier
(``analysis.pareto.frontier``).  ``show`` prints spec files, ``paper``
emits the paper-replay spec, and ``lint`` reports every finding of
``spec.lint_spec`` (``--registry``: also every timeline event that the
torch engine's ``TorchLaneOps`` cannot run), with the same lines and
JSON payload as the JAX CLI.  Every command runs on the card unless
``--device cpu`` is given, and raises without a card.

``check``, ``trace`` and ``diff`` stay with the JAX package: ``check``
reads that package's source tree, and ``trace`` and ``diff`` need
per-instance event traces, which the statistical torch engine does not
keep (the JAX CLI refuses them for its ``jax`` engine too).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
from dataclasses import replace
from typing import List, Optional

from repro_torch.core.api import run as api_run
from repro_torch.core.spec import (CampaignResult, CampaignSpec, lint_spec,
                                   paper_spec)
from repro_torch.device import resolve_device


def _load_spec(path: str) -> CampaignSpec:
    with open(path) as f:
        return CampaignSpec.from_json(f.read())


def _print_solo(res: CampaignResult):
    print(f"campaign {res.spec.name!r} seed={res.seed} "
          f"engine={res.engine}")
    print(f"  cost            ${res.cost:>12,.2f}")
    print(f"  GPU-days        {res.accel_days:>13,.1f}")
    print(f"  fp32 EFLOP-h    {res.eflop_hours_fp32:>13.3f}")
    print(f"  preemptions     {res.preemptions:>13,}")
    print(f"  jobs finished   {res.jobs_finished:>13,}")
    if res.spec.dataplane is not None:
        print(f"  egress          ${res.egress_usd:>12,.2f}")
        print(f"  stage-in hours  {res.stagein_hours:>13,.1f}")
        print(f"  cache hit frac  {res.cache_hit_fraction:>13.4f}")
    if res.spec.name == "paper":
        print("  paper-claim comparison:")
        for claim, row in res.compare_paper().items():
            print(f"    {claim:18s} sim={row['sim']:>12,.2f} "
                  f"paper={row['paper']:>10,.1f} "
                  f"err={row['err_pct']:+6.1f}%")


def cmd_run(args) -> int:
    specs = [_load_spec(p) for p in args.spec]
    seeds = [int(s) for s in args.seeds.split(",")]
    target = specs[0] if len(specs) == 1 else specs
    result = api_run(target, seeds=seeds if len(seeds) > 1 else seeds[0],
                     device=args.device)
    if isinstance(result, CampaignResult):
        _print_solo(result)
        payload = {"schema_version": 1, "kind": "campaign",
                   "spec": result.spec.to_dict(), "seed": result.seed,
                   "engine": result.engine,
                   "results": result.to_dict(),
                   "events_fired": list(result.events_fired)}
    else:
        print(f"swept {len(result.rows)} lanes "
              f"({len(specs)} specs x {len(seeds)} seeds, "
              f"engine=torch)\n")
        print(result.table())
        payload = {"schema_version": 1, "kind": "sweep",
                   "specs": [s.to_dict() for s in specs], "seeds": seeds,
                   "summary": result.summary(), "rows": result.rows}
        if args.csv:
            result.to_csv(args.csv)
            print(f"# wrote {args.csv}", file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True, default=str)
            f.write("\n")
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


def cmd_show(args) -> int:
    resolve_device(args.device)
    for path in args.spec:
        spec = _load_spec(path)
        print(f"# {path}")
        print(spec.to_json(), end="")
    return 0


def _registry_findings() -> List[str]:
    """Every registered timeline event must compile to ops the torch
    engine's planner adapter implements."""
    from repro_torch.core.sweep_torch import TorchLaneOps
    from repro_torch.core.timeline import registry_findings
    return registry_findings({"torch": TorchLaneOps})


#: every lint finding leads with its stable rule id (``SPEC014: ...``,
#: ``REG002: ...``): split back out for the --json payload
_RULE_PREFIX_RE = re.compile(r"^([A-Z]{3,5}\d{3}):\s+(.*)$", re.DOTALL)


def _lint_finding(path: str, text: str) -> dict:
    """One finding in the JAX CLI's ``--json`` shape (file, line, rule,
    message, hint)."""
    m = _RULE_PREFIX_RE.match(text)
    rule, message = (m.group(1), m.group(2)) if m else ("SPEC000", text)
    return {"file": path, "line": 0, "rule": rule,
            "message": message, "hint": ""}


def cmd_lint(args) -> int:
    """Report every finding of every spec and exit 1 if any has one.
    ``--registry`` also fails on timeline events the torch engine cannot
    run.  ``--json PATH`` writes the findings (``-``: stdout, and the
    human lines move to stderr)."""
    resolve_device(args.device)
    as_json = args.json
    out = sys.stderr if as_json == "-" else sys.stdout
    bad = 0
    collected: List[dict] = []
    if args.registry:
        findings = _registry_findings()
        collected.extend(_lint_finding("src/repro_torch/core/timeline.py", f)
                         for f in findings)
        if findings:
            bad += 1
            for f in findings:
                print(f"registry: {f}", file=out)
        else:
            from repro_torch.core.timeline import REGISTRY
            print(f"registry: OK ({len(REGISTRY)} event kinds on "
                  "all engines)", file=out)
    for path in args.spec:
        try:
            spec = _load_spec(path)
        except (OSError, ValueError, KeyError, TypeError) as e:
            print(f"{path}: ERROR: cannot load spec: {e}", file=out)
            collected.append(_lint_finding(
                path, f"SPEC100: cannot load spec: {e}"))
            bad += 1
            continue
        findings = lint_spec(spec)
        collected.extend(_lint_finding(path, f) for f in findings)
        if findings:
            bad += 1
            for f in findings:
                print(f"{path}: {f}", file=out)
        else:
            print(f"{path}: OK ({spec.name!r}, "
                  f"{len(spec.timeline)} timeline events)", file=out)
    if as_json:
        counts: dict = {}
        for f in collected:
            counts[f["rule"]] = counts.get(f["rule"], 0) + 1
        payload = json.dumps({
            "schema_version": 1,
            "tool": "repro_torch.campaigns lint",
            "specs": list(args.spec),
            "ok": not bad,
            "counts": dict(sorted(counts.items())),
            "findings": collected,
        }, indent=2, sort_keys=True) + "\n"
        if as_json == "-":
            sys.stdout.write(payload)
        else:
            with open(as_json, "w") as f:
                f.write(payload)
            print(f"# wrote {as_json}", file=sys.stderr)
    return 1 if bad else 0


def cmd_pareto(args) -> int:
    """Sweep a candidate grid and print the cost-vs-value Pareto
    frontier.  With no spec files the grid is
    ``scenarios.pareto_grid()``; ``--duration-h`` shortens every
    candidate for smoke runs."""
    from repro_torch.analysis.pareto import frontier
    if args.spec:
        specs = [_load_spec(p) for p in args.spec]
    else:
        from repro_torch.core.scenarios import pareto_grid
        specs = pareto_grid()
    if args.duration_h is not None:
        specs = [replace(s, duration_h=args.duration_h) for s in specs]
    seeds = [int(s) for s in args.seeds.split(",")]
    result = api_run(specs, seeds=seeds if len(seeds) > 1 else seeds[0],
                     device=args.device)
    front = frontier(result, x=args.x, y=args.y)
    print(f"pareto frontier over {len(specs)} scenarios x "
          f"{len(seeds)} seeds (minimize {front.x}, "
          f"maximize {front.y}):\n")
    print(front.table())
    names = ", ".join(p.scenario for p in front.frontier)
    print(f"\nnon-dominated: {names}")
    if args.json:
        payload = {"schema_version": 1, **front.to_dict(),
                   "seeds": seeds}
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"# wrote {args.json}", file=sys.stderr)
    return 0


def cmd_paper(args) -> int:
    resolve_device(args.device)
    text = paper_spec().to_json()
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
        print(f"# wrote {args.out}", file=sys.stderr)
    else:
        print(text, end="")
    return 0


def _add_device(p) -> None:
    p.add_argument("--device", default=None,
                   help="default: the card; 'cpu' runs the plain "
                        "versions on the CPU")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaigns",
        description="Run/inspect serialized CampaignSpecs on the torch "
                    "engine.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="execute spec file(s)")
    p_run.add_argument("spec", nargs="+", help="CampaignSpec JSON file(s)")
    p_run.add_argument("--seeds", default="2021",
                       help="comma-separated seeds (default: 2021)")
    _add_device(p_run)
    p_run.add_argument("--json", default=None,
                       help="write results JSON here")
    p_run.add_argument("--csv", default=None,
                       help="write the sweep row CSV here (sweeps only)")
    p_run.set_defaults(fn=cmd_run)

    p_show = sub.add_parser("show", help="pretty-print spec file(s)")
    p_show.add_argument("spec", nargs="+")
    _add_device(p_show)
    p_show.set_defaults(fn=cmd_show)

    p_lint = sub.add_parser(
        "lint", help="validate spec file(s) without running them")
    p_lint.add_argument("spec", nargs="+")
    p_lint.add_argument("--registry", action="store_true",
                        help="also check the timeline-event registry: "
                             "fail on events the torch engine cannot run")
    p_lint.add_argument("--json", default=None, metavar="PATH",
                        help="write machine-readable findings here "
                             "('-' for stdout)")
    _add_device(p_lint)
    p_lint.set_defaults(fn=cmd_lint)

    p_pareto = sub.add_parser(
        "pareto", help="sweep a candidate grid and print the "
                       "cost-vs-value Pareto frontier")
    p_pareto.add_argument("spec", nargs="*",
                          help="candidate CampaignSpec JSON files "
                               "(default: scenarios.pareto_grid())")
    p_pareto.add_argument("--seeds", default="2021",
                          help="comma-separated seeds (default: 2021)")
    _add_device(p_pareto)
    p_pareto.add_argument("--x", default="cost",
                          help="cost axis, minimized (default: cost)")
    p_pareto.add_argument("--y", default="accel_days",
                          help="value axis, maximized "
                               "(default: accel_days)")
    p_pareto.add_argument("--duration-h", default=None, type=float,
                          help="override every candidate's duration "
                               "(reduced smoke grids)")
    p_pareto.add_argument("--json", default=None,
                          help="write the frontier JSON here")
    p_pareto.set_defaults(fn=cmd_pareto)

    p_paper = sub.add_parser("paper",
                             help="emit the paper-replay golden spec")
    p_paper.add_argument("--out", default=None)
    _add_device(p_paper)
    p_paper.set_defaults(fn=cmd_paper)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as e:
        # an invalid spec says what is wrong: one line, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
