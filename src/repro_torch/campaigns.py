"""Campaign CLI of the port: run serialized CampaignSpecs on the card.

    PYTHONPATH=src python -m repro_torch.campaigns run spec.json
    PYTHONPATH=src python -m repro_torch.campaigns run spec.json \\
        --seeds 2021,2022,2023 --csv sweep.csv --json sweep.json
    PYTHONPATH=src python -m repro_torch.campaigns run spec.json \\
        --device cpu

The counterpart of the JAX package's ``python -m repro.campaigns run
... --engine jax``: ``run`` executes the spec(s) through
:func:`repro_torch.core.api.run` (one spec and one seed -> a
``CampaignResult``, anything else -> one batched sweep; on the card the
sweep is one launch of the fused ``campaign_sweep`` kernel), prints the
same summary lines, and writes the same JSON payload with ``"engine":
"torch"``, and the sweep's row CSV.  It runs on the card unless
``--device cpu`` is given, and raises without a card.

Only ``run`` is ported.  The JAX CLI's ``show``, ``lint``, ``check``,
``trace``, ``diff``, ``pareto`` and ``paper`` run that package's numpy
engines, its static analyzer and its per-instance traces, not JAX, and
the torch engine is statistical (it has no event trace), so they stay
with the JAX package.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from repro_torch.core.api import run as api_run
from repro_torch.core.spec import CampaignResult, CampaignSpec


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


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaigns",
        description="Run serialized CampaignSpecs on the torch engine.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="execute spec file(s)")
    p_run.add_argument("spec", nargs="+", help="CampaignSpec JSON file(s)")
    p_run.add_argument("--seeds", default="2021",
                       help="comma-separated seeds (default: 2021)")
    p_run.add_argument("--device", default=None,
                       help="default: the card; 'cpu' runs the plain "
                            "versions on the CPU")
    p_run.add_argument("--json", default=None,
                       help="write results JSON here")
    p_run.add_argument("--csv", default=None,
                       help="write the sweep row CSV here (sweeps only)")
    p_run.set_defaults(fn=cmd_run)

    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as e:
        # an invalid spec says what is wrong: one line, not a traceback
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    raise SystemExit(main())
