"""What-if planning sweep on the PyTorch port: hundreds of (seed x spec)
campaigns through the ``run()`` front door.

The counterpart of ``examples/whatif_sweep.py`` with ``repro_torch`` in
place of the JAX package.  It runs the default pre-burst suite
(``scenarios.default_suite()``: paper baseline, on-demand fallback,
spot/on-demand mix, heterogeneous pool, outage grid, budget-floor,
price- and workload-curve, slicing and data-plane variants; 19 specs)
over N seeds and prints the planning table: mean [p5, p95] bands on
cost, GPU-days and preemptions per spec.  On the card each of the
suite's six engine batches is one launch of the fused
``campaign_sweep`` kernel; without a card it raises.  ``--csv`` writes
the per-lane rows, each lane's ``events_fired`` included.

    PYTHONPATH=src python examples/whatif_sweep_torch.py
    PYTHONPATH=src python examples/whatif_sweep_torch.py --seeds 32
    PYTHONPATH=src python examples/whatif_sweep_torch.py \\
        --scenarios paper,hetero --device cpu
    PYTHONPATH=src python examples/whatif_sweep_torch.py --csv sweep.csv
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.api import run
from repro_torch.core.scenarios import default_suite


def main(argv=None):
    """Parse ``argv`` (default: the command line), run the sweep, print
    the table; returns the ``SweepResult``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8,
                    help="seeds per scenario spec")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated spec-name filter")
    ap.add_argument("--csv", default=None,
                    help="write the per-lane row CSV here")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain "
                         "versions on the CPU")
    args = ap.parse_args(argv)

    suite = default_suite()
    if args.scenarios:
        want = {s.strip() for s in args.scenarios.split(",")}
        suite = [s for s in suite if s.name in want]
        if not suite:
            raise SystemExit(f"no spec matches {sorted(want)}; "
                             f"have {[s.name for s in default_suite()]}")
    seeds = list(range(2021, 2021 + args.seeds))
    n = len(suite) * len(seeds)
    print(f"sweeping {len(suite)} specs x {len(seeds)} seeds "
          f"= {n} two-week campaigns (torch engine) ...")
    t0 = time.perf_counter()
    sw = run(suite, seeds=seeds, device=args.device)
    dt = time.perf_counter() - t0
    print(f"done in {dt:.1f}s ({n / dt:.1f} campaigns/s)\n")
    print(sw.table())
    if args.csv:
        sw.to_csv(args.csv)
        print(f"\nwrote {args.csv}")
    print("\n(paper single-run reference: ~$58k, ~16k GPU-days)")
    return sw


if __name__ == "__main__":
    main()
