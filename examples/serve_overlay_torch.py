"""Serving through the overlay on the PyTorch port: inference requests
as CE "jobs", decode slots as "pilots" — the paper's federation
principle applied to a model server, with straggler-aware speculative
re-execution.

The counterpart of ``examples/serve_overlay.py`` with ``repro_torch`` in
place of the JAX package; it prints the same two lines (they count
requests, batches and the CE's pilots, not tokens).  The server runs on
the card unless told otherwise, and raises without one:

    PYTHONPATH=src python examples/serve_overlay_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.configs import get_reduced
from repro_torch.core.overlay import ComputeElement, Job
from repro_torch.core.straggler import SpeculativeScheduler
from repro_torch.launch.serve import BatchServer, Request


def main(device=None):
    """Serves 10 requests; returns (the server, the CE, the scheduler)."""
    cfg = get_reduced("qwen3-moe-30b-a3b")     # MoE decode path
    server = BatchServer(cfg, slots=4, max_len=64, device=device)
    ce = ComputeElement(accept_policy="icecube", lease_interval_s=120.0)
    spec = SpeculativeScheduler(spec_factor=2.5, min_samples=3)

    rng = np.random.default_rng(1)
    n_requests = 10
    for i in range(n_requests):
        ce.submit(Job(i, wall_h=float(rng.integers(8, 24))))  # wall == tokens
    for slot in range(4):
        ce.register_pilot(slot, "cloud-a", nat_timeout_s=240.0, now_h=0.0)

    served = 0
    t = 0.0
    while served < n_requests:
        ce.match(t)
        for pilot in ce.pilots.values():
            if pilot.job is None or pilot.job.finished:
                continue
            job = pilot.job
            req = Request(job.id, rng.integers(0, cfg.vocab_size, 6)
                          .astype(np.int32), max_new=int(job.wall_h))
            server.submit(req)
            done = server.run()
            job.done_h = job.wall_h            # tokens delivered
            spec.record_completion(len(done[-1].out))
            served += 1
        ce.advance(1.0, t)
        t += 1.0

    print(f"served {served} requests via the CE overlay "
          f"({len(server.done)} batches), "
          f"speculative re-executions: {spec.speculated}")
    print("CE stats:", ce.stats())
    return server, ce, spec


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    main(ap.parse_args().device)
