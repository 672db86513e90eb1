"""Quickstart on the PyTorch port: declare and run a cloud campaign as
data, then train a small LM for a few hundred steps, checkpoint,
restore, and serve a few batched requests.

The counterpart of ``examples/quickstart.py`` with ``repro_torch`` in
place of the JAX package.  It runs on the card unless told otherwise: the
campaign half goes through the fused ``campaign_sweep`` kernel (one
launch per ``run`` call), the trainer and the server through the model's
reference path, as the JAX ones do.  Without a card it raises; on the
CPU:

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py     # on the card
"""
import argparse
import os
import shutil
import signal
import tempfile

import numpy as np

from repro_torch.checkpoint import restore
from repro_torch.core.api import run
from repro_torch.core.spec import (CampaignSpec, CEOutage, PriceShift,
                                   SetTarget)
from repro_torch.device import resolve_device
from repro_torch.launch.serve import BatchServer, Request
from repro_torch.launch.train import Trainer, build

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_quickstart_ckpt")


def campaign_quickstart(device=None):
    """The campaign half; returns (spec, one run's result, the sweep)."""
    # -- a two-day burst campaign, declared as data --------------------------
    spec = CampaignSpec(
        name="quickstart", budget=4000.0, duration_h=48.0,
        downscale_target=150,                # budget tripwire cap
        timeline=(SetTarget(0.0, 100),       # small-scale validation ...
                  SetTarget(6.0, 500),       # ... then burst
                  PriceShift(24.0, 1.3),     # spot market drifts up
                  CEOutage(36.0, 2.0, 250)))  # backend dies; resume lower
    print(f"spec round-trips to JSON: "
          f"{len(spec.to_json().splitlines())} lines")
    res = run(spec, seeds=2021, device=device)   # typed CampaignResult
    print(f"campaign {spec.name!r}: ${res.cost:,.0f} for "
          f"{res.accel_days:,.1f} GPU-days "
          f"({res.preemptions} preemptions, "
          f"{res.jobs_finished:,} jobs)")
    for ev in res.events_fired:
        print(f"  fired: {ev}")

    # the same spec across seeds = one batched Monte-Carlo sweep
    sw = run(spec, seeds=range(2021, 2025), device=device)
    band = sw.summary()[spec.name]["cost"]
    print(f"cost across 4 seeds: mean ${band['mean']:,.0f} "
          f"[p5 ${band['p5']:,.0f}, p95 ${band['p95']:,.0f}]")
    return spec, res, sw


def main(device=None, steps=200, ckpt_dir=CKPT):
    """Runs both halves; returns {"losses", "restored_step", "served"}
    (the finished ``Request`` objects) and the campaign's results."""
    dev = resolve_device(device)
    spec, res, sw = campaign_quickstart(dev)
    # -- train a ~300k-param yi-family model --------------------------------
    # start from scratch: a leftover checkpoint at step >= steps would make
    # train(steps) a no-op (the Trainer resumes from ckpt_dir)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg, shape, run_cfg = build("yi-9b", reduced=True, batch=8, seq=64)
    trainer = Trainer(cfg, shape, run_cfg, ckpt_dir=ckpt_dir, seed=0,
                      device=dev)
    # SIGTERM = preemption notice, for as long as the training runs
    previous = signal.getsignal(signal.SIGTERM)
    trainer.install_signal_handlers()
    try:
        losses = trainer.train(steps, ckpt_every=50, log_every=25)
    finally:
        signal.signal(signal.SIGTERM, previous)
    print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over {steps} steps")
    assert losses[-1] < losses[0]

    # -- restart from the durable checkpoint ---------------------------------
    step, _ = restore(ckpt_dir, {"params": trainer.params,
                                 "opt": trainer.opt})
    print(f"latest durable checkpoint: step {step}")

    # -- serve a few batched requests with the trained weights ----------------
    server = BatchServer(cfg, slots=4, params=trainer.params, device=dev)
    rng = np.random.default_rng(0)
    for i in range(6):
        server.submit(Request(i, rng.integers(0, cfg.vocab_size, 8)
                              .astype(np.int32), max_new=12))
    done = server.run()
    print(f"served {len(done)} requests, "
          f"{sum(len(r.out) for r in done)} tokens")
    return {"spec": spec, "campaign": res, "sweep": sw, "losses": losses,
            "restored_step": step, "served": done}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args()
    main(device=args.device, steps=args.steps)
