"""Training launcher: preemptible and checkpointed.

The port of the JAX package's ``launch/train.py``: data pipeline ->
train step -> async checkpoints, a SIGTERM (the cloud's preemption
notice) drained into a blocking checkpoint, restore-on-start from the
latest checkpoint, and the straggler monitor's step times.  It runs on
the card unless the caller passes ``device="cpu"``; checkpoints are the
JAX package's files, so a run moves between ``repro.launch.train`` and
this launcher in either direction.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-9b \\
        --reduced --steps 20 --device cpu --ckpt-dir /tmp/ck
"""
from __future__ import annotations

import argparse
import math
import signal
import time

import torch

from repro_torch.checkpoint import Checkpointer, latest_step, restore
from repro_torch.configs import (RunConfig, SHAPES, ShapeConfig, get_config,
                                 get_reduced)
from repro_torch.core.straggler import StragglerMonitor
from repro_torch.data import SyntheticPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import steps as st
from repro_torch.models import init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import map_tree


def build(arch, *, reduced=True, shape_name="train_4k", batch=None, seq=None,
          compute_dtype="float32", grad_accum=1):
    cfg = get_reduced(arch) if reduced else get_config(arch)
    base = SHAPES[shape_name]
    shape = ShapeConfig("custom", seq or (64 if reduced else base.seq_len),
                        batch or (4 if reduced else base.global_batch),
                        "train", grad_accum=grad_accum)
    run = RunConfig(model=cfg, shape=shape, compute_dtype=compute_dtype,
                    remat=not reduced)
    return cfg, shape, run


class Trainer:
    """``mesh``: a ``DeviceMesh`` every rank of which builds the trainer
    (the counterpart of the JAX ``Trainer(mesh=...)``): the state is
    placed by ``param_shardings`` / ``opt_shardings`` (each rank keeps
    its pieces of the same seeded init), the step is
    ``make_mesh_train_step`` on the global batch, and checkpoints stay
    the JAX package's npz files, the state gathered to the host and
    written by rank 0.  ``mesh=None`` is the single-device trainer."""

    def __init__(self, cfg, shape, run, *, ckpt_dir=None, seed=0, keep=3,
                 device=None, mesh=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        self.cfg, self.shape, self.run = cfg, shape, run
        self.pipe = SyntheticPipeline(cfg, shape, seed=seed,
                                      device=self.device)
        self.ckpt = Checkpointer(ckpt_dir, keep=keep) if ckpt_dir else None
        self.monitor = StragglerMonitor()
        self._preempt_requested = False
        self.step_num = 0
        self.last_metrics = {}         # the last step's, as floats

        params = init_params(cfg, seed, device=self.device)
        if run.compute_dtype != "float32":
            dt = getattr(torch, run.compute_dtype)
            params = map_tree(lambda x: x.to(dt) if x.is_floating_point()
                              else x, params)
        self.params = params
        self.opt = adamw_init(params)
        if mesh is None:
            self._step = st.make_train_step(cfg, run)
        else:
            from repro_torch import sharding as sh
            self.params = st.distribute(
                self.params, sh.param_shardings(self.params, mesh), mesh)
            self.opt = st.distribute(
                self.opt, sh.opt_shardings(self.opt, mesh), mesh)
            self._step = st.make_mesh_train_step(cfg, run, mesh)
        if ckpt_dir and latest_step(ckpt_dir) is not None:
            self.restore(ckpt_dir)

    # -- preemption ------------------------------------------------------------
    def install_signal_handlers(self):
        """SIGTERM = the cloud's preemption notice: drain + durable state."""
        def handler(signum, frame):
            self._preempt_requested = True
        signal.signal(signal.SIGTERM, handler)

    def trees(self) -> dict:
        """The state; on a mesh gathered whole (every rank calls it)."""
        trees = {"params": self.params, "opt": self.opt}
        if self.mesh is None:
            return trees
        return {k: map_tree(lambda d: d.full_tensor(), v)
                for k, v in trees.items()}

    def _writes(self) -> bool:
        import torch.distributed as dist
        return self.mesh is None or dist.get_rank() == 0

    def restore(self, ckpt_dir, step=None):
        """Loads checkpoint ``step`` (the latest by default) into the
        trainer and resumes from it; returns the step.  On a mesh each
        rank reads the files and keeps its pieces, in place."""
        step, trees = restore(ckpt_dir, {"params": self.params,
                                         "opt": self.opt}, step=step)
        if self.mesh is None:
            self.params, self.opt = trees["params"], trees["opt"]
        else:
            st.load_pieces(self.params, trees["params"], self.mesh)
            st.load_pieces(self.opt, trees["opt"], self.mesh)
        self.step_num = step
        return step

    def _save(self, blocking: bool):
        trees = self.trees()
        if not self._writes():
            return
        if blocking:
            self.ckpt.save_blocking(self.step_num, trees)
        else:
            self.ckpt.save_async(self.step_num, trees)

    # -- loop --------------------------------------------------------------------
    def train(self, num_steps, *, ckpt_every=25, log_every=10, log=print):
        """Runs steps up to ``num_steps``; returns their losses.  A
        non-finite loss raises FloatingPointError."""
        losses = []
        while self.step_num < num_steps:
            t0 = time.time()
            batch = self.pipe.batch(self.step_num)
            self.params, self.opt, m = self._step(self.params, self.opt,
                                                  batch)
            self.last_metrics = {k: float(v) for k, v in m.items()}
            loss = self.last_metrics["loss"]
            if not math.isfinite(loss):
                raise FloatingPointError(
                    f"non-finite loss at step {self.step_num}")
            losses.append(loss)
            self.step_num += 1
            self.monitor.record("pod0", time.time() - t0)
            if log_every and self.step_num % log_every == 0:
                log(f"step {self.step_num:5d} loss {loss:.4f} "
                    f"gnorm {self.last_metrics['grad_norm']:.3f} "
                    f"({time.time() - t0:.2f}s)")
            if self.ckpt and self.step_num % ckpt_every == 0:
                self._save(blocking=False)
            if self._preempt_requested:
                if self.ckpt:
                    self._save(blocking=True)
                log(f"preemption notice honored at step {self.step_num}")
                break
        if self.ckpt:
            self.ckpt.wait()
        return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)

    cfg, shape, run = build(args.arch, reduced=args.reduced,
                            shape_name=args.shape, batch=args.batch,
                            seq=args.seq)
    tr = Trainer(cfg, shape, run, ckpt_dir=args.ckpt_dir, seed=args.seed,
                 device=args.device)
    tr.install_signal_handlers()
    losses = tr.train(args.steps, ckpt_every=args.ckpt_every)
    if losses:
        print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}, "
              f"{len(losses)} steps)")
    else:
        print(f"nothing to run: resumed at step {tr.step_num}, "
              f"--steps {args.steps}")
    return losses


if __name__ == "__main__":
    main()
