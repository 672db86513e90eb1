"""End-to-end elastic cloud training on the PyTorch port: the paper's
scenario applied to synchronous data-parallel training.

The counterpart of ``examples/elastic_cloud_train.py`` with
``repro_torch`` in place of the JAX package.  A simulated multi-provider
spot fleet provisions pod slices; they join the PodPool; the
ElasticRunner reshapes the mesh as pods come and go (a spot preemption,
then regrowth), draining the state to the host and re-sharding it, with
checkpoints on the preemption notice.  The ledger bills the fleet by the
hour, as in the JAX example: the fleet, spend and ledger lines are the
same.

Every rank of the world runs this program.  Launch it with ``torchrun``:

    PYTHONPATH=src torchrun --nproc_per_node 4 \\
        examples/elastic_cloud_train_torch.py          # four cards, NCCL

On a world of 4 ranks the pods are (2, 1), as the JAX example's 4 faked
devices are, and the run rebuilds its mesh 4 times (2 pods -> 1 -> 2).
Started with plain ``python`` it makes a world of one rank itself (a
``file://`` store in a temporary directory): pods are (1, 1) and the
pool holds at most one, since NCCL refuses two ranks on one card, so the
preempted pod's slot stays with the surviving rank and the mesh is built
once; the rebuild count it prints says so.  It runs on the card unless
``--device cpu`` is given (gloo), and raises without one.
"""
import argparse
import os
import shutil
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
from repro_torch.core.budget import BudgetLedger
from repro_torch.core.elastic import ElasticRunner, PodPool
from repro_torch.core.provider import tpu_catalog
from repro_torch.core.provisioner import MultiCloudProvisioner
from repro_torch.data import make_batch
from repro_torch.device import resolve_device
from repro_torch.launch.steps import make_mesh_train_step
from repro_torch.models import init_params
from repro_torch.optim import adamw_init

CKPT = os.path.join(tempfile.gettempdir(), "repro_torch_elastic_ckpt")


def _join_world(dev):
    """Joins the caller's process group (returns None), or makes one:
    torchrun's (``WORLD_SIZE`` in the environment; returns "") or a
    world of one (returns its store's directory)."""
    if dist.is_initialized():
        return None
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return ""
    if dev.type == "cuda":
        torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp()
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=0, world_size=1)
    return tmp


def main(params_host=None, batch_fn=None, device=None, ckpt_dir=CKPT):
    """The 30-step run.  ``params_host``: a host tree of the port's
    layout (default: ``init_params(cfg, 0)``); ``batch_fn(step)``: a
    batch of tensors or numpy arrays (default: the port's
    ``make_batch``).  Returns the losses, the rebuild count and the
    control plane's lines on every rank; rank 0 prints them."""
    dev = resolve_device(device)
    made = _join_world(dev)
    try:
        return _run(dev, params_host, batch_fn, ckpt_dir)
    finally:
        if made is not None:
            dist.destroy_process_group()
        if made:
            shutil.rmtree(made, ignore_errors=True)


def _run(dev, params_host, batch_fn, ckpt_dir):
    world, rank = dist.get_world_size(), dist.get_rank()
    # two pods of half the world each where it divides, else one pod
    max_pods = 2 if world % 2 == 0 else 1
    pod_shape = (world // max_pods, 1)
    say = print if rank == 0 else (lambda *a, **k: None)

    cfg = get_reduced("yi-9b")
    run = RunConfig(model=cfg, shape=REDUCED_SHAPE,
                    compute_dtype="float32", remat=False)
    params = params_host if params_host is not None else \
        init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)

    def batch(step):
        if batch_fn is None:
            return make_batch(cfg, REDUCED_SHAPE, step, device=dev)
        return {k: torch.as_tensor(np.asarray(v)).to(dev)
                for k, v in batch_fn(step).items()}

    if rank == 0:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ckpt = Checkpointer(ckpt_dir, keep=2)

    # --- control plane: budget-managed multi-cloud slice provisioning ------
    ledger = BudgetLedger(total_budget=50000.0)
    prov = MultiCloudProvisioner(tpu_catalog(), ledger)
    pool = PodPool(max_pods=max_pods)
    runner = ElasticRunner(lambda mesh: make_mesh_train_step(cfg, run, mesh),
                           params, opt, pod_shape=pod_shape,
                           checkpointer=ckpt, device_type=dev.type)
    pool.on_change(lambda n: runner.ensure(max(n, 1)))
    lines = []

    def report(line):
        lines.append(line)
        say(line)

    def steps(lo, hi, losses):
        for step in range(lo, hi):
            m = runner.step(batch(step))
            if m is not None:              # None: a rank outside the mesh
                losses.append(float(m["loss"]))

    # hour 0: provision 2 slices (cheapest provider fills first)
    prov.scale_to(2, now=0.0)
    for inst in prov.live_instances():
        pool.join(f"slice-{inst.id}")
    report(f"fleet: {prov.running_by_provider()}  -> {runner.n_pods} pods")

    losses = []
    steps(0, 10, losses)
    runner.checkpoint(9)

    # hour 6: spot preemption takes one slice (30 s notice honored)
    victim = next(iter(pool.pods))
    pool.preemption_notice(victim)
    runner.handle_preemption(9)              # durable state, blocking
    pool.leave(victim)
    prov.bill(now=6.0)
    report(f"preempted {victim}; now {runner.n_pods} pod(s); "
           f"spent ${ledger.spent:,.0f}")

    steps(10, 20, losses)

    # hour 12: capacity returns -> grow back, same global batch throughout
    prov.scale_to(2, now=12.0)
    pool.join("slice-replacement")
    steps(20, 30, losses)
    prov.bill(now=12.5)
    ckpt.wait()

    assert all(np.isfinite(losses))
    if losses:
        report(f"30 elastic steps, {runner.rebuilds} mesh rebuilds, "
               f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    report(f"ledger: {ledger.report()}")
    return {"losses": losses, "rebuilds": runner.rebuilds,
            "pod_shape": pod_shape, "max_pods": max_pods,
            "spent": ledger.spent, "ledger": ledger.report(),
            "lines": lines}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs on the CPU (gloo)")
    main(device=ap.parse_args().device)
