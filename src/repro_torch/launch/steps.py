"""Step builders for the port's model path.

The port of the JAX package's ``launch/steps.py``: the train step
(``forward_loss``, its gradient by autograd, AdamW), and the prefill /
decode steps; each closes over the config.  ``_resolve_kernels`` maps
``RunConfig.attention_impl == "pallas"`` (the JAX package's only switch
to its kernels) to the CUDA kernels' wrappers for the forwards without
a gradient.  PyTorch runs eagerly, so nothing is jitted.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw_update, cosine_schedule
from repro_torch.tree import leaves, map_tree, unflatten


def _dtype(run: RunConfig) -> torch.dtype:
    return getattr(torch, run.compute_dtype)


def _resolve_kernels(run: RunConfig) -> dict:
    """The forward's kernel hooks for ``run``: with ``attention_impl ==
    "pallas"``, ``flash_fn`` / ``gmm_fn`` / ``scan_fn`` / ``chunk_fn``
    are the flash attention, ``moe_gmm``, ``mamba_scan`` and
    ``mlstm_chunk_model`` wrappers; otherwise all four are None and the
    forward computes exactly the JAX package's reference path (chunked
    attention, einsum experts, chunked scan, chunked mLSTM).
    Both settings compute the same function within the kernels'
    tolerances, so the switch adds no behaviour the JAX package lacks;
    it takes no new ``RunConfig`` field."""
    if run.attention_impl != "pallas":
        return {"flash_fn": None, "gmm_fn": None, "scan_fn": None,
                "chunk_fn": None}
    from repro_torch.kernels import ops as kops
    return {"flash_fn": kops.flash_attention, "gmm_fn": kops.moe_gmm,
            "scan_fn": kops.mamba_scan, "chunk_fn": kops.mlstm_chunk_model}


def make_value_and_grad(cfg: ModelConfig, run: RunConfig):
    """``fn(params, batch) -> (loss, grads)``: the training loss (CE + MoE
    aux) and its gradient, a tree of ``params``' structure.  With
    ``run.shape.grad_accum = a > 1`` microbatch i is rows [i B/a,
    (i+1) B/a) of the batch; the gradients are summed in f32 and, like
    the loss, divided by a.  The reference path only: no kernel of the
    port has a backward (ROADMAP C6), so ``attention_impl="pallas"``
    raises."""
    if run.attention_impl == "pallas":
        raise NotImplementedError(
            "make_train_step: attention_impl='pallas' has no backward: the "
            "port's kernels are forward-only, as the JAX package's Pallas "
            "flash kernel is (it fails under jax.grad, ROADMAP C6); train "
            "with attention_impl='reference'")
    dt = _dtype(run)
    accum = max(1, run.shape.grad_accum)

    def loss_and_grads(params, mb):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        loss, _ = M.forward_loss(params, cfg, mb, compute_dtype=dt,
                                 run_cfg=run)
        return loss.detach(), torch.autograd.grad(loss, ps)

    def value_and_grad(params, batch):
        if accum == 1:
            loss, grads = loss_and_grads(params, batch)
            return loss, unflatten(params, grads)
        n = batch["tokens"].shape[0] // accum
        lacc, gacc = 0.0, None
        for i in range(accum):
            loss, grads = loss_and_grads(
                params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            lacc = lacc + loss
            if gacc is None:
                gacc = [g.to(torch.float32) for g in grads]
            else:
                for a, g in zip(gacc, grads):
                    a.add_(g.to(torch.float32))
        return lacc / accum, unflatten(params, [g.div_(accum) for g in gacc])

    return value_and_grad


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and gradient of ``make_value_and_grad``, then one AdamW
    update at the cosine schedule's rate, written into ``params`` and
    ``opt_state`` in place; metrics {"loss", "grad_norm", "lr"} are
    tensors."""
    value_and_grad = make_value_and_grad(cfg, run)

    def train_step(params, opt_state, batch):
        lr = cosine_schedule(opt_state["step"], base_lr=run.learning_rate)
        loss, grads = value_and_grad(params, batch)
        new_params, new_opt, om = adamw_update(
            grads, opt_state, params, lr=lr, beta1=run.beta1,
            beta2=run.beta2, weight_decay=run.weight_decay,
            grad_clip=run.grad_clip)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


def _local_shard(full, mesh, placements):
    """The piece of ``full`` that this rank's DTensor holds under
    ``placements`` (even splits, nested in mesh-dim order)."""
    for size, c, pl in zip(mesh.mesh.shape, mesh.get_coordinate(),
                           placements):
        if pl.is_shard():
            full = full.chunk(size, dim=pl.dim)[c]
    return full


def make_mesh_train_step(cfg: ModelConfig, run: RunConfig, mesh):
    """``step(params, opt_state, batch)`` on trees of DTensors placed by
    ``sharding.param_shardings`` / ``opt_shardings`` on ``mesh``: the
    counterpart of the JAX package's ``jax.jit(make_train_step,
    in_shardings=..., out_shardings=...)``, whose compute GSPMD
    partitions.  The port's model does not run on DTensors, so this
    step stores the state sharded and computes data-parallel:

      1. gathers the full parameters and optimizer state;
      2. runs ``make_value_and_grad`` on the rank's rows of the global
         batch, split over the ("pod", "data") axes as
         ``sharding.batch_shardings`` splits it (a batch those axes
         cannot divide is computed whole on every rank, as the JAX rule
         replicates it);
      3. averages the gradients and the loss over those axes;
      4. applies ``adamw_update`` to the full state;
      5. writes each rank's shard back into the DTensors' local tensors,
         in place.

    On a mesh of one rank the full state is the DTensors' own storage:
    the plain step with no copy.  The result equals ``make_train_step``
    on the global batch within f32 rounding for a loss that is a mean
    over equal-sized shards (a dense model's).  An MoE layer computes
    its capacity and aux loss on the rank's shard (the naive dispatch:
    the step does not enter ``use_mesh``), so an MoE model's loss is not
    exactly the global one across ranks."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as sh
    from repro_torch.sharding_ctx import axis_names, mesh_shape
    from repro_torch.tree import flatten

    value_and_grad = make_value_and_grad(cfg, run)
    shape = mesh_shape(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    axes = sh.batch_axes(mesh)
    groups = [mesh.get_group(a) for a in axes if shape[a] > 1]
    n, idx = 1, 0
    for a in axes:                     # row-major over ("pod", "data")
        n, idx = n * shape[a], idx * shape[a] + coord[a]

    def full(t):
        if not isinstance(t, DTensor):
            return t
        if all(pl.is_replicate() for pl in t.placements) \
                or mesh.size() == 1:
            return t.to_local()
        return t.full_tensor()

    def local_rows(batch):
        specs = sh.batch_shardings(batch, mesh)
        tokens = specs["tokens"].spec
        if not tokens or tokens[0] is None:
            return batch, False
        rows = batch["tokens"].shape[0] // n
        return {k: v[idx * rows:(idx + 1) * rows] for k, v in batch.items()}, \
            True

    def mean(t):
        for g in groups:
            dist.all_reduce(t, group=g)
        return t.div_(n)

    def train_step(params, opt_state, batch):
        full_p = map_tree(full, params)
        full_o = map_tree(full, opt_state)
        lr = cosine_schedule(full_o["step"], base_lr=run.learning_rate)
        mb, sharded = local_rows(batch)
        loss, grads = value_and_grad(full_p, mb)
        if sharded and groups:
            loss = mean(loss.clone())
            for g in leaves(grads):
                mean(g)
        _, new_o, om = adamw_update(
            grads, full_o, full_p, lr=lr, beta1=run.beta1, beta2=run.beta2,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        with torch.no_grad():
            for tree, new in ((params, full_p), (opt_state, new_o)):
                for (_, d), (_, f) in zip(flatten(tree), flatten(new)):
                    if not isinstance(d, DTensor):
                        continue
                    local = d.to_local()
                    if local.data_ptr() != f.data_ptr() \
                            or local.shape != f.shape:
                        local.copy_(_local_shard(f, mesh, d.placements))
        return params, opt_state, {"loss": loss, **om}

    return train_step


def make_prefill_step(cfg: ModelConfig, run: RunConfig):
    dt = _dtype(run)

    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, compute_dtype=dt,
                         q_chunk=run.attention_q_chunk)

    return prefill_step


def make_decode_step(cfg: ModelConfig, run: RunConfig):
    dt = _dtype(run)

    def serve_step(params, caches, token, pos):
        return M.decode_step(params, cfg, caches, token, pos,
                             compute_dtype=dt)

    return serve_step
