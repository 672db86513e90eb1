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
from repro_torch.tree import leaves, unflatten


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
