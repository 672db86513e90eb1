"""AdamW with an f32 master copy, global-norm clipping and the cosine
schedule.

The port of the JAX package's ``optim/adamw.py``, as plain functions on
the port's trees (nested dicts, the stack a list of per-super-block
dicts), so that the state is the JAX state leaf for leaf: ``mu`` and
``nu`` in f32, a ``step`` counter (int32), and an f32 ``master`` only
when some float parameter is not f32.  Every expression is the JAX
one, in f32.  ``adamw_update`` writes the new moments, master and
parameters into the tensors it was given (the counterpart of the JAX
step's donated buffers, which keeps one copy of the state on the card)
and returns them.
"""
from __future__ import annotations

import math

import torch

from repro_torch.tree import leaves, map_tree

F32 = torch.float32


def cosine_schedule(step, *, base_lr, warmup_steps=100, decay_steps=10000,
                    min_ratio=0.1):
    """Linear warm-up, then a cosine decay to ``min_ratio``; an f32
    scalar tensor on ``step``'s device (``step``: an integer tensor or
    int)."""
    step = torch.as_tensor(step)
    warm = torch.clamp((step + 1.0) / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(decay_steps, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return (base_lr * warm * cos).to(F32)


def global_norm(tree):
    """sqrt of the f32 squares summed over every leaf."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32)))
                          for x in leaves(tree)))


def adamw_init(params):
    """The optimizer state for ``params``, on their device."""
    ls = leaves(params)
    state = {"mu": map_tree(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device), params),
             "nu": map_tree(lambda p: torch.zeros(p.shape, dtype=F32,
                                                  device=p.device), params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=ls[0].device)}
    low_precision = any(x.is_floating_point() and x.dtype != F32
                        for x in ls)
    if low_precision:
        state["master"] = map_tree(lambda p: p.detach().to(F32).clone(),
                                   params)
    return state


def sharded_norm(tree, counted, groups):
    """``global_norm`` of a tree of shards: the f32 squares of the leaves
    that ``counted`` marks (one rank of those holding the same piece
    counts it, so each element is counted once), all-reduced over the
    process ``groups`` that span the mesh."""
    import torch.distributed as dist
    ls = leaves(tree)
    sq = torch.zeros((), dtype=F32, device=ls[0].device)
    for x, c in zip(ls, counted):
        if c:
            sq = sq + torch.sum(torch.square(x.to(F32)))
    for g in groups:
        dist.all_reduce(sq, group=g)
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, beta1=0.9, beta2=0.95,
                 eps=1e-8, weight_decay=0.1, grad_clip=1.0,
                 norm_fn=global_norm):
    """One step: clip by the global norm, update the moments, decay the
    master copy (decoupled) and cast it back into each parameter's
    dtype.  Updates ``state`` and ``params`` in place; returns
    (params, state, {"grad_norm", "lr"}).  Every step is elementwise, so
    the trees may be a rank's shards, with ``norm_fn`` the norm over the
    mesh (``sharded_norm``)."""
    gnorm = norm_fn(grads)
    scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    c1 = 1.0 - beta1 ** step.to(F32)
    c2 = 1.0 - beta2 ** step.to(F32)
    master = state.get("master", params)

    def upd(g, mu, nu, m, p):
        g = g.to(F32) * scale
        mu1 = beta1 * mu + (1 - beta1) * g
        nu1 = beta2 * nu + (1 - beta2) * g * g
        upd_ = (mu1 / c1) / (torch.sqrt(nu1 / c2) + eps)
        m1 = m - lr * (upd_ + weight_decay * m)
        mu.copy_(mu1)
        nu.copy_(nu1)
        if m is not p:
            m.copy_(m1)
        p.copy_(m1)                    # cast into the parameter's dtype

    map_tree(upd, grads, state["mu"], state["nu"], master, params)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
