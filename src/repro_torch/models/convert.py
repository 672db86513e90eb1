"""Trees across between the JAX package's layout and the port's.

``params_from_jax`` takes the JAX tree as nested dicts of numpy arrays
(``jax.tree.map(np.asarray, params)``), unstacks the leading ``n_super``
axis of ``stack`` (and of an encoder's ``encoder/stack``, on the
encoder's own depth) into the port's list of per-super-block dicts, and
keeps every leaf's layout (``wq`` (d, H, hd), ``wo`` (H, hd, d), ...).
Every leaf must map onto a leaf of the port's tree for the config, with
its shape; an unknown or missing leaf raises.  ``params_to_jax`` is its
inverse for any port tree (parameters, gradients, optimizer state).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.model import init_params
from repro_torch.tree import flatten, map_tree


def _put(tree, path, value):
    for key in path[:-1]:
        tree = tree[key]
    tree[path[-1]] = value


def params_from_jax(tree, cfg, device=None):
    """The port's parameter tree for ``cfg`` holding the JAX weights, as
    f32 tensors on ``device`` (the card unless told otherwise)."""
    dev = resolve_device(device)
    out = init_params(cfg, torch.Generator(), device="meta")
    want = dict(flatten(out))
    # the stacks and their depths: the decoder's, and an encoder's
    stacks = {("stack",): cfg.n_super}
    if cfg.is_encdec:
        stacks[("encoder", "stack")] = len(out["encoder"]["stack"])
    seen = set()
    for path, arr in flatten(tree):
        arr = np.asarray(arr, dtype=np.float32)
        head = next((h for h in stacks if path[:len(h)] == h), None)
        if head is not None:
            n = stacks[head]
            if arr.shape[:1] != (n,):
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{arr.shape} has no leading n_super={n}")
            targets = [(head + (i,) + path[len(head):], arr[i])
                       for i in range(n)]
        else:
            targets = [(path, arr)]
        for dest, a in targets:
            if dest not in want:
                raise KeyError(f"JAX leaf {'/'.join(map(str, path))} has no "
                               f"place in the port's {cfg.name} tree")
            if tuple(want[dest].shape) != a.shape:
                raise ValueError(f"{'/'.join(map(str, path))}: shape "
                                 f"{a.shape}, the port expects "
                                 f"{tuple(want[dest].shape)}")
            _put(out, dest, torch.from_numpy(np.array(a)).to(dev))
            seen.add(dest)
    missing = sorted("/".join(map(str, p)) for p in set(want) - seen)
    if missing:
        raise KeyError(f"the JAX tree lacks {missing}")
    return out


def params_to_jax(tree):
    """The JAX package's layout of a port tree, as nested dicts of numpy
    arrays: each list (the stack) re-stacked along a new leading axis
    (``n_super``), bf16 leaves as f32 (numpy has no bf16), every other
    dtype kept."""
    if isinstance(tree, dict):
        return {k: params_to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return map_tree(lambda *xs: np.stack(xs),
                        *(params_to_jax(c) for c in tree))
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.cpu().numpy()
