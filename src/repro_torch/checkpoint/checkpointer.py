"""Checkpoint / restart for preemptible training, in the JAX package's
files.

The port of the JAX package's ``checkpoint/checkpointer.py``:
  * atomic: a tmp dir, then a rename; a preemption mid-save never
    corrupts the latest checkpoint (spot instances give 30 s - 2 min of
    notice),
  * async: ``Checkpointer.save_async`` copies the trees to the host, then
    serializes them on a worker thread, off the step's critical path,
  * bounded retention: the last K checkpoints are kept.

The files are the JAX package's: one ``.npz`` per tree (params / opt),
each leaf keyed by its '/'-joined JAX tree path, the stack stacked along
a leading ``n_super`` axis (``models.convert.params_to_jax``), bf16
stored as f32, and the same ``manifest.json``.  A checkpoint written by
either package restores in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.models.convert import params_to_jax
from repro_torch.tree import flatten, unflatten


def _key(path) -> str:
    """The JAX key of a port leaf: its path without the stack index."""
    return "/".join(str(p) for p in path if not isinstance(p, int))


def _flatten(tree) -> dict:
    return {"/".join(map(str, path)): arr
            for path, arr in flatten(params_to_jax(tree))}


def _to_host(tree):
    """A host copy of ``tree`` that later in-place updates do not touch."""
    return unflatten(tree, [t.detach().to("cpu", copy=True)
                            for _, t in flatten(tree)])


def save(ckpt_dir, step, trees: dict):
    """trees: {"params": ..., "opt": ...}; blocking, atomic."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    os.makedirs(tmp, exist_ok=True)
    for name, tree in trees.items():
        np.savez(os.path.join(tmp, f"{name}.npz"), **_flatten(tree))
    manifest = {"step": int(step), "wall_time": time.time(),
                "trees": sorted(trees)}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = os.path.join(ckpt_dir, f"step_{int(step):010d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir):
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for d in os.listdir(ckpt_dir):
        if d.startswith("step_") and \
                os.path.exists(os.path.join(ckpt_dir, d, "manifest.json")):
            steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


def restore(ckpt_dir, structs: dict, step=None):
    """structs: {"params": port tree, ...} -> new trees of the same
    structure holding the stored values, each leaf with its struct
    leaf's shape, dtype and device.  Returns (step, trees)."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{int(step):010d}")
    out = {}
    for name, struct in structs.items():
        want = list(flatten(struct))
        by_key = {}
        for i, (path, _) in enumerate(want):
            by_key.setdefault(_key(path), []).append(i)
        values = [None] * len(want)
        with np.load(os.path.join(d, f"{name}.npz")) as z:
            for key, idx in by_key.items():
                arr = z[key]
                for i in idx:
                    path, leaf = want[i]
                    stack_idx = tuple(p for p in path if isinstance(p, int))
                    a = np.ascontiguousarray(arr[stack_idx]) \
                        .reshape(leaf.shape)
                    values[i] = torch.from_numpy(a).to(device=leaf.device,
                                                       dtype=leaf.dtype)
        out[name] = unflatten(struct, values)
    return step, out


class Checkpointer:
    """Async checkpointing with retention.  ``save_async`` copies the
    trees to the host synchronously and serializes them on a worker
    thread."""

    def __init__(self, ckpt_dir, keep=3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread = None
        self._error = None
        self.saved_steps = []

    def wait(self):
        """Joins the worker; re-raises a failure of its save."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        for s in self.saved_steps[:-self.keep]:
            p = os.path.join(self.ckpt_dir, f"step_{int(s):010d}")
            if os.path.exists(p):
                shutil.rmtree(p)
        self.saved_steps = self.saved_steps[-self.keep:]

    def save_async(self, step, trees: dict):
        self.wait()
        host_trees = {k: _to_host(v) for k, v in trees.items()}

        def work():
            try:
                save(self.ckpt_dir, step, host_trees)
            except OSError as err:         # raised by the next wait()
                self._error = err
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        self.saved_steps.append(step)
        self._gc()

    def save_blocking(self, step, trees: dict):
        self.wait()
        path = save(self.ckpt_dir, step, trees)
        self.saved_steps.append(step)
        self._gc()
        return path
