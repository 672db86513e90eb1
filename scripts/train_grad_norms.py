#!/usr/bin/env python3
"""Losses and gradient norms of a few train steps at yi-9b's full width,
on the port's ``make_train_step`` and on the JAX package's
``jax.jit(make_train_step)``, from the same weights on the same batches.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/train_grad_norms.py \\
        --out DIR [--layers 1] [--seq 256] [--batch 4] [--steps 6]

The full-width yi-9b train cell's gradient norm jumps at its sixth step
(ROADMAP C17).  This script asks whether the JAX package's step does the
same on the CPU: yi-9b at full width (d_model 4096, vocab 64,000),
``--layers`` of its 48 layers, f32, ``grad_accum`` 2, the recipe's AdamW
and warm-up.  It runs three processes in turn, so that one copy of the
state is in memory at a time:

  * ``--part inputs``: the port's ``init_params(cfg, 2021)`` saved in the
    JAX layout (``params_to_jax``) and numpy batches drawn as the
    synthetic pipeline draws them (tokens ``floor(u**3 * vocab)``);
  * ``--part torch``: the port's ``make_train_step`` on those weights
    (``params_from_jax``) and batches; imports no JAX;
  * ``--part jax``: ``jax.jit(make_train_step)`` of the JAX package
    (parameters and state donated) on the same.

Each part writes ``DIR/<part>.json`` (losses, gradient norms, seconds a
step).  The parent process prints both and the largest relative gap
of each, and exits non-zero if a side failed.  ~12 GB of memory a part at one
layer; a few minutes a side on an 8-core CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np

ARCH, SEED = "yi-9b", 2021


def _shape_kw(args):
    return dict(seq_len=args.seq, global_batch=args.batch, kind="train",
                grad_accum=2)


def _inputs(args):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.convert import params_to_jax
    from repro_torch.tree import flatten

    cfg = replace(get_config(ARCH), num_layers=args.layers)
    tree = params_to_jax(init_params(cfg, SEED, device="cpu"))
    out = {"param/" + "/".join(map(str, p)): a for p, a in flatten(tree)}
    rng = np.random.default_rng(SEED)
    for s in range(args.steps):
        u = np.clip(rng.random((args.batch, args.seq + 1)), 1e-6, None)
        toks = np.minimum((u ** 3 * cfg.vocab_size).astype(np.int32),
                          cfg.vocab_size - 1)
        out[f"batch/{s}/tokens"] = toks[:, :-1]
        out[f"batch/{s}/targets"] = toks[:, 1:]
    np.savez(os.path.join(args.out, "inputs.npz"), **out)
    return {"params": int(sum(a.size for k, a in out.items()
                              if k.startswith("param/")))}


def _load(args):
    inp = np.load(os.path.join(args.out, "inputs.npz"))
    tree = {}
    for k in inp.files:
        if k.startswith("param/"):
            node, keys = tree, k[len("param/"):].split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = inp[k]
    batches = [{k: inp[f"batch/{s}/{k}"] for k in ("tokens", "targets")}
               for s in range(args.steps)]
    return tree, batches


def _torch(args):
    import torch

    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import adamw_init

    cfg = replace(get_config(ARCH), num_layers=args.layers)
    run = RunConfig(model=cfg, shape=ShapeConfig("c17", **_shape_kw(args)),
                    compute_dtype="float32", remat=False)
    tree, batches = _load(args)
    params = params_from_jax(tree, cfg, device="cpu")
    del tree
    opt, step = adamw_init(params), make_train_step(cfg, run)
    out = {"loss": [], "grad_norm": [], "s": []}
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, {k: torch.from_numpy(v)
                                            for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["s"].append(time.perf_counter() - t0)
    return out


def _jax(args):
    import jax
    import jax.numpy as jnp

    from repro.configs import RunConfig, ShapeConfig, get_config
    from repro.launch.steps import make_train_step
    from repro.optim import adamw_init

    cfg = replace(get_config(ARCH), num_layers=args.layers)
    run = RunConfig(model=cfg, shape=ShapeConfig("c17", **_shape_kw(args)),
                    compute_dtype="float32", remat=False)
    tree, batches = _load(args)
    params = jax.tree.map(jnp.asarray, tree)
    del tree
    opt = adamw_init(params)
    step = jax.jit(make_train_step(cfg, run), donate_argnums=(0, 1))
    out = {"loss": [], "grad_norm": [], "s": []}
    for b in batches:
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in b.items()})
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["s"].append(time.perf_counter() - t0)
    return out


PARTS = {"inputs": _inputs, "torch": _torch, "jax": _jax}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--layers", type=int, default=1)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--part", choices=sorted(PARTS), default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.part is not None:
        res = PARTS[args.part](args)
        with open(os.path.join(args.out, f"{args.part}.json"), "w") as f:
            json.dump(res, f)
        return 0
    flags = [f"--{k}={getattr(args, k)}"
             for k in ("out", "layers", "seq", "batch", "steps")]
    for part in ("inputs", "torch", "jax"):
        t0 = time.perf_counter()
        rc = subprocess.call([sys.executable, os.path.abspath(__file__),
                              *flags, f"--part={part}"])
        print(f"[{part}] exit {rc} in {time.perf_counter() - t0:.1f} s",
              flush=True)
        if rc:
            return rc
    got = {}
    for part in ("inputs", "torch", "jax"):
        with open(os.path.join(args.out, f"{part}.json")) as f:
            got[part] = json.load(f)
    print(f"yi-9b full width, {args.layers} of 48 layers "
          f"({got['inputs']['params']:,} parameters), f32, B={args.batch} "
          f"S={args.seq} grad_accum 2, {args.steps} steps")
    for key in ("loss", "grad_norm"):
        t, j = np.array(got["torch"][key]), np.array(got["jax"][key])
        print(f"{key:9s} port {np.round(t, 6).tolist()}")
        print(f"{key:9s} jax  {np.round(j, 6).tolist()}")
        print(f"{key:9s} largest relative gap "
              f"{float(np.max(np.abs(t - j) / np.abs(j))):.3e}")
    print(f"s a step: port {np.round(got['torch']['s'], 2).tolist()}, "
          f"jax {np.round(got['jax']['s'], 2).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
