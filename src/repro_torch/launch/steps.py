"""Step builders for the port's model path.

The port of the JAX package's ``launch/steps.py`` for what runs without
a gradient: ``_resolve_kernels`` maps ``RunConfig.attention_impl ==
"pallas"`` (the JAX package's only switch to its kernels) to the CUDA
kernels' wrappers, and the prefill / decode steps close over the config.
PyTorch runs eagerly, so nothing is jitted.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M


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
