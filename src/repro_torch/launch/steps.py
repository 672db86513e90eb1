"""Step builders for the port's model path.

The port of the JAX package's ``launch/steps.py`` for what runs without
a gradient: ``_resolve_flash`` maps ``RunConfig.attention_impl ==
"pallas"`` (the JAX package's name for its flash kernel) to the CUDA
flash kernel's wrapper, and the prefill / decode steps close over the
config.  PyTorch runs eagerly, so nothing is jitted.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import model as M


def _dtype(run: RunConfig) -> torch.dtype:
    return getattr(torch, run.compute_dtype)


def _resolve_flash(run: RunConfig, flash_fn=None):
    if flash_fn is None and run.attention_impl == "pallas":
        from repro_torch.kernels import ops as kops
        flash_fn = kops.flash_attention
    return flash_fn


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
