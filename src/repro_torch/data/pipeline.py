"""Deterministic synthetic batches (tokens + stub modality frontends).

The port of the JAX package's ``data/pipeline.py``.
Determinism is the elastic-restart contract: ``batch(step)`` depends only
on (seed, step), so a run restarted from checkpoint step k consumes the
same data from step k on, with no loader state to checkpoint.  The draws
come from a CPU ``torch.Generator`` seeded from (seed, step), so the
card and the CPU get the same batch; they are not JAX's threefry draws,
so the parity tests carry the JAX package's batches across as numpy.
The transform is the JAX one: ``u ~ U[1e-6, 1)`` of shape (B, S+1),
tokens ``int(u**3 * vocab)`` (a skewed, zipf-like access pattern),
targets the tokens shifted by one.  The modality frontends are stubs, as
in the JAX package: an encoder-decoder's ``enc_embeds`` (B, n_frames,
d_model) and a VLM's ``patch_embeds`` (B, num_patches, d_model) are
0.02 * N(0, 1) in f32, drawn after the tokens from the same generator,
and a VLM's batch holds seq_len - num_patches tokens.  Batches are on
the card unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


def _generator(seed: int, step: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(state[0]))


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int, *,
               seed: int = 0, device=None):
    """{"tokens", "targets"}, (B, S) int32 each, plus ``enc_embeds`` or
    ``patch_embeds`` (f32) where the config has them, for one training
    step (a pure function of (seed, step))."""
    dev = resolve_device(device)
    B, S = shape.global_batch, shape.seq_len
    if cfg.frontend is not None:
        S = S - cfg.frontend.num_patches
    gen = _generator(seed, step)
    u = torch.rand((B, S + 1), generator=gen)
    u = torch.clamp(1e-6 + (1.0 - 1e-6) * u, min=1e-6)
    toks = (torch.pow(u, 3.0) * cfg.vocab_size).to(torch.int32)
    toks = torch.clamp(toks, 0, cfg.vocab_size - 1).to(dev)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.is_encdec:
        batch["enc_embeds"] = (0.02 * torch.randn(
            (B, cfg.encoder.n_frames, cfg.d_model), generator=gen)).to(dev)
    if cfg.frontend is not None:
        batch["patch_embeds"] = (0.02 * torch.randn(
            (B, cfg.frontend.num_patches, cfg.d_model), generator=gen)).to(dev)
    return batch


class SyntheticPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed=0,
                 device=None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.device = resolve_device(device)

    def batch(self, step: int):
        return make_batch(self.cfg, self.shape, step, seed=self.seed,
                          device=self.device)
