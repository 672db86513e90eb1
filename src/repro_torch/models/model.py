"""Public model API: init / forward loss / prefill / decode.

The port of the JAX package's ``models/model.py`` for language models
(batch = {tokens, targets}); the encoder-decoder and VLM input plumbing
raises.  ``init_params`` and ``init_cache`` put their tensors on the card
unless the caller passes ``device="cpu"``; with no card and no CPU
request they raise.  The compute dtype is cast at the embedding boundary;
the weights stay in f32 and are cast per use, as in the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (apply_embed, apply_lm_head,
                                       apply_norm, cross_entropy_loss,
                                       init_embed, init_lm_head, init_norm)


def _check_lm(cfg: ModelConfig) -> None:
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models are "
                                  "not ported yet: ROADMAP A12")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: VLM patch inputs are not "
                                  "ported yet: ROADMAP A6")
    if cfg.pos_embedding not in ("rope", "none"):
        raise NotImplementedError(f"{cfg.name}: {cfg.pos_embedding} position "
                                  "embeddings are not ported yet: ROADMAP A6")
    if cfg.tie_embeddings:
        raise NotImplementedError(f"{cfg.name}: tied embeddings are not "
                                  "ported yet: ROADMAP A6")


def init_params(cfg: ModelConfig, generator, device=None):
    """Random weights for ``cfg`` in f32, the JAX tree's keys and layouts
    with the stack as one dict per super-block.  ``generator`` is a
    ``torch.Generator`` on ``device`` (a CPU generator also serves the
    meta device) or an int seed."""
    dev = resolve_device(device)
    _check_lm(cfg)
    if isinstance(generator, int):
        generator = torch.Generator(
            device=dev if dev.type == "cuda" else "cpu").manual_seed(generator)
    vp = cfg.padded_vocab()
    return {
        "embed": init_embed(generator, vp, cfg.d_model, dev),
        "stack": tf.init_stack(generator, cfg, dev),
        "final_norm": init_norm(cfg.d_model, dev, cfg.norm_type),
        "lm_head": init_lm_head(generator, cfg.d_model, vp, dev),
    }


def _assemble_inputs(p, cfg, batch, dtype):
    """Returns (x, positions) for a language model."""
    _check_lm(cfg)
    x = apply_embed(p["embed"], batch["tokens"], dtype)
    return x, torch.arange(x.shape[1], device=x.device)


def forward_loss(p, cfg: ModelConfig, batch, *, compute_dtype=torch.bfloat16,
                 run_cfg=None, flash_fn=None, gmm_fn=None, scan_fn=None,
                 chunk_fn=None):
    """Training forward: mean CE loss + the MoE aux loss (zero for models
    without MoE).  targets == -1 are masked.  ``run_cfg.remat``
    recomputes each super-block in the backward pass
    (``launch.steps.make_train_step`` takes the gradient).  The kernels
    come in only through the hooks: ``flash_fn`` (attention),
    ``gmm_fn`` (the MoE experts' grouped products), ``scan_fn`` (the
    Mamba selective scan) and ``chunk_fn`` (the mLSTM's chunkwise
    recurrence); ``launch.steps._resolve_kernels`` gives all four for
    ``attention_impl="pallas"``."""
    q_chunk = getattr(run_cfg, "attention_q_chunk", 1024) if run_cfg else 1024
    x, positions = _assemble_inputs(p, cfg, batch, compute_dtype)
    x, _, aux = tf.apply_stack(p["stack"], x, cfg, positions=positions,
                               causal=True, q_chunk=q_chunk, run_cfg=run_cfg,
                               flash_fn=flash_fn, gmm_fn=gmm_fn,
                               scan_fn=scan_fn, chunk_fn=chunk_fn)
    x = apply_norm(p["final_norm"], x, cfg.norm_type)
    logits = apply_lm_head(p["lm_head"], x, cfg.vocab_size)
    loss = cross_entropy_loss(logits, batch["targets"], cfg.vocab_size)
    return loss + aux.to(torch.float32), {"ce": loss, "aux": aux}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch, max_len, dtype=torch.bfloat16,
               device=None):
    """Zeroed decode state, one ``{"b<i>": ...}`` per super-block: a KV
    cache ``{"k","v"}`` (batch, max_len, Hkv, head_dim) per attention
    sub-block, a Mamba state ``{"h"}`` (batch, d_inner, d_state) f32 and
    ``{"conv"}`` (batch, d_conv - 1, d_inner) per Mamba sub-block, an
    mLSTM state ``{"C","n","m"}`` f32 and ``{"conv"}`` per mLSTM
    sub-block, an sLSTM state ``{"c","n","h","m"}`` (batch, H, d_model /
    H) f32 and ``{"conv"}`` per sLSTM sub-block."""
    _check_lm(cfg)
    return tf.init_stack_state(cfg, batch, max_len, dtype,
                               resolve_device(device))


def prefill(p, cfg: ModelConfig, batch, *, compute_dtype=torch.bfloat16,
            q_chunk=1024):
    """Full-sequence prefill on the reference path (chunked attention,
    chunked Mamba scan, einsum experts, chunked mLSTM); returns
    (last-token logits, caches): KV caches seq-aligned with the prompt,
    Mamba and xLSTM states after the prompt."""
    x, positions = _assemble_inputs(p, cfg, batch, compute_dtype)
    x, caches, _ = tf.apply_stack(p["stack"], x, cfg, positions=positions,
                                  causal=True, q_chunk=q_chunk,
                                  collect_cache=True)
    x = apply_norm(p["final_norm"], x, cfg.norm_type)
    logits = apply_lm_head(p["lm_head"], x[:, -1:, :], cfg.vocab_size)
    return logits, caches


def decode_step(p, cfg: ModelConfig, caches, token, pos, *,
                compute_dtype=torch.bfloat16):
    """One decode step.  token: (B,1) integer tensor; pos: int (write
    index).  Returns (logits (B,1,V), caches); the KV caches are written
    in place, the Mamba and xLSTM states come back new."""
    _check_lm(cfg)
    x = apply_embed(p["embed"], token, compute_dtype)
    x, new_caches = tf.decode_stack(p["stack"], x, caches, cfg, pos=int(pos))
    x = apply_norm(p["final_norm"], x, cfg.norm_type)
    logits = apply_lm_head(p["lm_head"], x, cfg.vocab_size)
    return logits, new_caches


def param_count(params) -> int:
    def count(node):
        if isinstance(node, torch.Tensor):
            return node.numel()
        items = node.values() if isinstance(node, dict) else node
        return sum(count(c) for c in items)
    return count(params)
