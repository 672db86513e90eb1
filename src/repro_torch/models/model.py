"""Public model API: init / forward loss / prefill / decode.

The port of the JAX package's ``models/model.py``, with its input
plumbing for each family:
  - LM     : batch = {tokens, targets}
  - encdec : batch = {enc_embeds, tokens, targets} (the frontend is a
             stub: frame embeddings arrive precomputed)
  - vlm    : batch = {patch_embeds, tokens, targets} (the frontend is a
             stub; the patches are prepended to the tokens, and the
             positions of both together are seq_len)
``init_params`` and ``init_cache`` put their tensors on the card unless
the caller passes ``device="cpu"``; with no card and no CPU request they
raise.  The compute dtype is cast at the embedding boundary; the weights
stay in f32 and are cast per use, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import tp
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (apply_embed, apply_lm_head,
                                       apply_norm, cross_entropy_loss,
                                       embed_init, init_embed, init_lm_head,
                                       init_norm, sinusoidal_table,
                                       vocab_parallel, vocab_parallel_loss)


def init_params(cfg: ModelConfig, generator, device=None):
    """Random weights for ``cfg`` in f32, the JAX tree's keys and layouts
    with each stack (the decoder's and an encoder's) as one dict per
    super-block.  ``generator`` is a ``torch.Generator`` on ``device`` (a
    CPU generator also serves the meta device) or an int seed."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(
            device=dev if dev.type == "cuda" else "cpu").manual_seed(generator)
    vp = cfg.padded_vocab()
    p = {
        "embed": init_embed(generator, vp, cfg.d_model, dev),
        "stack": tf.init_stack(generator, cfg, dev, cross=cfg.is_encdec),
        "final_norm": init_norm(cfg.d_model, dev, cfg.norm_type),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_lm_head(generator, cfg.d_model, vp, dev)
    if cfg.pos_embedding == "learned":
        p["pos"] = {"table": embed_init(
            generator, (min(cfg.max_position, 65536), cfg.d_model), dev)}
    if cfg.is_encdec:
        p["encoder"] = {
            "stack": tf.init_stack(generator, _encoder_cfg(cfg), dev),
            "final_norm": init_norm(cfg.d_model, dev, cfg.norm_type)}
    return p


def _encoder_cfg(cfg):
    return dataclasses.replace(cfg, num_layers=cfg.encoder.num_layers,
                               block_defs=(("attn", "dense"),), encoder=None,
                               moe=None)


def _lm_head(p, cfg, x):
    if cfg.tie_embeddings:          # a mesh step's table: gathered whole
        return x @ tp.whole(p["embed"]["table"]).to(x.dtype).T
    return apply_lm_head(p["lm_head"], x, cfg.vocab_size)


def _loss(p, cfg, logits, targets):
    """``cross_entropy_loss``, or its vocabulary-parallel form where a
    mesh step's head leaves each rank its own columns."""
    if not cfg.tie_embeddings and vocab_parallel(p["lm_head"]):
        return vocab_parallel_loss(logits, targets)
    return cross_entropy_loss(logits, targets, cfg.vocab_size)


def _pos_rows(table, offset, n):
    """Rows [offset, offset + n) of a position table, the start clamped
    as ``dynamic_slice_in_dim`` clamps it."""
    at = min(max(int(offset), 0), table.shape[0] - n)
    return table[at:at + n]


def _embed_tokens(p, cfg, tokens, dtype, offset=0):
    x = apply_embed(p["embed"], tokens, dtype)
    if cfg.pos_embedding == "learned":
        x = x + _pos_rows(tp.whole(p["pos"]["table"]), offset,
                          tokens.shape[1]).to(dtype)
    return x


def run_encoder(p, cfg, enc_embeds, *, q_chunk=1024, run_cfg=None):
    """Whisper-style encoder over stub frame embeddings (B,F,D): a
    sinusoidal table added, non-causal self-attention on the chunked
    path (no flash hook, as in the JAX package), the final norm."""
    ecfg = _encoder_cfg(cfg)
    dtype = enc_embeds.dtype
    x = enc_embeds + sinusoidal_table(enc_embeds.shape[1], cfg.d_model,
                                      enc_embeds.device).to(dtype)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = tf.apply_stack(p["encoder"]["stack"], x, ecfg,
                             positions=positions, causal=False,
                             q_chunk=q_chunk, run_cfg=run_cfg)
    return apply_norm(tp.whole_tree(p["encoder"]["final_norm"]), x,
                      cfg.norm_type)


def _assemble_inputs(p, cfg, batch, dtype):
    """Returns (x, positions, enc_out, n_prefix)."""
    enc_out = None
    n_prefix = 0
    x = _embed_tokens(p, cfg, batch["tokens"], dtype)
    if cfg.is_encdec:
        enc_out = run_encoder(p, cfg, batch["enc_embeds"].to(dtype))
    elif cfg.frontend is not None:
        patches = batch["patch_embeds"].to(dtype)
        x = torch.cat([patches, x], dim=1)
        n_prefix = patches.shape[1]
    return x, torch.arange(x.shape[1], device=x.device), enc_out, n_prefix


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
    x, positions, enc_out, n_prefix = _assemble_inputs(p, cfg, batch,
                                                       compute_dtype)
    x, _, aux = tf.apply_stack(p["stack"], x, cfg, positions=positions,
                               causal=True, q_chunk=q_chunk, enc_out=enc_out,
                               cross=cfg.is_encdec, run_cfg=run_cfg,
                               flash_fn=flash_fn, gmm_fn=gmm_fn,
                               scan_fn=scan_fn, chunk_fn=chunk_fn)
    x = apply_norm(tp.whole_tree(p["final_norm"]), x, cfg.norm_type)
    if n_prefix:
        x = x[:, n_prefix:]
    logits = _lm_head(p, cfg, x)
    loss = _loss(p, cfg, logits, batch["targets"])
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
    H) f32 and ``{"conv"}`` per sLSTM sub-block; an MLA sub-block's
    latent cache ``{"c_kv"}`` (batch, max_len, kv_lora_rank) and
    ``{"k_rope"}`` (batch, max_len, rope_dim); an encoder-decoder's
    ``{"self": kv, "cross": kv}`` with n_frames zeroed cross rows."""
    return tf.init_stack_state(cfg, batch, max_len, dtype,
                               resolve_device(device), cross=cfg.is_encdec)


def prefill(p, cfg: ModelConfig, batch, *, compute_dtype=torch.bfloat16,
            q_chunk=1024, flash_fn=None, gmm_fn=None):
    """Full-sequence prefill on the reference path (chunked attention,
    chunked Mamba scan, einsum experts, chunked mLSTM) unless the flash
    and ``moe_gmm`` hooks are given (the scan's and the mLSTM's kernels
    return no state); returns (last-token logits, caches): KV and latent
    caches seq-aligned with the prompt (a VLM's patches included), Mamba
    and xLSTM states after the prompt; an encoder-decoder's cross cache
    is the encoder's kv."""
    x, positions, enc_out, _ = _assemble_inputs(p, cfg, batch, compute_dtype)
    x, caches, _ = tf.apply_stack(p["stack"], x, cfg, positions=positions,
                                  causal=True, q_chunk=q_chunk,
                                  enc_out=enc_out, cross=cfg.is_encdec,
                                  collect_cache=True, flash_fn=flash_fn,
                                  gmm_fn=gmm_fn)
    x = apply_norm(tp.whole_tree(p["final_norm"]), x, cfg.norm_type)
    logits = _lm_head(p, cfg, x[:, -1:, :])
    return logits, caches


def decode_step(p, cfg: ModelConfig, caches, token, pos, *,
                compute_dtype=torch.bfloat16):
    """One decode step.  token: (B,1) integer tensor; pos: int (write
    index).  Returns (logits (B,1,V), caches); the KV caches are written
    in place, the Mamba and xLSTM states come back new.  A learned
    position table adds its row ``pos``."""
    pos = int(pos)
    x = _embed_tokens(p, cfg, token, compute_dtype, offset=pos)
    x, new_caches = tf.decode_stack(p["stack"], x, caches, cfg, pos=pos)
    x = apply_norm(tp.whole_tree(p["final_norm"]), x, cfg.norm_type)
    logits = _lm_head(p, cfg, x)
    return logits, new_caches


def param_count(params) -> int:
    def count(node):
        if isinstance(node, torch.Tensor):
            return node.numel()
        items = node.values() if isinstance(node, dict) else node
        return sum(count(c) for c in items)
    return count(params)
