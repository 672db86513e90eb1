"""Block / super-block assembly and the layer stack.

The port of the JAX package's ``models/transformer.py`` for the
("attn", "dense") sub-block: pre-norm GQA self-attention, then a pre-norm
dense FFN.  The JAX package stacks each leaf on a leading ``n_super`` axis
and scans it; here the stack is a list with one dict per super-block
(same keys, ``{"b0": ...}``), walked by a Python loop.  Nothing here
takes a gradient, so there is no rematerialization.  Every other branch
of the JAX package raises, naming the ROADMAP item that ports it
(encoder-decoder inputs raise in ``models/model.py``).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import apply_ffn, apply_norm, init_ffn, init_norm

# the ROADMAP item that ports each part the JAX package has beyond the
# ("attn", "dense") sub-block with GQA
_NOT_PORTED = {"mla": "A9", "qk_norm": "A8", "moe": "A8", "mamba": "A10",
               "mlstm": "A11", "slstm": "A11"}


def _check_supported(cfg, mixer, ffn):
    parts = [cfg.attention_type if mixer == "attn" else mixer, ffn]
    if cfg.qk_norm:
        parts.append("qk_norm")
    for part in parts:
        if part in _NOT_PORTED:
            raise NotImplementedError(
                f"{cfg.name}: {part!r} is not ported yet: ROADMAP "
                f"{_NOT_PORTED[part]}")
    if (mixer, ffn) != ("attn", "dense"):
        raise ValueError((mixer, ffn))


# --------------------------------------------------------------------------
# single sub-block
# --------------------------------------------------------------------------

def init_subblock(gen, cfg, mixer, ffn, device):
    _check_supported(cfg, mixer, ffn)
    return {"norm1": init_norm(cfg.d_model, device, cfg.norm_type),
            "mixer": attn.init_attention(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, device),
            "norm2": init_norm(cfg.d_model, device, cfg.norm_type),
            "ffn": init_ffn(gen, cfg.d_model, cfg.d_ff, device, cfg.ffn_type)}


def apply_subblock(p, x, cfg, mixer, ffn, *, positions, causal, q_chunk,
                   flash_fn=None):
    """Full-sequence apply.  Returns (x, cache_seed, aux)."""
    _check_supported(cfg, mixer, ffn)
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    y, (k, v) = attn.attention_forward(
        p["mixer"], h, positions=positions, causal=causal,
        rope_theta=cfg.rope_theta, use_rope=(cfg.pos_embedding == "rope"),
        q_chunk=q_chunk, flash_fn=flash_fn)
    x = x + y
    x = x + apply_ffn(p["ffn"], apply_norm(p["norm2"], x, cfg.norm_type),
                      cfg.ffn_type)
    return x, {"k": k, "v": v}, torch.zeros((), dtype=torch.float32,
                                            device=x.device)


def apply_subblock_decode(p, x, state, cfg, mixer, ffn, *, pos):
    """One-token apply.  Returns (x, new_state); the KV cache in
    ``state`` is written in place."""
    _check_supported(cfg, mixer, ffn)
    h = apply_norm(p["norm1"], x, cfg.norm_type)
    y, new_state = attn.attention_decode(
        p["mixer"], h, state, pos=pos, rope_theta=cfg.rope_theta,
        use_rope=(cfg.pos_embedding == "rope"))
    x = x + y
    x = x + apply_ffn(p["ffn"], apply_norm(p["norm2"], x, cfg.norm_type),
                      cfg.ffn_type)
    return x, new_state


def init_subblock_state(cfg, idx_def, batch, max_len, dtype, device):
    _check_supported(cfg, *cfg.block_defs[idx_def])
    return attn.init_kv_cache(batch, max_len, cfg.num_kv_heads, cfg.head_dim,
                              dtype, device)


# --------------------------------------------------------------------------
# the stack: one dict per super-block
# --------------------------------------------------------------------------

def init_stack(gen, cfg, device):
    return [{f"b{i}": init_subblock(gen, cfg, m, f, device)
             for i, (m, f) in enumerate(cfg.block_defs)}
            for _ in range(cfg.n_super)]


def apply_stack(stack_params, x, cfg, *, positions, causal=True, q_chunk=1024,
                collect_cache=False, flash_fn=None):
    """Run the super-blocks over x.  Returns (x, caches|None, aux), caches
    being one ``{"b<i>": {"k","v"}}`` per super-block."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for layer_p in stack_params:
        seeds = {}
        for i, (m, f) in enumerate(cfg.block_defs):
            x, seeds[f"b{i}"], a = apply_subblock(
                layer_p[f"b{i}"], x, cfg, m, f, positions=positions,
                causal=causal, q_chunk=q_chunk, flash_fn=flash_fn)
            aux = aux + a
        if collect_cache:
            caches.append(seeds)
    return x, (caches if collect_cache else None), aux


def decode_stack(stack_params, x, caches, cfg, *, pos):
    """One-token decode through every super-block; caches are written in
    place and returned."""
    new_caches = []
    for layer_p, cache in zip(stack_params, caches):
        new_cache = {}
        for i, (m, f) in enumerate(cfg.block_defs):
            x, new_cache[f"b{i}"] = apply_subblock_decode(
                layer_p[f"b{i}"], x, cache[f"b{i}"], cfg, m, f, pos=pos)
        new_caches.append(new_cache)
    return x, new_caches


def init_stack_state(cfg, batch, max_len, dtype, device):
    return [{f"b{i}": init_subblock_state(cfg, i, batch, max_len, dtype,
                                          device)
             for i in range(len(cfg.block_defs))}
            for _ in range(cfg.n_super)]
