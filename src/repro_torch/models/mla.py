"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The port of the JAX package's ``models/mla.py``.  Train and prefill use
the decompressed form through the chunked reference attention (the JAX
package runs no kernel here, so neither does the port: q/k head dim
nope + rope, v head dim ``v_head_dim``); decode uses the absorbed form
against the compressed latent cache (``c_kv`` + ``k_rope``, kv_lora +
rope_dim numbers per token instead of 2 * H * head_dim), written in
place as the port's KV caches are.

Every function here takes the weights as plain tensors or as a mesh
step's ``tp.Stored`` leaves, as the JAX package's compiled step splits
them where the rule splits the heads (``heads_split``): the
down-projections ``w_dq`` / ``w_dkv`` / ``w_kr`` column-parallel on
their rank dim and the latents gathered whole over "model" (the JAX
model constrains them to ``("batch", None, None)``); the heads, their
up-projections, the attention and ``wo`` on the rank's heads.  Where
the rule keeps the heads whole, every weight is gathered and all of
MLA runs whole on every rank.  On plain tensors nothing is split.
"""
from __future__ import annotations

import torch

from repro_torch.models import tp
from repro_torch.models.attention import chunked_attention
from repro_torch.models.layers import (apply_norm, apply_rope, dense_init,
                                       init_norm)


def init_mla(gen, d_model, num_heads, mla, device):
    qk_head = mla.qk_nope_head_dim + mla.qk_rope_head_dim
    return {
        "w_dq": dense_init(gen, (d_model, mla.q_lora_rank), device),
        "q_norm": init_norm(mla.q_lora_rank, device),
        "w_uq": dense_init(gen, (mla.q_lora_rank, num_heads, qk_head),
                           device),
        "w_dkv": dense_init(gen, (d_model, mla.kv_lora_rank), device),
        "kv_norm": init_norm(mla.kv_lora_rank, device),
        "w_kr": dense_init(gen, (d_model, mla.qk_rope_head_dim), device),
        "w_uk": dense_init(gen, (mla.kv_lora_rank, num_heads,
                                 mla.qk_nope_head_dim), device),
        "w_uv": dense_init(gen, (mla.kv_lora_rank, num_heads,
                                 mla.v_head_dim), device),
        "wo": dense_init(gen, (num_heads, mla.v_head_dim, d_model), device,
                         in_axis_size=num_heads * mla.v_head_dim),
    }


def heads_split(p) -> bool:
    """Whether the rule splits this MLA's heads over "model" (False for
    plain tensors)."""
    return tp.split_on(p["w_uq"], 1)


def _norm(p, heads):
    return {k: (tp.shared if heads else tp.whole)(v) for k, v in p.items()}


def _up(w, heads):
    return tp.local(w) if heads else tp.whole(w)


def _latents(p, x, positions, mla, rope_theta, down=None):
    """Compressed latents for the kv side: c_kv (B,S,r), k_rope (B,S,dr)."""
    heads = heads_split(p)
    down = down or tp.Columns(x, heads)
    c_kv = apply_norm(_norm(p["kv_norm"], heads), down(p["w_dkv"]))
    k_rope = down(p["w_kr"])[:, :, None, :]                    # (B,S,1,dr)
    k_rope = apply_rope(k_rope, positions, rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _queries(p, x, positions, mla, rope_theta, down=None):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope)): the rank's heads where
    they are split."""
    dt = x.dtype
    heads = heads_split(p)
    down = down or tp.Columns(x, heads)
    c_q = apply_norm(_norm(p["q_norm"], heads), down(p["w_dq"]))
    q = torch.einsum("bsr,rhe->bshe", c_q, _up(p["w_uq"], heads).to(dt))
    q_nope = q[..., :mla.qk_nope_head_dim]
    q_rope = apply_rope(q[..., mla.qk_nope_head_dim:], positions, rope_theta)
    return q_nope, q_rope


def mla_forward(p, x, *, positions, mla, rope_theta, q_chunk=1024):
    """Full-sequence causal MLA (decompressed form).  Returns (out,
    (c_kv, k_rope)): the latents (whole on every "model" rank) seed the
    compressed cache."""
    dt = x.dtype
    B, S, _ = x.shape
    heads = heads_split(p)
    down = tp.Columns(x, heads)
    q_nope, q_rope = _queries(p, x, positions, mla, rope_theta, down)
    c_kv, k_rope = _latents(p, x, positions, mla, rope_theta, down)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv,
                          _up(p["w_uk"], heads).to(dt))
    v = torch.einsum("bsr,rhe->bshe", c_kv, _up(p["w_uv"], heads).to(dt))
    H = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, mla.qk_rope_head_dim)], dim=-1)
    out = chunked_attention(q, k, v, q_positions=positions,
                            kv_positions=positions, causal=True,
                            q_chunk=q_chunk)
    y = torch.einsum("bshe,hed->bsd", out, _up(p["wo"], heads).to(dt))
    return tp.out_of_model(y, heads), (c_kv, k_rope)


def init_mla_cache(batch, max_len, mla, dtype, device):
    return {"c_kv": torch.zeros((batch, max_len, mla.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, mla.qk_rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_decode(p, x, cache, *, pos, mla, rope_theta, seq=None):
    """Absorbed-form one-token decode against the compressed cache.
    x: (B,1,D); pos: int.  The new latents are written at ``pos``
    (clamped into the cache, as ``dynamic_update_slice`` clamps), in
    place.  Returns (out, cache).  ``seq``: a mesh step's sequence slice
    of the cache, as ``attention.attention_decode`` takes it.  With the
    heads split, the rank absorbs its heads' queries, the scores run
    over every head (gathered over "model") against the rank's slice of
    the sequence, and the rank's heads of the context leave through
    ``w_uv`` and ``wo`` (g)."""
    dt = x.dtype
    heads = heads_split(p)
    pos_t = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    down = tp.Columns(x, heads)
    q_nope, q_rope = _queries(p, x, pos_t, mla, rope_theta,
                              down)                           # (B,1,H,*)
    c_new, kr_new = _latents(p, x, pos_t, mla, rope_theta, down)
    smax = cache["c_kv"].shape[1]
    groups, offset, length = seq or ((), 0, smax)
    at = min(max(pos, 0), length - 1) - offset
    if 0 <= at < smax:
        cache["c_kv"][:, at:at + 1] = c_new.to(cache["c_kv"].dtype)
        cache["k_rope"][:, at:at + 1] = kr_new.to(cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"].to(dt), cache["k_rope"].to(dt)

    # absorb W_uk into q: q_abs (B,1,H,r)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope,
                         _up(p["w_uk"], heads).to(dt))
    q_abs = tp.gather_model(q_abs, 2, heads)
    q_rope = tp.gather_model(q_rope, 2, heads)
    scale = (mla.qk_nope_head_dim + mla.qk_rope_head_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_abs, c_kv) +
              torch.einsum("bshe,bte->bhst", q_rope, k_rope))
    scores = scores.to(torch.float32) * scale
    t_pos = torch.arange(smax, device=x.device) + offset
    scores = scores.masked_fill(~(t_pos <= pos)[None, None, None, :],
                                torch.finfo(torch.float32).min)
    probs = tp.seq_softmax(scores, groups).to(dt)
    ctx = tp.seq_sum(torch.einsum("bhst,btr->bshr", probs, c_kv),
                     groups)                                      # (B,1,H,r)
    ctx = tp.model_slice(ctx, 2, heads)
    out = torch.einsum("bshr,rhe->bshe", ctx, _up(p["w_uv"], heads).to(dt))
    y = torch.einsum("bshe,hed->bsd", out, _up(p["wo"], heads).to(dt))
    return tp.out_of_model(y, heads), cache
