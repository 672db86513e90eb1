"""GQA attention with a memory-bounded chunked reference path + KV cache.

The port of the JAX package's ``models/attention.py``.  The reference
path chunks the query dimension (a Python loop where the JAX package
scans) so a long prefill never materializes a full (S, S) score tensor;
causal self-attention is also KV-segmented.  ``attention_forward`` takes
the flash kernel through its ``flash_fn`` hook, as the JAX package does;
decode always goes through the chunked path.
"""
from __future__ import annotations

import torch

from repro_torch.models.layers import apply_rope, dense_init

# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def init_attention(gen, d_model, num_heads, num_kv_heads, head_dim, device):
    return {
        "wq": dense_init(gen, (d_model, num_heads, head_dim), device),
        "wk": dense_init(gen, (d_model, num_kv_heads, head_dim), device),
        "wv": dense_init(gen, (d_model, num_kv_heads, head_dim), device),
        "wo": dense_init(gen, (num_heads, head_dim, d_model), device,
                         in_axis_size=num_heads * head_dim),
    }


# --------------------------------------------------------------------------
# core scaled-dot-product with GQA grouping
# --------------------------------------------------------------------------

def _sdpa(q, k, v, mask):
    """q: (B,Sq,H,D), k/v: (B,Skv,Hkv,D), mask: (B,Sq,Skv) bool or None.
    Returns (B,Sq,H,D).  Scores and softmax in f32; the probabilities are
    cast to q's dtype before the product with v, as in the JAX package."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Sq, Hkv, G, D)
    scale = D ** -0.5
    # JAX's preferred_element_type=f32: f32 scores straight from the
    # inputs, not rounded to a bf16 product first
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    if mask is not None:
        big_neg = torch.finfo(torch.float32).min
        scores = scores.masked_fill(~mask[:, None, None, :, :], big_neg)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(B, Sq, H, v.shape[-1])


def chunked_attention(q, k, v, *, q_positions, kv_positions, causal,
                      kv_valid_len=None, q_chunk=1024, _segment=True):
    """Query-chunked attention.  Shapes as _sdpa.  Positions are (Sq,)/(Skv,)
    integer tensors of absolute positions used for causal masking;
    kv_valid_len (an int) masks unwritten cache slots.

    Causal self-attention is KV-segmented: query segment j only sees
    kv[: (j+1)*Sq/nseg], as in the JAX package."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]

    if (_segment and causal and Sq == Skv and kv_valid_len is None
            and Sq % q_chunk == 0 and Sq // q_chunk >= 2):
        nseg = min(4, Sq // q_chunk)
        if Sq % nseg == 0:
            qs = Sq // nseg
            outs = []
            for j in range(nseg):
                kv_end = (j + 1) * qs
                outs.append(chunked_attention(
                    q[:, j * qs:(j + 1) * qs], k[:, :kv_end], v[:, :kv_end],
                    q_positions=q_positions[j * qs:(j + 1) * qs],
                    kv_positions=kv_positions[:kv_end], causal=True,
                    q_chunk=q_chunk, _segment=False))
            return torch.cat(outs, dim=1)

    def mask_for(qpos):
        m = torch.ones((qpos.shape[0], Skv), dtype=torch.bool,
                       device=q.device)
        if causal:
            m &= qpos[:, None] >= kv_positions[None, :]
        if kv_valid_len is not None:
            m &= (kv_positions < kv_valid_len)[None, :]
        return m[None].expand((B,) + m.shape)

    needs_mask = causal or (kv_valid_len is not None)
    if Sq <= q_chunk or Sq % q_chunk != 0:
        return _sdpa(q, k, v, mask_for(q_positions) if needs_mask else None)

    outs = []
    for c in range(Sq // q_chunk):
        sl = slice(c * q_chunk, (c + 1) * q_chunk)
        outs.append(_sdpa(q[:, sl], k, v,
                          mask_for(q_positions[sl]) if needs_mask else None))
    return torch.cat(outs, dim=1)


# --------------------------------------------------------------------------
# block-level apply
# --------------------------------------------------------------------------

def _project_qkv(p, x, rope_theta, positions, use_rope):
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(dt))
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q, k, v


def attention_forward(p, x, *, positions, causal=True, rope_theta=1e4,
                      use_rope=True, q_chunk=1024, flash_fn=None):
    """Full-sequence self-attention (train / prefill).  x: (B,S,D).
    Returns (out, (k, v)): k/v seed the cache after a prefill."""
    q, k, v = _project_qkv(p, x, rope_theta, positions, use_rope)
    if flash_fn is not None:
        out = flash_fn(q, k, v, causal=causal)
    else:
        out = chunked_attention(q, k, v, q_positions=positions,
                                kv_positions=positions, causal=causal,
                                q_chunk=q_chunk)
    dt = x.dtype
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt)), (k, v)


def init_kv_cache(batch, max_len, num_kv_heads, head_dim, dtype, device):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x, cache, *, pos, rope_theta=1e4, use_rope=True):
    """One-token decode.  x: (B,1,D); cache {"k","v"}: (B,Smax,Hkv,D);
    pos: int, the index of the new token.  Returns (out, cache).

    The new k/v are written at ``pos`` for every batch slot, in place
    (the JAX package returns an updated copy; writing in place spares a
    copy of the cache per step).  Like ``dynamic_update_slice``, the
    write index is clamped into the cache."""
    dt = x.dtype
    # filled on the device: no host-to-device copy to wait on
    pos_t = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k_new = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(dt))
    v_new = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(dt))
    if use_rope:
        q = apply_rope(q, pos_t, rope_theta)
        k_new = apply_rope(k_new, pos_t, rope_theta)
    smax = cache["k"].shape[1]
    at = min(max(pos, 0), smax - 1)
    cache["k"][:, at:at + 1] = k_new.to(cache["k"].dtype)
    cache["v"][:, at:at + 1] = v_new.to(cache["v"].dtype)

    kv_positions = torch.arange(smax, device=x.device)
    out = chunked_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                            q_positions=pos_t, kv_positions=kv_positions,
                            causal=False, kv_valid_len=pos + 1)
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt)), cache
