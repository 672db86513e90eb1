"""GQA attention with a memory-bounded chunked reference path + KV cache.

The port of the JAX package's ``models/attention.py``.  The reference
path chunks the query dimension (a Python loop where the JAX package
scans) so a long prefill never materializes a full (S, S) score tensor;
causal self-attention is also KV-segmented.  Qwen3's qk-norm (a per-head
RMS norm of q and k before RoPE) and the encoder-decoder's
cross-attention are here too.  ``attention_forward`` takes the flash
kernel through its ``flash_fn`` hook for self-attention, as the JAX
package does; cross-attention and decode always go through the chunked
path.
"""
from __future__ import annotations

import torch

from repro_torch.models import tp
from repro_torch.models.layers import apply_rope, dense_init, rms_head_norm

# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------


def init_attention(gen, d_model, num_heads, num_kv_heads, head_dim, device,
                   qk_norm=False):
    p = {
        "wq": dense_init(gen, (d_model, num_heads, head_dim), device),
        "wk": dense_init(gen, (d_model, num_kv_heads, head_dim), device),
        "wv": dense_init(gen, (d_model, num_kv_heads, head_dim), device),
        "wo": dense_init(gen, (num_heads, head_dim, d_model), device,
                         in_axis_size=num_heads * head_dim),
    }
    if qk_norm:
        p["q_norm"] = torch.ones(head_dim, dtype=torch.float32, device=device)
        p["k_norm"] = torch.ones(head_dim, dtype=torch.float32, device=device)
    return p


# --------------------------------------------------------------------------
# core scaled-dot-product with GQA grouping
# --------------------------------------------------------------------------

def _sdpa(q, k, v, mask, groups=(), heads_to=None):
    """q: (B,Sq,H,D), k/v: (B,Skv,Hkv,D), mask: (B,Sq,Skv) bool or None.
    Returns (B,Sq,H,D).  Scores and softmax in f32; the probabilities are
    cast to q's dtype before the product with v, as in the JAX package.
    ``groups``: the process groups over whose ranks the keys are split
    (a decode cache's sequence slices): the softmax's max and sum and the
    output are reduced over them (``tp.seq_softmax``).  ``heads_to``, one
    of ``groups``: the output is reduce-scattered over its ranks on the
    head dim instead (each keeps its slice of the H heads)."""
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
    probs = tp.seq_softmax(scores, groups).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v).reshape(
        B, Sq, H, v.shape[-1])
    if heads_to is None:
        return tp.seq_sum(out, groups)
    out = tp.seq_sum(out, [g for g in groups if g is not heads_to])
    return tp.reduce_scatter(out, heads_to, tp.model_size(), 2)


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

def _project_qkv(p, x, x_kv, rope_theta, q_positions, kv_positions,
                 qk_norm, use_rope):
    dt = x.dtype
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhe->bshe", x_kv, p["wk"].to(dt))
    v = torch.einsum("bsd,dhe->bshe", x_kv, p["wv"].to(dt))
    if qk_norm:                           # before RoPE, as in Qwen3
        q = rms_head_norm(q, p["q_norm"])
        k = rms_head_norm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, q_positions, rope_theta)
        k = apply_rope(k, kv_positions, rope_theta)
    return q, k, v


def attention_forward(p, x, *, positions, causal=True, rope_theta=1e4,
                      use_rope=True, qk_norm=False, q_chunk=1024,
                      x_cross=None, flash_fn=None):
    """Full-sequence attention (train / prefill / encoder).  x: (B,S,D);
    x_cross: the encoder's output (B,F,D), the kv source of
    cross-attention (kv positions arange(F), no RoPE, not causal, always
    the chunked path: the JAX package gives ``flash_fn`` to
    self-attention only).  Returns (out, (k, v)): k/v seed the cache
    after a prefill."""
    x_kv = x if x_cross is None else x_cross
    kv_pos = positions if x_cross is None else \
        torch.arange(x_kv.shape[1], device=x.device)
    q, k, v = _project_qkv(p, x, x_kv, rope_theta, positions, kv_pos,
                           qk_norm, use_rope and x_cross is None)
    if flash_fn is not None and x_cross is None:
        out = flash_fn(q, k, v, causal=causal)
    else:
        out = chunked_attention(q, k, v, q_positions=positions,
                                kv_positions=kv_pos,
                                causal=causal and x_cross is None,
                                q_chunk=q_chunk)
    dt = x.dtype
    return torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt)), (k, v)


def attention_rows(p, x, grp, *, positions, causal=True, rope_theta=1e4,
                   use_rope=True, qk_norm=False, q_chunk=1024, x_cross=None,
                   flash_fn=None):
    """``attention_forward`` on one rank's share of a ``tp.HeadGroups``
    group: ``p`` holds the group's heads (``tp.attention_groups``), x
    every row.  Where the group is the rank's alone (R = 1), that is
    ``attention_forward`` on its heads.  Else the rank projects q on its
    query rows (``grp.rows``: two chunks where causal, so each rank
    attends to as many keys) and k / v on its share of the kv rows (the
    encoder's frames for cross-attention), joined over the block
    (``grp.gather_rows``), and attends each chunk to the keys it sees
    (the flash kernel with the chunk's ``q_offset`` where ``flash_fn`` is
    given).  Returns (the output on the rank's rows, zero on the others:
    a sum over "model" makes it every group's on every row; (k, v) of
    every kv row for the group's kv heads)."""
    B, S, _ = x.shape
    self_causal = causal and x_cross is None
    spans = grp.rows(S, self_causal)
    mine = grp.R == 1
    rows = None if mine else torch.cat(
        [torch.arange(a, b) for a, b in spans]).to(x.device)
    x_r, pos_r = (x, positions) if mine else (x[:, rows], positions[rows])
    if x_cross is None:
        kv_src, kv_len, kv_pos, kv_pos_r = x_r, S, positions, pos_r
    else:
        kv_len = x_cross.shape[1]
        (a, b), = grp.rows(kv_len, False)
        kv_src = x_cross if mine else x_cross[:, a:b]
        kv_pos = torch.arange(kv_len, device=x.device)
        kv_pos_r = kv_pos[a:b]
    q, k, v = _project_qkv(p, x_r, kv_src, rope_theta, pos_r, kv_pos_r,
                           qk_norm, use_rope and x_cross is None)
    k, v = (grp.gather_rows(t, kv_len, self_causal) for t in (k, v))
    outs, at = [], 0
    for a, b in spans:
        qc = q if mine else q[:, at:at + b - a]
        at += b - a
        end = b if self_causal else kv_len
        kc, vc = (k, v) if end == kv_len else (k[:, :end], v[:, :end])
        if flash_fn is not None and x_cross is None:
            outs.append(flash_fn(qc, kc, vc, causal=causal,
                                 q_offset=a if causal else 0))
        else:
            outs.append(chunked_attention(
                qc, kc, vc, q_positions=positions[a:b],
                kv_positions=kv_pos[:end], causal=self_causal,
                q_chunk=q_chunk))
    out = outs[0] if mine else torch.cat(outs, dim=1)
    y = torch.einsum("bshe,hed->bsd", out, p["wo"].to(x.dtype))
    if not mine:
        y = y.new_zeros((B, S, y.shape[-1])).index_copy(1, rows, y)
    return y, (k, v)


def init_kv_cache(batch, max_len, num_kv_heads, head_dim, dtype, device):
    shape = (batch, max_len, num_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p, x, cache, *, pos, rope_theta=1e4, use_rope=True,
                     qk_norm=False, cross=False, seq=None, head_groups=None):
    """One-token decode.  x: (B,1,D); cache {"k","v"}: (B,Smax,Hkv,D);
    pos: int, the index of the new token.  Returns (out, cache).

    Self-attention writes the new k/v at ``pos`` for every batch slot,
    in place (the JAX package returns an updated copy; writing in place
    spares a copy of the cache per step).  Like ``dynamic_update_slice``,
    the write index is clamped into the cache.  With ``cross`` the cache
    is the encoder's static kv: nothing is written, every key is valid
    and q takes no RoPE.

    On a mesh step's ranks: ``seq`` = (groups, offset, length) when the
    cache holds the rank's slice [offset, offset + Smax) of a sequence of
    ``length`` split over ``groups`` (``tp.seq_split``): the rank whose
    slice holds ``pos`` writes, and the softmax is combined over the
    groups; ``head_groups`` (a ``tp.HeadGroups``): ``p`` holds the
    rank's group of q heads (and its kv slice, or every kv head), so q
    (and the new k / v) are gathered over "model" before attention, one
    copy a group, and the output keeps the group's heads for its
    row-parallel ``wo`` (reduce-scattered to them where each rank is a
    group and "model" is one of the sequence's groups); a block of R > 1
    ranks splits the rows (``batch_rows``) for q and for ``wo`` (where R
    does not divide the rows, each rank takes every row and the block's
    first adds its group's output)."""
    dt = x.dtype
    # filled on the device: no host-to-device copy to wait on
    pos_t = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    part = None if head_groups is None else \
        head_groups.batch_rows(x.shape[0])
    q = torch.einsum("bsd,dhe->bshe", x if part is None else x[part],
                     p["wq"].to(dt))
    if qk_norm:
        q = rms_head_norm(q, p["q_norm"])
    if use_rope and not cross:
        q = apply_rope(q, pos_t, rope_theta)
    if head_groups is not None:
        q = head_groups.gather_heads(q, rows=part is not None)

    smax = cache["k"].shape[1]
    groups, offset, length = seq or ((), 0, smax)
    if cross:
        kv_valid = None
    else:
        k_new = torch.einsum("bsd,dhe->bshe", x, p["wk"].to(dt))
        v_new = torch.einsum("bsd,dhe->bshe", x, p["wv"].to(dt))
        if qk_norm:
            k_new = rms_head_norm(k_new, p["k_norm"])
        if use_rope:
            k_new = apply_rope(k_new, pos_t, rope_theta)
        if k_new.shape[2] < cache["k"].shape[2]:
            k_new, v_new = (tp.gather_model(t, 2) for t in (k_new, v_new))
        at = min(max(pos, 0), length - 1) - offset
        if 0 <= at < smax:
            cache["k"][:, at:at + 1] = k_new.to(cache["k"].dtype)
            cache["v"][:, at:at + 1] = v_new.to(cache["v"].dtype)
        kv_valid = pos + 1

    kv_positions = torch.arange(smax, device=x.device)
    reduced = False
    if not groups:
        out = chunked_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                                q_positions=pos_t, kv_positions=kv_positions,
                                causal=False, kv_valid_len=kv_valid)
    else:
        mask = None
        if kv_valid is not None:
            mask = (kv_positions + offset < kv_valid)[None, None, :].expand(
                q.shape[0], 1, smax)
        # where "model" splits the sequence too and each rank is a group,
        # its sum over the ranks' slices leaves each rank its own heads (a
        # reduce-scatter)
        model = tp.model_group() if head_groups is not None and \
            head_groups.R == 1 else None
        reduced = model is not None and model in groups
        out = _sdpa(q, cache["k"].to(dt), cache["v"].to(dt), mask, groups,
                    heads_to=model if reduced else None)
    if head_groups is None:
        return torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt)), cache
    if not reduced:
        out = out[:, :, head_groups.heads]
    if part is not None:
        out = out[part]
    y = torch.einsum("bshe,hed->bsd", out, p["wo"].to(dt))
    return head_groups.add_rows(y, x.shape[0], part), cache
