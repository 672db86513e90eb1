"""Multi-head Latent Attention (MiniCPM3 / DeepSeek-V2 style).

The port of the JAX package's ``models/mla.py``.  Train and prefill use
the decompressed form through the chunked reference attention (the JAX
package runs no kernel here, so neither does the port: q/k head dim
nope + rope, v head dim ``v_head_dim``); decode uses the absorbed form
against the compressed latent cache (``c_kv`` + ``k_rope``, kv_lora +
rope_dim numbers per token instead of 2 * H * head_dim), written in
place as the port's KV caches are.

Every function here takes the weights as plain tensors or as a mesh
step's ``tp.Stored`` leaves, split over "model" as the rules store them
(``plan``: ``tp.HeadGroups``).  The down-projections ``w_dq`` /
``w_dkv`` / ``w_kr`` column-parallel on their rank dim and the latents
gathered whole over "model" (the JAX model constrains them to
``("batch", None, None)``).  Where the rule splits the heads, as the JAX
package's compiled step splits them, the heads, their up-projections,
the attention and ``wo`` on the rank's heads.  Where "model" does not
divide the heads (the up-projections stored whole), each block of R
ranks takes one group of heads, each of its ranks its share
of the query rows (``HeadGroups.rows``: two chunks of 2R, so that every
rank attends to as many keys), k and v up-projected on those rows and
joined over the block, the output's rows summed over "model" (g); in a
decode step the block's ranks split the batch's rows for the group's
heads.  On plain tensors nothing is split.
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


def plan(p, length=None):
    """The ``tp.HeadGroups`` of a mesh step's MLA (each rank its own heads
    where "model" divides them); None on plain tensors or where (train,
    prefill: ``length`` query rows) a block's chunks do not divide the
    rows and "model" computes all of MLA on every rank."""
    if not tp.is_stored(p["w_uq"]):
        return None
    grp = tp.HeadGroups(p["w_uq"].shape[1])
    if length is not None and grp.rows(length, True) is None:
        return None
    return grp


def _norm(p, region):
    return {k: (tp.shared if region else tp.whole)(v) for k, v in p.items()}


def _up(w, grp, dim=1):
    """An up-projection (or ``wo``, ``dim`` 0) on the group's heads
    (``HeadGroups.part``), or all of it without a group."""
    return tp.whole(w) if grp is None else grp.part(w, dim)


def _latents(p, x, positions, mla, rope_theta, down=None, grp=None):
    """Compressed latents for the kv side: c_kv (B,S,r), k_rope (B,S,dr);
    ``grp``: ``plan``'s."""
    region = grp is not None
    down = down or tp.Columns(x, region)
    c_kv = apply_norm(_norm(p["kv_norm"], region), down(p["w_dkv"]))
    k_rope = down(p["w_kr"])[:, :, None, :]                    # (B,S,1,dr)
    k_rope = apply_rope(k_rope, positions, rope_theta)[:, :, 0, :]
    return c_kv, k_rope


def _queries(p, x, positions, mla, rope_theta, down=None, grp=None,
             rows=None, part=None):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope)): the group's heads
    (``grp``, ``plan``'s) on the rank's ``rows`` (or its ``part`` of the
    batch)."""
    dt = x.dtype
    down = down or tp.Columns(x, grp is not None)
    c_q = apply_norm(_norm(p["q_norm"], grp is not None), down(p["w_dq"]))
    if rows is not None:
        c_q, positions = c_q[:, rows], positions[rows]
    if part is not None:
        c_q = c_q[part]
    q = torch.einsum("bsr,rhe->bshe", c_q, _up(p["w_uq"], grp).to(dt))
    q_nope = q[..., :mla.qk_nope_head_dim]
    q_rope = apply_rope(q[..., mla.qk_nope_head_dim:], positions, rope_theta)
    return q_nope, q_rope


def mla_forward(p, x, *, positions, mla, rope_theta, q_chunk=1024):
    """Full-sequence causal MLA (decompressed form).  Returns (out,
    (c_kv, k_rope)): the latents (whole on every "model" rank) seed the
    compressed cache."""
    dt = x.dtype
    B, S, _ = x.shape
    grp = plan(p, S)
    down = tp.Columns(x, grp is not None)
    rows = spans = None
    if grp is not None and grp.R > 1:
        spans = grp.rows(S, True)
        rows = torch.cat([torch.arange(a, b) for a, b in spans]).to(x.device)
    q_nope, q_rope = _queries(p, x, positions, mla, rope_theta, down, grp,
                              rows)
    c_kv, k_rope = _latents(p, x, positions, mla, rope_theta, down, grp)
    c_src = c_kv if rows is None else c_kv[:, rows]
    k_nope = torch.einsum("bsr,rhe->bshe", c_src,
                          _up(p["w_uk"], grp).to(dt))
    v = torch.einsum("bsr,rhe->bshe", c_src, _up(p["w_uv"], grp).to(dt))
    if rows is not None:                  # every row of the group's k, v
        k_nope, v = (grp.gather_rows(t, S, True) for t in (k_nope, v))
    H = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, mla.qk_rope_head_dim)], dim=-1)
    if rows is None:
        out = chunked_attention(q, k, v, q_positions=positions,
                                kv_positions=positions, causal=True,
                                q_chunk=q_chunk)
    else:
        outs, at = [], 0
        for a, b in spans:
            outs.append(chunked_attention(
                q[:, at:at + b - a], k[:, :b], v[:, :b],
                q_positions=positions[a:b], kv_positions=positions[:b],
                causal=True, q_chunk=q_chunk))
            at += b - a
        out = torch.cat(outs, dim=1)
    y = torch.einsum("bshe,hed->bsd", out, _up(p["wo"], grp, 0).to(dt))
    if rows is not None:
        y = y.new_zeros((B, S, y.shape[-1])).index_copy(1, rows, y)
    return tp.out_of_model(y, grp is not None), (c_kv, k_rope)


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
    ``w_uv`` and ``wo`` (g); a block of ranks on a group of heads
    (``tp.HeadGroups``) splits the rows (``HeadGroups.batch_rows``)."""
    dt = x.dtype
    grp = plan(p)
    region = grp is not None
    pos_t = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    down = tp.Columns(x, region)
    part = grp.batch_rows(x.shape[0]) if region else None
    q_nope, q_rope = _queries(p, x, pos_t, mla, rope_theta, down, grp,
                              part=part)                      # (B,1,H,*)
    c_new, kr_new = _latents(p, x, pos_t, mla, rope_theta, down, grp)
    smax = cache["c_kv"].shape[1]
    groups, offset, length = seq or ((), 0, smax)
    at = min(max(pos, 0), length - 1) - offset
    if 0 <= at < smax:
        cache["c_kv"][:, at:at + 1] = c_new.to(cache["c_kv"].dtype)
        cache["k_rope"][:, at:at + 1] = kr_new.to(cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"].to(dt), cache["k_rope"].to(dt)

    # absorb W_uk into q: q_abs (B,1,H,r)
    q_abs = torch.einsum("bshe,rhe->bshr", q_nope,
                         _up(p["w_uk"], grp).to(dt))
    if region:
        q_abs, q_rope = (grp.gather_heads(t, rows=part is not None)
                         for t in (q_abs, q_rope))
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
    if region:
        ctx = ctx[:, :, grp.heads]
        if part is not None:
            ctx = ctx[part]
    out = torch.einsum("bshr,rhe->bshe", ctx, _up(p["w_uv"], grp).to(dt))
    y = torch.einsum("bshe,hed->bsd", out, _up(p["wo"], grp, 0).to(dt))
    if region:
        y = grp.add_rows(y, x.shape[0], part)
    return tp.out_of_model(y, region), cache
