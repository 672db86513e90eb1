"""Block / super-block assembly and the layer stack.

The port of the JAX package's ``models/transformer.py``: the mixers
"attn" (GQA self-attention, with Qwen3's qk-norm, or MLA), "mamba",
"mlstm" and "slstm", and the FFNs "dense", "moe" and "none"; each
sub-block is a pre-norm mixer, then (in an encoder-decoder's decoder) a
pre-norm cross-attention over the encoder's output, then a pre-norm FFN.
The JAX package stacks each leaf on a leading ``n_super`` axis and scans
it; here the stack is a list with one dict per super-block (same keys,
``{"b0": ..., "b7": ...}``), walked by a Python loop; with
``run_cfg.remat`` each super-block is recomputed in the backward pass
(``torch.utils.checkpoint``).  The kernels come in through hooks:
``flash_fn`` (GQA self-attention), ``gmm_fn`` (MoE experts), ``scan_fn``
(Mamba) and ``chunk_fn`` (the mLSTM); MLA and cross-attention run the
chunked reference path, as in the JAX package.
"""
from __future__ import annotations

import contextlib

import torch
import torch.utils.checkpoint

from repro_torch.models import attention as attn
from repro_torch.models import mamba as mb
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import tp
from repro_torch.models import xlstm as xl
from repro_torch.models.layers import apply_ffn, apply_norm, init_ffn, init_norm
from repro_torch.sharding_ctx import current_mesh, use_mesh

_MIXERS = ("attn", "mamba", "mlstm", "slstm")


def _check_supported(mixer, ffn):
    if mixer not in _MIXERS or ffn not in ("dense", "moe", "none"):
        raise ValueError((mixer, ffn))


# --------------------------------------------------------------------------
# single sub-block
# --------------------------------------------------------------------------

def init_subblock(gen, cfg, mixer, ffn, device, cross=False):
    _check_supported(mixer, ffn)
    p = {"norm1": init_norm(cfg.d_model, device, cfg.norm_type)}
    if mixer == "attn":
        if cfg.attention_type == "mla":
            p["mixer"] = mla_mod.init_mla(gen, cfg.d_model, cfg.num_heads,
                                          cfg.mla, device)
        else:
            p["mixer"] = attn.init_attention(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, device, qk_norm=cfg.qk_norm)
        if cross:
            p["norm_cross"] = init_norm(cfg.d_model, device, cfg.norm_type)
            p["cross"] = attn.init_attention(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                cfg.head_dim, device)
    elif mixer == "mamba":
        p["mixer"] = mb.init_mamba(gen, cfg.d_model, cfg.mamba, device)
    elif mixer == "mlstm":
        p["mixer"] = xl.init_mlstm(gen, cfg.d_model, cfg.num_heads,
                                   cfg.xlstm, device)
    else:
        p["mixer"] = xl.init_slstm(gen, cfg.d_model, cfg.num_heads,
                                   cfg.xlstm, device)
    if ffn == "dense":
        p["norm2"] = init_norm(cfg.d_model, device, cfg.norm_type)
        p["ffn"] = init_ffn(gen, cfg.d_model, cfg.d_ff, device, cfg.ffn_type)
    elif ffn == "moe":
        p["norm2"] = init_norm(cfg.d_model, device, cfg.norm_type)
        p["ffn"] = moe_mod.init_moe(gen, cfg.d_model, cfg.moe, device,
                                    cfg.ffn_type)
    return p


def apply_subblock(p, x, cfg, mixer, ffn, *, positions, causal, q_chunk,
                   enc_out=None, cross=False, flash_fn=None, gmm_fn=None,
                   scan_fn=None, chunk_fn=None, collect_cache=True):
    """Full-sequence apply.  Returns (x, cache_seed, aux).  On a mesh
    step's leaves (``tp.Stored``) every mixer and the dense FFN split
    over "model" as the JAX package's compiled step splits them: GQA
    attention (and cross-attention) on the rank's heads, MLA on its
    heads (its down-projections column-parallel) where the rule splits
    them, Mamba on the rank's slice of ``d_inner``, the mLSTM and the
    sLSTM on the rank's heads where "model" divides them, each of these
    whole on every rank otherwise (its weights gathered); the MoE
    through ``apply_moe`` (the expert-parallel dispatch); each leaf is
    gathered here, inside the super-block's remat body.  On plain
    tensors every ``tp`` helper returns its input."""
    _check_supported(mixer, ffn)
    h = apply_norm(tp.whole_tree(p["norm1"]), x, cfg.norm_type)
    if mixer == "attn":
        if cfg.attention_type == "mla":
            y, seed = _mla_tp(p["mixer"], h, cfg, positions=positions,
                              q_chunk=q_chunk)
        else:
            y, seed = _attention_tp(
                p["mixer"], h, cfg, "attn", collect_cache=collect_cache,
                positions=positions, causal=causal, rope_theta=cfg.rope_theta,
                use_rope=(cfg.pos_embedding == "rope"), qk_norm=cfg.qk_norm,
                q_chunk=q_chunk, flash_fn=flash_fn)
        if cross:
            x = x + y
            hc = apply_norm(tp.whole_tree(p["norm_cross"]), x, cfg.norm_type)
            y, cseed = _attention_tp(
                p["cross"], hc, cfg, "cross", collect_cache=collect_cache,
                x_cross=enc_out, positions=positions, causal=False,
                use_rope=False, q_chunk=q_chunk)
            seed = {"self": seed, "cross": cseed}
    elif mixer == "mamba":
        y, seed = _mamba_tp(p["mixer"], h, cfg, scan_fn=scan_fn,
                            collect_cache=collect_cache)
    else:
        y, seed = _xlstm_tp(p["mixer"], h, cfg, mixer, chunk_fn=chunk_fn,
                            collect_cache=collect_cache)
    x = x + y

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if ffn == "dense":
        x = x + _ffn_tp(p["ffn"], apply_norm(tp.whole_tree(p["norm2"]), x,
                                             cfg.norm_type), cfg)
    elif ffn == "moe":
        y, aux = moe_mod.apply_moe(
            p["ffn"], apply_norm(tp.whole_tree(p["norm2"]), x, cfg.norm_type),
            cfg.moe, cfg.ffn_type, gmm_fn=gmm_fn)
        x = x + y
    return x, seed, aux


def apply_subblock_decode(p, x, state, cfg, mixer, ffn, *, pos):
    """One-token apply.  Returns (x, new_state); a KV or latent cache in
    ``state`` is written in place (an encoder-decoder's cross cache is
    only read), a Mamba or xLSTM state is replaced.  On a mesh step's
    leaves: parameters as ``apply_subblock`` takes them, each cache leaf
    a ``tp.Stored`` piece used in place (attention and MLA caches
    sequence-parallel, recurrent states the rank's rows); the new state
    holds the local pieces."""
    _check_supported(mixer, ffn)
    h = apply_norm(tp.whole_tree(p["norm1"]), x, cfg.norm_type)
    if mixer == "attn" and cfg.attention_type != "mla":
        self_state = state["self"] if "cross" in state else state
        y, new_state = _attention_decode_tp(
            p["mixer"], h, self_state, cfg, "attn", pos=pos,
            rope_theta=cfg.rope_theta,
            use_rope=(cfg.pos_embedding == "rope"), qk_norm=cfg.qk_norm)
        if "cross" in state:
            x = x + y
            hc = apply_norm(tp.whole_tree(p["norm_cross"]), x, cfg.norm_type)
            y, cross_state = _attention_decode_tp(
                p["cross"], hc, state["cross"], cfg, "cross", pos=pos,
                use_rope=False, cross=True)
            new_state = {"self": new_state, "cross": cross_state}
    else:
        local = {k: tp.own(v) for k, v in state.items()}
        if mixer == "attn":
            _mla_heads(p["mixer"])
            y, new_state = mla_mod.mla_decode(
                p["mixer"], h, local, pos=pos, mla=cfg.mla,
                rope_theta=cfg.rope_theta, seq=tp.seq_split(state["c_kv"]))
        elif mixer == "mamba":
            split = _mamba_split(p["mixer"], cfg)
            y, new_state = mb.mamba_decode(mb.rank_weights(p["mixer"], split),
                                           h, local, cfg.mamba, split=split)
        else:
            split = _xlstm_split(p["mixer"], cfg, mixer)
            decode = xl.mlstm_decode if mixer == "mlstm" else xl.slstm_decode
            y, new_state = decode(p["mixer"], h, local, cfg.num_heads,
                                  cfg.xlstm, split=split)
    x = x + y
    h2 = apply_norm(tp.whole_tree(p["norm2"]), x, cfg.norm_type) \
        if ffn != "none" else None
    if ffn == "dense":
        x = x + _ffn_tp(p["ffn"], h2, cfg)
    elif ffn == "moe":
        y, _ = moe_mod.apply_moe(p["ffn"], h2, cfg.moe, cfg.ffn_type)
        x = x + y
    return x, new_state


# --------------------------------------------------------------------------
# attention and the FFN on a mesh step's ranks (plain tensors: whole)
# --------------------------------------------------------------------------

def _attention_tp(p, h, cfg, kind, *, collect_cache, x_cross=None,
                  **kwargs):
    """``attention_forward`` on this rank's heads between f and g where
    "model" splits them (whole otherwise); the cache seeds leave with
    every kv head and the rank's slice of the sequence
    (``tp.heads_to_seq``)."""
    w, every = tp.attention_weights(p, cfg.num_heads, cfg.num_kv_heads)
    split = every is not None
    if not split:
        tp.note_whole(kind)
    if x_cross is not None:
        x_cross = tp.into_model(x_cross, split)
    y, (k, v) = attn.attention_forward(w, tp.into_model(h, split),
                                       x_cross=x_cross, **kwargs)
    if split and collect_cache:
        k = tp.heads_to_seq(k, every, cfg.num_kv_heads)
        v = tp.heads_to_seq(v, every, cfg.num_kv_heads)
    return tp.out_of_model(y, split), {"k": k, "v": v}


def _mla_heads(p) -> bool:
    """Whether the rule splits MLA's heads (``mla.heads_split``); MLA
    recorded whole where it does not."""
    heads = mla_mod.heads_split(p)
    if not heads:
        tp.note_whole("mla")
    return heads


def _mla_tp(p, h, cfg, *, positions, q_chunk):
    """``mla_forward`` as the rules split it (``models/mla.py``); the
    latents that seed the cache are whole on every "model" rank."""
    _mla_heads(p)
    y, (c_kv, k_rope) = mla_mod.mla_forward(
        p, h, positions=positions, mla=cfg.mla, rope_theta=cfg.rope_theta,
        q_chunk=q_chunk)
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def _mamba_split(p, cfg) -> bool:
    """``mamba.split_over_model``; Mamba recorded whole where it is
    not split."""
    split = mb.split_over_model(p, cfg.d_model, cfg.mamba)
    if not split:
        tp.note_whole("mamba")
    return split


def _mamba_tp(p, h, cfg, *, scan_fn, collect_cache):
    """``mamba_forward`` on the rank's slice of ``d_inner`` where the
    rules split the mixer (whole otherwise); the cache seeds leave with
    every channel (gathered over "model")."""
    split = _mamba_split(p, cfg)
    y, (h_last, conv_last) = mb.mamba_forward(
        mb.rank_weights(p, split), h, cfg.mamba, scan_fn=scan_fn,
        split=split)
    if split and collect_cache:
        h_last = tp.gather_model(h_last, 1)
        conv_last = tp.gather_model(conv_last, 2)
    return y, {"h": h_last, "conv": conv_last}


def _xlstm_split(p, cfg, mixer):
    """The mLSTM's or sLSTM's split (``xlstm.mlstm_split`` /
    ``slstm_split``); the mixer recorded whole where it is not split."""
    split = (xl.mlstm_split if mixer == "mlstm" else xl.slstm_split)(
        p, cfg.num_heads)
    if split is None:
        tp.note_whole(mixer)
    return split


def _xlstm_tp(p, h, cfg, mixer, *, chunk_fn, collect_cache):
    """``mlstm_forward`` / ``slstm_forward`` as the rules split them; the
    cache seeds leave with every head (gathered over "model")."""
    split = _xlstm_split(p, cfg, mixer)
    if mixer == "mlstm":
        y, seed = xl.mlstm_forward(p, h, cfg.num_heads, cfg.xlstm,
                                   chunk_fn=chunk_fn, split=split)
    else:
        y, seed = xl.slstm_forward(p, h, cfg.num_heads, cfg.xlstm,
                                   split=split)
    if split == "heads" and collect_cache:
        seed = {k: v if k == "conv" or v is None else tp.gather_model(v, 1)
                for k, v in seed.items()}
    return y, seed


def _ffn_tp(p, h, cfg):
    """``apply_ffn`` on this rank's ``d_ff`` slice between f and g where
    "model" splits it (whole otherwise)."""
    split = tp.split_on(p["wi"], 1)
    if not split:
        tp.note_whole("ffn")
    w = {k: (tp.local if split else tp.whole)(v) for k, v in p.items()}
    return tp.out_of_model(apply_ffn(w, tp.into_model(h, split),
                                     cfg.ffn_type), split)


def _attention_decode_tp(p, h, cache, cfg, kind, **kwargs):
    """``attention_decode`` on this rank's heads where "model" splits them
    (q and the new k / v gathered, the output's heads kept for ``wo``,
    then g), against the rank's slice of the cache's sequence."""
    w, every = tp.attention_weights(p, cfg.num_heads, cfg.num_kv_heads,
                                    select=False)
    split = every is not None
    if not split:
        tp.note_whole(kind)
    local = {k: tp.own(v) for k, v in cache.items()}
    y, _ = attn.attention_decode(w, h, local, seq=tp.seq_split(cache["k"]),
                                 heads_split=split, **kwargs)
    return tp.out_of_model(y, split), local


def init_subblock_state(cfg, idx_def, batch, max_len, dtype, device,
                        cross=False):
    mixer, ffn = cfg.block_defs[idx_def]
    _check_supported(mixer, ffn)
    if mixer == "attn":
        if cfg.attention_type == "mla":
            st = mla_mod.init_mla_cache(batch, max_len, cfg.mla, dtype,
                                        device)
        else:
            st = attn.init_kv_cache(batch, max_len, cfg.num_kv_heads,
                                    cfg.head_dim, dtype, device)
        if cross:
            st = {"self": st,
                  "cross": attn.init_kv_cache(batch, cfg.encoder.n_frames,
                                              cfg.num_kv_heads, cfg.head_dim,
                                              dtype, device)}
        return st
    if mixer == "mamba":
        return mb.init_mamba_state(batch, cfg.d_model, cfg.mamba, dtype,
                                   device)
    init = xl.init_mlstm_state if mixer == "mlstm" else xl.init_slstm_state
    return init(batch, cfg.d_model, cfg.num_heads, cfg.xlstm, dtype, device)


# --------------------------------------------------------------------------
# the stack: one dict per super-block
# --------------------------------------------------------------------------

def init_stack(gen, cfg, device, cross=False):
    return [{f"b{i}": init_subblock(gen, cfg, m, f, device, cross=cross)
             for i, (m, f) in enumerate(cfg.block_defs)}
            for _ in range(cfg.n_super)]


def _remat(fn, run_cfg):
    """``fn`` recomputed in the backward pass when ``run_cfg.remat``.
    The JAX package's policies: "full" saves nothing inside the
    super-block, "dots" saves its matmul outputs, "none" is no remat.
    PyTorch's checkpoint has no counterpart of "dots", so both "dots"
    and "full" recompute the whole super-block (its input is kept);
    the values are the same either way."""
    if run_cfg is None or not getattr(run_cfg, "remat", False) or \
            getattr(run_cfg, "remat_policy", "dots") == "none":
        return fn

    def remat_fn(*args):
        mesh = current_mesh()
        if mesh is None:
            return torch.utils.checkpoint.checkpoint(fn, *args,
                                                     use_reentrant=False)
        # the recompute runs on the autograd engine's thread (a device's
        # worker on the card), where the caller's thread-local mesh is
        # not set: re-enter it there
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), use_mesh(mesh)))
    return remat_fn


def apply_stack(stack_params, x, cfg, *, positions, causal=True, q_chunk=1024,
                enc_out=None, cross=False, run_cfg=None, collect_cache=False,
                flash_fn=None, gmm_fn=None, scan_fn=None, chunk_fn=None):
    """Run the super-blocks over x.  Returns (x, caches|None, aux): caches
    are one ``{"b<i>": seed}`` per super-block (``{"k","v"}`` for
    attention, ``{"c_kv","k_rope"}`` for MLA, ``{"self", "cross"}`` for a
    decoder sub-block over ``enc_out``, ``{"h","conv"}`` for Mamba,
    ``{"C","n","m","conv"}`` for the mLSTM, ``{"c","n","h","m","conv"}``
    for the sLSTM), aux is the
    sum of the MoE layers' aux losses.  ``run_cfg.remat`` recomputes
    each super-block in the backward pass (see ``_remat``)."""
    for fn, what in ((scan_fn, "Mamba"), (chunk_fn, "mLSTM")):
        if collect_cache and fn is not None:
            raise ValueError(f"apply_stack: a kernel hook returns no {what} "
                             "state, so a cache is collected without it")

    def body(layer_p, x, aux):
        seeds = {}
        for i, (m, f) in enumerate(cfg.block_defs):
            x, seeds[f"b{i}"], a = apply_subblock(
                layer_p[f"b{i}"], x, cfg, m, f, positions=positions,
                causal=causal, q_chunk=q_chunk, enc_out=enc_out, cross=cross,
                flash_fn=flash_fn, gmm_fn=gmm_fn, scan_fn=scan_fn,
                chunk_fn=chunk_fn, collect_cache=collect_cache)
            aux = aux + a
        return x, (seeds if collect_cache else None), aux

    body = _remat(body, run_cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = []
    for layer_p in stack_params:
        x, seeds, aux = body(layer_p, x, aux)
        if collect_cache:
            caches.append(seeds)
    return x, (caches if collect_cache else None), aux


def decode_stack(stack_params, x, caches, cfg, *, pos):
    """One-token decode through every super-block; KV caches are written
    in place, and the caches are returned."""
    new_caches = []
    for layer_p, cache in zip(stack_params, caches):
        new_cache = {}
        for i, (m, f) in enumerate(cfg.block_defs):
            x, new_cache[f"b{i}"] = apply_subblock_decode(
                layer_p[f"b{i}"], x, cache[f"b{i}"], cfg, m, f, pos=pos)
        new_caches.append(new_cache)
    return x, new_caches


def init_stack_state(cfg, batch, max_len, dtype, device, cross=False):
    return [{f"b{i}": init_subblock_state(cfg, i, batch, max_len, dtype,
                                          device, cross=cross)
             for i in range(len(cfg.block_defs))}
            for _ in range(cfg.n_super)]
