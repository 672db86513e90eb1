"""Token-choice top-k MoE with capacity-bounded scatter dispatch.

The port of the JAX package's ``models/moe.py``.  On its single-device
path (``_apply_moe_naive``, which the JAX package takes with no mesh)
tokens are scattered into an (E, C, D) capacity buffer, the expert FFNs
run as three grouped products over the expert axis, and the outputs
gather back weighted by the renormalized router probabilities.  Under
a mesh (``sharding_ctx.use_mesh``) that can hold the experts,
``apply_moe`` takes the expert-parallel all-to-all dispatch of
``moe_sharded.py`` instead, as the JAX package does.

``_expert_ffn`` takes the grouped product through its ``gmm_fn`` hook
(the CUDA ``moe_gmm`` kernel's wrapper on the model path); without it
the products are the reference's einsums.  Both compute the same
function within the kernel's tolerance.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import tp
from repro_torch.models.layers import dense_init


def init_moe(gen, d_model, moe, device, ffn_type="swiglu"):
    """The JAX tree's leaves and draws: ``dense_init`` takes fan-in from
    ``shape[0]``, which is E for the (E, d, F) expert weights, as in the
    JAX package."""
    E, Fe = moe.num_experts, moe.d_ff_expert
    p = {"router": dense_init(gen, (d_model, E), device),
         "wi": dense_init(gen, (E, d_model, Fe), device),
         "wo": dense_init(gen, (E, Fe, d_model), device, in_axis_size=Fe)}
    if ffn_type == "swiglu":
        p["wg"] = dense_init(gen, (E, d_model, Fe), device)
    if moe.num_shared_experts:
        Fs = moe.d_ff_shared * moe.num_shared_experts
        p["shared_wi"] = dense_init(gen, (d_model, Fs), device)
        p["shared_wo"] = dense_init(gen, (Fs, d_model), device,
                                    in_axis_size=Fs)
        if ffn_type == "swiglu":
            p["shared_wg"] = dense_init(gen, (d_model, Fs), device)
    return p


def _einsum_gmm(x, w):
    return torch.einsum("ecd,edf->ecf", x, w)


def _expert_ffn(p, buf, ffn_type, gmm_fn=None):
    """buf: (E, C, D) -> (E, C, D), three grouped products over experts
    through ``gmm_fn`` (x (E,C,D), w (E,D,F) -> (E,C,F)); the weights are
    cast to buf's dtype per use, as in the JAX package."""
    gmm = gmm_fn or _einsum_gmm
    dt = buf.dtype
    if ffn_type == "swiglu":
        h = F.silu(gmm(buf, p["wg"].to(dt))) * gmm(buf, p["wi"].to(dt))
    elif ffn_type == "squared_relu":
        h = torch.square(F.relu(gmm(buf, p["wi"].to(dt))))
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(gmm(buf, p["wi"].to(dt)), approximate="tanh")
    return gmm(h, p["wo"].to(dt))


def capacity(num_tokens, moe):
    c = int(num_tokens * moe.top_k * moe.capacity_factor / moe.num_experts)
    return max(8, -(-c // 8) * 8)        # >=8, rounded up to multiple of 8


def apply_moe(p, x, moe, ffn_type="swiglu", gmm_fn=None):
    """x: (B,S,D) -> (y, aux_loss). Token-choice top-k, capacity drop.

    Dispatch impl auto-selects: the explicit expert-parallel all-to-all
    when a compatible mesh is active (see moe_sharded.py; x is then this
    rank's rows of the batch), else the naive scatter path below
    (single-device runs, decode batches)."""
    from repro_torch.models.moe_sharded import (apply_moe_sharded,
                                                sharded_moe_available)
    from repro_torch.sharding import batch_axes
    from repro_torch.sharding_ctx import axis_size, current_mesh
    mesh = current_mesh()
    if mesh is not None and sharded_moe_available(
            mesh, moe, x.shape[0] * x.shape[1] * axis_size(
                mesh, batch_axes(mesh))):
        y, aux = apply_moe_sharded(p, x, moe, ffn_type, mesh, gmm_fn=gmm_fn)
        return y + _shared_expert(p, x, ffn_type), aux
    if tp.is_stored(p["router"]):        # a mesh step's leaves: all whole
        tp.note_whole("moe")
        p = {k: tp.whole(w) for k, w in p.items()}
    return _apply_moe_naive(p, x, moe, ffn_type, gmm_fn=gmm_fn)


def _shared_expert(p, x, ffn_type):
    """The shared experts' FFN; on a mesh step's leaves tensor-parallel
    over "model" (its ``d_ff`` slice between f and g) where the rule
    splits it, else whole."""
    if "shared_wi" not in p:
        return torch.zeros_like(x)
    if tp.is_stored(p["shared_wi"]):
        split = tp.split_on(p["shared_wi"], 1)
        if not split:
            tp.note_whole("moe")
        get = tp.local if split else tp.whole
        w = {k: get(p[k]) for k in ("shared_wi", "shared_wg", "shared_wo")
             if k in p}
        return tp.out_of_model(
            _shared_expert(w, tp.into_model(x, split), ffn_type), split)
    dt = x.dtype
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    if ffn_type == "swiglu":
        h = (F.silu(xt @ p["shared_wg"].to(dt))
             * (xt @ p["shared_wi"].to(dt)))
    else:
        h = F.gelu(xt @ p["shared_wi"].to(dt), approximate="tanh")
    return (h @ p["shared_wo"].to(dt)).reshape(B, S, D)


def _router(p, xt, moe):
    """Router of T tokens xt (T, D): (probs (T,E) f32, top_p (T,K)
    renormalized, top_e (T,K))."""
    logits = (xt @ p["router"].to(xt.dtype)).to(torch.float32)   # (T,E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, moe.top_k, dim=-1)  # descending
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_e


def _positions(ids, n, cap, valid=None):
    """Position of each entry of ``ids`` (in [0, n)) among the earlier
    ``valid`` entries with the same id: (pos, keep), keep = valid & (pos
    < cap), pos 0 where an entry is not kept.  Every capacity stage
    places its slots through it: the naive path's expert buffers, the
    sharded path's send buckets and its local expert buffers."""
    onehot = F.one_hot(ids, n)                                   # (N,n)
    if valid is not None:
        onehot = onehot * valid[:, None].to(onehot.dtype)
    pos = torch.gather(onehot.cumsum(0) - 1, 1, ids[:, None])[:, 0]
    keep = pos < cap
    if valid is not None:
        keep = keep & valid
    return torch.where(keep, pos, torch.zeros_like(pos)), keep


def _route(p, xt, moe, C):
    """Router of T tokens xt (T, D) into capacity C.  Returns (probs
    (T,E) f32, top_p (T,K) renormalized, top_e (T,K), eid (K*T,) and pos
    (K*T,) in slot-major order, keep = pos < C, pos 0 where dropped)."""
    probs, top_p, top_e = _router(p, xt, moe)
    eid = top_e.T.reshape(-1)                                    # (K*T,)
    pos, keep = _positions(eid, moe.num_experts, C)
    return probs, top_p, top_e, eid, pos, keep


def _aux_loss(probs, top_e, moe, mean=None):
    """Switch-style load-balancing loss from the token and probability
    fractions; ``mean`` turns this call's means over its tokens into
    global ones (the sharded path's means over the batch axes)."""
    E = moe.num_experts
    frac_tokens = F.one_hot(top_e[:, 0], E).to(torch.float32).mean(0)
    frac_probs = probs.mean(0)
    if mean is not None:
        frac_tokens, frac_probs = mean(frac_tokens), mean(frac_probs)
    return E * torch.sum(frac_tokens * frac_probs) * moe.aux_loss_weight


def _apply_moe_naive(p, x, moe, ffn_type="swiglu", gmm_fn=None):
    B, S, D = x.shape
    dt = x.dtype
    T = B * S
    E, K = moe.num_experts, moe.top_k
    C = capacity(T, moe)

    xt = x.reshape(T, D)
    probs, top_p, top_e, eid, slot, keep = _route(p, xt, moe, C)

    # dispatch: scatter tokens into (E, C, D).  A dropped token adds zeros
    # into slot 0 of its expert, and each kept (expert, slot) pair is
    # unique, so the sums are exact in any order of accumulation.
    x_rep = xt.repeat(K, 1)                                      # slot-major
    buf = torch.zeros((E, C, D), dtype=dt, device=x.device)
    buf.index_put_((eid, slot), x_rep * keep[:, None].to(dt),
                   accumulate=True)

    out_buf = _expert_ffn(p, buf, ffn_type, gmm_fn)              # (E,C,D)

    # combine: gather back, weight by router prob
    gath = out_buf[eid, slot]                                    # (KT,D)
    w = (top_p.T.reshape(-1) * keep).to(dt)                      # slot-major
    yt = (gath * w[:, None]).reshape(K, T, D).sum(0)
    y = yt.reshape(B, S, D) + _shared_expert(p, x, ffn_type)

    return y, _aux_loss(probs, top_e, moe)
