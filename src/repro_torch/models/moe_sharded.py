"""Expert-parallel MoE dispatch with explicit all-to-alls.

The port of the JAX package's ``models/moe_sharded.py``.  There, a
``shard_map`` body runs once per device; here the same body runs once
per rank, on the rank's own tokens, and its collectives take their
process groups from the ``DeviceMesh``.

  layout: experts sharded over "data" (EP), expert FFN hidden dim over
  "model" (TP-in-expert), tokens sharded over ("pod","data"); expert
  weights replicated over "pod" (pod-local expert replicas -> dispatch
  stays inside a pod; the elastic pod axis carries only the gradient
  all-reduce).

  per layer: route locally -> bucket by destination data-shard ->
  all_to_all(data) -> local capacity-bounded dispatch -> grouped FFN
  (all-reduce over model for the F contraction) -> all_to_all(data) back
  -> weighted combine at the source.

Gradients: with equal splits on dim 0 an all-to-all is its own
transpose, so both trips differentiate through the same collective;
the int8 dispatch quantizes the forward payload and the backward token
gradient alike.  The "model" axis replicates a rank's tokens, and its
ranks hold disjoint slices of F: the expert buffer enters the FFN
through an identity whose backward sums the token gradient over
"model", and the FFN's output leaves through an all-reduce whose
backward is the identity, so every rank gets the whole gradient of its
tokens and of its own weight slices.  The aux loss's means over "data"
(and "pod") average their cotangents too: each rank's loss holds the
same aux term, and a data-parallel step averages the ranks' gradients.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.models import moe as moe_mod
from repro_torch.models import tp
from repro_torch.models.moe import _expert_ffn
from repro_torch.models.tp import IntoModel as _IntoModel
from repro_torch.models.tp import OutOfModel as _OutOfModel
from repro_torch.sharding_ctx import axis_names, mesh_shape, placements


def _round8(n):
    return max(8, -(-int(n) // 8) * 8)


def _a2a(x, group):
    """all_to_all over ``group``: row i of dim 0 goes to the group's rank
    i, and row i of the result came from it."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None      # self-transposed


def _q_roundtrip(x, group):
    """The all-to-all of ``x`` with an int8 wire format (per-slot
    scales)."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return (_a2a(q, group).to(torch.float32)
            * _a2a(scale, group)).to(x.dtype)


class _AllToAllInt8(torch.autograd.Function):
    """Dispatch all-to-all with an int8 wire format. Forward quantizes the
    payload; backward quantizes the token-gradient all-to-all the same way
    (DeepSeek-V3 quantizes both dispatch directions; combine stays in the
    compute dtype)."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _q_roundtrip(x, group)

    @staticmethod
    def backward(ctx, g):
        return _q_roundtrip(g, ctx.group), None


class _Mean(torch.autograd.Function):
    """Mean over ``group``, forward and backward."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def sharded_moe_available(mesh, moe, num_tokens):
    """``num_tokens``: the global count (every rank's tokens)."""
    if mesh is None or "data" not in axis_names(mesh):
        return False
    shape = mesh_shape(mesh)
    nd = shape["data"]
    if moe.num_experts % nd or num_tokens % (nd * shape.get("pod", 1)):
        return False
    if "model" in shape and moe.d_ff_expert % shape["model"]:
        return False
    return True


def _local_weights(p, mesh):
    """The rank's (router, wi, wg, wo): the router whole, the experts'
    slice of the JAX in_specs — wi / wg ("data", None, "model"), wo
    ("data", "model", None).  A DTensor placed by
    ``sharding.param_shardings`` holds exactly that slice (``to_local``),
    as does a mesh step's ``tp.Stored`` leaf (its local piece, the router
    gathered by ``tp.whole``); a plain tensor holds every expert and is
    sliced by the rank's mesh coordinates."""
    shape = mesh_shape(mesh)
    coord = dict(zip(axis_names(mesh), mesh.get_coordinate()))
    has_model = "model" in shape

    def expert(w, f_dim):
        spec = ["data", None, None]
        if has_model:
            spec[f_dim] = "model"
        if isinstance(w, (DTensor, tp.Stored)):
            want = placements(mesh, spec)
            if list(w.placements) != want:
                raise ValueError(f"apply_moe_sharded: an expert weight placed "
                                 f"{w.placements}, expected {want}")
            return tp.own(w)
        n_loc = w.shape[0] // shape["data"]
        w = w.narrow(0, coord["data"] * n_loc, n_loc)
        if has_model:
            f_loc = w.shape[f_dim] // shape["model"]
            w = w.narrow(f_dim, coord["model"] * f_loc, f_loc)
        return w.contiguous()

    router = p["router"]
    if isinstance(router, DTensor):
        router = router.full_tensor()
    router = tp.whole(router)
    wi = expert(p["wi"], 2)
    wg = expert(p["wg"], 2) if "wg" in p else wi
    return router, wi, wg, expert(p["wo"], 1)


def apply_moe_sharded(p, x, moe, ffn_type, mesh, gmm_fn=None):
    """Routed-expert part only (shared experts handled by the caller).
    x: (B_loc,S,D), this rank's rows of the batch, which is sharded over
    ("pod","data"); every rank of the mesh calls it.  Returns (y, aux):
    y this rank's rows, aux the same on every rank.  ``gmm_fn`` is the
    grouped product of ``moe._expert_ffn``."""
    B_loc, S, D = x.shape
    E, K = moe.num_experts, moe.top_k
    shape = mesh_shape(mesh)
    nd = shape["data"]
    E_loc = E // nd
    data_g = mesh.get_group("data")
    model_g = mesh.get_group("model") if "model" in shape else None
    router, wi, wg, wo = _local_weights(p, mesh)
    dt, dev = x.dtype, x.device
    T = B_loc * S
    xt = x.reshape(T, D)
    probs, top_p, top_e = moe_mod._router({"router": router}, xt, moe)

    # ---- bucket slots by destination data-shard ---------------------------
    eid = top_e.T.reshape(-1)                                      # (KT,)
    gate = top_p.T.reshape(-1)
    dest = eid // E_loc                                            # (KT,)
    le = eid % E_loc
    C_send = _round8(T * K / nd * moe.capacity_factor)
    pd, keep = moe_mod._positions(dest, nd, C_send)
    flat = dest * C_send + pd
    tok = torch.arange(T, device=dev).repeat(K)
    # the kept slots' targets are unique: each is written once, and every
    # dropped slot goes to a spare last row (an accumulating scatter would
    # serialize the dropped slots' updates of one element)
    send_x = torch.zeros((nd * C_send + 1, D), dtype=dt, device=dev)
    send_x.index_put_((torch.where(keep, flat, nd * C_send),), xt[tok])
    send_x = send_x[:-1]
    send_le = torch.full((nd * C_send,), E_loc, dtype=torch.int32,
                         device=dev)
    send_le.scatter_reduce_(0, flat, torch.where(keep, le, E_loc).to(
        torch.int32), reduce="amin")
    send_ok = torch.zeros((nd * C_send,), dtype=torch.int32, device=dev)
    send_ok.scatter_reduce_(0, flat, keep.to(torch.int32), reduce="amax")

    # ---- dispatch all-to-all over the data axis ----------------------------
    a2a = _AllToAllInt8 if moe.dispatch_quant == "int8" else _AllToAll
    recv_x = a2a.apply(send_x.reshape(nd, C_send, D), data_g)
    recv_le = _a2a(send_le.reshape(nd, C_send), data_g)
    recv_ok = _a2a(send_ok.reshape(nd, C_send), data_g)

    # ---- local capacity-bounded expert buffers -----------------------------
    rx = recv_x.reshape(nd * C_send, D)
    rle = recv_le.reshape(-1).to(torch.int64)
    rok = recv_ok.reshape(-1).to(torch.bool) & (rle < E_loc)
    rle_s = torch.where(rok, rle, torch.zeros_like(rle))
    C_e = _round8(nd * C_send / E_loc * moe.local_capacity_factor)
    pe, keep_e = moe_mod._positions(rle_s, E_loc, C_e, rok)
    buf = torch.zeros((E_loc * C_e + 1, D), dtype=dt, device=dev)
    buf.index_put_((torch.where(keep_e, rle_s * C_e + pe, E_loc * C_e),), rx)
    buf = buf[:-1].reshape(E_loc, C_e, D)

    # ---- grouped expert FFN (F sharded over model) -------------------------
    if model_g is not None:
        buf = _IntoModel.apply(buf, model_g)
    y_buf = _expert_ffn({"wi": wi, "wg": wg, "wo": wo}, buf, ffn_type,
                        gmm_fn)
    if model_g is not None:
        y_buf = _OutOfModel.apply(y_buf, model_g)

    # ---- return trip --------------------------------------------------------
    ret = (y_buf[rle_s, pe] * keep_e[:, None].to(dt)).reshape(nd, C_send, D)
    back = _AllToAll.apply(ret, data_g).reshape(nd * C_send, D)
    y_slot = back[flat] * (keep & (send_ok[flat] > 0))[:, None].to(dt)
    yt = (y_slot * gate[:, None].to(dt)).reshape(K, T, D).sum(0)

    # ---- aux load-balancing loss (global means) -----------------------------
    def global_mean(v):
        for axis in ("data", "pod"):
            if axis in shape:
                v = _Mean.apply(v, mesh.get_group(axis))
        return v
    aux = moe_mod._aux_loss(probs, top_e, moe, mean=global_mean)
    return yt.reshape(B_loc, S, D), aux
