"""Tensor-parallel primitives of the mesh steps.

The JAX package jits its steps with ``in_shardings`` and lets GSPMD
split every product as ``sharding.py`` places the weights.  The port's
mesh steps (``launch/steps.py``) run the model once per rank on the
rank's own pieces instead: each parameter leaf reaches the model as a
:class:`Stored` (the rank's local tensor and the DTensor placements it
was cut by), and the model turns a super-block's leaves into the tensors
it computes with only when it runs that super-block:

  * ``local(leaf)``: gathered over the mesh dims that split it outside
    "model" (FSDP over "data"), the "model" split kept: the rank's head,
    ``d_ff`` or vocabulary slice for tensor-parallel compute;
  * ``whole(leaf)``: gathered over every mesh dim, for a sub-block that
    every "model" rank computes whole (``note_whole`` records it);
  * ``shared(leaf)``: ``whole`` through Megatron's f, for a leaf the
    rule replicates over "model" that a tensor-parallel region reads
    (qk-norm scales, the kv projections a rank's q heads select).

A gather's backward reduce-scatters the gradient, summed, over the dims
whose ranks hold other rows ("data"), and takes the rank's slice over
"model", whose ranks compute the same rows.  Megatron's f
(``into_model``: identity forward, the cotangent summed over "model")
and g (``out_of_model``: summed over "model" forward, identity
backward) bracket each tensor-parallel region.  On a plain tensor, or
with no mesh, every function here returns its input: the plain path
computes exactly what it computed before.
"""
from __future__ import annotations

import contextlib
import functools
import threading
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.sharding_ctx import current_mesh

_state = threading.local()
MODEL = "model"


class Stored:
    """A leaf as a rank stores it: ``local`` (its piece of the global
    tensor), ``placements`` (one per mesh dim, as ``DTensor`` has them)
    and ``shape`` (the global shape)."""
    __slots__ = ("local", "placements", "shape")

    def __init__(self, local, placements, shape):
        self.local = local
        self.placements = tuple(placements)
        self.shape = tuple(shape)


def is_stored(x) -> bool:
    return isinstance(x, Stored)


# --------------------------------------------------------------------------
# the mesh as a rank sees it
# --------------------------------------------------------------------------

class MeshView:
    """Names, sizes, coordinates and process groups of a ``DeviceMesh``
    as one rank sees it, read once per mesh (nothing here runs a
    collective or touches a tensor).  ``view`` keeps one per mesh;
    ``launch.steps._Rank`` adds the batch's rows to it."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.sizes = tuple(int(n) for n in mesh.mesh.shape)
        self.coord = tuple(mesh.get_coordinate())
        self.groups = tuple(mesh.get_group(a) if n > 1 else None
                            for a, n in zip(self.names, self.sizes))
        self.shape = dict(zip(self.names, self.sizes))

    def size(self, name) -> int:
        return self.shape.get(name, 1)

    def coordinate(self, name) -> int:
        return self.coord[self.names.index(name)] if name in self.names \
            else 0

    def group(self, name):
        return self.groups[self.names.index(name)] if name in self.names \
            else None


# id(mesh) -> (a weak reference to the mesh, its view): read once per
# mesh (a fake mode converts the mesh's rank tensor on every read), and
# kept no longer than the mesh
_VIEWS: dict = {}


def view(mesh=None):
    """The :class:`MeshView` of ``mesh`` (default: the current mesh; None
    without one)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    v = _VIEWS.get(id(mesh))
    if v is None or v[0]() is not mesh:
        v = _VIEWS[id(mesh)] = (weakref.ref(mesh), MeshView(mesh))
    return v[1]


def model_size() -> int:
    v = view()
    return v.size(MODEL) if v is not None else 1


def model_rank() -> int:
    v = view()
    return v.coordinate(MODEL) if v is not None else 0


def model_group():
    v = view()
    return v.group(MODEL) if v is not None else None


# --------------------------------------------------------------------------
# collectives along a tensor dim
# --------------------------------------------------------------------------

_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def all_gather(x, group, n, dim):
    """The ``n`` pieces of ``group``'s ranks joined along ``dim``, in rank
    order."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather(out, xt, group=group)
    return out.movedim(0, dim)


def reduce_scatter(x, group, n, dim):
    """``x`` summed over ``group`` and cut along ``dim``: the rank's
    piece."""
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _reduce_scatter(out, xt, op=dist.ReduceOp.SUM, group=group)
    return out.movedim(0, dim).contiguous()


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """``x`` reduced over ``group`` in place (no-op without a group)."""
    if group is not None:
        dist.all_reduce(x, op=op, group=group)
    return x


class _Gather(torch.autograd.Function):
    """All-gathers ``x`` over ``steps`` (group, size, coordinate, tensor
    dim, summed), innermost mesh dim first.  Backward, outermost first: a
    summed step reduce-scatters the cotangent, another takes the rank's
    slice (its ranks computed the same cotangent)."""

    @staticmethod
    def forward(ctx, x, steps):
        ctx.steps = steps
        for group, n, _, dim, _ in steps:
            x = all_gather(x, group, n, dim)
        return x

    @staticmethod
    def backward(ctx, g):
        for group, n, c, dim, summed in reversed(ctx.steps):
            if summed:
                g = reduce_scatter(g, group, n, dim)
            else:
                g = g.chunk(n, dim=dim)[c].contiguous()
        return g, None


def _gather(leaf, over_model: bool):
    if not is_stored(leaf):
        return leaf
    v = view()
    steps = []
    for i in reversed(range(len(v.names))):
        pl = leaf.placements[i]
        if not pl.is_shard() or v.sizes[i] == 1:
            continue
        if v.names[i] == MODEL and not over_model:
            continue
        steps.append((v.groups[i], v.sizes[i], v.coord[i], pl.dim,
                      v.names[i] != MODEL))
    if not steps:
        return leaf.local
    return _Gather.apply(leaf.local, tuple(steps))


def local(leaf):
    """The rank's piece of ``leaf`` for tensor-parallel compute: gathered
    over the mesh dims that split it outside "model" (FSDP over "data"),
    its "model" split kept; the backward reduce-scatters the summed
    gradient."""
    return _gather(leaf, over_model=False)


def whole(leaf):
    """All of ``leaf``, for compute that every "model" rank repeats."""
    return _gather(leaf, over_model=True)


def shared(leaf):
    """All of a leaf that a tensor-parallel region reads: ``whole``, its
    gradient summed over "model" (each rank adds its heads' share)."""
    if not is_stored(leaf):
        return leaf
    return into_model(whole(leaf))


def whole_tree(d):
    """A dict of leaves with each :class:`Stored` leaf gathered whole;
    ``d`` itself when it holds none (the plain path's dicts)."""
    if not _holds_stored(d):
        return d
    return {k: whole_tree(v) if isinstance(v, dict) else whole(v)
            for k, v in d.items()}


def _holds_stored(d) -> bool:
    return any(_holds_stored(v) if isinstance(v, dict) else is_stored(v)
               for v in d.values())


def own(x):
    """A leaf's own storage, no collective and no copy: the local piece of
    a :class:`Stored` leaf or a ``DTensor``; a plain tensor as it is."""
    if is_stored(x):
        return x.local
    return x.to_local() if isinstance(x, DTensor) else x


def stored(t):
    """A ``DTensor`` leaf as the model takes it on a mesh step: a
    :class:`Stored` over its own storage; a plain tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return Stored(t.to_local(), t.placements, t.shape)


def split_on(leaf, dim) -> bool:
    """Whether "model" splits ``leaf`` along ``dim``, or ``leaf`` is
    stored on a mesh whose "model" has one rank (tensor parallel of
    width 1: the whole is the rank's piece)."""
    if not is_stored(leaf):
        return False
    v = view()
    if v is None or v.size(MODEL) == 1:
        return True
    pl = leaf.placements[v.names.index(MODEL)]
    return pl.is_shard() and pl.dim == dim


# --------------------------------------------------------------------------
# a compute split that differs from the stored split
# --------------------------------------------------------------------------

def slice_of(leaf, dim):
    """The rank's slice along ``dim`` of a leaf that a tensor-parallel
    region reads split over "model" along ``dim``: its stored piece
    (``local``) where the rule splits it there; else all of it through
    ``shared`` (the gradient summed over "model": each rank adds its
    slice's) cut to the rank's slice.  A plain tensor as it is."""
    if not is_stored(leaf):
        return leaf
    if split_on(leaf, dim):
        return local(leaf)
    return shared(leaf).chunk(model_size(), dim=dim)[model_rank()]


def model_slice(x, dim, on: bool = True):
    """The rank's slice of ``x`` along ``dim`` over "model" (no
    collective; ``x`` itself when ``on`` is false or the axis has one
    rank)."""
    m = model_size() if on else 1
    return x if m == 1 else x.chunk(m, dim=dim)[model_rank()]


class Columns:
    """Products ``x @ w`` of one input ``x``, each whole (every output
    column) on every "model" rank.  ``region``: the products' consumers
    are a tensor-parallel region (each rank's cotangent is its share),
    so every product takes x through f, a product whose weight the rule
    splits on its output dim is column-parallel with its slices gathered
    over "model" (the cotangent reduce-scattered), and another reads its
    weight through ``shared``.  Otherwise the consumers are whole on
    every rank, and each product reads its weight whole.  On plain
    tensors, ``x @ w``."""

    def __init__(self, x, region: bool):
        self.x, self.region, self.xm = x, region, None

    def __call__(self, w):
        dt = self.x.dtype
        if not self.region:
            return self.x @ whole(w).to(dt)
        if self.xm is None:
            self.xm = into_model(self.x)
        if is_stored(w) and split_on(w, 1):
            return gather_model(self.xm @ local(w).to(dt), -1)
        return self.xm @ shared(w).to(dt)


def gather_model(x, dim, on: bool = True, summed: bool = True):
    """The "model" ranks' slices of an activation joined along ``dim``
    (``x`` itself when ``on`` is false or the axis has one rank).  The
    backward reduce-scatters the cotangent (``summed``: each rank's
    consumers saw only their share) or cuts the rank's slice from it
    (every rank computed all of it)."""
    group = model_group() if on else None
    if group is None:
        return x
    return _Gather.apply(x, ((group, model_size(), model_rank(),
                              dim % x.dim(), summed),))


@functools.lru_cache(maxsize=None)
def _halves_plan(width, m, c):
    """(the columns rank ``c`` sends each rank, the columns it receives
    from each) of ``halves``: ``width`` columns of [x | z] a rank, ``m``
    ranks, an even number, so that no rank's columns straddle x and z
    and each rank's go out in their order.  Column j of [x | z] goes to
    the rank whose slice of its half holds it; what a rank receives, in
    source order, is its x slice, then its z slice."""
    half = width * m // 2
    part = half // m

    def dest(r):
        return [(j % half) // part for j in range(r * width, (r + 1) * width)]
    mine = dest(c)
    return ([mine.count(j) for j in range(m)],
            [dest(s).count(c) for s in range(m)])


class _Halves(torch.autograd.Function):
    """The all-to-all of ``halves``; backward the reverse exchange."""

    @staticmethod
    def forward(ctx, xz, group, sends, recvs):
        ctx.args = (group, sends, recvs)
        send = xz.movedim(-1, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, recvs, sends, group=group)
        return recv.movedim(0, -1)

    @staticmethod
    def backward(ctx, g):
        group, sends, recvs = ctx.args
        gt = g.movedim(-1, 0).contiguous()
        back = torch.empty_like(gt)
        dist.all_to_all_single(back, gt, sends, recvs, group=group)
        return back.movedim(0, -1), None, None, None


def halves(xz, on: bool = True):
    """(x, z) of the product ``xz`` of a column-parallel ``[x | z]``
    projection: each half cut to the rank's slice.  The rule splits the
    concatenated dim, so on two ranks rank 0 holds all of x and rank 1
    all of z; an all-to-all over "model" sends each rank its slice of
    both (an even number of "model" ranks).  Plain (``on`` false, or one
    rank): ``xz.chunk(2, -1)``."""
    group = model_group() if on else None
    if group is None:
        return xz.chunk(2, dim=-1)
    sends, recvs = _halves_plan(xz.shape[-1], model_size(), model_rank())
    return _Halves.apply(xz, group, sends, recvs).chunk(2, dim=-1)


# --------------------------------------------------------------------------
# Megatron's f and g over "model"
# --------------------------------------------------------------------------

class IntoModel(torch.autograd.Function):
    """Identity forward; backward sums the cotangent over ``group``."""
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class OutOfModel(torch.autograd.Function):
    """Sum over ``group`` forward (a row-parallel product's psum);
    identity backward."""
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def into_model(x, on: bool = True):
    """Megatron's f over the current mesh's "model" axis (identity when
    ``on`` is false or the axis has one rank)."""
    group = model_group() if on else None
    return IntoModel.apply(x, group) if group is not None else x


def out_of_model(x, on: bool = True):
    """Megatron's g over the current mesh's "model" axis."""
    group = model_group() if on else None
    return OutOfModel.apply(x, group) if group is not None else x


# --------------------------------------------------------------------------
# rows over the batch axes
# --------------------------------------------------------------------------

@contextlib.contextmanager
def whole_batch(steps):
    """``with whole_batch(steps):`` -- the enclosed compute holds the
    rank's rows of a batch split over ``steps`` ((group, size,
    coordinate) of each batch axis of more than one rank, outermost
    first), and ``gather_batch`` / ``own_batch`` move between them and
    every row.  The JAX package's compiled mesh prefill runs the
    mLSTM's cell and the sLSTM's GLU of the rank's heads on every row
    of the batch (it splits their projections' contraction over "data"
    instead), and the port's mesh prefill does the same inside this
    context."""
    prev = getattr(_state, "rows", None)
    _state.rows = tuple(steps)
    try:
        yield
    finally:
        _state.rows = prev


def gather_batch(x, on: bool = True):
    """Every row of ``x`` (dim 0, in the global order) inside
    ``whole_batch``; ``x`` itself elsewhere or when ``on`` is false.
    Forward only: the mesh prefill takes no gradient."""
    for group, n, _ in reversed(getattr(_state, "rows", None) or ()
                                if on else ()):
        x = all_gather(x, group, n, 0)
    return x


def own_batch(x, on: bool = True):
    """The rank's rows of ``x`` (every row, dim 0) inside
    ``whole_batch``; ``x`` itself elsewhere or when ``on`` is false."""
    steps = getattr(_state, "rows", None) if on else None
    if not steps:
        return x
    idx, n = 0, 1
    for _, size, c in steps:
        idx, n = idx * size + c, n * size
    r = x.shape[0] // n
    return x[idx * r:(idx + 1) * r]


@contextlib.contextmanager
def row_parallel_glu():
    """``with row_parallel_glu():`` -- the enclosed compute takes the
    sLSTM GLU's up-projections row-parallel over "model" where the
    sLSTM runs on the rank's heads, as the JAX package's compiled mesh
    prefill and decode steps compute them; outside it (the mesh train
    step) they read their weights whole, as its train step does."""
    prev = getattr(_state, "glu_rows", False)
    _state.glu_rows = True
    try:
        yield
    finally:
        _state.glu_rows = prev


def glu_rows() -> bool:
    """Whether the compute is inside ``row_parallel_glu``."""
    return getattr(_state, "glu_rows", False)


# --------------------------------------------------------------------------
# what a step computes whole
# --------------------------------------------------------------------------

@contextlib.contextmanager
def recording():
    """``with recording() as whole:`` -- the set of sub-block kinds that
    the enclosed compute ran whole on every "model" rank."""
    prev = getattr(_state, "whole", None)
    _state.whole = set()
    try:
        yield _state.whole
    finally:
        _state.whole = prev


def note_whole(kind: str) -> None:
    """Records that a sub-block of ``kind`` ("mamba", "mlstm", "slstm",
    "mla", "attn", "cross", "ffn", "moe") ran whole over "model"; only
    where "model" has more than one rank."""
    rec = getattr(_state, "whole", None)
    if rec is not None and model_size() > 1:
        rec.add(kind)


# --------------------------------------------------------------------------
# attention: the rank's heads
# --------------------------------------------------------------------------

def kv_heads(num_heads, num_kv_heads, wk_split: bool, rank=None):
    """The kv heads that the q heads of "model" rank ``rank`` (this
    rank's by default) read: its own slice when "model" splits ``wk`` /
    ``wv``; else (GQA selection) the one head its ``num_heads / m`` q
    heads map to.  Raises where the rank's q heads straddle a group of G
    (a rank's q-head count that divides no G; a count that G divides
    would make "model" divide the kv heads, and the rule split them)."""
    m = model_size()
    c = model_rank() if rank is None else rank
    if wk_split:
        hk = num_kv_heads // m
        return list(range(c * hk, (c + 1) * hk))
    h_loc = num_heads // m
    group = num_heads // num_kv_heads
    if group % h_loc == 0:
        return [c * h_loc // group]
    raise ValueError(
        f"tensor-parallel attention: {num_heads} q heads over {m} ranks "
        f"({h_loc} a rank) cannot select from {num_kv_heads} kv heads "
        f"(groups of {group})")


def attention_weights(p, num_heads, num_kv_heads, *, select=True):
    """(the weights a rank computes attention with, the kv heads of every
    "model" rank or None).  With the heads split over "model": ``wq`` /
    ``wo`` the rank's heads, ``wk`` / ``wv`` its kv slice or (``select``)
    the kv heads it reads, through f; the qk-norm scales through f.
    Otherwise every weight whole and None."""
    if not split_on(p["wq"], 1):
        return {k: whole(w) for k, w in p.items()}, None
    out = {"wq": local(p["wq"]), "wo": local(p["wo"])}
    wk_split = split_on(p["wk"], 1)
    every = [kv_heads(num_heads, num_kv_heads, wk_split, r)
             for r in range(model_size())]
    heads = every[model_rank()]
    for k in ("wk", "wv"):
        if wk_split:
            out[k] = local(p[k])
        elif select:
            out[k] = shared(p[k])[:, heads[0]:heads[-1] + 1]
        else:
            out[k] = whole(p[k])
    for k in ("q_norm", "k_norm"):
        if k in p:
            out[k] = shared(p[k])
    return out, every


def heads_to_seq(x, every, num_kv_heads):
    """A prefill cache seed (B, S, h, Dh) of this rank's kv heads
    (``every[r]``: the heads of "model" rank r) -> (B, S / m, Hkv, Dh):
    every head, the rank's slice of the sequence (an all-to-all over
    "model"); (B, S, Hkv, Dh), every head, when "model" does not divide
    S (an all-gather)."""
    m, group = model_size(), model_group()
    if group is None:
        return x
    h = x.shape[2]
    if x.shape[1] % m:
        src = all_gather(x, group, m, 2)                 # (B, S, m*h, Dh)
    else:
        send = torch.stack(x.chunk(m, dim=1)).contiguous()   # (m,B,S/m,h,D)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        src = recv.permute(1, 2, 0, 3, 4).reshape(
            x.shape[0], x.shape[1] // m, m * h, x.shape[3])
    # rank r's heads sit at [r*h, (r+1)*h); each kv head from the first
    # rank that holds it
    owner = {}
    for r, hs in enumerate(every):
        for j, hd in enumerate(hs):
            owner.setdefault(hd, r * h + j)
    idx = torch.tensor([owner[j] for j in range(num_kv_heads)],
                       device=x.device)
    return src.index_select(2, idx)


# --------------------------------------------------------------------------
# the sequence split of a decode cache
# --------------------------------------------------------------------------

def seq_split(leaf):
    """(groups, offset, length) of a decode cache leaf's sequence dim
    (dim 1): the process groups of the mesh dims that split it
    (outermost first), the first position the rank holds, and the
    global length.  None for a plain tensor."""
    if not is_stored(leaf):
        return None
    v = view()
    groups, chunk, n = [], 0, 1
    for i, pl in enumerate(leaf.placements):
        if pl.is_shard() and pl.dim == 1 and v.sizes[i] > 1:
            groups.append(v.groups[i])
            chunk = chunk * v.sizes[i] + v.coord[i]
            n *= v.sizes[i]
    return tuple(groups), chunk * (leaf.shape[1] // n), leaf.shape[1]


def seq_softmax(scores, groups):
    """``softmax(scores, -1)`` over a sequence whose slices lie on the
    ranks of ``groups``: the max, then the sum of exponentials, reduced
    over them (f32, as the plain softmax)."""
    if not groups:
        return torch.softmax(scores, dim=-1)
    mx = scores.amax(dim=-1, keepdim=True)
    for g in groups:
        all_reduce(mx, g, dist.ReduceOp.MAX)
    e = torch.exp(scores - mx)
    s = e.sum(dim=-1, keepdim=True)
    for g in groups:
        all_reduce(s, g)
    return e / s


def seq_sum(x, groups):
    """``x`` summed over the ranks of ``groups`` (in place)."""
    for g in groups:
        all_reduce(x, g)
    return x
