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
    (qk-norm scales, the kv projections a rank's q heads select, the
    heads of a ``HeadGroups`` group where "model" does not divide them).

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
import math
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
        self.blocks = {}              # (size) -> ``block_group``'s group

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


def part_of(leaf, dim):
    """The rank's part along ``dim`` of a leaf that a tensor-parallel
    region reads in "model" parts that need not be even
    (``torch.tensor_split``): its stored piece where the rule splits it
    there (evenly), else all of it through ``shared`` cut to the rank's
    part.  A plain tensor as it is."""
    if not is_stored(leaf):
        return leaf
    if split_on(leaf, dim):
        return local(leaf)
    return shared(leaf).tensor_split(model_size(), dim=dim)[model_rank()]


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
# heads that "model" does not divide
# --------------------------------------------------------------------------

def block_group(size):
    """The process group of the ``size`` consecutive "model" ranks that
    hold this rank (``size`` divides "model"), made on first use by its
    members alone and kept with the mesh's view."""
    v = view()
    if size == 1:
        return None
    if size == v.size(MODEL):
        return v.group(MODEL)
    if size not in v.blocks:
        ranks = dist.get_process_group_ranks(v.group(MODEL))
        first = v.coordinate(MODEL) // size * size
        v.blocks[size] = dist.new_group(ranks[first:first + size],
                                        use_local_synchronization=True)
    return v.blocks[size]


class _Psum(torch.autograd.Function):
    """Sum over ``group`` forward and backward: a partial sum whose sum
    each rank then uses in its own share of the compute."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter over ``group`` along ``dim`` (each rank keeps its
    slice of the sum); backward all-gathers the slices' cotangents."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        group, n, dim = ctx.args
        return all_gather(g, group, n, dim), None, None, None


class HeadGroups:
    """How the "model" ranks share ``num_heads`` heads: ``g = gcd(H, m)``
    groups of ``hg = H / g`` consecutive heads, group ``index`` on the
    ``R = m / g`` consecutive ranks of its block (``block_group``), where
    this rank is number ``j``.  Where "model" divides the heads, R is 1:
    each rank its own group, every row its own (the heads split).  Else
    the ranks of a block split their group's work among them: attention
    and MLA its query rows (``rows``) with k and v joined over the block,
    the mLSTM (one head a block) its head dim.  Every collective of the
    block runs on ``group``."""

    def __init__(self, num_heads):
        m = model_size()
        self.g = math.gcd(num_heads, m)
        self.R = m // self.g
        self.hg = num_heads // self.g
        self.index, self.j = divmod(model_rank(), self.R)
        self.heads = slice(self.index * self.hg, (self.index + 1) * self.hg)
        self.group = block_group(self.R)

    def first(self) -> bool:
        """Whether this rank is its block's first."""
        return self.j == 0

    def part(self, leaf, dim):
        """The group's heads (along ``dim``) of a head-major weight: the
        rank's stored piece where the rule splits it there (R is 1),
        else all of it through ``shared`` cut to the group's heads."""
        if split_on(leaf, dim):
            return local(leaf)
        return shared(leaf).narrow(dim, self.heads.start, self.hg)

    def psum(self, x):
        """``x`` summed over the block, each rank's cotangent its share."""
        return _Psum.apply(x, self.group) if self.group is not None else x

    def scatter_sum(self, x, dim):
        """The rank's slice along ``dim`` of ``x`` summed over the block."""
        if self.group is None:
            return x
        return _ScatterSum.apply(x, self.group, self.R, dim % x.dim())

    def gather(self, x, dim):
        """The block's pieces of ``x`` joined along ``dim`` in rank order;
        the backward reduce-scatters the summed cotangent."""
        if self.group is None:
            return x
        return _Gather.apply(x, ((self.group, self.R, self.j, dim % x.dim(),
                                  True),))

    def rows(self, length, causal):
        """The rank's query rows of a sequence of ``length`` as (start,
        end) spans: every row where R is 1; of 2R equal chunks, chunk j
        and chunk 2R-1-j where the attention is causal (every rank of the
        block then attends to as many keys), else the j-th of R chunks.
        None when the chunks do not divide ``length``."""
        if self.R == 1:
            return [(0, length)]
        n = 2 * self.R if causal else self.R
        if length % n:
            return None
        c = length // n
        spans = [(self.j * c, (self.j + 1) * c)]
        if causal:
            spans.append(((n - 1 - self.j) * c, (n - self.j) * c))
        return spans

    def gather_rows(self, x, length, causal, dim=1):
        """Every row of a sequence (along ``dim``) from each block rank's
        ``rows`` of it, in the sequence's order."""
        x = self.gather(x, dim)
        if not causal or self.R == 1:
            return x
        c = length // (2 * self.R)
        order = []
        for r in range(self.R):
            order += [r, 2 * self.R - 1 - r]     # rank r's two chunks
        at = {chunk: i for i, chunk in enumerate(order)}
        idx = torch.cat([torch.arange(at[k] * c, (at[k] + 1) * c)
                         for k in range(2 * self.R)]).to(x.device)
        return x.index_select(dim, idx)

    def batch_rows(self, n):
        """The rank's share of a decode step's ``n`` rows (the block's
        ranks split them); None for every row (R is 1, or R does not
        divide ``n``)."""
        if self.R == 1 or n % self.R:
            return None
        r = n // self.R
        return slice(self.j * r, (self.j + 1) * r)

    def gather_heads(self, x, dim=2, rows=False):
        """Every head of ``x`` (this rank's group's ``hg`` heads along
        ``dim``) gathered over "model", one copy of each group's; with
        ``rows``, ``x`` holds the rank's ``batch_rows`` (dim 0), and
        every row comes back too (forward only: decode)."""
        if model_group() is None:
            return x
        if rows:
            x = all_gather(x, model_group(), model_size(), 0)
            x = x.reshape((self.g, self.R, x.shape[0] // model_size())
                          + tuple(x.shape[1:])).movedim(0, dim + 1)
            shape = x.shape                 # (R, b, ..., g, hg, ...)
            return x.reshape((shape[0] * shape[1],) + shape[2:dim + 1]
                             + (self.g * self.hg,) + shape[dim + 3:])
        x = all_gather(x, model_group(), model_size(), dim)
        shape = x.shape
        x = x.reshape(shape[:dim] + (self.g, self.R, self.hg)
                      + shape[dim + 1:])
        return x.select(dim + 1, 0).reshape(
            shape[:dim] + (self.g * self.hg,) + shape[dim + 1:])

    def add_rows(self, y, n, part):
        """A decode step's output of the rank's share of the rows (``part``
        of ``n``; None: every row, which only the block's first rank
        adds) as its term of the sum over "model"."""
        if part is None:
            return y if self.first() else torch.zeros_like(y)
        out = y.new_zeros((n,) + tuple(y.shape[1:]))
        out[part] = y
        return out


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
    context, but for the mLSTM's "dh" cell, which keeps the rank's
    rows."""
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
    "slstm_recurrence", "mla", "attn", "cross", "ffn", "moe") ran whole
    over "model"; only where "model" has more than one rank."""
    rec = getattr(_state, "whole", None)
    if rec is not None and model_size() > 1:
        rec.add(kind)


# --------------------------------------------------------------------------
# attention: the rank's heads
# --------------------------------------------------------------------------

def group_kv_heads(grp, num_heads, num_kv_heads, group=None):
    """The kv heads that the q heads of head group ``group`` (this rank's
    by default) read: its 1/g of them where the g groups divide the kv
    heads; else (GQA selection) the one head its ``hg`` q heads map to.
    Raises where a group's q heads straddle a kv group of G (an ``hg``
    that divides no G)."""
    c = grp.index if group is None else group
    if num_kv_heads % grp.g == 0:
        hk = num_kv_heads // grp.g
        return list(range(c * hk, (c + 1) * hk))
    per_kv = num_heads // num_kv_heads
    if per_kv % grp.hg == 0:
        return [c * grp.hg // per_kv]
    raise ValueError(
        f"tensor-parallel attention: {num_heads} q heads in {grp.g} groups "
        f"({grp.hg} a group) cannot select from {num_kv_heads} kv heads "
        f"(groups of {per_kv})")


def attention_groups(p, num_heads, num_kv_heads, length=None, causal=True,
                     kv_length=None, select=True):
    """(the weights of this rank's head group, the kv heads of every
    "model" rank, the ``HeadGroups``) of stored attention weights:
    ``wq`` / ``wo`` the group's heads (``HeadGroups.part``: the rank's
    stored piece where the rule splits the heads); ``wk`` / ``wv`` the
    rank's stored slice where the rule splits them, else the kv heads
    the group reads (``select``) or every kv head, through f; the
    qk-norm scales through f.  None on plain tensors, or where a block's
    chunks divide neither the ``length`` query rows nor the
    ``kv_length`` keys of cross-attention (then "model" computes it
    whole)."""
    if not is_stored(p["wq"]):
        return None
    grp = HeadGroups(num_heads)
    if (length is not None and grp.rows(length, causal) is None) or (
            kv_length is not None and grp.rows(kv_length, False) is None):
        return None
    every = [group_kv_heads(grp, num_heads, num_kv_heads, r // grp.R)
             for r in range(model_size())]
    out = {"wq": grp.part(p["wq"], 1), "wo": grp.part(p["wo"], 0)}
    heads = every[model_rank()]
    for k in ("wk", "wv"):
        if split_on(p[k], 1):
            out[k] = local(p[k])
        elif select:
            out[k] = shared(p[k])[:, heads[0]:heads[-1] + 1]
        else:
            out[k] = shared(p[k])
    for k in ("q_norm", "k_norm"):
        if k in p:
            out[k] = shared(p[k])
    return out, every, grp


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
