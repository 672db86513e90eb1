"""Step builders and abstract input structures for the port's model path.

The port of the JAX package's ``launch/steps.py``: the train step
(``forward_loss``, its gradient by autograd, AdamW), and the prefill /
decode steps; each closes over the config.  ``_resolve_kernels`` maps
``RunConfig.attention_impl == "pallas"`` (the JAX package's only switch
to its kernels) to the CUDA kernels' wrappers for the forwards without
a gradient.  PyTorch runs eagerly, so nothing is jitted.

``params_struct`` / ``opt_struct`` / ``cache_struct`` / ``input_specs``
are the JAX package's abstract structures as trees of meta tensors in
the port's layout (each stack a list of per-super-block dicts, no
``n_super`` axis): the dry run places them on a mesh as fake tensors;
the trainer and server allocate real buffers of the same shapes.  The
``make_mesh_*_step`` builders run the steps on trees of DTensors the
way the rules store them: each rank computes on its own shards, the
model gathering a super-block's weights over "data" as it runs it and
splitting attention, the FFN and the head over "model"
(``models/tp.py``).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models import tp
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.tree import leaves, map_tree, unflatten


BF16 = torch.bfloat16
I32 = torch.int32


def _dtype(run: RunConfig) -> torch.dtype:
    return getattr(torch, run.compute_dtype)


# --------------------------------------------------------------------------
# abstract structures (meta tensors: no allocation)
# --------------------------------------------------------------------------

def params_struct(cfg: ModelConfig, dtype=BF16):
    """The parameter tree of ``cfg`` on the meta device, float leaves cast
    to ``dtype``."""
    tree = M.init_params(cfg, torch.Generator(), device="meta")
    return map_tree(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def opt_struct(cfg: ModelConfig, pstruct=None, dtype=BF16):
    """``adamw_init``'s state for ``pstruct`` on the meta device: f32
    moments, an int32 step, and the f32 master when a parameter is not
    f32."""
    return adamw_init(pstruct if pstruct is not None
                      else params_struct(cfg, dtype))


def cache_struct(cfg: ModelConfig, batch, max_len, dtype=BF16):
    return M.init_cache(cfg, batch, max_len, dtype, device="meta")


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    if cfg.frontend is not None:
        return seq_len - cfg.frontend.num_patches
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig, dtype=BF16):
    """Model inputs of a cell on the meta device.  train / prefill: the
    token batch (+ the stub frontends' embeddings: ``enc_embeds`` for an
    encoder-decoder, ``patch_embeds`` for a VLM, whose patches and
    tokens fill ``seq_len`` together); decode: {caches, token, pos}, one
    new token against a ``seq_len`` cache."""
    B, S = shape.global_batch, shape.seq_len
    St = _text_len(cfg, S)

    def meta(shape_, dt):
        return torch.empty(shape_, dtype=dt, device="meta")

    if shape.kind in ("train", "prefill"):
        batch = {"tokens": meta((B, St), I32)}
        if shape.kind == "train":
            batch["targets"] = meta((B, St), I32)
        if cfg.is_encdec:
            batch["enc_embeds"] = meta((B, cfg.encoder.n_frames,
                                        cfg.d_model), dtype)
        if cfg.frontend is not None:
            batch["patch_embeds"] = meta((B, cfg.frontend.num_patches,
                                          cfg.d_model), dtype)
        return batch
    return {"caches": cache_struct(cfg, B, S, dtype),
            "token": meta((B, 1), I32),
            "pos": meta((), I32)}


def _resolve_kernels(run: RunConfig) -> dict:
    """The forward's kernel hooks for ``run``: with ``attention_impl ==
    "pallas"``, ``flash_fn`` / ``gmm_fn`` / ``scan_fn`` / ``chunk_fn``
    are the flash attention, ``moe_gmm``, ``mamba_scan`` and
    ``mlstm_chunk_model`` wrappers; otherwise all four are None and the
    forward computes exactly the JAX package's reference path (chunked
    attention, einsum experts, chunked scan, chunked mLSTM).
    Both settings compute the same function within the kernels'
    tolerances, so the switch adds no behaviour the JAX package lacks;
    it takes no new ``RunConfig`` field."""
    if run.attention_impl != "pallas":
        return {"flash_fn": None, "gmm_fn": None, "scan_fn": None,
                "chunk_fn": None}
    from repro_torch.kernels import ops as kops
    return {"flash_fn": kops.flash_attention, "gmm_fn": kops.moe_gmm,
            "scan_fn": kops.mamba_scan, "chunk_fn": kops.mlstm_chunk_model}


def _check_trainable(run: RunConfig) -> None:
    if run.attention_impl == "pallas":
        raise NotImplementedError(
            "make_train_step: attention_impl='pallas' has no backward: the "
            "port's kernels are forward-only, as the JAX package's Pallas "
            "flash kernel is (it fails under jax.grad, ROADMAP C6); train "
            "with attention_impl='reference'")


def make_value_and_grad(cfg: ModelConfig, run: RunConfig):
    """``fn(params, batch) -> (loss, grads)``: the training loss (CE + MoE
    aux) and its gradient, a tree of ``params``' structure.  With
    ``run.shape.grad_accum = a > 1`` microbatch i is rows [i B/a,
    (i+1) B/a) of the batch; the gradients are summed in f32 and, like
    the loss, divided by a.  The reference path only: no kernel of the
    port has a backward (ROADMAP C6), so ``attention_impl="pallas"``
    raises."""
    _check_trainable(run)
    dt = _dtype(run)
    accum = max(1, run.shape.grad_accum)

    def loss_and_grads(params, mb):
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
        loss, _ = M.forward_loss(params, cfg, mb, compute_dtype=dt,
                                 run_cfg=run)
        return loss.detach(), torch.autograd.grad(loss, ps)

    def value_and_grad(params, batch):
        if accum == 1:
            loss, grads = loss_and_grads(params, batch)
            return loss, unflatten(params, grads)
        n = batch["tokens"].shape[0] // accum
        lacc, gacc = 0.0, None
        for i in range(accum):
            loss, grads = loss_and_grads(
                params, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})
            lacc = lacc + loss
            if gacc is None:
                gacc = [g.to(torch.float32) for g in grads]
            else:
                for a, g in zip(gacc, grads):
                    a.add_(g.to(torch.float32))
        return lacc / accum, unflatten(params, [g.div_(accum) for g in gacc])

    return value_and_grad


def make_train_step(cfg: ModelConfig, run: RunConfig):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    the loss and gradient of ``make_value_and_grad``, then one AdamW
    update at the cosine schedule's rate, written into ``params`` and
    ``opt_state`` in place; metrics {"loss", "grad_norm", "lr"} are
    tensors."""
    value_and_grad = make_value_and_grad(cfg, run)

    def train_step(params, opt_state, batch):
        lr = cosine_schedule(opt_state["step"], base_lr=run.learning_rate)
        loss, grads = value_and_grad(params, batch)
        new_params, new_opt, om = adamw_update(
            grads, opt_state, params, lr=lr, beta1=run.beta1,
            beta2=run.beta2, weight_decay=run.weight_decay,
            grad_clip=run.grad_clip)
        return new_params, new_opt, {"loss": loss, **om}

    return train_step


class _Rank(tp.MeshView):
    """This rank's place on a ``DeviceMesh``, read once when a step is
    built (nothing here runs a collective or touches a tensor, so the
    steps also trace on fake tensors): ``tp.MeshView``'s names, sizes,
    coordinates and groups, and the rows of a batch split over the
    ("pod", "data") axes as ``sharding.batch_shardings`` splits it
    (row-major over those axes)."""

    def __init__(self, mesh):
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch import sharding as sh
        from repro_torch.sharding_ctx import abstract_mesh

        super().__init__(mesh)
        self.single = mesh.size() == 1
        self.abstract = abstract_mesh(self.sizes, self.names)
        axes = sh.batch_axes(mesh)
        self.n, self.idx = 1, 0          # row-major over the batch axes
        for a in axes:
            self.n = self.n * self.size(a)
            self.idx = self.idx * self.size(a) + self.coordinate(a)
        self.batch_pl = [Shard(0) if a in axes else Replicate()
                         for a in self.names]
        self.whole = [Replicate()] * len(self.sizes)
        # (axis, group) of each batch axis of more than one rank
        self.batch_groups = [(a, self.group(a)) for a in axes
                             if self.size(a) > 1]

    def full(self, t):
        """The whole of a DTensor leaf (its own storage when nothing is
        split, or on one rank); a plain tensor as it is."""
        from torch.distributed.tensor import DTensor
        if not isinstance(t, DTensor):
            return t
        if all(pl.is_replicate() for pl in t.placements) or self.single:
            return t.to_local()
        return t.full_tensor()

    def shard(self, x, placements, held=None):
        """The piece of ``x`` that this rank's DTensor holds under
        ``placements`` (even splits, nested in mesh-dim order), ``x``
        being already split as ``held`` (default: whole) on a subset of
        those mesh dims."""
        held = held or self.whole
        for size, c, pl, h in zip(self.sizes, self.coord, placements, held):
            if pl.is_shard() and not h.is_shard():
                x = x.chunk(size, dim=pl.dim)[c]
        return x

    def rows(self, batch):
        """(the rank's rows of ``batch``, their placements): a batch that
        the ("pod", "data") axes divide is split over them, as the JAX
        rule splits it, else computed whole on every rank.  A leaf given
        as a DTensor placed by ``batch_shardings`` holds its rows."""
        from torch.distributed.tensor import DTensor
        b = next(iter(batch.values())).shape[0]
        if b % self.n:
            return {k: self.full(v) for k, v in batch.items()}, self.whole
        r = b // self.n
        return {k: v.to_local() if isinstance(v, DTensor)
                else v[self.idx * r:(self.idx + 1) * r]
                for k, v in batch.items()}, self.batch_pl

    def place(self, x, held, placements):
        """A DTensor placed by ``placements`` from this rank's piece ``x``
        of a tensor split as ``held`` (redistributed where the two
        differ on a mesh dim of more than one rank)."""
        from torch.distributed.tensor import DTensor
        shape = list(x.shape)
        for size, h in zip(self.sizes, held):
            if h.is_shard():
                shape[h.dim] *= size
        if all(size == 1 or h == pl for size, h, pl
               in zip(self.sizes, held, placements)):
            return DTensor.from_local(x, self.mesh, placements,
                                      run_check=False, shape=tuple(shape),
                                      stride=_contiguous(shape))
        t = DTensor.from_local(x, self.mesh, held, run_check=False,
                               shape=tuple(shape), stride=_contiguous(shape))
        return t.redistribute(self.mesh, placements)


def distribute(tree, shardings, mesh):
    """A tree of DTensors placed by ``shardings`` (a tree of
    ``NamedSharding``) from a tree of whole tensors that every rank holds
    alike: each rank keeps a copy of its own piece (no collective)."""
    r = _Rank(mesh)

    def one(x, ns):
        pl = ns.placements
        return r.place(r.shard(x, pl).contiguous().clone(), pl, pl)
    return map_tree(one, tree, shardings)


def load_pieces(tree, whole, mesh):
    """Copies into each DTensor of ``tree``, in place, this rank's piece
    of the matching whole tensor of ``whole``."""
    r = _Rank(mesh)
    with torch.no_grad():
        for d, x in zip(leaves(tree), leaves(whole)):
            tp.own(d).copy_(r.shard(x, d.placements))


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def _microbatches(r: _Rank, batch, accum: int):
    """(the rank's rows of each of ``accum`` microbatches, whether the
    rows are split over the batch axes).  Microbatch i is rows [i B/a,
    (i+1) B/a) of the global batch, as the JAX step reshapes it, and the
    rank takes its slice of them.  A batch given as DTensors placed by
    ``batch_shardings`` holds the rank's slice of the whole batch, not
    of each microbatch: with ``accum`` > 1 its rows are gathered first
    (ROADMAP C15: an MoE's capacity and aux loss are taken per
    microbatch, so other rows would give other values).  A batch the
    axes cannot divide runs whole on every rank."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(v, DTensor) for v in batch.values()):
        if accum == 1:
            rows, held = r.rows(batch)
            return [rows], held is r.batch_pl
        batch = {k: r.full(v) for k, v in batch.items()}
    b = next(iter(batch.values())).shape[0]
    if b % (r.n * accum):
        n = b // accum
        return [{k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                for i in range(accum)], False
    per, sub = b // accum, b // accum // r.n
    return [{k: v[i * per + r.idx * sub:i * per + (r.idx + 1) * sub]
             for k, v in batch.items()} for i in range(accum)], True


def _counted(r: _Rank, placements) -> bool:
    """Whether this rank counts a leaf's piece in the gradient norm: the
    first rank of each mesh dim that replicates it."""
    return all(pl.is_shard() or n == 1 or c == 0
               for pl, n, c in zip(placements, r.sizes, r.coord))


def make_mesh_train_step(cfg: ModelConfig, run: RunConfig, mesh):
    """``step(params, opt_state, batch)`` on trees of DTensors placed by
    ``sharding.param_shardings`` / ``opt_shardings`` on ``mesh``: the
    counterpart of the JAX package's ``jax.jit(make_train_step,
    in_shardings=..., out_shardings=...)``, computed the way the rules
    store the state.  Each rank

      1. runs ``forward_loss`` on its rows of each microbatch (the global
         batch split over the ("pod", "data") axes as ``batch_shardings``
         splits it; plain tensors of the global batch or DTensors) with
         every parameter a ``tp.Stored`` over its shard: a super-block's
         weights are gathered over "data" inside its remat body and freed
         after, attention, the FFN and the head computed
         tensor-parallel over "model", the MoE through ``moe_sharded``
         (the step enters ``use_mesh``), the sub-blocks the slice does
         not partition whole (``tp.note_whole``);
      2. gets the gradient of its shards: reduce-scattered over "data"
         by the gathers' backward, summed over the batch axes that
         replicate a leaf, divided by the number of row shards;
      3. applies ``adamw_update`` to its shards in place, the gradient
         norm summed over the mesh (``sharded_norm``).

    On a mesh of one rank: the plain step on the DTensors' own storage
    (no copy; a caller inside ``use_mesh`` gets the MoE's expert-parallel
    dispatch, as from the plain step).  The result equals
    ``make_train_step``
    on the global batch within f32 rounding for a loss that is a mean
    over equal-sized shards.  ``whole`` on the returned function is the
    set of sub-block kinds its last call computed whole."""
    import torch.distributed as dist

    from repro_torch.optim.adamw import sharded_norm
    from repro_torch.sharding_ctx import use_mesh

    r = _Rank(mesh)
    if r.single:
        plain = make_train_step(cfg, run)

        def one_rank(params, opt_state, batch):
            lo = map_tree(tp.own, opt_state)
            _, new_o, om = plain(map_tree(tp.own, params), lo,
                                 map_tree(tp.own, batch))
            tp.own(opt_state["step"]).copy_(new_o["step"])
            return params, opt_state, om
        one_rank.whole = set()
        return one_rank

    _check_trainable(run)
    dt = _dtype(run)
    accum = max(1, run.shape.grad_accum)
    groups = [g for g in r.groups if g is not None]

    def train_step(params, opt_state, batch):
        stored = map_tree(tp.stored, params)
        sl = leaves(stored)
        ps = [s.local for s in sl]
        for p in ps:
            p.requires_grad_(True)
        mbs, split = _microbatches(r, batch, accum)
        lacc, gacc = 0.0, None
        with use_mesh(mesh), tp.recording() as whole:
            for mb in mbs:
                loss, _ = M.forward_loss(stored, cfg, mb, compute_dtype=dt,
                                         run_cfg=run)
                grads = torch.autograd.grad(loss, ps)
                lacc = lacc + loss.detach()
                if accum == 1:
                    gacc = list(grads)
                elif gacc is None:
                    gacc = [g.to(torch.float32) for g in grads]
                else:
                    for a, g in zip(gacc, grads):
                        a.add_(g.to(torch.float32))
        train_step.whole = whole
        with torch.no_grad():
            loss = lacc / accum if accum > 1 else lacc
            loss = loss.clone()
            for _, g in r.batch_groups:
                dist.all_reduce(loss, group=g)
            loss = loss / r.n
            for g, s in zip(gacc, sl):
                if accum > 1:
                    g.div_(accum)
                for axis, grp in r.batch_groups:
                    if not s.placements[r.names.index(axis)].is_shard():
                        dist.all_reduce(g, group=grp)
                g.div_(r.n)
        lo = map_tree(tp.own, opt_state)
        lr = cosine_schedule(lo["step"], base_lr=run.learning_rate)
        counted = [_counted(r, s.placements) for s in sl]
        _, new_o, om = adamw_update(
            unflatten(params, gacc), lo, unflatten(params, ps), lr=lr,
            beta1=run.beta1, beta2=run.beta2, weight_decay=run.weight_decay,
            grad_clip=run.grad_clip,
            norm_fn=lambda t: sharded_norm(t, counted, groups))
        tp.own(opt_state["step"]).copy_(new_o["step"])
        return params, opt_state, {"loss": loss, **om}

    train_step.whole = set()
    return train_step


def _cache_placements(r: _Rank, caches):
    """(each cache leaf's placements under ``sharding.cache_shardings``,
    the placements of the rank's rows: the batch split over "data" when
    the rule splits it, every other dim whole)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch import sharding as sh
    from repro_torch.sharding_ctx import placements

    shardings = sh.cache_shardings(caches, r.abstract)
    first = placements(r.mesh, leaves(shardings)[0].spec)
    rows = [Shard(0) if a == "data" and pl == Shard(0) else Replicate()
            for a, pl in zip(r.names, first)]
    return map_tree(lambda s: placements(r.mesh, s.spec), shardings), rows


def _logit_placements(r: _Rank, held, params):
    """``held`` with the vocabulary dim split over "model" where the
    head left each rank its own columns."""
    from torch.distributed.tensor import Shard

    if "lm_head" not in params or "model" not in r.names:
        return held
    i = r.names.index("model")
    if r.sizes[i] == 1 or params["lm_head"]["w"].placements[i] != Shard(1):
        return held
    out = list(held)
    out[i] = Shard(2)
    return out


def make_mesh_prefill_step(cfg: ModelConfig, run: RunConfig, mesh):
    """``step(params, batch) -> (logits, caches)`` on a tree of DTensors
    placed by ``sharding.param_shardings``: the counterpart of the JAX
    package's ``jax.jit(make_prefill_step, in_shardings=(psh, bsh))``,
    computed as ``make_mesh_train_step`` computes: the rank's rows of
    the batch (split as ``batch_shardings`` splits it; plain tensors of
    the global batch or DTensors) through ``make_prefill_step``'s
    forward on the rank's shards, tensor-parallel over "model"; with
    ``attention_impl="pallas"`` the flash kernel runs on the rank's
    heads and ``moe_gmm`` on its experts.  Returns the last-token logits
    as a DTensor split over the batch axes (and over "model" on the
    vocabulary) and the caches as DTensors placed by
    ``sharding.cache_shardings``: each attention cache leaves the model
    with the rank's slice of the sequence and every kv head, and DTensor
    redistributes where the cache rule splits rows otherwise than the
    batch rule, as on a mesh with a "pod" axis.  On one rank: the plain
    step's tensors, uncopied."""
    from torch.distributed.tensor import Shard

    from repro_torch.sharding_ctx import use_mesh

    prefill = make_prefill_step(cfg, run)
    hooks = _prefill_kernels(run)
    dt = _dtype(run)
    r = _Rank(mesh)

    def prefill_step(params, batch):
        mb, held = r.rows(batch)
        if r.single:
            logits, caches = prefill(map_tree(tp.own, params), mb)
        else:
            rows = [(g, r.size(a), r.coordinate(a))
                    for a, g in r.batch_groups] if held is r.batch_pl else []
            with use_mesh(mesh), tp.recording() as whole, \
                    tp.whole_batch(rows), tp.row_parallel_glu():
                logits, caches = M.prefill(
                    map_tree(tp.stored, params), cfg, mb, compute_dtype=dt,
                    q_chunk=run.attention_q_chunk, **hooks)
            prefill_step.whole = whole
        lpl = _logit_placements(r, held, params) if not r.single else held
        glob = _global_caches(cfg, mb, held, r)
        specs, _ = _cache_placements(r, glob)

        def place(x, g, pl):
            h = list(held)
            if x.dim() > 1 and x.shape[1] != g.shape[1]:
                h[r.names.index("model")] = Shard(1)   # heads_to_seq's
            return r.place(x, h, pl)
        return (r.place(logits, lpl, lpl),
                map_tree(place, caches, glob, specs))

    prefill_step.whole = set()
    return prefill_step


def _prefill_kernels(run: RunConfig) -> dict:
    """The kernel hooks a prefill takes: flash and ``moe_gmm`` (the
    scan's and the mLSTM's kernels return no state)."""
    k = _resolve_kernels(run)
    return {"flash_fn": k["flash_fn"], "gmm_fn": k["gmm_fn"]}


def _global_caches(cfg, mb, held, r: _Rank):
    """The global shapes of a prefill's caches: ``init_cache`` of the
    global batch at the prompt's length, on the meta device."""
    n = r.n if held is r.batch_pl else 1
    tokens = mb["tokens"]
    length = tokens.shape[1] + (mb["patch_embeds"].shape[1]
                                if "patch_embeds" in mb else 0)
    return M.init_cache(cfg, tokens.shape[0] * n, length, device="meta")


def make_mesh_decode_step(cfg: ModelConfig, run: RunConfig, mesh):
    """``step(params, caches, token, pos) -> (logits, caches)``: the
    counterpart of the JAX package's decode ``jax.jit`` with
    ``in_shardings=(psh, cache_shardings, batch_shardings, replicated)``
    and the caches donated.  ``params`` and ``caches`` are trees of
    DTensors placed by ``param_shardings`` / ``cache_shardings``;
    ``token`` is the global (B, 1) batch (a plain tensor or a DTensor),
    ``pos`` an int.  The rank computes the rows its caches hold (the
    batch over "data" where the rule splits it; a "pod" axis repeats
    them) on its parameter shards, tensor-parallel over "model", and
    uses each cache shard in place: attention (and MLA) run
    sequence-parallel over the ranks that split the cache's sequence
    (q gathered over "model", a softmax combined over them, the new k /
    v written by the rank whose slice holds ``pos``); a recurrent state
    is replaced in its storage.  Returns (logits as a DTensor split as
    those rows, and over "model" on the vocabulary; caches).  On one
    rank: the plain step on the caches' own storage, uncopied."""
    from repro_torch.sharding_ctx import use_mesh

    decode = make_decode_step(cfg, run)
    dt = _dtype(run)
    r = _Rank(mesh)

    def decode_step(params, caches, token, pos):
        _, rows = _cache_placements(r, caches)
        tok = r.shard(r.full(token), rows)
        if r.single:
            logits, new = decode(map_tree(tp.own, params),
                                 map_tree(tp.own, caches), tok, pos)
        else:
            with use_mesh(mesh), tp.recording() as whole, \
                    tp.row_parallel_glu(), torch.no_grad():
                logits, new = M.decode_step(
                    map_tree(tp.stored, params), cfg,
                    map_tree(tp.stored, caches),
                    tok, pos, compute_dtype=dt)
            decode_step.whole = whole
        with torch.no_grad():
            for d, x in zip(leaves(caches), leaves(new)):
                own = tp.own(d)
                if not own.is_set_to(x):
                    own.copy_(x)
        lpl = _logit_placements(r, rows, params) if not r.single else rows
        return r.place(logits, lpl, lpl), caches

    decode_step.whole = set()
    return decode_step


def make_prefill_step(cfg: ModelConfig, run: RunConfig):
    """``step(params, batch) -> (logits, caches)``; with
    ``attention_impl="pallas"`` through the flash and ``moe_gmm``
    kernels."""
    dt = _dtype(run)
    hooks = _prefill_kernels(run)

    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, compute_dtype=dt,
                         q_chunk=run.attention_q_chunk, **hooks)

    return prefill_step


def make_decode_step(cfg: ModelConfig, run: RunConfig):
    dt = _dtype(run)

    def serve_step(params, caches, token, pos):
        return M.decode_step(params, cfg, caches, token, pos,
                             compute_dtype=dt)

    return serve_step
