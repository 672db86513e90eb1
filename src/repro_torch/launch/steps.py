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
``make_mesh_*_step`` builders run the steps on trees of DTensors.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.models import model as M
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


def make_value_and_grad(cfg: ModelConfig, run: RunConfig):
    """``fn(params, batch) -> (loss, grads)``: the training loss (CE + MoE
    aux) and its gradient, a tree of ``params``' structure.  With
    ``run.shape.grad_accum = a > 1`` microbatch i is rows [i B/a,
    (i+1) B/a) of the batch; the gradients are summed in f32 and, like
    the loss, divided by a.  The reference path only: no kernel of the
    port has a backward (ROADMAP C6), so ``attention_impl="pallas"``
    raises."""
    if run.attention_impl == "pallas":
        raise NotImplementedError(
            "make_train_step: attention_impl='pallas' has no backward: the "
            "port's kernels are forward-only, as the JAX package's Pallas "
            "flash kernel is (it fails under jax.grad, ROADMAP C6); train "
            "with attention_impl='reference'")
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


class _Rank:
    """This rank's place on a ``DeviceMesh``, read once when a step is
    built (nothing here runs a collective or touches a tensor, so the
    steps also trace on fake tensors): the sizes and coordinate per mesh
    dim, and the rows of a batch split over the ("pod", "data") axes as
    ``sharding.batch_shardings`` splits it (row-major over those axes)."""

    def __init__(self, mesh):
        from torch.distributed.tensor import Replicate, Shard

        from repro_torch import sharding as sh
        from repro_torch.sharding_ctx import abstract_mesh, axis_names

        self.mesh = mesh
        self.names = axis_names(mesh)
        self.sizes = tuple(int(n) for n in mesh.mesh.shape)
        self.coord = tuple(mesh.get_coordinate())
        self.single = mesh.size() == 1
        self.abstract = abstract_mesh(self.sizes, self.names)
        shape, coord = dict(zip(self.names, self.sizes)), \
            dict(zip(self.names, self.coord))
        axes = sh.batch_axes(mesh)
        self.groups = [mesh.get_group(a) for a in axes if shape[a] > 1]
        self.n, self.idx = 1, 0          # row-major over the batch axes
        for a in axes:
            self.n = self.n * shape[a]
            self.idx = self.idx * shape[a] + coord[a]
        self.batch_pl = [Shard(0) if a in axes else Replicate()
                         for a in self.names]
        self.whole = [Replicate()] * len(self.sizes)

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

    def write_back(self, tree, new, held=None):
        """Each DTensor leaf of ``tree`` takes this rank's piece of its
        leaf in ``new`` (split as ``held``), in place; a leaf that is
        already that piece's storage (one rank) is left alone."""
        from torch.distributed.tensor import DTensor

        from repro_torch.tree import flatten

        with torch.no_grad():
            for (_, d), (_, f) in zip(flatten(tree), flatten(new)):
                if not isinstance(d, DTensor):
                    continue
                local = d.to_local()
                if not local.is_set_to(f):
                    local.copy_(self.shard(f, d.placements, held))


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def make_mesh_train_step(cfg: ModelConfig, run: RunConfig, mesh):
    """``step(params, opt_state, batch)`` on trees of DTensors placed by
    ``sharding.param_shardings`` / ``opt_shardings`` on ``mesh``: the
    counterpart of the JAX package's ``jax.jit(make_train_step,
    in_shardings=..., out_shardings=...)``, whose compute GSPMD
    partitions.  The port's model does not run on DTensors, so this
    step stores the state sharded and computes data-parallel:

      1. gathers the full parameters and optimizer state;
      2. runs ``make_value_and_grad`` on the rank's rows of the global
         batch, split over the ("pod", "data") axes as
         ``sharding.batch_shardings`` splits it (a batch those axes
         cannot divide is computed whole on every rank, as the JAX rule
         replicates it); the batch's leaves are plain tensors of the
         global batch or DTensors placed by ``batch_shardings``;
      3. averages the gradients and the loss over those axes;
      4. applies ``adamw_update`` to the full state;
      5. writes each rank's shard back into the DTensors' local tensors,
         in place.

    On a mesh of one rank the full state is the DTensors' own storage:
    the plain step with no copy.  The result equals ``make_train_step``
    on the global batch within f32 rounding for a loss that is a mean
    over equal-sized shards (a dense model's).  An MoE layer computes
    its capacity and aux loss on the rank's shard (the naive dispatch:
    the step does not enter ``use_mesh``), so an MoE model's loss is not
    exactly the global one across ranks."""
    import torch.distributed as dist

    value_and_grad = make_value_and_grad(cfg, run)
    r = _Rank(mesh)

    def mean(t):
        for g in r.groups:
            dist.all_reduce(t, group=g)
        return t.div_(r.n)

    def train_step(params, opt_state, batch):
        full_p = map_tree(r.full, params)
        full_o = map_tree(r.full, opt_state)
        lr = cosine_schedule(full_o["step"], base_lr=run.learning_rate)
        mb, held = r.rows(batch)
        loss, grads = value_and_grad(full_p, mb)
        if held is r.batch_pl and r.groups:
            loss = mean(loss.clone())
            for g in leaves(grads):
                mean(g)
        _, new_o, om = adamw_update(
            grads, full_o, full_p, lr=lr, beta1=run.beta1, beta2=run.beta2,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip)
        r.write_back(params, full_p)
        r.write_back(opt_state, new_o)
        return params, opt_state, {"loss": loss, **om}

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


def make_mesh_prefill_step(cfg: ModelConfig, run: RunConfig, mesh):
    """``step(params, batch) -> (logits, caches)`` on a tree of DTensors
    placed by ``sharding.param_shardings``: the counterpart of the JAX
    package's ``jax.jit(make_prefill_step, in_shardings=(psh, bsh))``,
    computed as ``make_mesh_train_step`` computes: the full parameters
    gathered, the rank's rows of the batch (split as ``batch_shardings``
    splits it; plain tensors of the global batch or DTensors) through
    ``make_prefill_step``.  Returns the last-token logits as a DTensor
    split over the batch axes and the caches as DTensors placed by
    ``sharding.cache_shardings`` (each rank keeps its slice of the
    sequence; where the cache rule splits the batch otherwise than the
    batch rule, as on a mesh with a "pod" axis, DTensor redistributes
    the rows).  On one rank: the plain step's tensors, uncopied."""
    prefill = make_prefill_step(cfg, run)
    r = _Rank(mesh)

    def prefill_step(params, batch):
        mb, held = r.rows(batch)
        logits, caches = prefill(map_tree(r.full, params), mb)
        specs, _ = _cache_placements(r, _global_shapes(caches, held, r))
        return (r.place(logits, held, held),
                map_tree(lambda x, pl: r.place(x, held, pl), caches, specs))

    return prefill_step


def _global_shapes(tree, held, r: _Rank):
    """Meta tensors of the global shapes of a tree of row pieces."""
    n = r.n if held is r.batch_pl else 1
    return map_tree(lambda x: torch.empty((x.shape[0] * n,) + x.shape[1:],
                                          device="meta"), tree)


def make_mesh_decode_step(cfg: ModelConfig, run: RunConfig, mesh):
    """``step(params, caches, token, pos) -> (logits, caches)``: the
    counterpart of the JAX package's decode ``jax.jit`` with
    ``in_shardings=(psh, cache_shardings, batch_shardings, replicated)``
    and the caches donated.  ``params`` and ``caches`` are trees of
    DTensors placed by ``param_shardings`` / ``cache_shardings``;
    ``token`` is the global (B, 1) batch (a plain tensor or a DTensor),
    ``pos`` an int.  The full parameters are gathered; each cache leaf's
    shard is gathered over the dims the rule splits besides the batch
    ("model" on the KV sequence, "data" too when the batch is not
    split), the rank computes the rows its caches hold (the batch over
    "data" where the rule splits it; a "pod" axis repeats them), and
    writes each leaf's new shard back into its DTensor, in place.
    Returns (logits as a DTensor split as those rows, caches).  On one
    rank: the plain step on the caches' own storage, uncopied."""
    decode = make_decode_step(cfg, run)
    r = _Rank(mesh)

    def decode_step(params, caches, token, pos):
        specs, rows = _cache_placements(r, caches)

        def gather(d):
            if r.single or list(d.placements) == rows:
                return d.to_local()
            return d.redistribute(r.mesh, rows).to_local()

        local = map_tree(gather, caches)
        tok = r.shard(r.full(token), rows)
        logits, new = decode(map_tree(r.full, params), local, tok, pos)
        r.write_back(caches, new, rows)
        return r.place(logits, rows, rows), caches

    return decode_step


def make_prefill_step(cfg: ModelConfig, run: RunConfig):
    dt = _dtype(run)

    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch, compute_dtype=dt,
                         q_chunk=run.attention_q_chunk)

    return prefill_step


def make_decode_step(cfg: ModelConfig, run: RunConfig):
    dt = _dtype(run)

    def serve_step(params, caches, token, pos):
        return M.decode_step(params, cfg, caches, token, pos,
                             compute_dtype=dt)

    return serve_step
