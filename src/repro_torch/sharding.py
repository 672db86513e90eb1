"""Data-driven sharding rules: param / optimizer / cache / batch specs.

The port of the JAX package's ``sharding.py``, rule for rule.  Mesh axes
("pod", "data", "model") or ("data", "model").
  * params: 2D sharded — megatron-style TP over "model" (column-parallel
    input projections, row-parallel output projections, EP for experts,
    vocab-parallel embeddings) + FSDP-style storage sharding over "data".
    Any dim the mesh cannot divide falls back to unsharded (whisper's 20
    heads, xLSTM's 4 heads, ...).
  * optimizer state: mirrors param specs leaf-for-leaf.
  * batch: batch dim over ("pod","data").
  * decode caches: batch over "data" when divisible, KV-seq over "model"
    (+"data" for batch-1 long-context).
All leaves are matched by (path name, shape), never by model type.

The port's trees hold each stack as a list of per-super-block dicts
(``models/convert.py``), and its caches are a list of ``{"b<i>": ...}``
per super-block: no leaf carries the JAX tree's leading ``n_super``
axis.  So a rule sees a stack leaf's whole shape, and its spec has no
leading ``None``; the list indices in a path are skipped as the JAX
rules skip what is not a dict key.  A result is a :class:`NamedSharding`
(mesh and spec); on a ``DeviceMesh`` its ``placements`` place a DTensor.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.sharding_ctx import axis_names, mesh_shape, placements
from repro_torch.tree import map_tree


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the JAX package's ``NamedSharding``)."""
    mesh: object
    spec: tuple

    @property
    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def _axes(mesh):
    return set(axis_names(mesh))


def _div(dim, mesh, *axes):
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return dim % n == 0


def _maybe(dim, mesh, axis):
    return axis if (axis in _axes(mesh) and _div(dim, mesh, axis)) else None


def _spec(*parts) -> tuple:
    """``PartitionSpec(*parts)`` with trailing ``None``s popped."""
    parts = list(parts)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


ROW_PARALLEL = ("wo", "w_out", "w_down", "shared_wo")   # contraction first


def _names(path):
    return [p for p in path if isinstance(p, str)]


def _param_spec(path, leaf, mesh):
    names = _names(path)
    name = names[-1] if names else ""
    core = tuple(leaf.shape)
    if len(core) == 0 or min(core, default=0) == 0:
        return ()

    if name == "table":                       # embed/pos tables
        if "pos" in names:
            return ()
        # vocab dim unsharded (token gather stays local); shard d_model over
        # model(+data)
        if _div(core[1], mesh, *(a for a in ("model", "data")
                                 if a in _axes(mesh))):
            ax = tuple(a for a in ("model", "data") if a in _axes(mesh))
            return _spec(None, ax if len(ax) > 1 else ax[0])
        return _spec(None, _maybe(core[1], mesh, "model"))
    if name == "w" and "lm_head" in names:
        return _spec(_maybe(core[0], mesh, "data"),
                     _maybe(core[1], mesh, "model"))
    if len(core) == 1:
        return ()                             # norms, biases, A_log rows etc.

    # MoE experts: (E, D, F) / (E, F, D) — EP over *data* (tokens all-to-all
    # stays on the axis that shards them; see moe_sharded.py), TP-in-expert
    # (F) over model, replicated over pod (pod-local expert replicas).
    if name in ("wi", "wg") and len(core) == 3:
        return _spec(_maybe(core[0], mesh, "data"), None,
                     _maybe(core[2], mesh, "model"))
    if name == "wo" and len(core) == 3 and "ffn" in names:
        return _spec(_maybe(core[0], mesh, "data"),
                     _maybe(core[1], mesh, "model"), None)

    # attention projections: (D, H, Dh) in / (H, Dh, D) out
    if name in ("wq", "wk", "wv") and len(core) == 3:
        return _spec(_maybe(core[0], mesh, "data"),
                     _maybe(core[1], mesh, "model"), None)
    if name == "wo" and len(core) == 3:
        return _spec(_maybe(core[0], mesh, "model"), None,
                     _maybe(core[2], mesh, "data"))
    if name in ("w_uq", "w_uk", "w_uv") and len(core) == 3:   # MLA up-proj
        # never shard the lora-rank contraction dim (a partial sum would
        # reach the attention scores): heads when divisible, else replicate
        return _spec(None, _maybe(core[1], mesh, "model"), None)
    if name in ("w_dq", "w_dkv", "w_kr") and len(core) == 2:  # MLA down-proj
        # the same partial-sum hazard on d_model: shard only the rank dim
        return _spec(None, _maybe(core[1], mesh, "model"))

    if name in ROW_PARALLEL:                  # (F, D): row-parallel
        return _spec(_maybe(core[0], mesh, "model"),
                     _maybe(core[1], mesh, "data"))
    # default 2D: column-parallel (D_in, F): FSDP over data, TP over model
    parts = [_maybe(core[0], mesh, "data")]
    parts += [None] * (len(core) - 2)
    parts += [_maybe(core[-1], mesh, "model")]
    return _spec(*parts)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def param_shardings(param_tree, mesh):
    """param_tree: a port tree of tensors (any device, meta included)."""
    return _map_with_path(
        lambda path, leaf: NamedSharding(mesh, _param_spec(path, leaf, mesh)),
        param_tree)


def opt_shardings(opt_tree, mesh):
    """Moments/master mirror the param rules (drop the {mu,nu,master} key);
    the step counter is replicated."""
    def spec(path, leaf):
        names = _names(path)
        if not names or names[0] == "step":
            return NamedSharding(mesh, ())
        return NamedSharding(mesh, _param_spec(path[1:], leaf, mesh))
    return _map_with_path(spec, opt_tree)


# --------------------------------------------------------------------------
# batch / cache
# --------------------------------------------------------------------------

def batch_axes(mesh):
    return tuple(a for a in ("pod", "data") if a in _axes(mesh))


def batch_shardings(batch_tree, mesh):
    axes = batch_axes(mesh)
    shape = mesh_shape(mesh)

    def spec(leaf):
        if leaf.dim() == 0:
            return NamedSharding(mesh, ())
        n = 1
        for a in axes:
            n *= shape[a]
        if leaf.shape[0] % n == 0:
            return NamedSharding(mesh, (axes if len(axes) > 1 else axes[0],))
        return NamedSharding(mesh, (None,))
    return map_tree(spec, batch_tree)


_SEQ_CACHE_LEAVES = {"k", "v", "c_kv", "k_rope"}


def cache_shardings(cache_tree, mesh):
    """Cache leaves: (B, S, ...) for attention, (B, ...) for recurrent
    state, one dict per super-block (no leading n_super axis). Batch ->
    data when divisible; attention KV seq -> model (+data when batch is
    not shardable)."""
    shape_of = mesh_shape(mesh)

    def spec(path, leaf):
        names = _names(path)
        name = names[-1] if names else ""
        shape = tuple(leaf.shape)
        if len(shape) < 1:
            return NamedSharding(mesh, ())
        b_ok = _div(shape[0], mesh, "data")
        parts = ["data" if b_ok else None]
        if name in _SEQ_CACHE_LEAVES and len(shape) >= 2:
            seq_axes = ["model"] + ([] if b_ok else ["data"])
            seq_axes = [a for a in seq_axes if a in _axes(mesh)]
            n = 1
            for a in seq_axes:
                n *= shape_of[a]
            if shape[1] % n == 0 and shape[1] > 1:
                parts.append(tuple(seq_axes) if len(seq_axes) > 1
                             else seq_axes[0])
        return NamedSharding(mesh, _spec(*parts))
    return _map_with_path(spec, cache_tree)


def replicated(mesh):
    return NamedSharding(mesh, ())
