"""Mesh context and logical-axis sharding constraints.

The port of the JAX package's ``sharding_ctx.py`` on
``torch.distributed``: a mesh is a ``DeviceMesh`` (one process per
device, ranks laid out over named axes), or, where rules are evaluated
without any rank, the small frozen :class:`AbstractMesh`.  A spec is
what ``PartitionSpec`` is there: a tuple with one entry per tensor dim,
an axis name, a tuple of names or ``None``, trailing ``None``s popped.

Model code calls ``constrain(x, *logical_axes)`` with logical names;
outside a mesh, or on a plain tensor, it returns ``x``; on a DTensor it
redistributes to the spec the logical axes give, skipping any dim the
mesh cannot divide evenly (the divisibility fallback).

Logical axes:
  "batch"   -> ("pod", "data") when the mesh has a pod axis, else ("data",)
  "tokens"  -> same as batch (flattened token dim)
  "data"    -> ("data",)
  "model"/"expert"/"heads"/"ff"/"vocab" -> ("model",)
  "seq"     -> ("model",)   (context/sequence sharding for long KV)
  None      -> unsharded dim

The JAX module's ``shard_map``, ``on_tpu`` and ``default_interpret``
have no counterpart: the port's code already runs once per rank (what a
``shard_map`` body is) and takes its process groups from
``mesh.get_group(axis)``; its kernels need no interpret mode.
"""
from __future__ import annotations

import contextlib
import math
import threading
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

_state = threading.local()


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no ranks behind them (the JAX package's
    ``AbstractMesh``): enough to evaluate the sharding rules for a
    256- or 512-chip layout in one process."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def abstract_mesh(axis_sizes, axis_names) -> AbstractMesh:
    """``abstract_mesh((16, 16), ("data", "model"))``."""
    return AbstractMesh(tuple(int(n) for n in axis_sizes), tuple(axis_names))


def axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.axis_names
    return tuple(mesh.mesh_dim_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def check_device_type(device_type: str) -> str:
    """``device_type`` when it can be used: "cuda" needs a card (nothing
    falls back to the CPU, or to gloo, on its own)."""
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the mesh's ranks run on the card; pass "
            "device_type='cpu' for ranks on the CPU (gloo)")
    return device_type


def make_mesh(axis_shapes, axis_names, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``axis_shapes`` over the first
    ``prod(axis_shapes)`` ranks of the world, in rank order (the JAX
    package's ``jax.make_mesh`` over the first devices).  Every rank of
    the world must call it (it creates the axes' process groups); a rank
    outside the mesh gets ``None``.  Raises, naming both sizes, when the
    world is smaller than the mesh.  The default process group is the
    caller's to create (``init_process_group`` with its own init method,
    backend, world size and rank): nccl for ``device_type="cuda"``, gloo
    for ``"cpu"``."""
    check_device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: call torch.distributed.init_process_group "
            "before making a mesh")
    n = math.prod(axis_shapes)
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(f"a mesh of shape {tuple(axis_shapes)} needs {n} "
                           f"ranks; the world has {world}")
    layout = torch.arange(n).reshape(tuple(axis_shapes))
    mesh = DeviceMesh(device_type, layout, mesh_dim_names=tuple(axis_names))
    return mesh if mesh.get_coordinate() is not None else None


_LOGICAL = {
    "data": ("data",),
    "model": ("model",),
    "expert": ("model",),
    "heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "seq": ("model",),
}


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def _physical(mesh, logical):
    if logical is None:
        return None
    names = axis_names(mesh)
    if logical in ("batch", "tokens"):
        return ("pod", "data") if "pod" in names else ("data",)
    axes = _LOGICAL[logical]
    return tuple(a for a in axes if a in names) or None


def axis_size(mesh, physical):
    if physical is None:
        return 1
    shape = mesh_shape(mesh)
    n = 1
    for a in (physical if isinstance(physical, tuple) else (physical,)):
        n *= shape[a]
    return n


def spec_for(mesh, shape, logical_axes) -> tuple:
    """The spec of a tensor of ``shape`` with the divisibility fallback
    per dim."""
    parts = []
    for dim, logical in zip(shape, logical_axes):
        phys = _physical(mesh, logical)
        if phys is not None and dim % axis_size(mesh, phys) == 0:
            parts.append(phys if len(phys) > 1 else phys[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(mesh, spec) -> list:
    """DTensor placements for ``spec`` on a ``DeviceMesh``: ``Shard(d)``
    on every mesh dim that spec entry d names, ``Replicate()`` on the
    others.  A tensor dim split over several mesh dims is split in mesh
    order (``("model", "data")`` on a ("data", "model") mesh puts "data"
    outermost), so each rank holds a piece of the same size as under the
    JAX spec, not always the same piece."""
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for dim, part in enumerate(spec):
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            out[names.index(a)] = Shard(dim)
    return out


def constrain(x, *logical_axes):
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = spec_for(mesh, x.shape, logical_axes)
    return x.redistribute(mesh, placements(mesh, spec))
