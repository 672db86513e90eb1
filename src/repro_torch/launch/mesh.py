"""Production mesh builders.

The port of the JAX package's ``launch/mesh.py`` on
``torch.distributed``: each builder returns a ``DeviceMesh`` over ranks
of the default process group, which the caller has created (one process
per card, nccl on the card, gloo for ranks on the CPU).  Every rank of
the world calls the builder, since it creates the axes' process groups;
a rank the mesh leaves out gets ``None``.  They run on the card unless
``device_type="cpu"`` is passed.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.sharding_ctx import check_device_type, make_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """Single pod: (16,16)=(data,model), 256 ranks.
    Multi-pod: (2,16,16)=(pod,data,model), 512 ranks; "pod" is the elastic
    pure-DP axis the cloud provisioner grows/shrinks.  Raises, with the
    sizes, when the world has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_elastic_mesh(n_pods: int, *, pod_shape=(16, 16),
                      device_type: str = "cuda"):
    """Mesh for an elastic pool of ``n_pods`` pods (n_pods >= 1) over the
    first ``n_pods * prod(pod_shape)`` ranks of the world. The pod axis
    is what core/elastic.py re-sizes when spot capacity changes."""
    if n_pods == 1:
        return make_mesh(pod_shape, ("data", "model"), device_type)
    return make_mesh((n_pods,) + tuple(pod_shape), ("pod", "data", "model"),
                     device_type)


def make_host_mesh(shape=None, axes=("data", "model"),
                   device_type: str = "cuda"):
    """Mesh over the whole world (tests / examples)."""
    check_device_type(device_type)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None:
        shape = (n, 1) if len(axes) == 2 else (n,)
    if math.prod(shape) != n:
        raise RuntimeError(f"a host mesh of shape {tuple(shape)} must cover "
                           f"the world's {n} ranks")
    return make_mesh(shape, axes, device_type)
