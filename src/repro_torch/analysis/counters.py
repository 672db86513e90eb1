"""What one device computes, sends and holds over a step, from the
dispatcher.

The port's counterpart of the JAX package's ``analysis/hlo.py``.  The
JAX package reads these numbers from the compiled HLO text of an SPMD
module; PyTorch runs eagerly, so the port counts the operators a rank
dispatches while the step runs (on fake tensors in the dry run, on real
ones on the card): ``counting()`` is one context manager around a step
that yields a :class:`Counts` filled on exit with

  * ``dot_flops``: ``FlopCounterMode``'s total, 2 x out x K per matrix
    product (``hlo._dot_flops``' rule; a product recomputed by remat
    counts again, as a ``while`` body's trips do there);
  * ``collective_bytes`` / ``collective_bytes_by_kind``: the bytes of
    each collective's output, by kind ("all-gather", "reduce-scatter",
    "all-reduce", "all-to-all"; ``hlo._collective_bytes``' rule), over
    the functional collectives that DTensor issues and the in-place
    ``c10d`` ones (``dist.all_reduce`` ...);
  * ``peak_bytes``: the peak of live device bytes (``MemTracker``), the
    tensors given as ``external`` (the step's arguments) counted from
    the start.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# operator name (namespace.name, overload dropped) -> kind; the functional
# collectives return their output, the c10d ones write into tensors given
# in their first argument (a list, or a list of lists for all-gather) and
# the ``_base_`` ones into their first, a tensor
_FUNCTIONAL = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.all_to_all_single": "all-to-all",
}
_IN_PLACE = {
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allgather_into_tensor_coalesced_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d.allreduce_": "all-reduce",
    "c10d.allreduce_coalesced_": "all-reduce",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


def _op_name(func) -> str:
    return f"{func.namespace}.{func._opname}"


class _CollectiveCounter(TorchDispatchMode):
    """Adds each collective's output bytes to ``by_kind``."""

    def __init__(self, by_kind: dict):
        super().__init__()
        self.by_kind = by_kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = _op_name(func)
        if name in _FUNCTIONAL:
            self._add(_FUNCTIONAL[name], _nbytes(out))
        elif name in _IN_PLACE:
            self._add(_IN_PLACE[name], _nbytes(args[0]))
        return out

    def _add(self, kind: str, n: int) -> None:
        self.by_kind[kind] = self.by_kind.get(kind, 0) + n


@dataclass
class Counts:
    """Per device, over one step (filled when ``counting`` exits)."""
    dot_flops: int = 0
    collective_bytes_by_kind: dict = field(default_factory=dict)
    peak_bytes: int = 0
    external_bytes: int = 0

    @property
    def collective_bytes(self) -> int:
        return sum(self.collective_bytes_by_kind.values())


def tensor_bytes(tensors) -> int:
    """Bytes of ``tensors`` (a DTensor counts its local piece)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for t in tensors:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


@contextlib.contextmanager
def counting(external=(), device_type: str = "cuda"):
    """``with counting(external=leaves) as c: step(...)``: ``c`` holds the
    step's dot FLOPs, collective bytes by kind and peak live bytes on the
    devices of ``device_type`` once the block ends.  ``external``: the
    tensors alive before the step (its arguments; a DTensor's local
    piece is tracked), counted in the peak from the start."""
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.distributed.tensor import DTensor
    from torch.utils.flop_counter import FlopCounterMode

    local = [t.to_local() if isinstance(t, DTensor) else t
             for t in external if isinstance(t, torch.Tensor)]
    counts = Counts(external_bytes=tensor_bytes(local))
    mem = MemTracker()
    if local:
        mem.track_external(*local)
    flops = FlopCounterMode(display=False)
    with mem, flops, _CollectiveCounter(counts.collective_bytes_by_kind):
        yield counts
    counts.dot_flops = int(flops.get_total_flops())
    peak = mem.get_tracker_snapshot("peak")
    counts.peak_bytes = int(sum(d["Total"] for dev, d in peak.items()
                                if torch.device(dev).type == device_type))
