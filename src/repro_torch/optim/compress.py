"""Cross-pod gradient compression (int8 + error feedback).

The port of the JAX package's ``optim/compress.py``.  The elastic axis
crosses pods, over the data-centre network, an order of magnitude
slower than the links inside a pod, so the pure-DP gradient exchange on
the "pod" axis is compressed:

  * int8 per-tensor quantization with fp32 scales (4x fewer wire bytes than
    fp32, 2x fewer than bf16),
  * exchange via all_gather(int8) + local dequant-mean (for small pod
    counts the gathered payload n_pod x 1B still beats a ring all-reduce of
    2 x 2B at n_pod <= 4; beyond that switch to quantized reduce-scatter),
  * optional error-feedback residual so the quantization error is carried
    into the next step instead of lost (Seide et al.; keeps convergence).

Usage on every rank of the group (``mesh.get_group("pod")``, the
counterpart of the JAX axis name):
    g_sync, resid = compressed_psum_mean(g_local, group, resid)
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import leaves, unflatten


def quantize_int8(x):
    """(q, scale): q int8, per-tensor f32 scale. Exact for zeros;
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    xf = x.to(torch.float32)
    scale = xf.abs().max() / 127.0 + 1e-20
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum_mean(x, group, residual=None):
    """Mean over the ranks of ``group`` with an int8 wire format + error
    feedback. Returns (mean, new_residual). Every rank of ``group`` calls
    it with a tensor of the same shape."""
    xf = x.to(torch.float32)
    if residual is not None:
        xf = xf + residual
    q, scale = quantize_int8(xf)
    new_residual = xf - dequantize_int8(q, scale)
    n = dist.get_world_size(group)
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty(1, dtype=scale.dtype, device=scale.device)
          for _ in range(n)]
    dist.all_gather(qs, q, group=group)              # n_pod x (...)
    dist.all_gather(ss, scale.reshape(1), group=group)
    deq = torch.stack(qs).to(torch.float32) \
        * torch.stack(ss).reshape((-1,) + (1,) * x.dim())
    return deq.mean(dim=0).to(x.dtype), new_residual


def compressed_tree_psum_mean(tree, group, residuals=None):
    """Tree version; residuals tree threads error feedback across steps."""
    xs = leaves(tree)
    rs = leaves(residuals) if residuals is not None else [None] * len(xs)
    outs, new_res = [], []
    for x, r in zip(xs, rs):
        m, nr = compressed_psum_mean(x, group, r)
        outs.append(m)
        new_res.append(nr)
    return unflatten(tree, outs), unflatten(tree, new_res)


def wire_bytes(tree, n_pod, compressed=True):
    """Bytes each rank sends per sync (an analysis helper)."""
    ls = leaves(tree)
    n = sum(x.numel() for x in ls)
    if compressed:
        return n * 1 + 4 * len(ls)
    return n * 4 * 2 * (n_pod - 1) / n_pod          # fp32 ring all-reduce
