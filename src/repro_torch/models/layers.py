"""Core functional layers: inits, norms, FFN variants, position encodings.

The port of the JAX package's ``models/layers.py``.  Modules are (init,
apply) pairs over plain dicts of tensors, with the same keys and layouts
as the JAX trees, so ``models/convert.py`` carries JAX weights across
leaf for leaf.  Inits draw from an explicit ``torch.Generator`` (its
numbers differ from JAX's threefry; the parity tests load the JAX
weights instead).  Arithmetic follows the JAX order: norms and the loss
in f32, matmuls in the compute dtype with the weights cast per use.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed
import torch.nn.functional as F

from repro_torch.models import tp

# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------


def dense_init(gen, shape, device, in_axis_size=None, dtype=torch.float32):
    """Truncated-normal fan-in init (maxtext-style): std * N(0,1) cut at
    +-2."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    std = 1.0 / np.sqrt(max(fan_in, 1))
    t = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t.mul_(std)


def embed_init(gen, shape, device, dtype=torch.float32):
    t = torch.empty(shape, dtype=dtype, device=device)
    return t.normal_(generator=gen).mul_(0.02)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(d, device, norm_type="rmsnorm"):
    if norm_type == "rmsnorm":
        return {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    return {"scale": torch.ones(d, dtype=torch.float32, device=device),
            "bias": torch.zeros(d, dtype=torch.float32, device=device)}


def apply_norm(p, x, norm_type="rmsnorm", eps=1e-6):
    """RMSNorm / LayerNorm with f32 statistics, cast back to x's dtype."""
    xf = x.to(torch.float32)
    if norm_type == "rmsnorm":
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def rms_head_norm(x, scale, eps=1e-6):
    """Per-head RMS norm over the trailing dim (Qwen3's qk-norm), in f32
    and cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# --------------------------------------------------------------------------
# FFN variants
# --------------------------------------------------------------------------

def init_ffn(gen, d_model, d_ff, device, ffn_type="swiglu"):
    if ffn_type == "swiglu":
        return {"wi": dense_init(gen, (d_model, d_ff), device),
                "wg": dense_init(gen, (d_model, d_ff), device),
                "wo": dense_init(gen, (d_ff, d_model), device,
                                 in_axis_size=d_ff)}
    return {"wi": dense_init(gen, (d_model, d_ff), device),
            "wo": dense_init(gen, (d_ff, d_model), device, in_axis_size=d_ff)}


def apply_ffn(p, x, ffn_type="swiglu"):
    dt = x.dtype
    if ffn_type == "swiglu":
        h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wi"].to(dt))
    elif ffn_type == "squared_relu":
        h = torch.square(F.relu(x @ p["wi"].to(dt)))
    elif ffn_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    else:
        raise ValueError(ffn_type)
    return h @ p["wo"].to(dt)


# --------------------------------------------------------------------------
# position encodings
# --------------------------------------------------------------------------

def rope_freqs(head_dim, theta):
    """numpy float32, the JAX package's expression exactly."""
    exponent = np.arange(0, head_dim, 2, dtype=np.float32) / head_dim
    return 1.0 / (theta ** exponent)          # (head_dim/2,)


@functools.lru_cache(maxsize=None)
def _rope_freqs_on(head_dim, theta, device):
    # one host-to-device copy per (dim, theta, device): a copy per call
    # would stall the host on the card's queue at every layer
    return torch.from_numpy(rope_freqs(head_dim, theta)).to(device)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D) rotated by split halves (not interleaved);
    positions: (..., S) integer tensor."""
    d = x.shape[-1]
    freqs = _rope_freqs_on(d, theta, x.device)                    # (d/2,)
    angles = positions[..., :, None].to(torch.float32) * freqs    # (...,S,d/2)
    cos = torch.cos(angles)[..., :, None, :]                      # (...,S,1,d/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_table(n_pos, d_model, device):
    """(n_pos, d_model) f32: sin at the even columns, cos at the odd
    ones, built in numpy f32 as the JAX package builds it."""
    pos = np.arange(n_pos, dtype=np.float32)[:, None]
    dim = np.arange(0, d_model, 2, dtype=np.float32)[None, :]
    ang = pos / (10000.0 ** (dim / d_model))
    out = np.zeros((n_pos, d_model), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return torch.from_numpy(out).to(device)


# --------------------------------------------------------------------------
# embedding / lm head
# --------------------------------------------------------------------------

def init_embed(gen, vocab_padded, d_model, device):
    return {"table": embed_init(gen, (vocab_padded, d_model), device)}


def apply_embed(p, tokens, dtype):
    # gather, then cast: the same values as casting the whole table first
    # (the JAX order) without a vocab x d_model copy per call.  A mesh
    # step's table is gathered whole for the lookup (its gradient
    # reduce-scattered back)
    return F.embedding(tokens, tp.whole(p["table"])).to(dtype)


def init_lm_head(gen, d_model, vocab_padded, device):
    return {"w": dense_init(gen, (d_model, vocab_padded), device)}


def apply_lm_head(p, x, vocab_size):
    """Logits of x; on a mesh step's leaf split over "model" on the
    vocabulary, the rank's columns only (``vocab_parallel`` says which),
    the padded vocabulary masked inside them."""
    if tp.is_stored(p["w"]):
        if not vocab_parallel(p):
            tp.note_whole("head")
            return apply_lm_head({"w": tp.whole(p["w"])}, x, vocab_size)
        w = tp.local(p["w"])
        logits = tp.into_model(x) @ w.to(x.dtype)
        first = max(vocab_size - tp.model_rank() * w.shape[1], 0)
        if first < w.shape[1]:
            logits[..., first:] = torch.finfo(logits.dtype).min
        return logits
    logits = x @ p["w"].to(x.dtype)
    if p["w"].shape[1] != vocab_size:  # mask padded vocab entries
        logits[..., vocab_size:] = torch.finfo(logits.dtype).min
    return logits


def vocab_parallel(p) -> bool:
    """Whether a head's weight is a mesh step's leaf whose vocabulary
    "model" splits: its logits are then the rank's columns."""
    return tp.is_stored(p["w"]) and tp.split_on(p["w"], 1)


def cross_entropy_loss(logits, targets, vocab_size):
    """Mean token NLL with an f32 logsumexp; targets == -1 are masked
    (e.g. image-patch positions)."""
    del vocab_size                     # padded logits are already masked
    valid = targets >= 0
    tgt = torch.where(valid, targets, torch.zeros_like(targets))
    lf = logits.to(torch.float32)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, tgt[..., None].to(torch.int64))[..., 0]
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)


def vocab_parallel_loss(logits, targets):
    """``cross_entropy_loss`` of logits whose vocabulary is split over the
    current mesh's "model" ranks (this rank's columns, rank-major, the
    padded vocabulary already masked): the f32 logsumexp's max and sum
    are reduced over "model", the gold logit comes from the rank that
    owns it, and the mean runs over the valid targets (-1 masked).  On a
    "model" axis of one rank, ``cross_entropy_loss`` itself."""
    group = tp.model_group()
    if group is None:
        return cross_entropy_loss(logits, targets, None)
    valid = targets >= 0
    tgt = torch.where(valid, targets, torch.zeros_like(targets))
    lf = logits.to(torch.float32)
    n = lf.shape[-1]
    first = tp.model_rank() * n
    mx = lf.detach().amax(dim=-1, keepdim=True)
    tp.all_reduce(mx, group, torch.distributed.ReduceOp.MAX)
    total = tp.out_of_model(torch.exp(lf - mx).sum(dim=-1))
    logz = mx[..., 0] + torch.log(total)
    mine = (tgt >= first) & (tgt < first + n)
    at = torch.clamp(tgt - first, 0, n - 1).to(torch.int64)
    gold = tp.out_of_model(torch.gather(lf, -1, at[..., None])[..., 0]
                           * mine)
    nll = (logz - gold) * valid
    return nll.sum() / torch.clamp(valid.sum(), min=1)
