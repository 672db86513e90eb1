"""Mamba (S6) selective-state-space mixer: chunked reference path.

The port of the JAX package's ``models/mamba.py``.  The (S, d_inner,
d_state) discretized tensors are never built for the whole sequence: a
loop over chunks of S carries the (B, d_inner, d_state) state, and the
recurrence inside a chunk is a log-depth (Hillis-Steele) scan with the
JAX package's combine ``(a1*a2, x1*a2 + x2)``, where the JAX package
calls ``lax.associative_scan``.  (A cumulative product of A_bar
underflows inside a chunk, so a cumprod-and-divide form would give
inf/NaN.)  Single-token decode is an elementwise state update.

``mamba_forward`` takes the selective scan through its ``scan_fn`` hook
(the CUDA ``mamba_scan`` kernel's wrapper on the model path): it then
discretizes the whole sequence and calls ``scan_fn(x_conv, dt, Bm, Cm,
A)`` in place of the chunk loop.  The kernel starts from a zero state
and returns no final state, so that path serves the training forward
only: it takes no ``h0`` and returns no ``h_last``.

On a mesh step (``split``) a rank computes its slice of ``d_inner``, as
the JAX package's compiled step splits the mixer: the in-projection
column-parallel (``tp.halves`` sends each rank its slice of both x and
z), the conv, the discretisation and the scan on the rank's channels,
``w_x``'s (B, S, R+2N) product summed over "model", the out-projection
row-parallel; ``rank_weights`` cuts the weights.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models import tp
from repro_torch.models.layers import dense_init


def mamba_dims(d_model, mcfg):
    d_inner = mcfg.expand * d_model
    dt_rank = mcfg.dt_rank or -(-d_model // 16)
    return d_inner, dt_rank


def split_over_model(p, d_model, mcfg) -> bool:
    """Whether a mesh step splits this mixer over "model" on ``d_inner``:
    its in-projection stored column-parallel and "model" dividing
    ``d_inner``, an even number of ranks or one (``tp.halves``; False
    for plain tensors)."""
    d_inner, _ = mamba_dims(d_model, mcfg)
    m = tp.model_size()
    return tp.split_on(p["w_in"], 1) and d_inner % m == 0 and \
        (m == 1 or m % 2 == 0)


def rank_weights(p, split: bool):
    """The weights a rank computes with: its ``d_inner`` slice of every
    leaf (``w_in``: its stored columns, exchanged after the product;
    ``w_x`` and ``A_log``, whose rule splits another dim, through
    ``tp.shared``), or all of them when not ``split``."""
    if not split:
        return tp.whole_tree(p)
    by_dim = {"conv_w": 1, "conv_b": 0, "w_x": 0, "w_dt": 1, "dt_bias": 0,
              "A_log": 0, "D": 0, "w_out": 0}
    out = {k: tp.slice_of(p[k], d) for k, d in by_dim.items()}
    out["w_in"] = tp.local(p["w_in"])
    return out


def init_mamba(gen, d_model, mcfg, device):
    """The JAX package's recipe: S4D-real A (``A_log = log(1..N)``),
    ``dt_bias = softplus^-1(dt)`` for dt log-uniform in [1e-3, 0.1], and
    D = 1."""
    d_inner, dt_rank = mamba_dims(d_model, mcfg)
    N = mcfg.d_state
    a = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device).repeat(d_inner, 1)           # (di,N)
    u = torch.rand(d_inner, generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    return {
        "w_in": dense_init(gen, (d_model, 2 * d_inner), device),
        "conv_w": dense_init(gen, (mcfg.d_conv, d_inner), device,
                             in_axis_size=mcfg.d_conv),
        "conv_b": torch.zeros(d_inner, dtype=torch.float32, device=device),
        "w_x": dense_init(gen, (d_inner, dt_rank + 2 * N), device),
        "w_dt": dense_init(gen, (dt_rank, d_inner), device),
        "dt_bias": torch.log(torch.expm1(dt)),      # softplus^-1(dt)
        "A_log": torch.log(a),
        "D": torch.ones(d_inner, dtype=torch.float32, device=device),
        "w_out": dense_init(gen, (d_inner, d_model), device,
                            in_axis_size=d_inner),
    }


def _causal_conv(x, w, b, carry=None):
    """x: (B,S,di); w: (k,di) depthwise causal conv as a sum of k shifted
    products (not ``F.conv1d``, which cuDNN may run in TF32).
    carry: (B,k-1,di) previous inputs (decode) or None (zero history)."""
    k = w.shape[0]
    if carry is None:
        carry = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([carry, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    new_carry = xp[:, -(k - 1):, :] if k > 1 else carry
    return y + b, new_carry


def _dt_b_c(p, x_conv, mcfg, dt_rank, split=False):
    """The input-dependent SSM streams of x_conv (B,c,di): dt (B,c,di)
    f32 after softplus, and Bm, Cm (B,c,N) in x_conv's dtype.  ``split``:
    x_conv holds the rank's channels, so ``w_x``'s product is summed over
    "model" (g), and every rank's channels read the sum (f)."""
    dt_f = x_conv.dtype
    xdb = x_conv @ p["w_x"].to(dt_f)                         # (B,c,R+2N)
    xdb = tp.into_model(tp.out_of_model(xdb, split), split)
    dt_raw, Bm, Cm = torch.split(
        xdb, [dt_rank, mcfg.d_state, mcfg.d_state], dim=-1)
    dt = F.softplus(
        (dt_raw @ p["w_dt"].to(dt_f)).to(torch.float32) + p["dt_bias"])
    return dt, Bm, Cm


def _ssm_params(p, x_conv, mcfg, dt_rank, split=False):
    """Discretize: returns (A_bar, Bx, C) for a chunk. x_conv: (B,c,di)."""
    dt, Bm, Cm = _dt_b_c(p, x_conv, mcfg, dt_rank, split)
    A = -torch.exp(p["A_log"])                               # (di,N)
    A_bar = torch.exp(dt[..., None] * A)                     # (B,c,di,N)
    Bx = (dt[..., None] * Bm[:, :, None, :].to(torch.float32)
          * x_conv[..., None].to(torch.float32))             # (B,c,di,N)
    return A_bar, Bx, Cm.to(torch.float32)


def _scan_chunk(h0, A_bar, Bx):
    """Inclusive scan over the chunk axis (dim 1) with the combine
    ``(a1*a2, x1*a2 + x2)``, log2(c) passes.  h0: (B,di,N).  Returns
    (h_all, h_last)."""
    A, X = A_bar, Bx
    d, c = 1, A.shape[1]
    while d < c:
        X = torch.cat([X[:, :d], X[:, :-d] * A[:, d:] + X[:, d:]], dim=1)
        A = torch.cat([A[:, :d], A[:, :-d] * A[:, d:]], dim=1)
        d *= 2
    h_all = X + A * h0[:, None]
    return h_all, h_all[:, -1]


def mamba_forward(p, x, mcfg, *, chunk=256, h0=None, conv0=None,
                  scan_fn=None, split=False):
    """x: (B,S,D) -> (y, (h_last, conv_last)).  Chunked over S, or one
    ``scan_fn`` call over the whole sequence (then h_last is None).
    ``split``: ``p`` is a rank's (``rank_weights``), and so are the
    channels of h_last and conv_last."""
    B, S, D = x.shape
    dt = x.dtype
    _, dt_rank = mamba_dims(D, mcfg)
    xz = tp.into_model(x, split) @ p["w_in"].to(dt)
    x_in, z = tp.halves(xz, split)
    x_conv, conv_last = _causal_conv(x_in, p["conv_w"].to(dt),
                                     p["conv_b"].to(dt), conv0)
    x_conv = F.silu(x_conv)

    if scan_fn is not None:
        if h0 is not None:
            raise ValueError("mamba_forward: scan_fn starts from a zero "
                             "state; an h0 needs the chunked path")
        dts, Bm, Cm = _dt_b_c(p, x_conv, mcfg, dt_rank, split)
        y = scan_fn(x_conv, dts, Bm.contiguous(),
                    Cm.to(torch.float32).contiguous(), -torch.exp(p["A_log"]))
        h_last = None
    else:
        if h0 is None:
            h0 = torch.zeros((B, x_conv.shape[-1], mcfg.d_state),
                             dtype=torch.float32, device=x.device)
        c = min(chunk, S)
        if S % c:
            c = S  # fallback: single chunk
        h_last, ys = h0, []
        for i in range(S // c):
            A_bar, Bx, Cm = _ssm_params(p, x_conv[:, i * c:(i + 1) * c],
                                        mcfg, dt_rank, split)
            h_all, h_last = _scan_chunk(h_last, A_bar, Bx)
            ys.append(torch.einsum("bcdn,bcn->bcd", h_all, Cm).to(dt))
        y = torch.cat(ys, dim=1)
    y = y + x_conv * p["D"].to(dt)
    y = y * F.silu(z)
    return tp.out_of_model(y @ p["w_out"].to(dt), split), (h_last, conv_last)


def init_mamba_state(batch, d_model, mcfg, dtype, device):
    d_inner, _ = mamba_dims(d_model, mcfg)
    return {"h": torch.zeros((batch, d_inner, mcfg.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, mcfg.d_conv - 1, d_inner),
                                dtype=dtype, device=device)}


def mamba_decode(p, x, state, mcfg, split=False):
    """One-token step. x: (B,1,D).  Returns (y, new state).  ``split``:
    ``p`` is a rank's (``rank_weights``); the state holds every channel
    (the rules store it whole over "model"): the rank steps its slice,
    and the new slices are gathered over "model"."""
    B, _, D = x.shape
    dt = x.dtype
    _, dt_rank = mamba_dims(D, mcfg)
    xz = x @ p["w_in"].to(dt)
    x_in, z = tp.halves(xz, split)
    x_conv, conv_new = _causal_conv(
        x_in, p["conv_w"].to(dt), p["conv_b"].to(dt),
        tp.model_slice(state["conv"], 2, split))
    x_conv = F.silu(x_conv)
    A_bar, Bx, Cm = _ssm_params(p, x_conv, mcfg, dt_rank,
                                split)                       # (B,1,di,N)
    h = tp.model_slice(state["h"], 1, split) * A_bar[:, 0] + Bx[:, 0]
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :].to(dt)
    y = y + x_conv * p["D"].to(dt)
    y = y * F.silu(z)
    return (tp.out_of_model(y @ p["w_out"].to(dt), split),
            {"h": tp.gather_model(h, 1, split),
             "conv": tp.gather_model(conv_new, 2, split)})
