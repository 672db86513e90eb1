"""xLSTM blocks: chunkwise-parallel mLSTM (matrix memory) + sequential sLSTM.

The port of the JAX package's ``models/xlstm.py``.  The mLSTM uses the
exact stabilized chunkwise form: within a chunk an attention-like
(c x c) masked product, across chunks a (B, H, dk, dv) state carried by
a Python loop over the chunks (the JAX package's ``lax.scan``); decode
is an O(1)-state single step.  The sLSTM is a loop over S of small
recurrent steps, as the JAX ``lax.scan``; it has no kernel.

``mlstm_forward`` takes the chunk loop through its ``chunk_fn`` hook
(the CUDA ``mlstm_chunk`` kernel's model-layout wrapper on the model
path): it then calls ``chunk_fn(q, k, v, logi, logf)`` once on the whole
sequence, with q/k/v as (B, S, H, dh) views and the gates as (B, S, H)
f32.  The kernel starts from a zero state and returns no final state,
so that path serves the training forward only: it takes no ``state``
and returns None for C, n and m.  It also returns h in q's dtype where
the chunk loop keeps it in f32 into the head-wise norm, so in bf16 the
two paths differ by one more rounding of h.

Every function here takes the weights as plain tensors or as a mesh
step's ``tp.Stored`` leaves, split over "model" as the JAX package's
compiled step splits them (``mlstm_split`` / ``slstm_split``): with
"heads", where "model" divides the heads, each rank runs its heads'
cells between f and g (the mLSTM's up-projection column-parallel and
gathered, q / k / v / the gates and the sLSTM's gate projections on the
rank's heads, the mLSTM's down-projection row-parallel; the sLSTM's
hidden state gathered, its GLU's up-projections row-parallel inside
``tp.row_parallel_glu`` and its down-projection column-parallel); with
None (plain tensors, nothing split, or heads that "model" does not
divide) every weight is gathered and everything is whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import tp
from repro_torch.models.layers import dense_init
from repro_torch.models.mamba import _causal_conv


def _split(w, num_heads):
    """"heads" or None for a mixer whose first head-major projection is
    ``w`` (see the module docstring)."""
    if tp.split_on(w, 1) and num_heads % tp.model_size() == 0:
        return "heads"
    return None


def _heads_of(leaf, region):
    """The rank's heads (dim 0) of a head-major leaf inside a
    tensor-parallel region, else all of it."""
    return tp.slice_of(leaf, 0) if region else tp.whole(leaf)


def _row(x, w, region):
    """``x @ w`` for a down-projection: row-parallel between f and g in a
    tensor-parallel region (x holds the rank's rows), else whole."""
    if not region:
        return x @ tp.whole(w).to(x.dtype)
    return tp.out_of_model(x @ tp.slice_of(w, 0).to(x.dtype))

# ==========================================================================
# mLSTM
# ==========================================================================


def mlstm_dims(d_model, xcfg, num_heads):
    d_inner = int(d_model * xcfg.proj_factor_mlstm)
    return d_inner, d_inner // num_heads


def init_mlstm(gen, d_model, num_heads, xcfg, device):
    d_inner, _ = mlstm_dims(d_model, xcfg, num_heads)
    f32 = torch.float32
    return {
        "w_up": dense_init(gen, (d_model, 2 * d_inner), device),
        "conv_w": dense_init(gen, (xcfg.conv1d_kernel, d_inner), device,
                             in_axis_size=xcfg.conv1d_kernel),
        "conv_b": torch.zeros(d_inner, dtype=f32, device=device),
        "wq": dense_init(gen, (d_inner, d_inner), device),
        "wk": dense_init(gen, (d_inner, d_inner), device),
        "wv": dense_init(gen, (d_inner, d_inner), device),
        "w_if": dense_init(gen, (d_inner, 2 * num_heads), device),
        # small initial input gate; forget-gate bias ~ open
        "b_i": torch.full((num_heads,), -10.0, dtype=f32, device=device),
        "b_f": torch.full((num_heads,), 3.0, dtype=f32, device=device),
        "norm_scale": torch.ones(d_inner, dtype=f32, device=device),
        "w_down": dense_init(gen, (d_inner, d_model), device,
                             in_axis_size=d_inner),
    }


def _headwise_norm(h, scale, num_heads, eps=1e-6):
    """GroupNorm with one group per head over (B,S,H,dh); population
    variance, as ``jnp.var``."""
    hf = h.to(torch.float32)
    mu = hf.mean(-1, keepdim=True)
    var = hf.var(-1, keepdim=True, correction=0)
    out = (hf - mu) * torch.rsqrt(var + eps)
    _, _, H, dh = h.shape
    return (out * scale.reshape(H, dh)).to(h.dtype)


def _mlstm_chunk(carry, qkv_if, dh):
    """One chunk of the stabilized chunkwise-parallel mLSTM.
    carry: C (B,H,dk,dv), n (B,H,dk), m (B,H).
    qkv_if: q,k,v (B,H,c,dh); logi, logf (B,H,c)."""
    C0, n0, m0 = carry
    q, k, v, logi, logf = qkv_if
    f32 = torch.float32
    kf = k.to(f32) * (dh ** -0.5)
    qf = q.to(f32)
    vf = v.to(f32)

    Fc = torch.cumsum(logf, dim=2)                       # (B,H,c)
    a = logi - Fc
    M = torch.maximum(m0[..., None], torch.cummax(a, dim=2).values)
    m_new = Fc + M                                       # running stabilizer

    w_state = torch.exp(m0[..., None] - M)               # (B,H,c)
    Dmask = torch.exp(a[:, :, None, :] - M[:, :, :, None])
    c = q.shape[2]
    tril = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    Dmask = torch.where(tril, Dmask, torch.zeros((), dtype=f32,
                                                 device=q.device))

    S_intra = torch.einsum("bhtd,bhjd->bhtj", qf, kf) * Dmask
    num = (torch.einsum("bhtj,bhjd->bhtd", S_intra, vf)
           + w_state[..., None] * torch.einsum("bhtd,bhde->bhte", qf, C0))
    nvec = (w_state[..., None] * n0[:, :, None, :]
            + torch.einsum("bhtj,bhjd->bhtd", Dmask, kf))
    den = torch.maximum(torch.einsum("bhtd,bhtd->bht", nvec, qf).abs(),
                        torch.exp(-m_new))
    h = num / den[..., None]                             # (B,H,c,dv)

    # end-of-chunk state
    Mc = M[..., -1]
    wc = torch.exp(m0 - Mc)                              # (B,H)
    w_j = torch.exp(a - Mc[..., None])                   # (B,H,c)
    C1 = wc[..., None, None] * C0 + torch.einsum(
        "bhjd,bhje->bhde", kf * w_j[..., None], vf)
    n1 = wc[..., None] * n0 + torch.einsum("bhj,bhjd->bhd", w_j, kf)
    m1 = m_new[..., -1]
    return (C1, n1, m1), h


def mlstm_split(p, num_heads):
    """How a mesh step splits this mLSTM over "model": "heads" or None
    (the module docstring)."""
    return _split(p["wq"], num_heads)


def _qkv_gates(p, x, num_heads, d_inner, dh, conv0=None, split=None):
    """q and k from the convolved, silu'd stream, v from the
    unconvolved one; q/k/v as (B,H,S,dh) views, gates (B,H,S) f32:
    logi raw (an exponential gate), logf a log-sigmoid.  ``split``
    "heads": H and z are the rank's heads (the conv runs on every
    channel, as the reference's ``w_up`` product is gathered)."""
    dt = x.dtype
    region = split == "heads"
    up = tp.Columns(x, region)(p["w_up"])
    xi, z = up.chunk(2, dim=-1)
    cw = tp.shared if region else tp.whole
    xc, conv_new = _causal_conv(xi, cw(p["conv_w"]).to(dt),
                                cw(p["conv_b"]).to(dt), conv0)
    xc = F.silu(xc)
    B, S, _ = x.shape
    if region:
        m, c = tp.model_size(), tp.model_rank()
        hl = num_heads // m
        wq, wk, wv = (tp.local(p[k]).to(dt) for k in ("wq", "wk", "wv"))
        q, k, v = xc @ wq, xc @ wk, xi @ wv
        w_if = tp.shared(p["w_if"])
        w_if = torch.cat([w_if[:, c * hl:(c + 1) * hl],
                          w_if[:, num_heads + c * hl:
                               num_heads + (c + 1) * hl]], dim=1)
        b_i, b_f = tp.slice_of(p["b_i"], 0), tp.slice_of(p["b_f"], 0)
        z = tp.model_slice(z, -1)
    else:
        hl = num_heads
        wq, wk, wv = (tp.whole(p[k]).to(dt) for k in ("wq", "wk", "wv"))
        q, k, v = xc @ wq, xc @ wk, xi @ wv
        w_if, b_i, b_f = (tp.whole(p[k]) for k in ("w_if", "b_i", "b_f"))

    def heads(t):
        return t.reshape(B, S, hl, dh).transpose(1, 2)
    q, k, v = heads(q), heads(k), heads(v)
    gif = (xc @ w_if.to(dt)).to(torch.float32)
    i_raw = gif[..., :hl] + b_i
    f_raw = gif[..., hl:] + b_f
    logi = i_raw.transpose(1, 2)                         # (B,H,S)
    logf = F.logsigmoid(f_raw).transpose(1, 2)
    return q, k, v, logi, logf, z, conv_new


def _head_state(state, keys, region):
    """The rank's heads (dim 1) of a state stored whole over "model"."""
    return [tp.model_slice(state[k], 1, region) for k in keys]


def mlstm_forward(p, x, num_heads, xcfg, *, chunk=128, state=None,
                  chunk_fn=None, split=None):
    """x: (B,S,D) -> (y, new_state). state: {"C","n","m","conv"}.
    Chunked over S, or one ``chunk_fn`` call over the whole sequence
    (then C, n and m come back None).  ``split`` (``mlstm_split``)
    "heads": C, n and m of the new state are the rank's heads."""
    B, S, D = x.shape
    dt = x.dtype
    d_inner, dh = mlstm_dims(D, xcfg, num_heads)
    region = split == "heads"
    conv0 = state["conv"] if state is not None else None
    q, k, v, logi, logf, z, conv_new = _qkv_gates(p, x, num_heads, d_inner,
                                                  dh, conv0, split)
    hl = q.shape[1]
    # a mesh prefill runs the rank's heads' cells on every row
    # (``tp.whole_batch``)
    q, k, v, logi, logf = (tp.gather_batch(t, region)
                           for t in (q, k, v, logi, logf))
    B = q.shape[0]
    if chunk_fn is not None:
        if state is not None:
            raise ValueError("mlstm_forward: chunk_fn starts from a zero "
                             "state; a state needs the chunked path")
        h = chunk_fn(*(t.transpose(1, 2) for t in (q, k, v, logi, logf)))
        C1 = n1 = m1 = None                              # h: (B,S,H,dh)
    else:
        if state is None:
            f32 = torch.float32
            C0 = torch.zeros((B, hl, dh, dh), dtype=f32, device=x.device)
            n0 = torch.zeros((B, hl, dh), dtype=f32, device=x.device)
            m0 = torch.zeros((B, hl), dtype=f32, device=x.device)
        else:
            C0, n0, m0 = _head_state(state, ("C", "n", "m"), region)
        c = min(chunk, S)
        if S % c:
            c = S
        carry, hs = (C0, n0, m0), []
        for i in range(S // c):
            sl = slice(i * c, (i + 1) * c)
            carry, h_c = _mlstm_chunk(
                carry, (q[:, :, sl], k[:, :, sl], v[:, :, sl],
                        logi[:, :, sl], logf[:, :, sl]), dh)
            hs.append(h_c)
        C1, n1, m1 = (tp.own_batch(t, region) for t in carry)
        h = torch.cat(hs, dim=2).transpose(1, 2)         # (B,S,H,dh)
    h = tp.own_batch(h, region)
    B = h.shape[0]
    h = _headwise_norm(h, _heads_of(p["norm_scale"], region), hl)
    h = h.reshape(B, S, hl * dh) * F.silu(z)
    y = _row(h.to(dt), p["w_down"], region)
    return y, {"C": C1, "n": n1, "m": m1, "conv": conv_new}


def init_mlstm_state(batch, d_model, num_heads, xcfg, dtype, device):
    d_inner, dh = mlstm_dims(d_model, xcfg, num_heads)
    f32 = torch.float32
    return {"C": torch.zeros((batch, num_heads, dh, dh), dtype=f32,
                             device=device),
            "n": torch.zeros((batch, num_heads, dh), dtype=f32,
                             device=device),
            "m": torch.zeros((batch, num_heads), dtype=f32, device=device),
            "conv": torch.zeros((batch, xcfg.conv1d_kernel - 1, d_inner),
                                dtype=dtype, device=device)}


def mlstm_decode(p, x, state, num_heads, xcfg, split=None):
    """Exact sequential single-token step.  ``split`` "heads": the rank
    steps its heads of the state (stored whole over "model") and the
    new heads are gathered over "model"."""
    B, _, D = x.shape
    d_inner, dh = mlstm_dims(D, xcfg, num_heads)
    region = split == "heads"
    q, k, v, logi, logf, z, conv_new = _qkv_gates(
        p, x, num_heads, d_inner, dh, state["conv"], split)
    hl = q.shape[1]
    C0, n0, m0 = _head_state(state, ("C", "n", "m"), region)
    f32 = torch.float32
    qf = q[:, :, 0].to(f32)                              # (B,H,dh)
    kf = k[:, :, 0].to(f32) * (dh ** -0.5)
    vf = v[:, :, 0].to(f32)
    li, lf = logi[:, :, 0], logf[:, :, 0]                # (B,H)
    m1 = torch.maximum(lf + m0, li)
    fp = torch.exp(lf + m0 - m1)
    ip = torch.exp(li - m1)
    C1 = fp[..., None, None] * C0 + ip[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", kf, vf)
    n1 = fp[..., None] * n0 + ip[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C1)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", n1, qf).abs(),
                        torch.exp(-m1))
    h = (num / den[..., None])[:, None]                  # (B,1,H,dh)
    h = _headwise_norm(h, _heads_of(p["norm_scale"], region), hl)
    h = h.reshape(B, 1, hl * dh) * F.silu(z)
    y = _row(h.to(x.dtype), p["w_down"], region)
    C1, n1, m1 = (tp.gather_model(t, 1, region) for t in (C1, n1, m1))
    return y, {"C": C1, "n": n1, "m": m1, "conv": conv_new}


# ==========================================================================
# sLSTM
# ==========================================================================

_SLSTM_GATES = ("z", "i", "f", "o")


def init_slstm(gen, d_model, num_heads, xcfg, device):
    dh = d_model // num_heads
    d_ff = int(d_model * xcfg.proj_factor_slstm)
    f32 = torch.float32
    p = {"conv_w": dense_init(gen, (xcfg.conv1d_kernel, d_model), device,
                              in_axis_size=xcfg.conv1d_kernel),
         "conv_b": torch.zeros(d_model, dtype=f32, device=device),
         "norm_scale": torch.ones(d_model, dtype=f32, device=device),
         "w_up1": dense_init(gen, (d_model, d_ff), device),
         "w_up2": dense_init(gen, (d_model, d_ff), device),
         "w_down": dense_init(gen, (d_ff, d_model), device,
                              in_axis_size=d_ff)}
    for g in _SLSTM_GATES:
        p[f"w_{g}"] = dense_init(gen, (d_model, d_model), device)
        p[f"r_{g}"] = dense_init(gen, (num_heads, dh, dh), device,
                                 in_axis_size=dh)
        p[f"b_{g}"] = torch.zeros(d_model, dtype=f32, device=device)
    return p


def slstm_split(p, num_heads):
    """How a mesh step splits this sLSTM over "model": "heads" or None
    (the module docstring)."""
    return _split(p["w_z"], num_heads)


def _slstm_gates_x(p, x, conv0, split=None):
    """Input-side gate pre-activations (no recurrence): the rank's heads'
    channels with ``split`` "heads", else every channel."""
    dt = x.dtype
    region = split == "heads"
    cw = tp.shared if region else tp.whole
    x = tp.into_model(x, region)
    xc, conv_new = _causal_conv(x, cw(p["conv_w"]).to(dt),
                                cw(p["conv_b"]).to(dt), conv0)
    xc = F.silu(xc)
    if region:
        def gate(inp, g):
            return (inp @ tp.local(p[f"w_{g}"]).to(dt)
                    + tp.slice_of(p[f"b_{g}"], 0).to(dt))
    else:
        def gate(inp, g):
            return (inp @ tp.whole(p[f"w_{g}"]).to(dt)
                    + tp.whole(p[f"b_{g}"]).to(dt))
    gz = gate(x, "z")
    go = gate(x, "o")
    gi = gate(xc, "i")
    gf = gate(xc, "f")
    return gz, gi, gf, go, conv_new


def _slstm_step(r_all, carry, pre):
    """One recurrent step.  carry: (c,n,h,m), all (B,H,dh) f32 — per-cell
    gates and a per-cell stabilizer m, per the xLSTM paper.  pre:
    (B,H,4,dh) f32 input-side pre-activations of z, i, f, o; r_all
    (H,dh,4*dh) the four recurrent matrices side by side, so one product
    gives every gate's ``einsum("bhd,hde->bhe", h, r_g)``."""
    c, n, h, m = carry
    B, H, dh = h.shape
    g = pre + torch.einsum("bhd,hde->bhe", h, r_all).reshape(B, H, 4, dh)
    z_t = torch.tanh(g[:, :, 0])
    i_t = g[:, :, 1]
    f_t = g[:, :, 2]
    o_t = torch.sigmoid(g[:, :, 3])
    fm = f_t + m
    m1 = torch.maximum(fm, i_t)                          # (B,H,dh)
    ip = torch.exp(i_t - m1)
    fp = torch.exp(fm - m1)
    c1 = fp * c + ip * z_t
    n1 = fp * n + ip
    h1 = o_t * c1 / torch.clamp(n1, min=1.0)
    return (c1, n1, h1, m1)


def slstm_forward(p, x, num_heads, xcfg, *, state=None, split=None):
    """x: (B,S,D) -> (y, new_state).  ``split`` (``slstm_split``)
    "heads": the recurrence on the rank's heads (c, n, h, m of the new
    state are theirs), its output gathered over "model", the GLU's
    down-projection column-parallel and gathered, and its
    up-projections row-parallel (g) inside ``tp.row_parallel_glu`` (the
    reference's prefill and decode programs), whole outside it (its
    train program)."""
    B, S, D = x.shape
    dt = x.dtype
    dh = D // num_heads
    f32 = torch.float32
    region = split == "heads"
    conv0 = state["conv"] if state is not None else None
    gz, gi, gf, go, conv_new = _slstm_gates_x(p, x, conv0, split)
    hl = gz.shape[-1] // dh
    if state is None:
        carry = tuple(torch.zeros((B, hl, dh), dtype=f32,
                                  device=x.device) for _ in range(4))
    else:
        carry = tuple(_head_state(state, ("c", "n", "h", "m"), region))
    pre = torch.stack([g.to(f32).reshape(B, S, hl, dh)
                       for g in (gz, gi, gf, go)], dim=3)  # (B,S,H,4,dh)
    # f32 whatever the parameters' dtype: the JAX einsum promotes bf16
    # recurrent matrices against the f32 h
    r_all = torch.cat([_heads_of(p[f"r_{g}"], region) for g in _SLSTM_GATES],
                      dim=-1).to(f32)
    hs = []
    for t in range(S):
        carry = _slstm_step(r_all, carry, pre[:, t])
        hs.append(carry[2])                              # emit h
    # the GLU's up-projections read the rank's share of h where they are
    # row-parallel, so its cotangent is the rank's share too
    part = region and tp.glu_rows()
    h = tp.gather_model(torch.stack(hs, dim=1).reshape(B, S, hl * dh), -1,
                        region, summed=part)
    # normalisation over all of D + gated FFN (proj_factor 4/3 GLU),
    # block-internal
    hf = h.to(f32)
    mu = hf.mean(-1, keepdim=True)
    var = hf.var(-1, keepdim=True, correction=0)
    h = ((hf - mu) * torch.rsqrt(var + 1e-6)
         * (tp.shared if part else tp.whole)(p["norm_scale"])
         ).to(dt)
    h = tp.gather_batch(h, region)
    if part:
        hr = tp.model_slice(h, -1)
        u1, u2 = (tp.out_of_model(hr @ tp.slice_of(p[k], 0).to(dt))
                  for k in ("w_up1", "w_up2"))
    else:
        u1, u2 = (h @ tp.whole(p[k]).to(dt) for k in ("w_up1", "w_up2"))
    u = F.gelu(u1, approximate="tanh") * u2
    if not region:
        y = u @ tp.whole(p["w_down"]).to(dt)
    else:
        y = tp.gather_model(tp.into_model(u) @ tp.slice_of(
            p["w_down"], 1).to(dt), -1, summed=False)
    y = tp.own_batch(y, region)
    new_state = {"c": carry[0], "n": carry[1], "h": carry[2],
                 "m": carry[3], "conv": conv_new}
    return y, new_state


def init_slstm_state(batch, d_model, num_heads, xcfg, dtype, device):
    dh = d_model // num_heads

    def zeros():
        return torch.zeros((batch, num_heads, dh), dtype=torch.float32,
                           device=device)
    return {"c": zeros(), "n": zeros(), "h": zeros(), "m": zeros(),
            "conv": torch.zeros((batch, xcfg.conv1d_kernel - 1, d_model),
                                dtype=dtype, device=device)}


def slstm_decode(p, x, state, num_heads, xcfg, split=None):
    """One-token step; ``split`` "heads": the rank steps its heads of the
    state (stored whole over "model"), the new heads gathered."""
    y, st = slstm_forward(p, x, num_heads, xcfg, state=state, split=split)
    for k in ("c", "n", "h", "m"):
        st[k] = tp.gather_model(st[k], 1, split == "heads")
    return y, st
