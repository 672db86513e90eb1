"""Plain PyTorch versions of the port's CUDA kernels.

``flash_attention_ref`` is the plain version of csrc/flash_attention.cu
and the port of the JAX package's ``kernels/ref.py`` oracle of the same
name: f32 throughout, masked scores -1e30, output in q's dtype.
``moe_gmm_ref`` (csrc/moe_gmm.cu), ``mamba_scan_ref``
(csrc/mamba_scan.cu) and ``mlstm_ref`` (csrc/mlstm_chunk.cu and
csrc/mlstm_chunk_wgmma.cu) port the oracles of the same names: f32
math, output in the first input's dtype.  ``mlstm_chunkwise_ref``
mirrors the algorithm of csrc/mlstm_chunk_wgmma.cu step by step, bf16
roundings included, for the tests.

The campaign sweep's per-tick ops follow.

The sweep engine (core/sweep_torch.py) tracks exchangeable instances
as count planes (lane x group x progress step), so its tick ops are
integer allocations and reductions over those planes.  These are the
plain versions of the CUDA kernels in csrc/campaign_sweep.cu: the
wrappers in ops.py run them for CPU tensors, and the CPU tests hold them
to the JAX package's ``kernels/ref.py`` on the same numpy inputs.

Every op keeps int32 counts and f32 arithmetic in the JAX order:

  * the allocator rounds ``inc * s`` and ``+ 1e-3`` as two separate
    IEEE operations (each a separate PyTorch op, so nothing fuses them
    into one FMA), which is what keeps its floors exact;
  * billing sums its G columns left to right, the order the kernel
    uses, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["flash_attention_ref", "flash_attention_model_ref",
           "moe_gmm_ref", "mamba_scan_ref", "mlstm_ref",
           "mlstm_model_ref", "mlstm_chunkwise_ref",
           "campaign_alloc_ref", "campaign_preempt_ref",
           "campaign_match_ref", "campaign_advance_ref",
           "campaign_bill_ref"]

def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, kv_len=None, scale=None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (BHG, Sq, D); k/v: (BKV, Skv, D), BHG = BKV * G (query head
    bhg reads kv row bhg // G).  Plain softmax attention in f32; the
    score tensor is masked in place."""
    BHG, Sq, D = q.shape
    BKV, Skv, _ = k.shape
    G = BHG // BKV
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(BKV, G, Sq, D).to(torch.float32) * scale
    s = torch.einsum("bgqd,bkd->bgqk", qg, k.to(torch.float32))
    kpos = torch.arange(Skv, device=q.device)
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if kv_len is not None:
        mask &= (kpos < kv_len)[None, :]
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        mask &= qpos[:, None] >= kpos[None, :]
    s.masked_fill_(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqk,bkd->bgqd", p, v.to(torch.float32))
    return o.reshape(BHG, Sq, D).to(q.dtype)


def flash_attention_model_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True
                              ) -> torch.Tensor:
    """The plain version in the model layout: q (B,Sq,H,D), k/v
    (B,Skv,Hkv,D) -> (B,Sq,H,D), scale D**-0.5, every key valid."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qk = q.transpose(1, 2).reshape(B * H, Sq, D)
    kk = k.transpose(1, 2).reshape(B * Hkv, -1, D)
    vv = v.transpose(1, 2).reshape(B * Hkv, -1, D)
    o = flash_attention_ref(qk, kk, vv, causal=causal, scale=D ** -0.5)
    return o.reshape(B, H, Sq, D).transpose(1, 2)


def moe_gmm_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product: x (E,C,D) @ w (E,D,F) -> (E,C,F) in f32,
    cast to x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.to(torch.float32),
                        w.to(torch.float32)).to(x.dtype)


def mamba_scan_ref(xc: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Sequential selective scan from a zero state: xc/dt (B,S,di),
    bm/cm (B,S,N), a (di,N) -> y (B,S,di) in xc's dtype, with
    ``h = exp(dt_t a) h + (dt_t x_t) B_t`` and ``y_t = sum_N h C_t``
    in f32 (before the gate and the D skip)."""
    B, S, di = xc.shape
    xf, df, bf, cf = (t.to(torch.float32) for t in (xc, dt, bm, cm))
    af = a.to(torch.float32)
    h = torch.zeros((B, di, a.shape[1]), dtype=torch.float32,
                    device=xc.device)
    ys = []
    for t in range(S):
        a_bar = torch.exp(df[:, t, :, None] * af[None])        # (B,di,N)
        h = a_bar * h + (df[:, t] * xf[:, t])[:, :, None] * bf[:, t, None, :]
        ys.append((h * cf[:, t, None, :]).sum(-1))             # (B,di)
    return torch.stack(ys, dim=1).to(xc.dtype)


def mlstm_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logi: torch.Tensor, logf: torch.Tensor) -> torch.Tensor:
    """Exact stabilized sequential mLSTM from a zero state (C, n and m
    all 0): q/k (BH,S,dqk), v (BH,S,dv), logi/logf (BH,S,1) -> h
    (BH,S,dv) in q's dtype.  A loop over S in f32, k scaled by
    dqk**-0.5."""
    BH, S, dqk = q.shape
    dv = v.shape[2]
    f32 = torch.float32
    qf, vf = q.to(f32), v.to(f32)
    kf = k.to(f32) * (dqk ** -0.5)
    li, lf = logi[..., 0].to(f32), logf[..., 0].to(f32)
    C = torch.zeros((BH, dqk, dv), dtype=f32, device=q.device)
    n = torch.zeros((BH, dqk), dtype=f32, device=q.device)
    m = torch.zeros(BH, dtype=f32, device=q.device)
    hs = []
    for t in range(S):
        q_t, k_t, v_t = qf[:, t], kf[:, t], vf[:, t]
        m1 = torch.maximum(lf[:, t] + m, li[:, t])              # (BH,)
        fp = torch.exp(lf[:, t] + m - m1)
        ip = torch.exp(li[:, t] - m1)
        C = fp[:, None, None] * C + ip[:, None, None] * \
            torch.einsum("bd,be->bde", k_t, v_t)
        n = fp[:, None] * n + ip[:, None] * k_t
        num = torch.einsum("bd,bde->be", q_t, C)
        den = torch.maximum((n * q_t).sum(-1).abs(), torch.exp(-m1))
        hs.append(num / den[:, None])
        m = m1
    return torch.stack(hs, dim=1).to(q.dtype)


def mlstm_model_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logi: torch.Tensor, logf: torch.Tensor) -> torch.Tensor:
    """``mlstm_ref`` in the model layout: q/k (B,S,H,dqk), v (B,S,H,dv),
    logi/logf (B,S,H) -> h (B,S,H,dv) in q's dtype."""
    B, S, H, dqk = q.shape
    dv = v.shape[3]

    def rows(t, d):
        return t.transpose(1, 2).reshape(B * H, S, d)
    h = mlstm_ref(rows(q, dqk), rows(k, dqk), rows(v, dv),
                  rows(logi[..., None], 1), rows(logf[..., None], 1))
    return h.reshape(B, H, S, dv).transpose(1, 2)


def mlstm_chunkwise_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        logi: torch.Tensor, logf: torch.Tensor, *,
                        chunk: int = 128) -> torch.Tensor:
    """The two-phase algorithm of the tensor-core mLSTM kernel, in plain
    PyTorch: q/k (BH,S,dqk), v (BH,S,dv), logi/logf (BH,S,1) -> h
    (BH,S,dv) in q's dtype, from a zero state, any S (a ragged last
    chunk is padded with zero steps).

    1. the gate pass: chunk-local cumsum and prefix max, then the chain
       of m0 (entering each chunk) and Mc (its end) over the chunks;
    2. the states (C, n) entering every chunk, C <- exp(m0 - Mc) C +
       (k w)^T v and n <- exp(m0 - Mc) n + sum_j k_j w_j;
    3. every chunk's outputs from its entering state.

    With bf16 q the kernel's roundings are applied where it rounds: k w
    (the state update's operand), the masked scores S~ (the operand of
    S~ v) and C entering each chunk (the operand of q C), each to bf16;
    the gates, n, the denominator and every sum stay f32."""
    f32 = torch.float32
    BH, S, dqk = q.shape
    dv = v.shape[2]
    L = chunk
    nc = -(-S // L)
    pad = nc * L - S
    scale = dqk ** -0.5
    if q.dtype == torch.bfloat16:
        def rnd(t):
            return t.to(torch.bfloat16).to(f32)
    else:
        def rnd(t):
            return t

    def tiles(t):                       # (BH, S, d) -> (BH, nc, L, d)
        t = torch.nn.functional.pad(t.to(f32), (0, 0, 0, pad))
        return t.reshape(BH, nc, L, t.shape[-1])
    qf, kf, vf = tiles(q), tiles(k), tiles(v)
    li, lf = tiles(logi)[..., 0], tiles(logf)[..., 0]      # (BH, nc, L)
    valid = (torch.arange(nc * L, device=q.device) < S).reshape(nc, L)
    last = [min(L, S - c * L) - 1 for c in range(nc)]

    # 1. the gate pass
    F = torch.cumsum(lf, -1)
    a = li - F
    amax = torch.cummax(a, -1).values
    m0 = torch.zeros((BH, nc), dtype=f32, device=q.device)
    mc = torch.zeros((BH, nc), dtype=f32, device=q.device)
    m = torch.zeros(BH, dtype=f32, device=q.device)
    for c in range(nc):
        m0[:, c] = m
        mc[:, c] = torch.maximum(m, amax[:, c, last[c]])
        m = F[:, c, last[c]] + mc[:, c]
    M = torch.maximum(m0[..., None], amax)
    w_state = torch.exp(m0[..., None] - M)
    floor = torch.exp(-(F + M))
    w_end = torch.where(valid, torch.exp(a - mc[..., None]), 0.0)
    decay = torch.exp(m0 - mc)

    # 2. the states entering every chunk
    kw = kf * (w_end * scale)[..., None]
    C = torch.zeros((BH, dqk, dv), dtype=f32, device=q.device)
    n = torch.zeros((BH, dqk), dtype=f32, device=q.device)
    c_in, n_in = [], []
    for c in range(nc):
        c_in.append(rnd(C))
        n_in.append(n)
        if c < nc - 1:
            C = decay[:, c, None, None] * C + \
                rnd(kw[:, c]).transpose(1, 2) @ vf[:, c]
            n = decay[:, c, None] * n + kw[:, c].sum(1)
    c_in, n_in = torch.stack(c_in, 1), torch.stack(n_in, 1)

    # 3. every chunk's outputs
    causal = torch.ones((L, L), dtype=torch.bool, device=q.device).tril()
    keep = causal & valid[:, None, :] & valid[:, :, None]  # (nc, L, L)
    scores = (qf @ kf.transpose(-1, -2)) * scale
    dmask = torch.exp(a[..., None, :] - M[..., :, None])
    s_t = torch.where(keep, scores * dmask, 0.0)
    qn = (qf * n_in[:, :, None, :]).sum(-1)
    den = torch.maximum((s_t.sum(-1) + w_state * qn).abs(), floor)
    num = w_state[..., None] * (qf @ c_in) + rnd(s_t) @ vf
    h = (num / den[..., None]).reshape(BH, nc * L, dv)[:, :S]
    return h.to(q.dtype)


# -- campaign-sweep tick ops -----------------------------------------------

# f32-representable, so the value is the same whether an op computes
# with it in f32 or f64
_ROUND_GUARD = float(np.float32(1e-3))


def campaign_alloc_ref(counts: torch.Tensor, k: torch.Tensor
                       ) -> torch.Tensor:
    """Proportional integer allocator: counts (R,C) i32 non-negative,
    k (R,) i32 -> take (R,C) i32 with 0 <= take <= counts and
    ``take.sum(-1) == min(k, counts.sum(-1))`` (cumulative
    largest-remainder rounding)."""
    tot = counts.sum(-1, dtype=torch.int32)
    kk = torch.minimum(k, tot)
    s = kk.to(torch.float32) / torch.clamp(tot, min=1).to(torch.float32)
    inc = counts.cumsum(-1, dtype=torch.int32).to(torch.float32)
    exc = inc - counts.to(torch.float32)
    return (torch.floor(inc * s[:, None] + _ROUND_GUARD)
            - torch.floor(exc * s[:, None] + _ROUND_GUARD)
            ).to(torch.int32)


def campaign_preempt_ref(counts: torch.Tensor, k: torch.Tensor
                         ) -> torch.Tensor:
    """Preemption fan-out: split each (lane, group)'s removal count
    ``k`` across its occupancy cells (idle | pilot-dead | busy-at-w).
    counts (R,C) i32, k (R,) i32 -> killed (R,C) i32."""
    return campaign_alloc_ref(counts, k)


def campaign_match_ref(idle: torch.Tensor, k: torch.Tensor
                       ) -> torch.Tensor:
    """Queue->pilot matcher core: split each lane's ``k`` matched jobs
    across groups by idle-pilot counts.
    idle (B,G) i32, k (B,) i32 -> take (B,G) i32."""
    return campaign_alloc_ref(idle, k)


def campaign_advance_ref(busy: torch.Tensor, fin_mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pilot progress sync: busy (R,W) i32 job counts by progress step,
    fin_mask (R,W) i32 (1 where one more tick completes the job) ->
    (advanced (R,W) i32, finished (R,) i32).  Completing jobs leave;
    the rest shift one step right."""
    fin = busy * fin_mask.to(busy.dtype)
    rest = busy - fin
    advanced = torch.cat([torch.zeros_like(rest[:, :1]), rest[:, :-1]],
                         dim=-1)
    return advanced, fin.sum(-1, dtype=torch.int32)


def campaign_bill_ref(live: torch.Tensor, rate: torch.Tensor,
                      prov_onehot: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Billing/ledger reduction: live (B,G) i32 instance counts,
    rate (B,G) f32 ($ per instance this interval), prov_onehot (G,P)
    f32 -> (spent (B,) f32, by_provider (B,P) f32), both summed over
    the groups left to right."""
    amt = live.to(torch.float32) * rate
    spent = amt[:, 0]
    by_prov = amt[:, :1] * prov_onehot[0]
    for g in range(1, amt.shape[1]):
        spent = spent + amt[:, g]
        by_prov = by_prov + amt[:, g:g + 1] * prov_onehot[g]
    return spent, by_prov
