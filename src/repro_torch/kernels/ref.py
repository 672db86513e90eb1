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
``campaign_sweep_ref`` is the plain version of the persistent sweep
kernel (csrc/campaign_sweep_fused.cu): all N ticks of a batch, built
from those ops, with the engine's draws (``philox_uniforms``,
``poisson``), which live here so that the engine and it share them.

Every op keeps int32 counts and f32 arithmetic in the JAX order:

  * the allocator rounds ``inc * s`` and ``+ 1e-3`` as two separate
    IEEE operations (each a separate PyTorch op, so nothing fuses them
    into one FMA), which is what keeps its floors exact;
  * billing sums its G columns left to right, the order the kernel
    uses, so kernel and plain version agree bit for bit.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["flash_attention_ref", "flash_attention_model_ref",
           "moe_gmm_ref", "mamba_scan_ref", "mlstm_ref",
           "mlstm_model_ref", "mlstm_chunkwise_ref",
           "campaign_alloc_ref", "campaign_preempt_ref",
           "campaign_match_ref", "campaign_advance_ref",
           "campaign_bill_ref", "philox4x32", "philox_uniforms", "poisson",
           "campaign_sweep_ref"]

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
                              v: torch.Tensor, *, causal: bool = True,
                              q_offset: int = 0) -> torch.Tensor:
    """The plain version in the model layout: q (B,Sq,H,D), k/v
    (B,Skv,Hkv,D) -> (B,Sq,H,D), scale D**-0.5, every key valid, causal
    masking q_offset + i >= j."""
    B, Sq, H, D = q.shape
    Hkv = k.shape[2]
    qk = q.transpose(1, 2).reshape(B * H, Sq, D)
    kk = k.transpose(1, 2).reshape(B * Hkv, -1, D)
    vv = v.transpose(1, 2).reshape(B * Hkv, -1, D)
    o = flash_attention_ref(qk, kk, vv, causal=causal, scale=D ** -0.5,
                            q_offset=q_offset)
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
    """The two-phase algorithm of the mLSTM kernel's two routes, in plain
    PyTorch: q/k (BH,S,dqk), v (BH,S,dv), logi/logf (BH,S,1) -> h
    (BH,S,dv) in q's dtype, from a zero state, any S (a ragged last
    chunk is padded with zero steps).

    1. the gate pass: chunk-local cumsum and prefix max, then the chain
       of m0 (entering each chunk) and Mc (its end) over the chunks;
    2. the states (C, n) entering every chunk, C <- exp(m0 - Mc) C +
       (k w)^T v and n <- exp(m0 - Mc) n + sum_j k_j w_j;
    3. every chunk's outputs from its entering state.

    With bf16 q the tensor-core route's roundings are applied where it
    rounds: k w (the state update's operand), the masked scores S~ (the
    operand of S~ v) and C entering each chunk (the operand of q C), each
    to bf16; the gates, n, the denominator and every sum stay f32.  The
    CUDA-core route rounds nothing but h: its mirror is this function on
    f32-widened inputs."""
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


# -- the sweep's draws -----------------------------------------------------

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of ``a * m`` for int64 ``a`` in
    [0, 2**32): the product is split at 16 bits of ``a`` so no
    intermediate leaves int64."""
    p_lo = (a & 0xFFFF) * m                # < 2**48
    p_hi = (a >> 16) * m                   # < 2**48
    s = (p_lo >> 16) + p_hi                # product == s * 2**16 + low16
    return s >> 16, ((s & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32(ctr, key, rounds: int = 10):
    """Philox-4x32 (Salmon et al., SC'11) on int64 tensors holding
    uint32 values: ``ctr`` four words, ``key`` two; returns four words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(rounds):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + _PHILOX_W[0]) & _U32
        k1 = (k1 + _PHILOX_W[1]) & _U32
    return c0, c1, c2, c3


def philox_uniforms(seeds: torch.Tensor, ticks: torch.Tensor, G: int
                    ) -> torch.Tensor:
    """[T, B, G] float32 uniforms in [0, 1) for lane seeds ``seeds``
    (B,) int64 at tick indices ``ticks`` (T,) int64: word 0 of
    Philox-4x32-10 at key (seed low, seed high), counter
    (tick, group, 0, 0), top 24 bits."""
    dev = seeds.device
    T, B = ticks.shape[0], seeds.shape[0]
    shape = (T, B, G)
    c0 = ticks.view(T, 1, 1).expand(shape)
    c1 = torch.arange(G, dtype=torch.int64, device=dev).view(1, 1, G) \
        .expand(shape)
    zero = torch.zeros(shape, dtype=torch.int64, device=dev)
    k0 = (seeds & _U32).view(1, B, 1).expand(shape)
    k1 = ((seeds >> 32) & _U32).view(1, B, 1).expand(shape)
    x0, _x1, _x2, _x3 = philox4x32((c0, c1, zero, zero), (k0, k1))
    return (x0 >> 8).to(torch.float32) * (1.0 / (1 << 24))


# f32-representable clip bounds (the values JAX's weak-typed
# ``clip(u, 1e-7, 1 - 1e-7)`` rounds to)
_U_LO = float(np.float32(1e-7))
_U_HI = float(np.float32(1.0 - 1e-7))


def poisson(u: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Poisson(lam) quantile of the uniform draw ``u``: truncated
    inverse CDF for small lam, a rounded normal approximation above 8
    (the JAX engine's ``_poisson``, op for op)."""
    K = 24
    p = torch.exp(-torch.clamp(lam, max=30.0))
    cdf = p
    kk = (u > cdf).to(torch.int32)
    for j in range(1, K):
        p = p * lam / j
        cdf = cdf + p
        kk = kk + (u > cdf).to(torch.int32)
    z = torch.special.ndtri(torch.clamp(u, _U_LO, _U_HI))
    k_norm = torch.round(lam + torch.sqrt(torch.clamp(lam, min=0.0)) * z)
    return torch.where(lam > 8.0, torch.clamp(k_norm, min=0.0)
                       .to(torch.int32), kk)


# -- the whole sweep ---------------------------------------------------------

def campaign_sweep_ref(args: Dict[str, Optional[torch.Tensor]], *,
                       dt: float, nat_any: bool, dp_active: bool,
                       dp_staging: bool) -> Dict[str, torch.Tensor]:
    """All N ticks of one engine batch from the packed arguments of
    ``ops.campaign_sweep`` (names and shapes in ``ops.SWEEP_INPUTS``);
    returns the final state (``ops.SWEEP_STATE``), before the settle.

    Lane-vectorised and phase for phase the eager engine's ``_tick``
    (core/sweep_torch.py) on the plain tick ops, with two differences
    that change no integer: counts are scattered by the index planes
    (``lvl_of_w``, ``w0_of_j``, ``pos_hit``, ``pos_miss``) instead of
    multiplied by one-hot planes, and the data plane's egress is summed
    over the groups left to right (the kernel's order) where the eager
    engine calls ``torch.sum``."""
    I32, F32 = torch.int32, torch.float32
    a = args
    seg_of_tick = a["seg_of_tick"].tolist()
    is_start = a["is_seg_start"].tolist()
    N = len(seg_of_tick)
    _S, B, G = a["cap"].shape
    X = a["lvl_of_w"].shape[1]
    J = a["w0_of_j"].shape[1]
    L = J - 1
    P = a["prov_onehot"].shape[1]
    dev = a["cap"].device
    onehot = a["prov_onehot"]
    lvl_of_w = a["lvl_of_w"].to(torch.int64)
    w0_of_j = a["w0_of_j"].to(torch.int64)[:, None, :].expand(B, G, J)
    finmask_rg = a["finmask"].repeat_interleave(G, dim=0)
    thresholds = a["thresholds"]
    budget = a["budget"]
    oh = a["overhead_tick"]
    if dp_staging:
        pos_hit = a["pos_hit"].to(torch.int64)
        pos_miss = a["pos_miss"].to(torch.int64)

    def z_i(*s):
        return torch.zeros(s, dtype=I32, device=dev)

    def z_f(*s):
        return torch.zeros(s, dtype=F32, device=dev)
    idle, pdead, busy, target_g = z_i(B, G), z_i(B, G), z_i(B, G, X), \
        z_i(B, G)
    lv, fresh_q = z_i(B, L), z_i(B)
    spent, by_prov, infra = z_f(B), z_f(B, P), z_f(B)
    fired = torch.zeros((B, thresholds.shape[0]), dtype=torch.bool,
                        device=dev)
    capped = torch.zeros(B, dtype=torch.bool, device=dev)
    cap_pending = torch.zeros(B, dtype=torch.bool, device=dev)
    cap_tick = torch.full((B,), -1, dtype=I32, device=dev)
    pre_ct, nat_ct, fin_ct = z_i(B), z_i(B), z_i(B)
    accel, busy_h, busy_prov = z_f(B), z_f(B), z_f(B, P)
    hit_acc, virgin, egress_g = z_f(B, G), z_f(B, G), z_f(B, G)
    hits, misses, stage_t = z_f(B), z_f(B), z_f(B)

    def requeue(lv, kb):                  # busy cells -> their levels
        return lv.scatter_add(1, lvl_of_w, kb.sum(1, dtype=I32))

    def split(idle, pdead, busy, k):      # the allocator over the cells
        cells = torch.cat([idle[..., None], pdead[..., None], busy], dim=2)
        killed = campaign_alloc_ref(cells.view(B * G, X + 2),
                                    k.reshape(B * G)).view(B, G, X + 2)
        return killed[..., 0], killed[..., 1], killed[..., 2:]

    block = 64
    draws = None
    for i in range(N):
        seg, start = seg_of_tick[i], bool(is_start[i])
        if a["uniforms"] is not None:
            u = a["uniforms"][i]
        else:
            if i % block == 0:
                draws = philox_uniforms(
                    a["seeds"], torch.arange(i, min(i + block, N),
                                             dtype=torch.int64, device=dev),
                    G)
            u = draws[i % block]
        cap_g, rate_g = a["cap"][seg], a["rate"][seg]
        live0 = idle + pdead + busy.sum(2, dtype=I32)
        live_g = live0
        if dp_staging and start:
            virgin = torch.where(a["dp_flush"][seg], live0.to(F32), virgin)

        # 1. events
        cume = cap_g.cumsum(1, dtype=I32) - cap_g

        def greedy(n):
            return torch.minimum(torch.clamp(n[:, None] - cume, min=0),
                                 cap_g)
        apply_cap = cap_pending
        target_g = torch.where(apply_cap[:, None],
                               greedy(a["downscale"][seg]), target_g)
        cap_tick = torch.where(apply_cap, i, cap_tick)
        if start:
            n_eff = torch.where(capped, a["n_cap"][seg], a["n_unc"][seg])
            target_g = torch.where((n_eff >= 0)[:, None],
                                   greedy(torch.clamp(n_eff, min=0)),
                                   target_g)

        # 2. kill down to target
        excess = torch.clamp(live_g - target_g, min=0)
        ki, kp, kb = split(idle, pdead, busy, excess)
        idle, pdead, busy = idle - ki, pdead - kp, busy - kb
        pre_ct = pre_ct + kb.sum((1, 2), dtype=I32)
        lv = requeue(lv, kb)
        live_g = live_g - ki - kp - kb.sum(2, dtype=I32)
        if dp_staging:
            virgin = virgin * live_g.to(F32) \
                / torch.clamp(live0.to(F32), min=1.0)

        # 3. spawn
        deficit = torch.clamp(torch.minimum(target_g, cap_g) - live_g,
                              min=0)
        idle = idle + deficit
        live_g = live_g + deficit
        if dp_staging:
            virgin = virgin + deficit.to(F32)
            live_sp = live_g

        # 4. preemption
        util = live_g.to(F32) / torch.clamp(cap_g, min=1).to(F32)
        hazard = a["pre_rate_g"][None, :] \
            * (1.0 + (a["pre_scale_g"][None, :] - 1.0) * util) * dt
        k_pre = poisson(u, live_g.to(F32) * hazard)
        ki, kp, kb = split(idle, pdead, busy, k_pre)
        idle, pdead, busy = idle - ki, pdead - kp, busy - kb
        pre_ct = pre_ct + kb.sum((1, 2), dtype=I32)
        lv = requeue(lv, kb)
        live_g = live_g - ki - kp - kb.sum(2, dtype=I32)
        if dp_staging:
            virgin = virgin * live_g.to(F32) \
                / torch.clamp(live_sp.to(F32), min=1.0)

        # 5/6. queue top-up
        ring_tot = lv.sum(1, dtype=I32)
        fresh_q = fresh_q + torch.clamp(
            a["minq"][seg] - (ring_tot + fresh_q), min=0)

        # 7. match
        idle_m = idle * a["origin_up"][seg] if dp_active else idle
        idle_tot = idle_m.sum(1, dtype=I32)
        k = torch.minimum(idle_tot, ring_tot + fresh_q)
        k = torch.where(a["outage"][seg], 0, k)
        take_g = campaign_match_ref(idle_m, k)
        avail = torch.cat([lv.flip(1), fresh_q[:, None]], dim=1)
        cumq = avail.cumsum(1, dtype=I32)
        take_j = torch.minimum(torch.clamp(k[:, None] - (cumq - avail),
                                           min=0), avail)
        cA = take_g.cumsum(1, dtype=I32)
        cB = take_j.cumsum(1, dtype=I32)
        lo = torch.maximum((cA - take_g)[:, :, None],
                           (cB - take_j)[:, None, :])
        hi = torch.minimum(cA[:, :, None], cB[:, None, :])
        joint = torch.clamp(hi - lo, min=0)                  # [B,G,J]
        if dp_staging:
            joint = joint.to(F32)
            take_f = take_g.to(F32)
            first_f = torch.minimum(take_f, virgin)
            virgin = virgin - first_f
            acc = hit_acc + take_f * a["dp_r_g"][None, :] \
                - first_f * a["dp_loss_g"][None, :]
            th_f = torch.minimum(torch.clamp(torch.floor(acc), min=0.0),
                                 take_f)
            hit_acc = acc - th_f
            cumj = joint.cumsum(2)
            hit_j = torch.minimum(
                torch.clamp(th_f[:, :, None] - (cumj - joint), min=0.0),
                joint)
            miss_j = joint - hit_j
            busy = busy.scatter_add(2, pos_hit, hit_j.to(I32)) \
                .scatter_add(2, pos_miss[seg], miss_j.to(I32))
            has = a["dp_has_g"][None, :]
            miss_f = (take_f - th_f) * has
            hits = hits + (th_f * has).sum(1)
            misses = misses + miss_f.sum(1)
            stage_t = stage_t \
                + (th_f * a["S_hit_g"][None, :]
                   + (take_f - th_f) * a["S_miss"][seg].to(F32)).sum(1)
            eg_g = (take_f - th_f) * a["dp_usd_miss_g"][None, :]
            egress_g = egress_g + eg_g
        else:
            busy = busy.scatter_add(2, w0_of_j, joint)
        idle = idle - take_g
        lv = lv - take_j[:, :L].flip(1)
        fresh_q = fresh_q - take_j[:, L]

        # 7.5 NAT drops
        if nat_any:
            drop = busy * a["nat_g"][:, :, None]
            cnt = drop.sum((1, 2), dtype=I32)
            lv = requeue(lv, drop)
            nat_ct = nat_ct + cnt
            pre_ct = pre_ct + cnt
            busy = busy - drop
            pdead = pdead + drop.sum(2, dtype=I32)

        # 8. advance
        adv, fin = campaign_advance_ref(busy.reshape(B * G, X), finmask_rg)
        busy = adv.view(B, G, X)
        fin_g = fin.view(B, G)
        fin_ct = fin_ct + fin_g.sum(1, dtype=I32)
        idle = idle + fin_g

        # 9. billing
        spent_d, prov_d = campaign_bill_ref(
            live0, rate_g * (dt if i > 0 else 0.0), onehot)
        spent = spent + spent_d
        if dp_staging:
            eg_sum = eg_g[:, 0]
            for g in range(1, G):
                eg_sum = eg_sum + eg_g[:, g]
            spent = spent + eg_sum
        by_prov = by_prov + prov_d

        # 10. overhead
        spent = spent + oh
        infra = infra + oh

        # 11. ledger thresholds -> budget-floor tripwire
        frac = torch.clamp(budget - spent, min=0.0) / budget
        cross = (frac[:, None] <= thresholds[None, :]) & ~fired
        newly = cross.any(1)
        fired = fired | cross
        trigger = newly & (frac <= a["floor"][seg]) & ~capped
        capped = capped | trigger
        cap_pending = trigger

        # 12. GPU-time totals
        busy_g = busy.sum(2, dtype=I32).to(F32)
        live_end = (idle + pdead).to(F32) + busy_g
        accel = accel + live_end.sum(1) * dt
        busy_h = busy_h + busy_g.sum(1) * dt
        busy_prov = busy_prov + (busy_g @ onehot) * dt

    return {"idle": idle, "pdead": pdead, "target_g": target_g,
            "busy": busy, "lv": lv, "fresh_q": fresh_q, "spent": spent,
            "by_prov": by_prov, "infra": infra, "fired": fired,
            "capped": capped, "cap_pending": cap_pending,
            "cap_tick": cap_tick, "pre_ct": pre_ct, "nat_ct": nat_ct,
            "fin_ct": fin_ct, "accel": accel, "busy_h": busy_h,
            "busy_prov": busy_prov, "hit_acc": hit_acc, "virgin": virgin,
            "hits": hits, "misses": misses, "stage_t": stage_t,
            "egress_g": egress_g}
