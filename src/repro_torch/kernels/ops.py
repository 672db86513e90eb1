"""Wrappers for the port's CUDA kernels.

Each wrapper checks dtype, shape, device and contiguity, then routes by
where its tensors lie: CPU tensors go to the plain version in ref.py,
CUDA tensors to the hand-written kernel in csrc/ (built at first use by
build.py).  There is no fallback: a kernel that fails to build or launch
raises.  The kernel launches on PyTorch's current stream; the wrapper
allocates its outputs.

``LAUNCHES`` counts kernel launches per wrapper, and only those, so a
run can show that its main path went through the kernels (one per
wrapper call, however many CUDA kernels the call launches).  Three
kernels have two routes each: a tensor-core one (``wgmma``: bf16
through TMA and wgmma) and the CUDA-core one (``simt``: everything
else).  A stated rule picks the route (``flash_route``, ``gmm_route``,
``mlstm_route``); ``ROUTES`` (flash attention and moe_gmm) and
``MLSTM_ROUTES`` (mlstm_chunk) count the launches of each route beside
``LAUNCHES``.  ``_force_route`` pins one for the harness and the tests,
which time and check both routes on the same inputs (forcing the wgmma
route on an input its rule refuses raises); nothing in the models or the
launch path calls it.

  wrapper             kernel            replaces (JAX package)
  campaign_preempt    campaign_alloc    kernels/campaign_sweep.py:69
  campaign_match      campaign_alloc    kernels/campaign_sweep.py:76
  campaign_advance    campaign_advance  kernels/campaign_sweep.py:93
  campaign_bill       campaign_bill     kernels/campaign_sweep.py:117
  flash_attention     flash_attention   kernels/flash_attention.py:79
                      (flash_attention_wgmma on the tensor-core route)
  (and flash_attention_kernel, its kernel-level entry point)
  moe_gmm             moe_gmm           kernels/moe_gmm.py:39
                      (moe_gmm_wgmma on the tensor-core route)
  mamba_scan          mamba_scan        kernels/mamba_scan.py:51
  mlstm_chunk         mlstm_chunk       kernels/mlstm_chunk.py:74
                      (the mlstm_chunk_kernel_gates, _states and _outputs
                      kernels; mlstm_chunk_wgmma on the tensor-core route:
                      the mlstm_chunk_wgmma_gates, _states and _outputs
                      kernels)
  (and mlstm_chunk_model, its model-layout entry point)
"""
from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Iterator, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import ref

__all__ = ["LAUNCHES", "ROUTES", "MLSTM_ROUTES", "reset_launches",
           "flash_route", "gmm_route", "gmm_row_tile", "mlstm_route",
           "scan_segment_len",
           "campaign_preempt",
           "campaign_match", "campaign_advance", "campaign_bill",
           "flash_attention", "flash_attention_kernel", "moe_gmm",
           "mamba_scan", "mlstm_chunk", "mlstm_chunk_model"]

LAUNCHES: Dict[str, int] = {"campaign_preempt": 0, "campaign_match": 0,
                            "campaign_advance": 0, "campaign_bill": 0,
                            "flash_attention": 0, "moe_gmm": 0,
                            "mamba_scan": 0, "mlstm_chunk": 0}
# launches of each route of the two-route kernels ("op.route")
ROUTES: Dict[str, int] = {"flash_attention.wgmma": 0,
                          "flash_attention.simt": 0,
                          "moe_gmm.wgmma": 0, "moe_gmm.simt": 0}
# the same for the mLSTM kernel's two routes
MLSTM_ROUTES: Dict[str, int] = {"mlstm_chunk.wgmma": 0,
                                "mlstm_chunk.simt": 0}
_FORCED: Dict[str, Optional[str]] = {"flash_attention": None,
                                     "moe_gmm": None, "mlstm_chunk": None}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, MLSTM_ROUTES):
        for name in counts:
            counts[name] = 0


@contextlib.contextmanager
def _force_route(op: str, route: Optional[str]) -> Iterator[None]:
    """Pin ``op`` ("flash_attention", "moe_gmm" or "mlstm_chunk") to
    ``route`` ("wgmma" or "simt"; None: the rule) inside the block.  A
    forced wgmma route on an input the rule would not send there
    raises."""
    if op not in _FORCED or route not in (None, "wgmma", "simt"):
        raise ValueError(f"_force_route: no route {route!r} for {op!r}")
    before = _FORCED[op]
    _FORCED[op] = route
    try:
        yield
    finally:
        _FORCED[op] = before


def _pick(op: str, rule: str) -> str:
    forced = _FORCED[op]
    if forced == "wgmma" and rule != "wgmma":
        raise ValueError(f"{op}: the wgmma route was forced on an input "
                         "its rule sends to the CUDA cores")
    return forced or rule


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           shape: Tuple[int, ...], device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_card(t: torch.Tensor, op: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one
    (run the plain version); anything else raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"{op}: no kernel for device {t.device}")


def _raise_on(err: int, op: str) -> None:
    if err != 0:
        raise RuntimeError(f"{op}: CUDA launch failed with error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _alloc(counts: torch.Tensor, k: torch.Tensor, op: str) -> torch.Tensor:
    R, C = counts.shape
    _check(f"{op} counts", counts, torch.int32, (R, C), counts.device)
    _check(f"{op} k", k, torch.int32, (R,), counts.device)
    if not _on_card(counts, op):
        return ref.campaign_alloc_ref(counts, k)
    from repro_torch.kernels.build import library
    out = torch.empty_like(counts)
    _raise_on(library().campaign_alloc(
        counts.data_ptr(), k.data_ptr(), out.data_ptr(), R, C,
        _stream(counts)), op)
    LAUNCHES[op] += 1
    return out


def campaign_preempt(counts: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Preemption fan-out: counts (R,C) i32 occupancy cells per
    (lane, group) row, k (R,) i32 removals -> killed (R,C) i32."""
    return _alloc(counts, k, "campaign_preempt")


def campaign_match(idle: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Queue->pilot matcher core: idle (B,G) i32 idle-pilot counts,
    k (B,) i32 matched jobs per lane -> take (B,G) i32."""
    return _alloc(idle, k, "campaign_match")


def campaign_advance(busy: torch.Tensor, fin_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pilot progress sync: busy (R,W) i32, fin_mask (R,W) i32 ->
    (advanced (R,W) i32, finished (R,) i32)."""
    op = "campaign_advance"
    R, W = busy.shape
    _check(f"{op} busy", busy, torch.int32, (R, W), busy.device)
    _check(f"{op} fin_mask", fin_mask, torch.int32, (R, W), busy.device)
    if not _on_card(busy, op):
        return ref.campaign_advance_ref(busy, fin_mask)
    from repro_torch.kernels.build import library
    adv = torch.empty_like(busy)
    fin = torch.empty(R, dtype=torch.int32, device=busy.device)
    _raise_on(library().campaign_advance(
        busy.data_ptr(), fin_mask.data_ptr(), adv.data_ptr(),
        fin.data_ptr(), R, W, _stream(busy)), op)
    LAUNCHES[op] += 1
    return adv, fin


def campaign_bill(live: torch.Tensor, rate: torch.Tensor,
                  prov_onehot: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Billing/ledger reduction: live (B,G) i32, rate (B,G) f32,
    prov_onehot (G,P) f32 -> (spent (B,) f32, by_provider (B,P) f32)."""
    op = "campaign_bill"
    B, G = live.shape
    P = prov_onehot.shape[1]
    _check(f"{op} live", live, torch.int32, (B, G), live.device)
    _check(f"{op} rate", rate, torch.float32, (B, G), live.device)
    _check(f"{op} prov_onehot", prov_onehot, torch.float32, (G, P),
           live.device)
    if not _on_card(live, op):
        return ref.campaign_bill_ref(live, rate, prov_onehot)
    from repro_torch.kernels.build import library
    spent = torch.empty(B, dtype=torch.float32, device=live.device)
    by_prov = torch.empty((B, P), dtype=torch.float32, device=live.device)
    _raise_on(library().campaign_bill(
        live.data_ptr(), rate.data_ptr(), prov_onehot.data_ptr(),
        spent.data_ptr(), by_prov.data_ptr(), B, G, P, _stream(live)), op)
    LAUNCHES[op] += 1
    return spent, by_prov


# -- flash attention ---------------------------------------------------------

_FLOAT_DTYPES = (torch.float32, torch.bfloat16)
_MAX_HEAD_DIM = 256          # the kernel's largest shared-memory tile


def _check_attention(op: str, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, rank: int, kv_len, q_offset) -> None:
    if q.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"{op}: q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{op}: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{op}: {name} on {t.device}, q on {q.device}")
    if q.dim() != rank or k.dim() != rank or k.shape != v.shape:
        raise ValueError(f"{op}: expected rank-{rank} q and equal k/v "
                         f"shapes, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    D = q.shape[-1]
    if k.shape[-1] != D or not 1 <= D <= _MAX_HEAD_DIM:
        raise ValueError(f"{op}: head dims {D} / {k.shape[-1]}; the kernel "
                         f"takes equal dims up to {_MAX_HEAD_DIM}")
    if k.shape[-2 if rank == 3 else 1] < 1:
        raise ValueError(f"{op}: no keys")
    if kv_len is not None and kv_len < 1:
        raise ValueError(f"{op}: kv_len {kv_len} masks every key")
    if q_offset < 0:
        raise ValueError(f"{op}: negative q_offset {q_offset}")


def _rows(t: torch.Tensor) -> torch.Tensor:
    """The kernel reads any (batch, seq, head) strides but a contiguous
    last dim: copy only a tensor whose last dim is strided."""
    return t if t.stride(-1) == 1 else t.contiguous()


_WGMMA_HEAD_DIMS = (64, 128)   # the tensor-core kernel's instantiations


def flash_route(dtype: torch.dtype, head_dim: int, strides: Sequence[int],
                ptrs: Sequence[int]) -> str:
    """The flash kernel's route: "wgmma" for bf16 with a head dim of 64
    or 128 whose element strides (the 12 passed to the kernel) are all
    multiples of 8 and whose base addresses are 16-byte aligned (what a
    TMA tensor map can express); "simt" for everything else (f32, whose
    2e-5 gate is beyond bf16 or TF32 tensor cores, other head dims, odd
    strides)."""
    if dtype == torch.bfloat16 and head_dim in _WGMMA_HEAD_DIMS and \
            all(st % 8 == 0 for st in strides) and \
            all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "simt"


def _launch_flash(q, k, v, o, strides, B, H, Hkv, Sq, Skv, D, causal,
                  kv_len, q_offset, scale) -> None:
    from repro_torch.kernels.build import library
    op = "flash_attention"
    route = _pick(op, flash_route(q.dtype, D, strides, [
        t.data_ptr() for t in (q, k, v, o)]))
    st = (ctypes.c_longlong * 12)(*strides)
    lib = library()
    if route == "wgmma":
        err = lib.flash_attention_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), st, B, H,
            Hkv, Sq, Skv, D, int(causal), kv_len, q_offset, scale,
            _stream(q))
    else:
        err = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), st,
            int(q.dtype == torch.bfloat16), B, H, Hkv, Sq, Skv, D,
            int(causal), kv_len, q_offset, scale, _stream(q))
    _raise_on(err, op)
    LAUNCHES[op] += 1
    ROUTES[f"{op}.{route}"] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Model layout: q (B,Sq,H,D), k/v (B,Skv,Hkv,D) -> (B,Sq,H,D), with
    scale D**-0.5 and every key valid (the model's ``flash_fn``).  The
    kernel reads the model layout through strides: no transpose, no
    padding."""
    op = "flash_attention"
    _check_attention(op, q, k, v, 4, None, 0)
    B, Sq, H, D = q.shape
    Bk, Skv, Hkv, _ = k.shape
    if Bk != B or H % Hkv:
        raise ValueError(f"{op}: q {tuple(q.shape)} vs k {tuple(k.shape)}: "
                         "batch must match and H be a multiple of Hkv")
    if not _on_card(q, op):
        return ref.flash_attention_model_ref(q, k, v, causal=causal)
    q, k, v = _rows(q), _rows(k), _rows(v)
    o = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    strides = [t.stride(a) for t in (q, k, v, o) for a in (0, 1, 2)]
    _launch_flash(q, k, v, o, strides, B, H, Hkv, Sq, Skv, D, causal,
                  Skv, 0, D ** -0.5)
    return o


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool, kv_len=None,
                           scale=None, q_offset: int = 0) -> torch.Tensor:
    """Kernel layout, the signature of the JAX package's
    ``flash_attention_kernel``: q (BHG,Sq,D), k/v (BKV,Skv,D) with
    BHG = BKV * G -> (BHG,Sq,D).  ``kv_len`` masks keys at or past it,
    ``scale`` defaults to D**-0.5, causal masking is q_offset + i >= j."""
    op = "flash_attention"
    _check_attention(op, q, k, v, 3, kv_len, q_offset)
    BHG, Sq, D = q.shape
    BKV, Skv, _ = k.shape
    if BHG % BKV:
        raise ValueError(f"{op}: {BHG} query rows for {BKV} kv rows")
    if not _on_card(q, op):
        return ref.flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len,
                                       scale=scale, q_offset=q_offset)
    G = BHG // BKV
    q, k, v = _rows(q), _rows(k), _rows(v)
    o = torch.empty((BHG, Sq, D), dtype=q.dtype, device=q.device)
    # viewed as (B = BKV, S, H = G, D) with one kv head
    strides = [G * q.stride(0), q.stride(1), q.stride(0),
               k.stride(0), k.stride(1), 0,
               v.stride(0), v.stride(1), 0,
               G * o.stride(0), o.stride(1), o.stride(0)]
    _launch_flash(q, k, v, o, strides, BKV, G, 1, Sq, Skv, D, causal,
                  Skv if kv_len is None else int(kv_len), int(q_offset),
                  D ** -0.5 if scale is None else float(scale))
    return o


# -- MoE grouped product and Mamba selective scan ----------------------------

def _check_stream(op: str, name: str, t: torch.Tensor, rank: int,
                  device: torch.device, contiguous: bool = True) -> None:
    if t.dtype not in _FLOAT_DTYPES:
        raise TypeError(f"{op}: {name} must be float32 or bfloat16, got "
                        f"{t.dtype}")
    if t.dim() != rank:
        raise ValueError(f"{op}: {name} must have rank {rank}, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{op}: {name} on {t.device}, expected {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def _is_bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def gmm_route(x_dtype: torch.dtype, w_dtype: torch.dtype, D: int, F: int,
              ptrs: Sequence[int]) -> str:
    """moe_gmm's route: "wgmma" when x and w are both bf16, D and F are
    multiples of 8 (16-byte row strides) and the bases are 16-byte
    aligned (what a TMA tensor map can express); "simt" for everything
    else (f32, mixed types, unaligned widths)."""
    if x_dtype == w_dtype == torch.bfloat16 and D % 8 == 0 and F % 8 == 0 \
            and all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "simt"


def gmm_row_tile(C: int) -> int:
    """Output rows per block of moe_gmm's CUDA-core route: 16 up to
    C=32, 128 above.  A block computes its whole row tile whatever C is,
    so a tile much taller than C spends FMAs on nothing (the decode
    capacity, C=8, is bound by the bytes of w), while each block row
    reads all of w again (from L2: the row tile is the grid's fastest
    axis) and the 16-row tile runs its FMAs at a lower rate.  One block
    row of 128 takes 2.25 times as long as one of 16 (jamba's E=16,
    D=4096, F=14336, f32, on an H100: scripts/simt_timings.py --tiles;
    the times are in PERF.md), so up to two 16-row block rows, C <= 32,
    beat one of 128, and from C=33 on the 128-row tile takes less
    time."""
    return 16 if C <= 32 else 128


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-expert product x (E,C,D) @ w (E,D,F) -> (E,C,F) with f32
    accumulation, in x's dtype.  x and w are each f32 or bf16; any C, D
    and F (ragged tiles are masked in the kernel, nothing is padded)."""
    op = "moe_gmm"
    _check_stream(op, "x", x, 3, x.device)
    _check_stream(op, "w", w, 3, x.device)
    E, C, D = x.shape
    F = w.shape[2]
    if tuple(w.shape[:2]) != (E, D):
        raise ValueError(f"{op}: x {tuple(x.shape)} vs w {tuple(w.shape)}: "
                         "expected w (E, D, F)")
    if not _on_card(x, op):
        return ref.moe_gmm_ref(x, w)
    if E > 65535 or -(-F // 128) > 65535:
        raise ValueError(f"{op}: {E} experts of {F} columns exceed the grid")
    from repro_torch.kernels.build import library
    o = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    route = _pick(op, gmm_route(x.dtype, w.dtype, D, F,
                                [x.data_ptr(), w.data_ptr(), o.data_ptr()]))
    if route == "wgmma":
        err = library().moe_gmm_wgmma(x.data_ptr(), w.data_ptr(),
                                      o.data_ptr(), E, C, D, F, _stream(x))
    else:
        err = library().moe_gmm(x.data_ptr(), w.data_ptr(), o.data_ptr(),
                                _is_bf16(x), _is_bf16(w), E, C, D, F,
                                gmm_row_tile(C), _stream(x))
    _raise_on(err, op)
    LAUNCHES[op] += 1
    ROUTES[f"{op}.{route}"] += 1
    return o


_MAX_STATE = 32              # a thread keeps a channel's N states (padded)
_SCAN_TILE = 32              # the kernel's time tile: segments are whole tiles
# (b, channel) threads from which S stays whole: 4 warps on each of 128
# SMs; below it S is cut until there are _SCAN_THREADS threads
_SCAN_WHOLE = 4 * 32 * 128
_SCAN_THREADS = 16 * 32 * 128


def scan_segment_len(B: int, S: int, di: int) -> int:
    """Steps per segment of mamba_scan's sequence (a multiple of the
    32-step tile).  One thread scans one (batch, channel, segment), and
    each segment after the first costs a fix-up pass as long as the scan
    (its entering state's share of y: one exp per state and step).  So
    S stays whole from ``_SCAN_WHOLE`` (b, channel) pairs on, where the
    card is already busy (jamba at B=2: 1.22-1.36 ms whole, 1.72-2.03 ms
    in 2-16 segments), and is cut into ``_SCAN_THREADS / (B * di)``
    segments below it, where one thread per channel leaves the card
    waiting (B=1: 1.35 ms whole, 1.01-1.11 ms in 8-9 segments; NVIDIA
    H100 80GB HBM3, 700 W)."""
    if B * di >= _SCAN_WHOLE:
        segments = 1
    else:
        segments = -(-_SCAN_THREADS // max(1, B * di))
    tiles = -(-S // _SCAN_TILE)
    return _SCAN_TILE * max(1, -(-tiles // segments))


def mamba_scan(xc: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
               cm: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Selective scan from a zero state: xc/dt (B,S,di), bm/cm (B,S,N),
    a (di,N) f32 -> y (B,S,di) in xc's dtype (before the gate and the D
    skip).  Each stream is f32 or bf16 on its own; N <= 32."""
    op = "mamba_scan"
    for name, t in (("xc", xc), ("dt", dt), ("bm", bm), ("cm", cm)):
        _check_stream(op, name, t, 3, xc.device)
    B, S, di = xc.shape
    N = bm.shape[2]
    if tuple(dt.shape) != (B, S, di) or tuple(bm.shape) != (B, S, N) or \
            tuple(cm.shape) != (B, S, N):
        raise ValueError(f"{op}: shapes xc {tuple(xc.shape)} dt "
                         f"{tuple(dt.shape)} bm {tuple(bm.shape)} cm "
                         f"{tuple(cm.shape)}")
    _check(f"{op} a", a, torch.float32, (di, N), xc.device)
    if not 1 <= N <= _MAX_STATE:
        raise ValueError(f"{op}: state size {N}; the kernel takes 1 to "
                         f"{_MAX_STATE}")
    if not _on_card(xc, op):
        return ref.mamba_scan_ref(xc, dt, bm, cm, a)
    if B > 65535:
        raise ValueError(f"{op}: batch {B} exceeds the grid")
    from repro_torch.kernels.build import library
    y = torch.empty((B, S, di), dtype=xc.dtype, device=xc.device)
    types = sum(_is_bf16(t) << i for i, t in enumerate((xc, dt, bm, cm)))
    seg_len = scan_segment_len(B, S, di)
    segments = -(-S // seg_len)
    padded = 8 if N <= 8 else 16 if N <= 16 else 32
    # h and sum(dt) at each segment's end, for the fix-up of the next ones
    carry = torch.empty((B, segments, padded + 1, di), dtype=torch.float32,
                        device=xc.device) if segments > 1 else None
    _raise_on(library().mamba_scan(
        xc.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
        a.data_ptr(), y.data_ptr(), 0 if carry is None else carry.data_ptr(),
        types, B, S, di, N, seg_len, _stream(xc)), op)
    LAUNCHES[op] += 1
    return y


# -- mLSTM chunkwise recurrence ----------------------------------------------

# q . n0 reads n entering the chunk from shared memory beside the CUDA-core
# route's tiles; 512 is xlstm-350m's head, the widest the kernels are held to
_MAX_DQK = 512
_MAX_CHUNK = 128         # rows of the kernel's intra-chunk product


def mlstm_route(dtypes: Sequence[torch.dtype], dqk: int, dv: int,
                strides: Sequence[int], ptrs: Sequence[int]) -> str:
    """mlstm_chunk's route: "wgmma" when q, k and v (``dtypes``) are all
    bf16, dqk and dv are multiples of 16, the element strides of q, k, v
    and o (the 12 (batch, head, step) strides passed to the kernel) are
    multiples of 8 and their bases 16-byte aligned (what the TMA maps of
    the two-phase tensor-core kernel can express); "simt" for everything
    else (f32, whose 5e-4 gate leaves no room for bf16 operands, other
    widths, odd strides).  The gates may be f32 or bf16 on either route."""
    if all(dt == torch.bfloat16 for dt in dtypes) and dqk % 16 == 0 and \
            dv % 16 == 0 and all(st % 8 == 0 for st in strides) and \
            all(p % 16 == 0 for p in ptrs):
        return "wgmma"
    return "simt"


def _check_mlstm(op: str, q, k, v, logi, logf, rank: int) -> None:
    """q/k (..., S, dqk) and v (..., S, dv) with equal leading dims,
    gates one value a row; every stream f32 or bf16 on q's device.  The
    kernel reads rows through strides, so nothing need be contiguous."""
    for name, t, r in (("q", q, rank), ("k", k, rank), ("v", v, rank),
                       ("logi", logi, 3), ("logf", logf, 3)):
        _check_stream(op, name, t, r, q.device, contiguous=False)
    lead = tuple(q.shape[:-1])
    gate = lead if rank == 4 else lead + (1,)
    if tuple(k.shape) != tuple(q.shape) or tuple(v.shape[:-1]) != lead or \
            tuple(logi.shape) != gate or tuple(logf.shape) != gate:
        raise ValueError(f"{op}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} logi "
                         f"{tuple(logi.shape)} logf {tuple(logf.shape)}")
    if q.shape[-1] < 1 or v.shape[-1] < 1:
        raise ValueError(f"{op}: empty head dims {q.shape[-1]} / "
                         f"{v.shape[-1]}")


def _launch_mlstm(q, k, v, logi, logf, o, strides, B, H, S, chunk) -> None:
    op = "mlstm_chunk"
    dqk, dv = q.shape[-1], v.shape[-1]
    if dqk > _MAX_DQK:
        raise ValueError(f"{op}: dqk {dqk}; the kernel takes up to "
                         f"{_MAX_DQK}")
    if B * H > 65535:
        raise ValueError(f"{op}: {B * H} (batch, head) rows exceed the grid")
    from repro_torch.kernels.build import library
    lib = library()
    # (batch, head, step) strides of q, k, v, then the gates', then o's
    tensor_strides = strides[:9] + strides[15:]
    route = _pick(op, mlstm_route(
        [q.dtype, k.dtype, v.dtype], dqk, dv, tensor_strides,
        [t.data_ptr() for t in (q, k, v, o)]))
    st = (ctypes.c_longlong * 18)(*strides)
    types = sum(_is_bf16(t) << i for i, t in enumerate((q, k, v, logi, logf)))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), logi.data_ptr(),
            logf.data_ptr(), o.data_ptr(), st, types, B, H, S, dqk, dv,
            chunk, dqk ** -0.5)
    size, launch = (lib.mlstm_chunk_wgmma_scratch, lib.mlstm_chunk_wgmma) \
        if route == "wgmma" else (lib.mlstm_chunk_scratch, lib.mlstm_chunk)
    # the gate factors and the state entering every chunk (C in bf16 on
    # the tensor cores, f32 on the CUDA cores; n in f32), carved by the
    # kernel from one 1024-byte-aligned block
    nbytes = size(B, H, S, dqk, dv, chunk)
    if nbytes < 0:
        raise ValueError(f"{op}: no scratch for B={B} H={H} S={S} "
                         f"dqk={dqk} dv={dv} chunk={chunk}")
    scratch = torch.empty(nbytes + 1024, dtype=torch.uint8, device=q.device)
    base = -scratch.data_ptr() % 1024 + scratch.data_ptr()
    _raise_on(launch(*args, base, _stream(q)), op)
    LAUNCHES[op] += 1
    MLSTM_ROUTES[f"{op}.{route}"] += 1


def mlstm_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logi: torch.Tensor, logf: torch.Tensor, *,
                block_s: int = 128) -> torch.Tensor:
    """The JAX package's signature: q/k (BH,S,dqk), v (BH,S,dv),
    logi/logf (BH,S,1) -> h (BH,S,dv) in q's dtype, the stabilized mLSTM
    from a zero state.  S must be a multiple of min(block_s, S), as the
    JAX wrapper asserts; the kernel runs chunks of min(block_s, S, 128)
    steps (the chunk size changes only the rounding).  On the card
    ``mlstm_route`` picks the route of the two-phase kernel: the tensor
    cores for bf16 q/k/v, the CUDA cores otherwise."""
    op = "mlstm_chunk"
    _check_mlstm(op, q, k, v, logi, logf, 3)
    BH, S, _ = q.shape
    if block_s < 1 or S < 1:
        raise ValueError(f"{op}: block_s {block_s}, S {S}")
    bs = min(block_s, S)
    if S % bs:
        raise ValueError(f"{op}: S={S} is not a multiple of the chunk {bs}: "
                         "pad the sequence to a chunk multiple upstream")
    if not _on_card(q, op):
        return ref.mlstm_ref(q, k, v, logi, logf)
    q, k, v = _rows(q), _rows(k), _rows(v)
    o = torch.empty((BH, S, v.shape[2]), dtype=q.dtype, device=q.device)
    # (batch = BH, head = 1, step) strides
    strides = [x for t in (q, k, v, logi, logf, o)
               for x in (t.stride(0), 0, t.stride(1))]
    _launch_mlstm(q, k, v, logi, logf, o, strides, BH, 1, S,
                  min(bs, _MAX_CHUNK))
    return o


def mlstm_chunk_model(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logi: torch.Tensor, logf: torch.Tensor) -> torch.Tensor:
    """Model layout (the mLSTM's ``chunk_fn``): q/k (B,S,H,dqk), v
    (B,S,H,dv), logi/logf (B,S,H) -> h (B,S,H,dv) in q's dtype, from a
    zero state, for any S (the kernel masks a ragged last chunk).  The
    kernel reads the layout through strides: the model's transposed
    views go in without a copy."""
    op = "mlstm_chunk"
    _check_mlstm(op, q, k, v, logi, logf, 4)
    B, S, H, _ = q.shape
    if S < 1:
        raise ValueError(f"{op}: empty sequence")
    if not _on_card(q, op):
        return ref.mlstm_model_ref(q, k, v, logi, logf)
    q, k, v = _rows(q), _rows(k), _rows(v)
    o = torch.empty((B, S, H, v.shape[3]), dtype=q.dtype, device=q.device)
    strides = [x for t in (q, k, v, logi, logf, o)
               for x in (t.stride(0), t.stride(2), t.stride(1))]
    _launch_mlstm(q, k, v, logi, logf, o, strides, B, H, S, _MAX_CHUNK)
    return o
