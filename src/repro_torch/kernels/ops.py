"""Wrappers for the campaign sweep's per-tick kernels.

Each wrapper checks dtype, shape, device and contiguity, then routes by
where its tensors lie: CPU tensors go to the plain version in ref.py,
CUDA tensors to the hand-written kernel in csrc/campaign_sweep.cu
(built at first use by build.py).  There is no fallback: a kernel that
fails to build or launch raises.  The kernel launches on PyTorch's
current stream; the wrapper allocates its outputs.

``LAUNCHES`` counts kernel launches per wrapper, and only those, so a
run can show that its main path went through the kernels.

  wrapper             kernel            replaces (JAX package)
  campaign_preempt    campaign_alloc    kernels/campaign_sweep.py:69
  campaign_match      campaign_alloc    kernels/campaign_sweep.py:76
  campaign_advance    campaign_advance  kernels/campaign_sweep.py:93
  campaign_bill       campaign_bill     kernels/campaign_sweep.py:117
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref

__all__ = ["LAUNCHES", "reset_launches", "campaign_preempt",
           "campaign_match", "campaign_advance", "campaign_bill"]

LAUNCHES: Dict[str, int] = {"campaign_preempt": 0, "campaign_match": 0,
                            "campaign_advance": 0, "campaign_bill": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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
