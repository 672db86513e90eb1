"""Plain PyTorch versions of the campaign sweep's per-tick ops.

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

__all__ = ["campaign_alloc_ref", "campaign_preempt_ref",
           "campaign_match_ref", "campaign_advance_ref",
           "campaign_bill_ref"]

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
