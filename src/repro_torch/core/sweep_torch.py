"""Monte-Carlo campaign sweep on the card: B campaigns ticked in lock-step.

The PyTorch counterpart of the JAX package's compiled sweep engine
(``core/sweep_jax.py``).  Instances within a (lane, group,
progress-step) cell are exchangeable, so the state is how many
instances occupy each cell: ``idle``/``pdead`` counts per (lane, group),
``busy`` job counts per (lane, group, step), the CE queue as per-lane
checkpoint-level counts, and budgets and counters as lane columns.
Every tick is a fixed-shape sequence of integer reductions over those
planes, run eagerly as a Python loop over N ticks with the state in a
dict of device tensors.  The hot per-tick ops (preemption fan-out, the
queue->pilot matcher, progress advance, billing) go through the
wrappers in ``kernels/ops.py``: hand-written CUDA kernels for CUDA
tensors, their plain versions for CPU tensors.

**The planner.**  The spec timeline is compiled through the
``core/timeline.py`` registry into segments of constant control
parameters: the union of all lanes' event fire ticks.  Every
per-segment plane (rates, caps, outage, floor arming, workload level,
scale targets, data-plane gating) is baked ahead of the run by driving
:class:`TorchLaneOps` through the registry's own ``apply_op`` bodies,
once uncapped and once capped, so the tick loop only indexes
``plane[seg]``.  The budget-floor cap is the one data-dependent event
and is handled in the loop with ``capped`` / ``cap_pending`` flags.

**Randomness.**  Each lane draws its per-(tick, group) uniforms from
Philox-4x32-10 keyed by the lane's seed, counter (tick, group, 0, 0),
written in int64 tensor ops so CPU and GPU give the same bits and a
lane's draws do not depend on which other lanes share its batch.  The
``uniforms`` hook replaces those draws (a test feeds the JAX engine's
threefry uniforms through it).

**Equivalence tier: statistical.**  Like the JAX engine, this one is
held to the bit-identical batched engine by mean/p5/p95 bands, and fed
the JAX engine's uniforms it reproduces that engine's integer counters.
``events_fired`` is rebuilt after the run through the registry and
matches the other engines' records.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import timeline as timeline_registry
from repro_torch.core.spec import LEDGER_THRESHOLDS, CampaignSpec
from repro_torch.core.sweep_result import _Lane, _prepare
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, ref

__all__ = ["TorchLaneOps", "TorchSweepEngine", "philox_uniforms",
           "resolve_device", "run_torch_detailed", "run_torch"]

I32, F32 = torch.int32, torch.float32

#: a per-tick draw source: tick index -> [B, G] float32 uniforms
UniformHook = Callable[[int], object]


class TorchLaneOps:
    """One lane's :class:`~repro_torch.core.timeline.EngineOps` adapter
    over *planner* state (prices, caps, targets, floor arming) instead
    of a live fleet.  The segment splitter drives it through the
    registry's ``apply`` bodies to bake per-segment parameter planes,
    once with ``budget_capped=False`` and once ``=True``; the
    provenance pass drives it again to rebuild ``events_fired``."""

    budget_capped = False
    downscale_target = 0

    def __init__(self, spec: CampaignSpec, pairs,
                 budget_capped: bool = False):
        G = len(pairs)
        self.budget_capped = bool(budget_capped)
        self.downscale_target = int(spec.downscale_target)
        self.floor_fraction = float(spec.budget_floor_fraction)
        self.rate_base = np.array(
            [((p.spot_price_per_day if spec.spot
               else p.ondemand_price_per_day) / 24.0) for p, _ in pairs])
        self.price_scale = 1.0
        self.curve = np.ones(G)
        self.cap = np.array([r.capacity for _, r in pairs], dtype=np.int64)
        self.outage = False
        self.min_queue = int(spec.min_queue)
        self.min_queue_eff = int(spec.min_queue)
        # net scale target set during the current segment (None: keep)
        self.scale_n: Optional[int] = None
        self.g_provider = [p.name for p, _ in pairs]
        self._prov_groups = {}
        for g, name in enumerate(self.g_provider):
            self._prov_groups.setdefault(name, []).append(g)
        # data plane: per-group origin up/down for match gating, the
        # cumulative miss-bandwidth degrade factor, and flush edges
        self.origin_up = np.ones(G, dtype=bool)
        self.dp_degrade = np.ones(G)
        self.flush_edge = np.zeros(G, dtype=bool)
        self._dp_groups_by_base = {}
        for g, name in enumerate(self.g_provider):
            self._dp_groups_by_base.setdefault(
                name.split("/", 1)[0], []).append(g)
        self._dp_groups_by_base = {
            k: np.array(v, dtype=np.int64)
            for k, v in self._dp_groups_by_base.items()}

    def rate_h(self) -> np.ndarray:
        """Effective $/h per group: ``(base * shift scalar) * curve``."""
        return self.rate_base * self.price_scale * self.curve

    # -- EngineOps ---------------------------------------------------------
    def scale_to(self, n: int):
        self.scale_n = max(0, int(n))

    def deprovision_all(self):
        self.scale_n = 0

    def set_outage(self, on: bool):
        self.outage = bool(on)

    def scale_prices(self, factor: float):
        self.price_scale *= factor

    def set_price_factor(self, provider, factor: float):
        if provider is None:
            self.curve[:] = factor
        else:
            gs = self._prov_groups.get(provider)
            if gs is not None:          # unknown provider: no-op
                self.curve[gs] = factor

    def scale_capacity(self, factor: float):
        self.cap = np.maximum(1, (self.cap * factor).astype(np.int64))

    def arm_budget_floor(self, fraction: float, target: int):
        self.floor_fraction = float(fraction)
        self.downscale_target = int(target)

    def set_workload_factor(self, factor: float):
        self.min_queue_eff = int(self.min_queue * factor)

    def set_origin_outage(self, provider: str, on: bool):
        gs = self._dp_groups_by_base.get(str(provider).split("/", 1)[0])
        if gs is not None:
            self.origin_up[gs] = not bool(on)

    def degrade_origin(self, provider: str, factor: float):
        gs = self._dp_groups_by_base.get(str(provider).split("/", 1)[0])
        if gs is not None:
            self.dp_degrade[gs] *= float(factor)

    def flush_cache(self, provider: str):
        # a flush marks the provider's whole live population "virgin"
        # (next stage-in misses) at the segment start
        gs = self._dp_groups_by_base.get(str(provider).split("/", 1)[0])
        if gs is not None:
            self.flush_edge[gs] = True


# -- randomness ------------------------------------------------------------

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
    return (x0 >> 8).to(F32) * (1.0 / (1 << 24))


def _poisson(u: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Poisson(lam) quantile of the uniform draw ``u``: truncated
    inverse CDF for small lam, a rounded normal approximation above 8
    (the JAX engine's ``_poisson``, op for op)."""
    K = 24
    p = torch.exp(-torch.clamp(lam, max=30.0))
    cdf = p
    kk = (u > cdf).to(I32)
    for j in range(1, K):
        p = p * lam / j
        cdf = cdf + p
        kk = kk + (u > cdf).to(I32)
    z = torch.special.ndtri(torch.clamp(u, _U_LO, _U_HI))
    k_norm = torch.round(lam + torch.sqrt(torch.clamp(lam, min=0.0)) * z)
    return torch.where(lam > 8.0, torch.clamp(k_norm, min=0.0).to(I32), kk)


# f32-representable clip bounds (the values JAX's weak-typed
# ``clip(u, 1e-7, 1 - 1e-7)`` rounds to)
_U_LO = float(np.float32(1e-7))
_U_HI = float(np.float32(1.0 - 1e-7))


# -- the engine ------------------------------------------------------------

class TorchSweepEngine:
    """One lock-step batch of lanes (same batching key as the JAX
    package's engines).  The constructor is the planner: ``planes``
    (per-segment parameter planes) and ``consts`` (per-lane and
    per-group constants) are numpy arrays, keyed and shaped exactly as
    the JAX engine's.  :meth:`run` ticks them on ``device``."""

    def __init__(self, lanes: Sequence[_Lane], device=None,
                 use_kernels: bool = True):
        self.lanes = list(lanes)
        self.device = resolve_device(device)
        self.use_kernels = bool(use_kernels)
        B = len(self.lanes)
        ref_lane = self.lanes[0]
        pairs = ref_lane.pairs
        G = len(pairs)
        self.B, self.G = B, G
        self.dt = float(ref_lane.spec.dt_h)
        self.duration = float(ref_lane.spec.duration_h)

        # static per-group config (identical across lanes by batch key)
        self.g_provider = [p.name for p, _ in pairs]
        self.providers: List[str] = []
        for name in self.g_provider:
            if name not in self.providers:
                self.providers.append(name)
        self.Pn = len(self.providers)
        pi = np.array([self.providers.index(n) for n in self.g_provider])
        prov_onehot = np.zeros((G, self.Pn), np.float32)
        prov_onehot[np.arange(G), pi] = 1.0
        self.provider_tflops = {p.name: p.fp32_tflops for p, _r in pairs}
        self.homogeneous = all(t is None
                               for t in self.provider_tflops.values())
        g_pre_rate = np.array([r.preempt_rate_per_hour for _, r in pairs],
                              np.float32)
        g_pre_scale = np.array([r.preempt_scale_at_full for _, r in pairs],
                               np.float32)
        g_nat = np.array([p.nat_idle_timeout_s for p, _ in pairs])

        # the float tick walk of every engine
        times = []
        now = 0.0
        while now < self.duration:
            times.append(now)
            now += self.dt
        self.tick_times = np.array(times)
        N = len(times)
        self.N = N

        # compile timelines; segments = union of all lanes' fire ticks
        self._evs: List[List[tuple]] = []
        self._fts: List[np.ndarray] = []
        seg_set = {0}
        for ln in self.lanes:
            evs = timeline_registry.compile_timeline(ln.spec.timeline)
            ft = np.searchsorted(self.tick_times,
                                 np.array([e[0] for e in evs]), "left") \
                if evs else np.zeros(0, np.int64)
            self._evs.append(evs)
            self._fts.append(ft)
            seg_set.update(int(t) for t in ft if t < N)
        seg_ticks = np.array(sorted(seg_set), np.int64)
        n_seg = len(seg_ticks)
        seg_of_tick = (np.searchsorted(seg_ticks, np.arange(N), "right")
                       - 1).astype(np.int32)
        is_seg_start = np.zeros(N, bool)
        is_seg_start[seg_ticks] = True

        # drive the EngineOps adapter through every lane's events, once
        # uncapped and once capped, snapshotting planes per segment
        rate = np.zeros((n_seg, B, G), np.float32)
        cap = np.zeros((n_seg, B, G), np.int32)
        outage = np.zeros((n_seg, B), bool)
        floor = np.zeros((n_seg, B), np.float32)
        downscale = np.zeros((n_seg, B), np.int32)
        minq = np.zeros((n_seg, B), np.int32)
        n_unc = np.full((n_seg, B), -1, np.int32)
        n_cap = np.full((n_seg, B), -1, np.int32)
        origin_up = np.ones((n_seg, B, G), bool)
        dp_degrade_sbg = np.ones((n_seg, B, G))
        dp_flush_sbg = np.zeros((n_seg, B, G), bool)
        for b, ln in enumerate(self.lanes):
            ops_u = TorchLaneOps(ln.spec, ln.pairs, budget_capped=False)
            ops_c = TorchLaneOps(ln.spec, ln.pairs, budget_capped=True)
            by_tick: Dict[int, list] = {}
            for (t, kind, arg), ft in zip(self._evs[b], self._fts[b]):
                if ft < N:
                    by_tick.setdefault(int(ft), []).append((kind, arg))
            for s, st in enumerate(seg_ticks):
                ops_u.scale_n = None
                ops_c.scale_n = None
                ops_u.flush_edge[:] = False
                for kind, arg in by_tick.get(int(st), []):
                    timeline_registry.apply_op(ops_u, kind, arg, 0.0)
                    timeline_registry.apply_op(ops_c, kind, arg, 0.0)
                rate[s, b] = ops_u.rate_h()
                cap[s, b] = ops_u.cap
                outage[s, b] = ops_u.outage
                floor[s, b] = ops_u.floor_fraction
                downscale[s, b] = ops_u.downscale_target
                minq[s, b] = ops_u.min_queue_eff
                origin_up[s, b] = ops_u.origin_up
                dp_degrade_sbg[s, b] = ops_u.dp_degrade
                dp_flush_sbg[s, b] = ops_u.flush_edge
                if ops_u.scale_n is not None:
                    n_unc[s, b] = ops_u.scale_n
                if ops_c.scale_n is not None:
                    n_cap[s, b] = ops_c.scale_n
        self.planes = {"rate": rate, "cap": cap, "outage": outage,
                       "floor": floor, "downscale": downscale,
                       "minq": minq, "n_unc": n_unc, "n_cap": n_cap}
        self.seg_of_tick = seg_of_tick
        self.is_seg_start = is_seg_start

        # count-plane geometry: W progress steps (one per dt until the
        # job wall), L checkpoint levels, and the per-lane maps between
        # them (requeue level of a step; queue-drain start step)
        lease = np.array([ln.spec.lease_interval_s for ln in self.lanes])
        connected = lease[:, None] < g_nat[None, :]          # [B,G]
        nat_g = (~connected).astype(np.int32)
        self.nat_any = bool(nat_g.any())
        wall = np.array([ln.spec.job_wall_h for ln in self.lanes])
        ckpt = np.array([ln.spec.job_checkpoint_h for ln in self.lanes])
        self.L = L = max(1, int(np.max(np.floor(wall / ckpt)) + 1))
        wfin1 = np.maximum(
            0, np.ceil(wall / self.dt - 1e-9).astype(np.int64) - 1)
        self.W = W = int(wfin1.max()) + 1
        finmask = (np.arange(W)[None, :] >= wfin1[:, None]) \
            .astype(np.int32)                                # [B,W]
        lvl_of_w = np.minimum(np.floor(
            np.arange(W)[None, :] * self.dt / ckpt[:, None] + 1e-9)
            .astype(np.int64), L - 1)
        M_wl = np.zeros((B, W, L), np.float32)
        M_wl[np.arange(B)[:, None], np.arange(W)[None, :], lvl_of_w] = 1.0
        # queue drain order j: levels L-1..0 (highest checkpoint first),
        # then fresh (j = L) starting at step 0
        lev_of_j = np.concatenate([np.arange(L - 1, -1, -1), [0]])
        w0_of_j = np.minimum(np.rint(
            lev_of_j[None, :] * ckpt[:, None] / self.dt).astype(np.int64),
            W - 1)
        w0_of_j[:, L] = 0
        M_jw = np.zeros((B, L + 1, W), np.float32)
        M_jw[np.arange(B)[:, None], np.arange(L + 1)[None, :],
             w0_of_j] = 1.0

        # -- data plane: stage-in as a count-axis front extension.  A
        # matched job enters at ext position S_max + w0 - S and reaches
        # its old entry step after exactly S staging ticks.  Killed
        # staging cells requeue at the level of their position past
        # S_max: the same statistical approximation as the JAX engine.
        dp = ref_lane.spec.dataplane
        dp_size = float(ref_lane.spec.job_input_gb)
        origins_g = [dp.origin_for(n) if dp is not None else None
                     for n in self.g_provider]
        self.dp_active = dp is not None and bool(dp.origins)
        self.dp_staging = self.dp_active and dp_size > 0.0
        self.dp_base_g = [n.split("/", 1)[0] for n in self.g_provider]
        dp_has_g = np.array([o is not None for o in origins_g],
                            np.float32)
        r_g = np.array([o.cache_hit_rate if o else 0.0
                        for o in origins_g], np.float32)
        usd_miss_g = np.array(
            [dp_size * o.egress_usd_per_gb if o else 0.0
             for o in origins_g], np.float32)
        if self.dp_staging:
            def _ticks(gbps):
                # vectorized dataplane.stage_ticks (0 where gbps <= 0)
                gbps = np.asarray(gbps, np.float64)
                hours = dp_size * 8.0 / np.where(gbps > 0.0, gbps, 1.0) \
                    / 3600.0
                t = np.maximum(1, np.ceil(hours / self.dt - 1e-9)
                               .astype(np.int64))
                return np.where(gbps > 0.0, t, 0)

            bw_g = np.array([o.bandwidth_gbps if o else 0.0
                             for o in origins_g])
            hbw_g = np.array(
                [(o.cache_bandwidth_gbps if o.cache_bandwidth_gbps > 0.0
                  else o.bandwidth_gbps) if o else 0.0
                 for o in origins_g])
            S_hit = _ticks(hbw_g)                            # [G]
            S_miss = _ticks(bw_g[None, None, :] * dp_degrade_sbg) \
                .astype(np.int32)                            # [S,B,G]
            S_max = int(max(S_hit.max(), S_miss.max()))
            W_ext = W + S_max
            finmask = (np.arange(W_ext)[None, :]
                       >= S_max + wfin1[:, None]).astype(np.int32)
            lvl_of_ext = np.minimum(np.floor(np.clip(
                np.arange(W_ext)[None, :] - S_max, 0, None)
                * self.dt / ckpt[:, None] + 1e-9)
                .astype(np.int64), L - 1)
            M_wl = np.zeros((B, W_ext, L), np.float32)
            M_wl[np.arange(B)[:, None], np.arange(W_ext)[None, :],
                 lvl_of_ext] = 1.0
            bi = np.arange(B)[:, None, None]
            gi = np.arange(G)[None, :, None]
            ji = np.arange(L + 1)[None, None, :]
            pos_hit = S_max + w0_of_j[:, None, :] \
                - S_hit[None, :, None]                       # [B,G,L+1]
            E_hit = np.zeros((B, G, L + 1, W_ext), np.float32)
            E_hit[bi, gi, ji, pos_hit] = 1.0
            E_miss = np.zeros((n_seg, B, G, L + 1, W_ext), np.float32)
            for s in range(n_seg):
                pos_miss = S_max + w0_of_j[:, None, :] \
                    - S_miss[s][:, :, None]
                E_miss[s][bi, gi, ji, pos_miss] = 1.0
            self.planes["S_miss"] = S_miss
            self.planes["E_miss"] = E_miss
            self.planes["dp_flush"] = dp_flush_sbg
            # expected hit-credit loss when a pilot's rotation resets:
            # mean of frac(n*r) over n = 1..200 stage-ins
            n_ = np.arange(1, 201)[:, None]
            loss_g = np.where(
                r_g > 0.0,
                np.modf(n_ * r_g[None, :].astype(np.float64))[0].mean(0),
                0.0).astype(np.float32)
            dp_consts = {"dp_r_g": r_g, "dp_has_g": dp_has_g,
                         "dp_usd_miss_g": usd_miss_g,
                         "dp_loss_g": loss_g,
                         "S_hit_g": S_hit.astype(np.float32),
                         "E_hit": E_hit}
        else:
            dp_consts = {}
        if self.dp_active:
            self.planes["origin_up"] = origin_up

        self.consts = {
            "prov_onehot": prov_onehot,
            "pre_rate_g": g_pre_rate,
            "pre_scale_g": g_pre_scale,
            "nat_g": nat_g,
            "finmask_rg": np.repeat(finmask, G, axis=0),     # [B*G,W]
            "M_wl": M_wl,
            "M_jw": M_jw,
            "overhead": np.array([ln.spec.overhead_per_day
                                  for ln in self.lanes], np.float32),
            "budget": np.array([ln.spec.budget for ln in self.lanes],
                               np.float32),
            "dt": np.float32(self.dt),
            "seeds": np.array([ln.seed for ln in self.lanes], np.uint32),
            **dp_consts,
        }
        if not (self.consts["budget"] > 0).all():
            raise ValueError("sweep lanes need a budget")
        self.out: Optional[dict] = None

    # -- the tick loop -----------------------------------------------------
    def _tick_ops(self):
        """The four hot ops: the kernel wrappers, or (``use_kernels=
        False``) their plain versions on the same device."""
        onehot = self._k["prov_onehot"]
        if self.use_kernels:
            return (ops.campaign_preempt, ops.campaign_match,
                    ops.campaign_advance,
                    lambda live, rate: ops.campaign_bill(live, rate, onehot))
        return (ref.campaign_preempt_ref, ref.campaign_match_ref,
                ref.campaign_advance_ref,
                lambda live, rate: ref.campaign_bill_ref(live, rate, onehot))

    def _own_uniforms(self, block: int = 64) -> UniformHook:
        """Philox draws, generated ``block`` ticks at a time."""
        seeds = torch.as_tensor(self.consts["seeds"].astype(np.int64),
                                device=self.device)
        cache: Dict[int, torch.Tensor] = {}

        def hook(i: int) -> torch.Tensor:
            b0 = i - i % block
            if b0 not in cache:
                cache.clear()
                ticks = torch.arange(b0, min(b0 + block, self.N),
                                     dtype=torch.int64, device=self.device)
                cache[b0] = philox_uniforms(seeds, ticks, self.G)
            return cache[b0][i - b0]
        return hook

    def run(self, uniforms: Optional[UniformHook] = None
            ) -> "TorchSweepEngine":
        """Tick all N ticks on the engine's device; ``uniforms(i)``
        (-> [B, G] float32) replaces the engine's own draws."""
        # f32 products of counts up to ~4,000 must not round to TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = self.device
        self._p = {k: torch.as_tensor(np.asarray(v), device=dev)
                   for k, v in self.planes.items()}
        self._k = {k: torch.as_tensor(np.asarray(v), device=dev)
                   for k, v in self.consts.items()
                   if k not in ("dt", "seeds")}
        hook = uniforms if uniforms is not None else self._own_uniforms()
        self._ops = self._tick_ops()
        B, G, W, L, P = self.B, self.G, self.consts["M_wl"].shape[1], \
            self.L, self.Pn
        self._shape = (B, G, W, L)
        z_i = lambda *s: torch.zeros(s, dtype=I32, device=dev)  # noqa: E731
        z_f = lambda *s: torch.zeros(s, dtype=F32, device=dev)  # noqa: E731
        c = {"idle": z_i(B, G), "pdead": z_i(B, G), "busy": z_i(B, G, W),
             "target_g": z_i(B, G), "lv": z_i(B, L), "fresh_q": z_i(B),
             "spent": z_f(B), "by_prov": z_f(B, P), "infra": z_f(B),
             "fired": torch.zeros((B, len(LEDGER_THRESHOLDS)),
                                  dtype=torch.bool, device=dev),
             "capped": torch.zeros(B, dtype=torch.bool, device=dev),
             "cap_pending": torch.zeros(B, dtype=torch.bool, device=dev),
             "cap_tick": torch.full((B,), -1, dtype=I32, device=dev),
             "pre_ct": z_i(B), "nat_ct": z_i(B), "fin_ct": z_i(B),
             "accel": z_f(B), "busy_h": z_f(B), "busy_prov": z_f(B, P),
             "hit_acc": z_f(B, G), "virgin": z_f(B, G), "hits": z_f(B),
             "misses": z_f(B), "stage_t": z_f(B), "egress_g": z_f(B, G)}
        self._thresholds = torch.tensor(LEDGER_THRESHOLDS, dtype=F32,
                                        device=dev)
        oh = self._k["overhead"] * float(self.consts["dt"]) / 24.0
        self._overhead_tick = torch.where(oh > 0, oh, 0.0)
        for i in range(self.N):
            u = torch.as_tensor(hook(i), dtype=F32, device=dev)
            c = self._tick(c, i, int(self.seg_of_tick[i]),
                           bool(self.is_seg_start[i]), u)

        # settle the final interval: one more dt at last-segment rates
        dt = float(self.consts["dt"])
        live_final = c["idle"] + c["pdead"] + c["busy"].sum(2, dtype=I32)
        amt = live_final.to(F32) * self._p["rate"][-1] * dt
        c["spent"] = c["spent"] + amt.sum(1)
        c["by_prov"] = c["by_prov"] + amt @ self._k["prov_onehot"]
        c["live_g"] = live_final
        self.out = {k: v.cpu().numpy() for k, v in c.items()}
        return self

    def _requeue_levels(self, kb: torch.Tensor) -> torch.Tensor:
        # busy cells [B,G,W] -> checkpoint-level counts [B,L]
        return torch.matmul(kb.to(F32), self._k["M_wl"]).sum(1).to(I32)

    def _split_cells(self, idle, pdead, busy, k):
        # proportional fan-out of k removals per (lane, group) across
        # the group's occupancy cells (idle | pilot-dead | busy-at-w)
        B, G, W, _L = self._shape
        cells = torch.cat([idle[..., None], pdead[..., None], busy], dim=2)
        killed = self._ops[0](cells.view(B * G, W + 2),
                              k.reshape(B * G).contiguous()) \
            .view(B, G, W + 2)
        return killed[..., 0], killed[..., 1], killed[..., 2:]

    def _tick(self, c: dict, i: int, seg: int, is_start: bool,
              u: torch.Tensor) -> dict:
        """One tick of every lane; the phases mirror the JAX engine's
        scan step: events, kill to target, spawn, preemption, queue
        top-up, match, NAT drops, advance, billing, overhead, ledger
        thresholds, accumulation."""
        P, K = self._p, self._k
        B, G, W, L = self._shape
        _preempt, match_fn, advance_fn, bill_fn = self._ops
        dt = float(self.consts["dt"])
        dp_staging = self.dp_staging
        idle, pdead, busy = c["idle"], c["pdead"], c["busy"]
        cap_g = P["cap"][seg]                                # [B,G] i32
        rate_g = P["rate"][seg]                              # [B,G] f32
        live0 = idle + pdead + busy.sum(2, dtype=I32)        # [B,G] i32
        live_g = live0
        virgin = c["virgin"]
        if dp_staging and is_start:
            # a CacheFlush edge marks the flushed provider's whole live
            # population virgin (next stage-in misses)
            virgin = torch.where(P["dp_flush"][seg], live0.to(F32), virgin)

        # 1. events: the deferred budget cap first, then this segment's
        # net scale target (uncapped/capped pair)
        cume = cap_g.cumsum(1, dtype=I32) - cap_g

        def greedy(n):                                       # [B] -> [B,G]
            return torch.minimum(torch.clamp(n[:, None] - cume, min=0),
                                 cap_g)

        apply_cap = c["cap_pending"]
        target_g = torch.where(apply_cap[:, None],
                               greedy(P["downscale"][seg]), c["target_g"])
        cap_tick = torch.where(apply_cap, i, c["cap_tick"])
        if is_start:
            n_eff = torch.where(c["capped"], P["n_cap"][seg],
                                P["n_unc"][seg])
            target_g = torch.where((n_eff >= 0)[:, None],
                                   greedy(torch.clamp(n_eff, min=0)),
                                   target_g)

        # 2. kill down to target (event stops); busy kills requeue
        excess = torch.clamp(live_g - target_g, min=0)
        ki, kp, kb = self._split_cells(idle, pdead, busy, excess)
        idle, pdead, busy = idle - ki, pdead - kp, busy - kb
        pre_ct = c["pre_ct"] + kb.sum((1, 2), dtype=I32)
        lv = c["lv"] + self._requeue_levels(kb)
        live_g = live_g - ki - kp - kb.sum(2, dtype=I32)
        if dp_staging:                     # kills hit virgins pro rata
            virgin = virgin * live_g.to(F32) \
                / torch.clamp(live0.to(F32), min=1.0)

        # 3. spawn to min(target, capacity); fresh pilots arrive idle
        deficit = torch.clamp(torch.minimum(target_g, cap_g) - live_g,
                              min=0)
        idle = idle + deficit
        live_g = live_g + deficit
        if dp_staging:                     # fresh pilots stage cold
            virgin = virgin + deficit.to(F32)
            live_sp = live_g

        # 4. preemption: a Poisson total per (lane, group) from the
        # shared fleet hazard, fanned out across occupancy cells
        util = live_g.to(F32) / torch.clamp(cap_g, min=1).to(F32)
        hazard = K["pre_rate_g"][None, :] \
            * (1.0 + (K["pre_scale_g"][None, :] - 1.0) * util) * dt
        k_pre = _poisson(u, live_g.to(F32) * hazard)
        ki, kp, kb = self._split_cells(idle, pdead, busy, k_pre)
        idle, pdead, busy = idle - ki, pdead - kp, busy - kb
        pre_ct = pre_ct + kb.sum((1, 2), dtype=I32)
        lv = lv + self._requeue_levels(kb)
        live_g = live_g - ki - kp - kb.sum(2, dtype=I32)
        if dp_staging:
            virgin = virgin * live_g.to(F32) \
                / torch.clamp(live_sp.to(F32), min=1.0)

        # 5/6. top the CE queue up to the workload level
        ring_tot = lv.sum(1, dtype=I32)
        fresh_q = c["fresh_q"] + torch.clamp(
            P["minq"][seg] - (ring_tot + c["fresh_q"]), min=0)

        # 7. match k = min(idle, queued) jobs: the requeued ring drains
        # first (highest checkpoint level first), then fresh jobs; the
        # joint (group x queue-slice) pairing is the overlap of the two
        # cumulative partitions of [0, k).  Origin outages remove the
        # gated groups' idle pilots from the matcher's input.
        idle_m = idle * P["origin_up"][seg] if self.dp_active else idle
        idle_tot = idle_m.sum(1, dtype=I32)
        k = torch.minimum(idle_tot, ring_tot + fresh_q)
        k = torch.where(P["outage"][seg], 0, k)
        take_g = match_fn(idle_m, k)                         # [B,G]
        avail = torch.cat([lv.flip(1), fresh_q[:, None]], dim=1)
        cumq = avail.cumsum(1, dtype=I32)
        take_j = torch.minimum(torch.clamp(k[:, None] - (cumq - avail),
                                           min=0), avail)
        cA = take_g.cumsum(1, dtype=I32)
        cB = take_j.cumsum(1, dtype=I32)
        lo = torch.maximum((cA - take_g)[:, :, None],
                           (cB - take_j)[:, None, :])
        hi = torch.minimum(cA[:, :, None], cB[:, None, :])
        joint = torch.clamp(hi - lo, min=0).to(F32)          # [B,G,L+1]
        if dp_staging:
            # stage-in: the hit/miss split is the per-(lane, group)
            # fractional accumulator; a virgin pilot's first match
            # forfeits the expected hit credit dp_loss_g
            take_f = take_g.to(F32)
            first_f = torch.minimum(take_f, virgin)
            virgin = virgin - first_f
            acc = c["hit_acc"] + take_f * K["dp_r_g"][None, :] \
                - first_f * K["dp_loss_g"][None, :]
            th_f = torch.minimum(torch.clamp(torch.floor(acc), min=0.0),
                                 take_f)
            hit_acc = acc - th_f
            cumj = joint.cumsum(2)
            hit_j = torch.minimum(
                torch.clamp(th_f[:, :, None] - (cumj - joint), min=0.0),
                joint)
            miss_j = joint - hit_j
            inc = (hit_j[..., None] * K["E_hit"]).sum(2) \
                + (miss_j[..., None] * P["E_miss"][seg]).sum(2)
            busy = busy + inc.to(I32)
            has = K["dp_has_g"][None, :]
            miss_f = (take_f - th_f) * has
            hits = c["hits"] + (th_f * has).sum(1)
            misses = c["misses"] + miss_f.sum(1)
            stage_t = c["stage_t"] \
                + (th_f * K["S_hit_g"][None, :]
                   + (take_f - th_f) * P["S_miss"][seg].to(F32)).sum(1)
            # cache-miss egress, charged the tick the job matched
            eg_g = (take_f - th_f) * K["dp_usd_miss_g"][None, :]
            egress_g = c["egress_g"] + eg_g
        else:
            busy = busy + torch.matmul(joint, K["M_jw"]).to(I32)
            hit_acc, hits, misses = c["hit_acc"], c["hits"], c["misses"]
            stage_t, egress_g = c["stage_t"], c["egress_g"]
        idle = idle - take_g
        lv = lv - take_j[:, :L].flip(1)
        fresh_q = fresh_q - take_j[:, L]

        # 7.5 NAT drops: every busy pilot in a disconnected group
        # requeues its job (instance stays alive and billed, pilot dead)
        nat_ct = c["nat_ct"]
        if self.nat_any:
            drop = busy * K["nat_g"][:, :, None]
            cnt = drop.sum((1, 2), dtype=I32)
            lv = lv + self._requeue_levels(drop)
            nat_ct = nat_ct + cnt
            pre_ct = pre_ct + cnt
            busy = busy - drop
            pdead = pdead + drop.sum(2, dtype=I32)

        # 8. advance progress one dt step; finishes release the pilot
        adv, fin = advance_fn(busy.reshape(B * G, W), K["finmask_rg"])
        busy = adv.view(B, G, W)
        fin_g = fin.view(B, G)
        fin_ct = c["fin_ct"] + fin_g.sum(1, dtype=I32)
        idle = idle + fin_g

        # 9. bill the interval ending at this tick against the tick's
        # starting live set, at post-event rates
        spent_d, prov_d = bill_fn(live0, rate_g * (dt if i > 0 else 0.0))
        spent = c["spent"] + spent_d
        if dp_staging:
            spent = spent + eg_g.sum(1)
        by_prov = c["by_prov"] + prov_d

        # 10. flat infra overhead
        spent = spent + self._overhead_tick
        infra = c["infra"] + self._overhead_tick

        # 11. ledger alert thresholds -> budget-floor tripwire (the cap
        # itself applies at the next tick's event phase)
        budget = K["budget"]
        frac = torch.clamp(budget - spent, min=0.0) / budget
        cross = (frac[:, None] <= self._thresholds[None, :]) & ~c["fired"]
        newly = cross.any(1)
        fired = c["fired"] | cross
        trigger = newly & (frac <= P["floor"][seg]) & ~c["capped"]
        capped = c["capped"] | trigger

        # 12. accumulate GPU-time totals at end-of-tick occupancy
        busy_g = busy.sum(2, dtype=I32).to(F32)
        live_end = (idle + pdead).to(F32) + busy_g
        accel = c["accel"] + live_end.sum(1) * dt
        busy_h = c["busy_h"] + busy_g.sum(1) * dt
        busy_prov = c["busy_prov"] + (busy_g @ K["prov_onehot"]) * dt

        return {"idle": idle, "pdead": pdead, "busy": busy,
                "target_g": target_g, "lv": lv, "fresh_q": fresh_q,
                "spent": spent, "by_prov": by_prov, "infra": infra,
                "fired": fired, "capped": capped, "cap_pending": trigger,
                "cap_tick": cap_tick, "pre_ct": pre_ct,
                "nat_ct": nat_ct, "fin_ct": fin_ct, "accel": accel,
                "busy_h": busy_h, "busy_prov": busy_prov,
                "hit_acc": hit_acc, "hits": hits, "misses": misses,
                "stage_t": stage_t, "egress_g": egress_g,
                "virgin": virgin}

    # -- per-lane provenance + results ------------------------------------
    def lane_events(self, b: int) -> List[dict]:
        """Rebuild the lane's ``events_fired`` records through the
        registry's own ``apply_op`` bodies; the budget cap is inserted
        at the tick the run applied it."""
        ln = self.lanes[b]
        ops_b = TorchLaneOps(ln.spec, ln.pairs)
        cap_tick = int(self.out["cap_tick"][b]) if self.out is not None \
            else -1
        by_tick: Dict[int, list] = {}
        for (t, kind, arg), ft in zip(self._evs[b], self._fts[b]):
            if ft < self.N:
                by_tick.setdefault(int(ft), []).append((kind, arg))
        ticks = sorted(set(by_tick)
                       | ({cap_tick} if cap_tick >= 0 else set()))
        recs: List[dict] = []
        for ft in ticks:
            now = float(self.tick_times[ft])
            ops_b.budget_capped = 0 <= cap_tick <= ft
            if ft == cap_tick:
                recs.append(timeline_registry.apply_budget_cap(ops_b, now))
            for kind, arg in by_tick.get(ft, []):
                recs.append(timeline_registry.apply_op(ops_b, kind, arg,
                                                       now))
        return recs

    def lane_results(self, b: int) -> dict:
        """Summary totals with the other engines' ``results()`` keys,
        grouping and rounding."""
        out = self.out
        if out is None:
            raise RuntimeError("run() first")
        sc = self.lanes[b].spec
        busy_by_prov = {}
        for pidx, name in enumerate(self.providers):
            h = float(out["busy_prov"][b, pidx])
            if h > 0:
                busy_by_prov[name] = h
        if self.homogeneous:
            eflop = float(out["busy_h"][b]) * sc.accel_tflops * 1e12 / 1e18
        else:
            eflop = sum(
                h * (self.provider_tflops.get(name) or sc.accel_tflops)
                for name, h in busy_by_prov.items()) * 1e12 / 1e18
        spent = float(out["spent"][b])
        budget = float(self.consts["budget"][b])
        raw_by_prov: Dict[str, float] = {}
        for pidx, name in enumerate(self.providers):
            v = float(out["by_prov"][b, pidx])
            if v > 0:
                raw_by_prov[name] = v
        # egress lands under the BASE provider name, merged before
        # rounding
        for g, base in enumerate(self.dp_base_g):
            e = float(out["egress_g"][b, g])
            if e > 0:
                raw_by_prov[base] = raw_by_prov.get(base, 0.0) + e
        ledger_by_prov = {k: round(v, 2) for k, v in raw_by_prov.items()}
        infra = float(out["infra"][b])
        if infra > 0:
            ledger_by_prov["infra"] = round(infra, 2)
        by_provider: Dict[str, int] = {}
        for g, name in enumerate(self.g_provider):
            by_provider[name] = by_provider.get(name, 0) \
                + int(out["live_g"][b, g])
        accel = float(out["accel"][b])
        hits, misses = float(out["hits"][b]), float(out["misses"][b])
        return {
            "accel_hours": round(accel, 1),
            "accel_days": round(accel / 24.0, 1),
            "busy_hours": round(float(out["busy_h"][b]), 1),
            "busy_hours_by_provider": {
                k: round(v, 1) for k, v in sorted(busy_by_prov.items())},
            "eflop_hours_fp32": round(eflop, 3),
            "cost": round(spent, 2),
            "cost_per_accel_day": round(
                spent / max(accel / 24.0, 1e-9), 2),
            "preemptions": int(out["pre_ct"][b]),
            "nat_drops": int(out["nat_ct"][b]),
            "jobs_finished": int(out["fin_ct"][b]),
            "egress_usd": round(float(out["egress_g"][b].sum()), 2),
            "stagein_hours": round(float(out["stage_t"][b]) * self.dt, 1),
            "cache_hit_fraction": round(hits / (hits + misses), 4)
            if hits + misses else 0.0,
            "budget": {
                "total_spent": round(spent, 2),
                "by_provider": dict(sorted(ledger_by_prov.items())),
                "remaining": round(max(0.0, budget - spent), 2),
                "remaining_fraction": round(
                    max(0.0, budget - spent) / budget, 4),
                "overdraft": round(max(0.0, spent - budget), 2),
            },
            "by_provider": by_provider,
        }


def run_torch_detailed(
        lane_specs: Sequence[Tuple[CampaignSpec, int]], device=None,
        uniforms: Optional[Callable[[TorchSweepEngine], UniformHook]] = None,
        use_kernels: bool = True) -> List[Tuple[dict, List[dict]]]:
    """Run every (spec, seed) lane, batching by the structural key;
    returns per-lane ``(results, events_fired)`` in input order.
    ``uniforms``, if given, maps each engine batch to its draw hook
    (see :meth:`TorchSweepEngine.run`); ``use_kernels=False`` runs the
    plain versions of the tick ops on the same device."""
    dev = resolve_device(device)
    prepared = [_prepare(sc, seed) for sc, seed in lane_specs]
    batches: Dict[tuple, List[int]] = {}
    for i, (key, _lane) in enumerate(prepared):
        batches.setdefault(key, []).append(i)
    out: List[Optional[tuple]] = [None] * len(prepared)
    for idxs in batches.values():
        eng = TorchSweepEngine([prepared[i][1] for i in idxs], device=dev,
                               use_kernels=use_kernels)
        eng.run(uniforms(eng) if uniforms is not None else None)
        for j, i in enumerate(idxs):
            out[i] = (eng.lane_results(j), eng.lane_events(j))
    return out


def run_torch(lane_specs: Sequence[Tuple[CampaignSpec, int]], device=None,
              **kw) -> List[dict]:
    """Like :func:`run_torch_detailed`, results only."""
    return [res for res, _events in
            run_torch_detailed(lane_specs, device=device, **kw)]
