#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero with no result line):

  1. build   the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
             nvcc (sm_90a); print the build time and the card's name and
             power limit as ``nvidia-smi`` reports them;
  2. kernels each kernel against its plain PyTorch version on the card,
             at the main path's shapes plus adversarial allocator rows:
             allocator and advance exactly equal, bill within 1e-6
             relative; kernel and plain version timed with CUDA events;
  3. main    ``sweep(planning_grid(), range(17))`` at paper scale (1,020
             lanes x 1,344 ticks) on each route of the engine, on the
             same device and draws: "fused" (the default: one
             campaign_sweep launch), "ops" (the eager tick loop through
             the four per-op kernels, forced) and "plain"
             (use_kernels=False): every fused lane's integer counters,
             by_provider and events_fired equal both others', cost,
             accelerator hours and egress within 1e-5 relative; launch
             counts 1 on fused and 2N / N / N / N on ops; then the
             persistent kernel against its plain version on the grid's
             packed arguments (integers exact, f32 within 1e-6 relative)
             with its time per sweep and per tick, device time, plain
             version's time and bound; the fused run's planner / run /
             results split; then a planted case whose Poisson rates pass
             8 (the draw's normal branch), the same three routes;
  4. profile the device's busy share of a 24 h grid sweep at the same
             widths on the fused and the ops route (torch.profiler kernel
             time over wall time);
  5. data    the data-plane golden spec at 64 seeds, the same checks as 3;
  6. flash   the flash attention kernel against its plain version at the
             yi-9b shape (B=2, S=4096, H=32, Hkv=4, D=128, causal; and
             B=1, the f32 forward's) and the
             edge shapes of tests/test_kernels.py, plus q_offset and
             kv_len cases, in f32 (2e-5) and bf16 (2e-2) elementwise and
             by the worst query row's relative error (1e-5 / 1e-2), on
             each route that takes the case (bf16 with D = 64 / 128: the
             tensor-core "wgmma" route and the CUDA-core "simt" route,
             forced in turn; everything else: "simt"); per case and
             route the per-call time (CUDA events), device time
             (profiler), plain version's time,
             scaled_dot_product_attention's time (the library yardstick,
             never called by the port), the bound, the share of the
             bound and the ratio to SDPA;
  7. forward yi-9b at full width and depth (48 layers, random weights
             from the port's own init_params): forward_loss at B=2,
             S=4096 in bf16 and B=1, S=4096 in f32, each through the flash
             kernel (48 launches, all on the wgmma route in bf16 and on
             the simt route in f32) and through its plain version: finite
             loss within 2.0 of ln 64000, kernel vs plain within 1e-2
             (bf16) / 1e-4 (f32) relative; tokens/s; a profiled kernel
             forward in each type (device ms per flash launch on each
             route at the forward's own shape);
  8. serve   BatchServer(slots=4, max_len=128) on the same weights answers
             8 requests (prompts of 4-12 tokens, 16 new tokens each); every
             token below 64000; prefill logits == token-by-token decode
             logits within 1e-3 (f32); decode tokens/s;
  9. gmm     the moe_gmm kernel against its plain version at the
             jamba-v0.1-52b shapes (E=16, C=1280 and 640, D=4096 -> F=14336
             and back), the decode C=8 and an unaligned shape, f32 and
             bf16 (bf16 on both routes, as in 6): max |err| / max |plain|
             within 1e-5 (f32) / 1e-2 (bf16); per case and route the
             per-call, device, plain version's and torch.bmm's times (the
             library yardstick, never called by the port), the bound, the
             share of the bound and the ratio to torch.bmm; on the simt
             route the row tile ``ops.gmm_row_tile`` picked;
 10. scan    the mamba_scan kernel against its plain version at jamba's
             shapes (B=2 with the model's bf16/f32 stream mix, B=1 in
             f32; S=4096, di=8192, N=16) and the edge shapes of
             tests/test_kernels.py, the same criterion plus the worst
             (b, t) row's relative error over di (1e-5 / 1e-2), the same
             timings (no library call computes it), the byte bound and
             the special-function unit's floor (one exp per state
             update at 16 a clock per SM);
 11. hybrid the yi-9b weights freed, jamba-v0.1-52b at full width, one
             super-block deep (8 of 32 layers, random weights from the
             port's init_params): forward_loss at B=2, S=4096 in bf16 and
             B=1, S=4096 in f32, through the kernels (attention_impl=
             "pallas": flash 1, moe_gmm 12 and mamba_scan 7 launches, the
             first two on the wgmma route in bf16) and
             through the reference path: finite loss, kernels vs reference
             within 1e-2 (bf16) / 1e-4 (f32) relative; tokens/s, peak
             memory, a profiled bf16 forward on each path and a profiled
             f32 forward through the kernels (the CUDA-core routes);
 12. served  BatchServer(slots=4, max_len=128) on the jamba weights, f32,
             8 requests as in 8; the prefill-vs-decode check on a prompt
             whose MoE layers drop no token (drops counted, asserted 0);
 13. mlstm   the mlstm_chunk kernel against its plain version (the
             sequential mLSTM, computed once per case) at xlstm-350m's
             shapes (B=2, H=4, S=4096, dqk=dv=512 in the model layout,
             q/k/v bf16 with f32 gates; B=1 all f32), the edge shapes of
             tests/test_kernels.py in f32 and bf16 and a dv that is not a
             multiple of the kernel's tile, on each route that takes the
             case (bf16: the two-phase tensor-core "wgmma" route and the
             two-phase CUDA-core "simt" route, forced in turn, one launch
             each; f32: "simt"): elementwise within 5e-4 (f32) / 5e-2
             (bf16) absolute plus relative, and the worst (b, t, h) row's
             relative error over dv (MLSTM_ROW_TOL); the per-call, device
             (all of a call's CUDA kernels, and each of the three: gates,
             states, outputs) and plain version's times (the plain loop
             over S timed over 3 calls), the bound (no library call
             computes it) and the design's own state-scratch traffic (C
             entering every chunk written and read: bf16 on wgmma, f32 on
             simt);
 14. xlstm   the jamba weights freed, xlstm-350m at full width and depth
             (24 layers: 21 mLSTM + 3 sLSTM, 530.2 M f32 parameters, random
             from the port's init_params): forward_loss at B=2, S=4096 in
             bf16 and B=1, S=4096 in f32, through the kernel
             (attention_impl="pallas": 21 mlstm_chunk launches, all on the
             wgmma route in bf16 and on the simt route in f32) and through
             the chunked reference path: finite loss within 2.0 of ln
             50304, kernel vs reference within 1e-2 (bf16) / 1e-4 (f32)
             relative; tokens/s, peak memory, a profiled bf16 forward on
             each path and a profiled f32 forward through the kernel (its
             device busy time and the 21 simt launches);
 15. xserved BatchServer(slots=4, max_len=128) on the xlstm weights, f32,
             8 requests as in 8, and the prefill-vs-decode check;
 16. report  a ``{"kernels": [...]}`` line (each entry with its route,
             "cuda", and "cuda_route", the kernel's route on the main path:
             "wgmma" or "simt"; flash attention and moe_gmm have one entry
             per route, the simt one, "flash_attention.simt",
             "moe_gmm.simt" and "mlstm_chunk.simt", at the f32 forwards'
             shapes and launches; the four per-op campaign kernels with
             their launches on the ops route, and "campaign_sweep", the
             persistent kernel, with its time per sweep),
             the nvidia-smi line, and last
             ``{"ok": true, "device": {...}}``.

Device times are per wrapper call: a call that launches several CUDA
kernels (mlstm_chunk: three on either route; mamba_scan with its
sequence in segments: two) counts all of them.

Exits 2 without a card or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (data sheet)
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
SFU_PER_CLOCK_PER_SM = 16        # special-function unit results (exp)
SMS = 132
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
CU_SOURCE = "src/repro_torch/kernels/csrc/campaign_sweep.cu"
SWEEP_SOURCE = "src/repro_torch/kernels/csrc/campaign_sweep_fused.cu"
# the JAX engine's scan, whose step calls the four kernels of REPLACES
SWEEP_REPLACES = "src/repro/core/sweep_jax.py:236"
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {
    "campaign_preempt": "src/repro/kernels/campaign_sweep.py:69",
    "campaign_match": "src/repro/kernels/campaign_sweep.py:76",
    "campaign_advance": "src/repro/kernels/campaign_sweep.py:93",
    "campaign_bill": "src/repro/kernels/campaign_sweep.py:117",
}
FLASH_REPLACES = "src/repro/kernels/flash_attention.py:79"
GMM_SOURCE = "src/repro_torch/kernels/csrc/moe_gmm.cu"
GMM_REPLACES = "src/repro/kernels/moe_gmm.py:39"
SCAN_SOURCE = "src/repro_torch/kernels/csrc/mamba_scan.cu"
SCAN_REPLACES = "src/repro/kernels/mamba_scan.py:51"
MLSTM_SOURCE = "src/repro_torch/kernels/csrc/mlstm_chunk_wgmma.cu"
MLSTM_SIMT_SOURCE = "src/repro_torch/kernels/csrc/mlstm_chunk.cu"
MLSTM_REPLACES = "src/repro/kernels/mlstm_chunk.py:74"
INT_COUNTERS = ("preemptions", "jobs_finished", "nat_drops")
REL = 1e-5


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# -- phase 2: kernels against their plain versions -------------------------

def fma_flip_rows(rng, n: int, C: int):
    """Rows where one fused multiply-add would floor some cell of
    ``inc * s + 1e-3`` differently from two roundings."""
    found_c, found_k = [], []
    while len(found_c) < n:
        counts = rng.integers(0, 100000, (4096, C)).astype(np.int32)
        tot = counts.sum(1)
        k = rng.integers(1, np.maximum(tot, 1) + 1).astype(np.int32)
        s = k.astype(np.float32) / np.maximum(tot, 1).astype(np.float32)
        inc = np.cumsum(counts, 1).astype(np.float32)
        two = np.floor(inc * s[:, None] + np.float32(1e-3))
        fused = np.floor((inc.astype(np.float64) * s[:, None]
                          + np.float32(1e-3)).astype(np.float32))
        rows = np.nonzero((two != fused).any(1))[0]
        found_c.extend(counts[rows])
        found_k.extend(k[rows])
    return np.array(found_c[:n]), np.array(found_k[:n])


def alloc_inputs(rng, R: int, C: int, hi: int):
    """Random occupancy rows, then the allocator's edge cases: k = 0,
    k = total, k > total, empty rows, totals near 2**20, and FMA-flip
    rows."""
    counts = rng.integers(0, hi, (R, C)).astype(np.int32)
    k = rng.integers(0, 3 * hi, R).astype(np.int32)
    tot = counts.sum(1)
    k[0:8] = 0
    k[8:16] = tot[8:16]
    k[16:24] = tot[16:24] + 5
    counts[24:32] = 0
    counts[32:40] = rng.integers(0, 2 ** 20 // C, (8, C))
    k[32:40] = counts[32:40].sum(1) // 3
    fc, fk = fma_flip_rows(rng, 64, C)
    counts[40:104], k[40:104] = fc, fk
    return counts, k


def time_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean ms per call: CUDA events around ``iters`` back-to-back calls
    after a warm-up (the wrapper's host time is inside the window)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiled(fn):
    """Run ``fn`` under torch.profiler; returns its CUDA kernel
    averages (empty where the profiler sees no device activity)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]


def kernel_name(key: str) -> str:
    """A CUDA kernel's name from the profiler's demangled signature."""
    found = re.search(r"(\w+(?:<[^<>]*>)?)\(", key)
    return found.group(1) if found else key[:60]


def per_call_ms(hits) -> float:
    """Device ms per wrapper call from the profiler's averages of the
    CUDA kernels one call launches, each once: the sum over kernel names
    of each name's mean.  Short windows sometimes drop some launches'
    events, so a total over the calls made would undercount."""
    return sum(e.self_device_time_total / e.count for e in hits) / 1e3


def device_split(fn, kernel: str, calls: int = 50) -> dict:
    """Mean device time (ms) per call of ``fn`` in each CUDA kernel whose
    name contains ``kernel`` (a call may launch several), by kernel name,
    from the profiler trace of ``calls`` calls; empty where the trace has
    none."""
    def many():
        for _ in range(calls):
            fn()
    for attempt in range(2):
        # a short window sometimes comes back with no device events at
        # all; take a second window before calling it unmeasured
        seen = profiled(many)
        hits = [e for e in seen if kernel in e.key]
        if hits:
            break
        log(f"[profile] window {attempt + 1}: no {kernel} among "
            f"{len(seen)} device events")
    else:
        return {}
    split = {}
    for e in hits:
        name = kernel_name(e.key)
        split[name] = split.get(name, 0.0) + per_call_ms([e])
    if len(hits) > 1:                  # where a call's time goes
        log("[profile] per call: " + ", ".join(
            f"{name} {ms:.4f} ms" for name, ms in split.items()))
    return split


def device_ms(fn, kernel: str, calls: int = 50):
    """Mean device time (ms) per call of ``fn`` spent in the CUDA kernels
    whose names contain ``kernel`` (all of them), as ``device_split``
    finds them; None where the trace has none."""
    split = device_split(fn, kernel, calls)
    return sum(split.values()) if split else None


def bound(nbytes: int, flops: int, peak: float = FP32_FLOPS_PER_S):
    """The least time (ms) for the work, and which term bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernels(dev, shapes) -> dict:
    from repro_torch.kernels import ops, ref
    rng = np.random.default_rng(2021)
    out = {}
    B, G, W, P = shapes["B"], shapes["G"], shapes["W"], shapes["P"]
    R, C = B * G, W + 2

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for name, (rows, cols, hi) in {"campaign_preempt": (R, C, 300),
                                   "campaign_match": (B, G, 200)}.items():
        counts, k = alloc_inputs(rng, rows, cols, hi)
        c_d, k_d = cuda(counts), cuda(k)
        wrapper = getattr(ops, name)
        got = wrapper(c_d, k_d)
        want = ref.campaign_alloc_ref(c_d, k_d)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        if err != 0 or not torch.equal(got, want):
            fail(f"{name}: kernel differs from plain version "
                 f"(max abs err {err})")
        # rows sum to min(k, total) where f32 holds total * k / total
        # within the 1e-3 guard (the reference's own limit)
        small = c_d.sum(1) < 4096
        if not (got.sum(1) == torch.minimum(k_d, c_d.sum(1)))[small].all():
            fail(f"{name}: rows do not sum to min(k, total)")
        b, how = bound(nbytes(c_d, k_d, got), 8 * rows * cols + rows)
        out[name] = {"max_abs_err": float(err),
                     "ms": time_ms(lambda: wrapper(c_d, k_d)),
                     "plain_ms": time_ms(
                         lambda: ref.campaign_alloc_ref(c_d, k_d)),
                     "device_ms": device_ms(lambda: wrapper(c_d, k_d),
                                            "campaign_alloc_kernel"),
                     "bound_ms": b, "bound_by": how, "library_ms": None}

    busy = cuda(rng.integers(0, 300, (R, W)).astype(np.int32))
    wfin = rng.integers(W // 2, W, (R, 1))
    mask = cuda((np.arange(W)[None, :] >= wfin).astype(np.int32))
    adv, fin = ops.campaign_advance(busy, mask)
    adv_p, fin_p = ref.campaign_advance_ref(busy, mask)
    torch.cuda.synchronize()
    err = max(int((adv - adv_p).abs().max()), int((fin - fin_p).abs().max()))
    if err != 0:
        fail(f"campaign_advance: kernel differs (max abs err {err})")
    b, how = bound(nbytes(busy, mask, adv, fin), 3 * R * W)
    out["campaign_advance"] = {
        "max_abs_err": float(err),
        "ms": time_ms(lambda: ops.campaign_advance(busy, mask)),
        "plain_ms": time_ms(lambda: ref.campaign_advance_ref(busy, mask)),
        "device_ms": device_ms(lambda: ops.campaign_advance(busy, mask),
                               "campaign_advance_kernel"),
        "bound_ms": b, "bound_by": how, "library_ms": None}

    live = cuda(rng.integers(0, 500, (B, G)).astype(np.int32))
    rate = cuda((rng.uniform(0.1, 1.0, (B, G)) * 0.25).astype(np.float32))
    onehot = cuda(np.eye(P, dtype=np.float32)[np.arange(G) % P])
    spent, prov = ops.campaign_bill(live, rate, onehot)
    spent_p, prov_p = ref.campaign_bill_ref(live, rate, onehot)
    torch.cuda.synchronize()
    err = max(float((spent - spent_p).abs().max()),
              float((prov - prov_p).abs().max()))
    rel = max(float(((spent - spent_p).abs() / spent_p.abs()
                     .clamp(min=1e-30)).max()),
              float(((prov - prov_p).abs() / prov_p.abs()
                     .clamp(min=1e-30)).max()))
    if rel > 1e-6:
        fail(f"campaign_bill: kernel differs by {rel} relative")
    b, how = bound(nbytes(live, rate, onehot, spent, prov),
                   B * G * (2 + 3 * P))
    out["campaign_bill"] = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.campaign_bill(live, rate, onehot)),
        "plain_ms": time_ms(
            lambda: ref.campaign_bill_ref(live, rate, onehot)),
        "device_ms": device_ms(lambda: ops.campaign_bill(live, rate, onehot),
                               "campaign_bill_kernel"),
        "bound_ms": b, "bound_by": how, "library_ms": None}
    return out


# -- phases 3 and 4: a sweep on each route ---------------------------------

# the per-op wrappers' launches on the "ops" route, per tick
OPS_PER_TICK = {"campaign_preempt": 2, "campaign_match": 1,
                "campaign_advance": 1, "campaign_bill": 1}


def drive(label, specs, seeds):
    """One sweep on each route of the engine, same device and draws:
    "fused" (the default on the card: one campaign_sweep launch), "ops"
    (the eager tick loop through the per-op kernels, forced) and "plain"
    (use_kernels=False).  Launch counts are read around each kernel
    route's run; every fused lane is compared with both others."""
    from repro_torch.core.api import sweep
    from repro_torch.core.sweep_result import _prepare
    from repro_torch.kernels import ops

    keys = {repr(_prepare(s, 0)[0]) for s in specs}
    if len(keys) != 1:
        fail(f"{label}: specs span {len(keys)} engine batches, expected 1")
    n_ticks, now = 0, 0.0              # the engines' float tick walk
    while now < specs[0].duration_h:
        n_ticks, now = n_ticks + 1, now + specs[0].dt_h
    lanes = len(specs) * len(seeds)
    zero = {name: 0 for name in ops.LAUNCHES}

    def run(route):
        ops.reset_launches()
        split = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "plain":
            res = sweep(specs, seeds, use_kernels=False, timings=split)
        else:
            with ops._force_route("campaign_sweep", route):
                res = sweep(specs, seeds, timings=split)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, dict(ops.LAUNCHES),
                dict(ops.SWEEP_ROUTES), split)

    got, t_fused, launches, routes, split = run("fused")
    if launches != {**zero, "campaign_sweep": 1} or \
            routes != {"campaign_sweep.fused": 1, "campaign_sweep.ops": 0}:
        fail(f"{label} fused: launches {launches}, routes {routes}; "
             "expected one campaign_sweep launch and no per-op launch")
    by_ops, t_ops, launches_ops, routes_ops, _ = run("ops")
    expect = {**zero, **{k: n * n_ticks for k, n in OPS_PER_TICK.items()}}
    if launches_ops != expect or routes_ops["campaign_sweep.ops"] != 1:
        fail(f"{label} ops: launches {launches_ops}, expected {expect}")
    plain, t_plain, launches_plain, _, _ = run("plain")
    if any(launches_plain.values()):
        fail(f"{label} plain: launches {launches_plain}")

    if len(got.rows) != lanes:
        fail(f"{label}: {len(got.rows)} rows for {lanes} lanes")
    for other, name in ((by_ops, "ops"), (plain, "plain")):
        for a, b in zip(got.rows, other.rows):
            lane = (a["scenario"], a["seed"])
            for k in INT_COUNTERS:
                if a[k] != b[k]:
                    fail(f"{label} {lane}: {k} {a[k]} != {name} {b[k]}")
            if a["by_provider"] != b["by_provider"]:
                fail(f"{label} {lane}: by_provider differs from {name}")
            if a["events_fired"] != b["events_fired"]:
                fail(f"{label} {lane}: events_fired differs from {name}")
            for k in ("cost", "accel_hours", "egress_usd"):
                if not math.isfinite(a[k]) or \
                        abs(a[k] - b[k]) > REL * max(abs(b[k]), 1.0):
                    fail(f"{label} {lane}: {k} {a[k]} vs {name} {b[k]}")
    for a in got.rows:
        if not (a["cost"] > 0 and a["accel_hours"] > 0
                and a["jobs_finished"] > 0):
            fail(f"{label} {(a['scenario'], a['seed'])}: empty campaign {a}")
    costs = [r["cost"] for r in got.rows]

    def rate(t):
        return (f"{t:.3f} s ({lanes / t:.1f} campaigns/s, "
                f"{1e3 * t / n_ticks:.3f} ms/tick)")
    log(f"[{label}] {lanes} lanes x {n_ticks} ticks: fused {rate(t_fused)}; "
        f"ops {rate(t_ops)}; plain {rate(t_plain)}; cost "
        f"${min(costs):,.0f}..${max(costs):,.0f}; fused launches "
        f"{launches['campaign_sweep']}, ops launches "
        f"{ {k: launches_ops[k] for k in OPS_PER_TICK} }")
    return {"lanes": lanes, "ticks": n_ticks, "fused_s": t_fused,
            "ops_s": t_ops, "plain_s": t_plain, "launches": launches,
            "launches_ops": launches_ops, "split": split}


def hot_spec():
    """A planted case whose Poisson rates pass 8, so the draw takes its
    rounded-normal branch (torch.special.ndtri), which the planning grid
    (rates up to ~0.3) never reaches: 600 live in one region at 0.3
    preemptions an hour, tripled at full use, a rate of 135 a tick."""
    from repro_torch.core.spec import (CampaignSpec, ProviderSpec,
                                       RegionSpec, SetTarget)
    hot = ProviderSpec(name="hot", accel="t4", spot_price_per_day=2.0,
                       ondemand_price_per_day=6.0,
                       regions=(RegionSpec("r1", 600, 0.3),
                                RegionSpec("r2", 400, 0.2)))
    return CampaignSpec(name="hot", providers=(hot,),
                        timeline=(SetTarget(0.0, 800),), duration_h=48.0)


# f32 operations of one (lane, tick, group) that every draw needs,
# whatever its count: util (1), hazard (4), lam (1), exp (1), the first
# CDF comparison (1), the bill's product and sum (2) and the advance's
# f32-free integer pass (0); a lower bound on the work, so the bound it
# gives is a least time
SWEEP_F32_OPS = 10


def check_sweep(dev, specs, seeds) -> dict:
    """The persistent sweep kernel against its plain version on the main
    grid's packed arguments: integer fields and flags exactly, f32 fields
    within 1e-6 relative; its time per sweep (CUDA events), device time
    (profiler), the plain version's time and the bound."""
    from repro_torch.core.sweep_result import _prepare
    from repro_torch.core.sweep_torch import TorchSweepEngine
    from repro_torch.kernels import ops, ref
    eng = TorchSweepEngine([_prepare(s, sd)[1] for s in specs for sd in seeds],
                           device=dev)
    args = eng.pack_args()
    kw = dict(dt=float(eng.consts["dt"]), nat_any=eng.nat_any,
              dp_active=eng.dp_active, dp_staging=eng.dp_staging)
    got = ops.campaign_sweep(args, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref.campaign_sweep_ref(args, **kw)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    err = 0.0
    for k, v in want.items():
        if v.dtype.is_floating_point:
            d = (got[k] - v).abs()
            err = max(err, float(d.max()))
            if float((d / v.abs().clamp(min=1e-30)).max()) > 1e-6:
                fail(f"campaign_sweep: {k} differs from the plain version")
        elif not torch.equal(got[k], v):
            fail(f"campaign_sweep: {k} differs from the plain version")
    nb = nbytes(*[t for t in args.values() if t is not None],
                *got.values())
    b, how = bound(nb, SWEEP_F32_OPS * eng.B * eng.N * eng.G)
    res = {"max_abs_err": err,
           "ms": time_ms(lambda: ops.campaign_sweep(args, **kw), iters=5,
                         warmup=1),
           "plain_ms": plain_ms,
           "device_ms": device_ms(lambda: ops.campaign_sweep(args, **kw),
                                  "campaign_sweep_kernel", calls=3),
           "bound_ms": b, "bound_by": how, "library_ms": None,
           "ticks": eng.N, "bytes": nb}
    dev_txt = "not measured" if res["device_ms"] is None \
        else f"{res['device_ms']:.3f} ms"
    log(f"[sweep kernel] {eng.B} lanes x {eng.N} ticks: exact integers, "
        f"f32 max abs err {err:.3g}; {res['ms']:.3f} ms per sweep "
        f"({1e3 * res['ms'] / eng.N:.2f} us per tick; device {dev_txt}); "
        f"plain {plain_ms:.1f} ms; bound {1e3 * b:.3f} us by {how} "
        f"({nb} bytes moved once); latency-bound by design")
    return res


def profile_window(specs, seeds, route) -> None:
    """Device busy share of a sweep on one route at main-path widths: the
    sum of CUDA kernel time in a profiled run over an unprofiled run's
    wall time (host clock, ended by a synchronize)."""
    from repro_torch.core.api import sweep
    from repro_torch.kernels import ops

    def run():
        with ops._force_route("campaign_sweep", route):
            sweep(specs, seeds)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern = profiled(run)
    if not kern:
        log(f"[profile {route}] device time not measured: the profiler "
            "trace holds no CUDA kernels")
        return
    busy_s = sum(e.self_device_time_total for e in kern) / 1e6
    n = sum(e.count for e in kern)
    ticks = round(specs[0].duration_h / specs[0].dt_h)
    log(f"[profile {route}] {len(specs) * len(seeds)} lanes x {ticks} "
        f"ticks: wall {wall:.3f} s, device busy {busy_s:.3f} s "
        f"({100 * busy_s / wall:.1f}% of wall), {n} kernel launches "
        f"({n / ticks:.2f} per tick, mean "
        f"{1e6 * busy_s / n:.2f} us device time each)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile {route}]   {e.self_device_time_total / 1e3:9.1f} ms "
            f"{e.count:7d}x  {e.key[:90]}")


# -- phase 6: the flash attention kernel against its plain version -------

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# the worst query row's |err| / |plain| (2-norms over the head dim): a
# check that scales with the output, which the elementwise gate above
# does not where |o| is ~0.03 (a row that averages thousands of keys); a
# dropped key tile or a row mis-scaled by 1/32 moves a row by more than
# 3e-2, sound bf16 rounding by a few 1e-3
FLASH_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (label, model layout?, shapes, kwargs); model layout: B, Sq, Skv, H,
# Hkv, D, causal; kernel layout: BHG, BKV, Sq, Skv, D and the keywords
FLASH_CASES = [
    ("yi-9b", True, (2, 4096, 4096, 32, 4, 128, True), {}),
    # the f32 forward's own shape (phase 7 runs f32 at B=1)
    ("yi-9b-b1", True, (1, 4096, 4096, 32, 4, 128, True), {}),
    ("d64-gqa", True, (2, 256, 256, 4, 2, 64, True), {}),
    ("mqa-noncausal", True, (1, 128, 384, 2, 1, 128, False), {}),
    ("d80-ragged", True, (2, 96, 160, 2, 2, 80, True), {}),
    ("q_offset", False, (64, 8, 512, 1536, 128),
     {"causal": True, "q_offset": 1024}),
    ("kv_len", False, (64, 8, 256, 1024, 128),
     {"causal": False, "kv_len": 700}),
]


def valid_pairs(Sq: int, Skv: int, causal: bool, kv_len=None,
                q_offset: int = 0) -> int:
    """(query, key) pairs the mask lets through: the work these inputs
    need (about half of Sq * Skv when causal)."""
    lim = Skv if kv_len is None else min(Skv, kv_len)
    if not causal:
        return Sq * lim
    i = np.arange(Sq)
    return int(np.clip(q_offset + i + 1, 0, lim).sum())


# the profiler's kernel name of each route (the CUDA-core kernels are
# templates: flash_attention_kernel<float, 128>, moe_gmm_kernel<float,
# float, 128>)
FLASH_KERNEL = {"wgmma": "flash_attention_kernel_wgmma",
                "simt": "flash_attention_kernel<"}
GMM_KERNEL = {"wgmma": "moe_gmm_kernel_wgmma", "simt": "moe_gmm_kernel<"}


def worst_row_err(got, want) -> float:
    """max over query rows of ||got - want|| / ||want||, the norms over
    the last (head) dim; rows of zeros in want count their error alone."""
    diff = (got.float() - want.float()).square_().sum(-1).sqrt_()
    norm = want.float().square().sum(-1).sqrt_().clamp_min_(1e-30)
    return float((diff / norm).max())


def check_flash(dev) -> dict:
    """Every case in f32 and bf16, on each route that takes it: kernel vs
    plain version within the tolerance, then the timings.  Returns
    {(label, dtype, route): numbers}."""
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(12)
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        for label, model, shape, kw in FLASH_CASES:
            if model:
                B, Sq, Skv, H, Hkv, D, causal = shape
                q_shape, kv_shape = (B, Sq, H, D), (B, Skv, Hkv, D)
            else:
                BHG, BKV, Sq, Skv, D = shape
                q_shape, kv_shape = (BHG, Sq, D), (BKV, Skv, D)
                B, H, Hkv, causal = BKV, BHG // BKV, 1, kw["causal"]
            q, k, v = (torch.randn(s, generator=gen, device=dev).to(dtype)
                       for s in (q_shape, kv_shape, kv_shape))
            if model:
                def kern():
                    return ops.flash_attention(q, k, v, causal=causal)

                def plain():
                    return ref.flash_attention_model_ref(q, k, v,
                                                         causal=causal)
                qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
                mask = None
            else:
                def kern():
                    return ops.flash_attention_kernel(q, k, v, **kw)

                def plain():
                    return ref.flash_attention_ref(q, k, v, **kw)
                qs = q.reshape(B, H, Sq, D)
                ks, vs = k[:, None], v[:, None]
                kpos = torch.arange(Skv, device=dev)
                mask = kpos[None, :] < kw.get("kv_len", Skv)
                if causal:
                    mask = mask & (kw.get("q_offset", 0)
                                   + torch.arange(Sq, device=dev)[:, None]
                                   >= kpos[None, :])

            def library():
                if mask is None:
                    return F.scaled_dot_product_attention(
                        qs, ks, vs, is_causal=causal, enable_gqa=True)
                return F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)

            # the inputs are contiguous: the rule rests on dtype and D
            rule = ops.flash_route(dtype, D, [0], [0])
            routes = ("wgmma", "simt") if rule == "wgmma" else ("simt",)
            want = plain()
            big = Sq * Skv * B * H >= 2 ** 28
            iters, warm = (5, 2) if big else (50, 5)
            pairs = valid_pairs(Sq, Skv, causal, kw.get("kv_len"),
                                kw.get("q_offset", 0))
            flops = 4 * B * H * pairs * D
            moved = nbytes(q, k, v) + q.numel() * q.element_size()
            b, how = bound(moved, flops, BF16_FLOPS_PER_S
                           if dtype == torch.bfloat16 else FP32_FLOPS_PER_S)
            plain_ms = time_ms(plain, iters, warm)
            library_ms = time_ms(library, iters, warm)
            tol, row_tol = FLASH_TOL[dtype], FLASH_ROW_TOL[dtype]
            for route in routes:
                with ops._force_route("flash_attention", route):
                    before = ops.ROUTES[f"flash_attention.{route}"]
                    got = kern()
                    torch.cuda.synchronize()
                    if ops.ROUTES[f"flash_attention.{route}"] != before + 1:
                        fail(f"flash {label} {dtype}: no launch on the "
                             f"{route} route")
                    if not torch.isfinite(got.float()).all():
                        fail(f"flash {label} {dtype} {route}: non-finite "
                             "output")
                    diff = (got.float() - want.float()).abs()
                    err = float(diff.max())
                    far = bool((diff > tol + tol * want.float().abs()).any())
                    del diff
                    row = worst_row_err(got, want)
                    if far or row > row_tol:
                        fail(f"flash {label} {dtype} {route}: kernel "
                             f"differs from plain version (elementwise "
                             f"gate {'failed' if far else 'passed'}: max "
                             f"abs err {err}, tolerance {tol} + {tol} "
                             f"|plain|; worst row {row}, tolerance "
                             f"{row_tol})")
                    del got
                    res = {"max_abs_err": err, "worst_row_err": row,
                           "ms": time_ms(kern, iters, warm),
                           "plain_ms": plain_ms, "library_ms": library_ms,
                           "device_ms": device_ms(kern, FLASH_KERNEL[route],
                                                  calls=8 if big else 20),
                           "bound_ms": b, "bound_by": how,
                           "bound_bytes_ms": moved / HBM_BYTES_PER_S * 1e3,
                           "flops": flops}
                out[(label, dtype, route)] = res
                dev_ms = "not measured" if res["device_ms"] is None \
                    else f"{res['device_ms']:.4f} ms"
                log(f"[flash] {label} {str(dtype)[6:]} q{q_shape} "
                    f"kv{kv_shape} {kw or ''}: {route} route, max abs err "
                    f"{err:.3g} (tol {tol}), worst row {row:.3g} (tol "
                    f"{row_tol}); kernel {res['ms']:.4f} ms "
                    f"(device {dev_ms}), plain {plain_ms:.4f} ms, sdpa "
                    f"{library_ms:.4f} ms; bound {b:.4f} ms by {how} "
                    f"({flops / 1e9:.2f} GFLOP, bytes term "
                    f"{res['bound_bytes_ms']:.4f} ms); kernel at "
                    f"{flops / res['ms'] / 1e9:.2f} TFLOP/s, "
                    f"{100 * b / res['ms']:.1f}% of the bound, "
                    f"{res['ms'] / library_ms:.3f}x sdpa")
            del want
            torch.cuda.empty_cache()
    return out


# -- phases 7 and 8: the yi-9b model path --------------------------------

def forward_phase(params, cfg, dev) -> dict:
    """forward_loss at full width and depth through the kernel and its
    plain version, in bf16 (B=2) and f32 (B=1)."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig
    from repro_torch.kernels import ops, ref
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss

    kernel_fn = _resolve_kernels(RunConfig(
        model=cfg, shape=REDUCED_SHAPE, attention_impl="pallas"))["flash_fn"]
    if kernel_fn is not ops.flash_attention:
        fail("forward: attention_impl='pallas' does not resolve to the "
             "CUDA flash kernel")
    rng = np.random.default_rng(2021)
    ln_v = math.log(cfg.vocab_size)
    out = {}
    for dtype, B, rel in ((torch.bfloat16, 2, 1e-2), (torch.float32, 1, 1e-4)):
        S = 4096
        tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tok[:, :-1]).to(dev),
                 "targets": torch.from_numpy(tok[:, 1:]).to(dev)}
        losses, secs = {}, {}
        for label, fn in (("kernel", kernel_fn),
                          ("plain", ref.flash_attention_model_ref)):
            forward_loss(params, cfg, batch, compute_dtype=dtype,
                         flash_fn=fn)                      # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            loss, _ = forward_loss(params, cfg, batch, compute_dtype=dtype,
                                   flash_fn=fn)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
            launches, routes = dict(ops.LAUNCHES), dict(ops.ROUTES)
            want = {name: 0 for name in launches}
            want["flash_attention"] = cfg.num_layers if label == "kernel" \
                else 0
            if launches != want:
                fail(f"forward {label} {dtype}: launches {launches}, "
                     f"expected {want}")
            route = "wgmma" if dtype == torch.bfloat16 else "simt"
            want_routes = {name: 0 for name in routes}
            want_routes[f"flash_attention.{route}"] = \
                want["flash_attention"]
            if routes != want_routes:
                fail(f"forward {label} {dtype}: routes {routes}, expected "
                     f"{want_routes}")
            losses[label] = float(loss)
            if not math.isfinite(losses[label]) or \
                    abs(losses[label] - ln_v) > 2.0:
                fail(f"forward {label} {dtype}: loss {losses[label]} not "
                     f"within 2.0 of ln {cfg.vocab_size} = {ln_v:.4f}")
            log(f"[forward] {cfg.name} {cfg.num_layers}L {str(dtype)[6:]} B={B} "
                f"S={S} via {label}: loss {losses[label]:.6f}, "
                f"{secs[label]:.3f} s ({B * S / secs[label]:.1f} tokens/s), "
                f"flash launches {launches['flash_attention']} "
                f"({ {k: n for k, n in routes.items() if n} }), peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
            if label == "kernel":
                # device time per launch inside the forward: the main
                # path's own shape and dtype (bf16 B=2 on the wgmma route,
                # f32 B=1 on the simt route)
                out[route] = {
                    "launches": launches["flash_attention"],
                    "device_ms": profile_forward(
                        lambda: forward_loss(params, cfg, batch,
                                             compute_dtype=dtype,
                                             flash_fn=fn),
                        secs[label], tag=f"forward {str(dtype)[6:]}")[
                            "flash_attention_kernel"]}
        d = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
        if d > rel:
            fail(f"forward {dtype}: kernel loss {losses['kernel']} vs plain "
                 f"{losses['plain']} ({d:.3g} relative > {rel})")
        out[str(dtype)] = {"losses": losses, "secs": secs, "rel": d}
        del batch
        torch.cuda.empty_cache()
    return out


def profile_forward(fn, wall: float, tag: str = "forward",
                    kernels=("flash_attention_kernel",)) -> dict:
    """Device time by kernel over one profiled forward, against the wall
    time of an unprofiled one; returns, for each name (matched inside the
    CUDA kernels' names), the device ms per wrapper call, all of a call's
    CUDA kernels together (None where the trace has none)."""
    kern = profiled(fn)
    if not kern:
        log(f"[{tag}] device time not measured: the profiler trace holds "
            "no CUDA kernels")
        return {name: None for name in kernels}
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    log(f"[{tag}] profile: device busy {busy:.3f} s of a {wall:.3f} s "
        f"forward ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in kern)} kernel launches")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[{tag}]   {e.self_device_time_total / 1e3:9.1f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    out = {}
    for name in kernels:
        hits = [e for e in kern if name in e.key]
        out[name] = per_call_ms(hits) if hits else None
    return out


def serve_phase(params, cfg, dev, tag: str = "serve") -> None:
    """BatchServer on the card: 8 requests, then prefill vs decode (with
    the MoE layers' capacity drops in the prefill counted: decode never
    drops, so a prefill that drops would differ by design)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import decode_step, init_cache, prefill
    from repro_torch.models import moe as moe_mod

    rng = np.random.default_rng(0)              # as launch/serve.py draws
    server = BatchServer(cfg, slots=4, max_len=128, params=params,
                         device=dev)
    for i in range(8):
        plen = int(rng.integers(4, 12))
        server.submit(Request(i, rng.integers(
            0, cfg.vocab_size, plen).astype(np.int32), 16))
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(r.id for r in done) != list(range(8)):
        fail(f"{tag}: {len(done)} of 8 requests finished")
    for r in done:
        if len(r.out) != 16 or not all(0 <= t < cfg.vocab_size
                                       for t in r.out):
            fail(f"{tag}: request {r.id} gave {r.out}")
    if any(ops.LAUNCHES.values()):
        fail(f"{tag}: decode launched kernels {ops.LAUNCHES}; it runs the "
             "reference path, as the JAX package's server does")
    toks = sum(len(r.out) for r in done)
    log(f"[{tag}] {cfg.name} f32 slots=4: 8 requests, {toks} tokens, "
        f"{server.steps} decode steps in {wall:.3f} s ({toks / wall:.1f} "
        f"tokens/s, {1e3 * wall / server.steps:.2f} ms per step)")

    # where a decode step's time goes: 8 steps of all 4 slots, profiled
    tokens = torch.zeros((4, 1), dtype=torch.int32, device=dev)

    def steps8():
        for t in range(8):
            decode_step(params, cfg, server.caches, tokens, 100 + t,
                        compute_dtype=torch.float32)
        torch.cuda.synchronize()
    steps8()
    t0 = time.perf_counter()
    steps8()
    step_ms = (time.perf_counter() - t0) / 8 * 1e3
    kern = profiled(steps8)
    if kern:
        busy = sum(e.self_device_time_total for e in kern) / 8 / 1e3
        log(f"[{tag}] profile: a decode step takes {step_ms:.2f} ms wall, "
            f"{busy:.2f} ms device busy ({100 * busy / step_ms:.1f}%), "
            f"{sum(e.count for e in kern) // 8} kernel launches")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"[{tag}]   {e.self_device_time_total / 8e3:8.2f} ms/step "
                f"{e.count // 8:5d}x  {e.key[:90]}")

    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, 8)).astype(np.int32)).to(dev)
    route, dropped = moe_mod._route, []

    def counting_route(*args, **kw):
        out = route(*args, **kw)
        dropped.append(int((~out[-1]).sum()))        # keep = pos < C
        return out
    moe_mod._route = counting_route
    try:
        pre, _ = prefill(params, cfg, {"tokens": prompt},
                         compute_dtype=torch.float32)
    finally:
        moe_mod._route = route
    n_moe = cfg.n_super * sum(f == "moe" for _, f in cfg.block_defs)
    if len(dropped) != n_moe or any(dropped):
        fail(f"{tag}: the prefill's MoE layers dropped {dropped} tokens "
             f"({n_moe} layers); the check needs a drop-free prompt")
    caches = init_cache(cfg, 1, 9, torch.float32, device=dev)
    for t in range(8):
        step, caches = decode_step(params, cfg, caches, prompt[:, t:t + 1], t,
                                   compute_dtype=torch.float32)
    vocab = cfg.vocab_size
    err = float((pre[..., :vocab] - step[..., :vocab]).abs().max())
    if not err <= 1e-3:
        fail(f"{tag}: prefill vs decode logits differ by {err} (> 1e-3)")
    log(f"[{tag}] prefill vs token-by-token decode, 8 tokens, f32: max abs "
        f"err {err:.3g} (tol 1e-3); MoE drops in the prefill "
        f"{sum(dropped)} over {n_moe} layers")


# -- phases 9 and 10: moe_gmm and mamba_scan against their plain versions ---

KERNEL_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
# (label, E, C, D, F): jamba-v0.1-52b's expert products at B*S = 8192
# (C = 1280) and 4096 (C = 640) tokens, the decode capacity (on the simt
# route the 16-row tile of ops.gmm_row_tile; the others take 128), unaligned
GMM_CASES = [("jamba-up-c1280", 16, 1280, 4096, 14336),
             ("jamba-down-c1280", 16, 1280, 14336, 4096),
             ("jamba-up-c640", 16, 640, 4096, 14336),
             ("jamba-down-c640", 16, 640, 14336, 4096),
             ("decode-c8", 16, 8, 4096, 14336),
             ("unaligned", 3, 72, 40, 56)]
# (label, B, S, di, N, stream dtypes xc / dt / bm / cm or None for all
# in the case's dtype): jamba's mixers at B=2 bf16 and B=1 f32, and the
# edge shapes of tests/test_kernels.py
BF, F32 = torch.bfloat16, torch.float32
SCAN_CASES = [("jamba-b2-model", 2, 4096, 8192, 16, (BF, F32, BF, F32)),
              ("jamba-b1-f32", 1, 4096, 8192, 16, (F32,) * 4),
              ("edge-1x64x32x8", 1, 64, 32, 8, None),
              ("edge-2x128x64x16", 2, 128, 64, 16, None),
              ("edge-1x96x48x8", 1, 96, 48, 8, None)]


# the worst (b, t) row's ||err|| / ||plain|| over di, beside the global
# gate: a fault in one late segment or tile moves whole rows; sound rows
# read at most ~1e-6 in f32 and ~6e-3 in bf16 (y rounded, twice where a
# fix-up adds a segment's entering state) on an NVIDIA H100 80GB HBM3 at
# 700 W
SCAN_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def sm_clock_hz() -> float:
    """The card's highest SM clock, as nvidia-smi reports it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def rel_err(got, want) -> float:
    """max |kernel - plain| / max |plain|: the sums run in another order
    than the plain version's, so the error scales with the largest
    output."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def check_gmm(dev) -> dict:
    """Every case in f32 and bf16, on each route that takes it; returns
    {(label, dtype, route): numbers}."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(13)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        for label, E, C, D, F in GMM_CASES:
            x = torch.randn((E, C, D), generator=gen, device=dev).to(dtype)
            w = (torch.randn((E, D, F), generator=gen, device=dev)
                 * D ** -0.5).to(dtype)

            def kern():
                return ops.moe_gmm(x, w)

            def plain():
                return ref.moe_gmm_ref(x, w)

            def library():
                return torch.bmm(x, w)
            rule = ops.gmm_route(dtype, dtype, D, F,
                                 [x.data_ptr(), w.data_ptr()])
            routes = ("wgmma", "simt") if rule == "wgmma" else ("simt",)
            want = plain()
            flops = 2 * E * C * D * F
            b, how = bound(nbytes(x, w) + E * C * F * x.element_size(), flops,
                           BF16_FLOPS_PER_S if dtype == torch.bfloat16
                           else FP32_FLOPS_PER_S)
            big = flops > 1e11
            iters, warm = (3, 1) if big else (20, 3)
            plain_ms = time_ms(plain, iters, warm)
            library_ms = time_ms(library, iters, warm)
            tol = KERNEL_REL_TOL[dtype]
            for route in routes:
                with ops._force_route("moe_gmm", route):
                    before = ops.ROUTES[f"moe_gmm.{route}"]
                    got = kern()
                    torch.cuda.synchronize()
                    if ops.ROUTES[f"moe_gmm.{route}"] != before + 1:
                        fail(f"gmm {label} {dtype}: no launch on the "
                             f"{route} route")
                    err = rel_err(got, want)
                    if not torch.isfinite(got.float()).all() or \
                            not err <= tol:
                        fail(f"gmm {label} {dtype} {route}: kernel differs "
                             f"from plain version ({err:.3g} of max |plain| "
                             f"> {tol})")
                    del got
                    res = {"max_abs_err": err,
                           "ms": time_ms(kern, iters, warm),
                           "plain_ms": plain_ms, "library_ms": library_ms,
                           "device_ms": device_ms(kern, GMM_KERNEL[route],
                                                  calls=4 if big else 20),
                           "bound_ms": b, "bound_by": how}
                out[(label, dtype, route)] = res
                dev_ms = "not measured" if res["device_ms"] is None \
                    else f"{res['device_ms']:.4f} ms"
                tile = f", row tile {ops.gmm_row_tile(C)}" \
                    if route == "simt" else ""
                log(f"[gmm] {label} {str(dtype)[6:]} x({E},{C},{D}) w({E},"
                    f"{D},{F}): {route} route{tile}, max err / max |plain| "
                    f"{err:.3g} (tol {tol}); kernel {res['ms']:.4f} ms "
                    f"(device {dev_ms}), plain {plain_ms:.4f} ms, bmm "
                    f"{library_ms:.4f} ms; bound {b:.4f} ms by {how}; "
                    f"kernel at {flops / res['ms'] / 1e9:.2f} TFLOP/s, "
                    f"{100 * b / res['ms']:.1f}% of the bound, "
                    f"{res['ms'] / library_ms:.3f}x bmm")
            del x, w, want
            torch.cuda.empty_cache()
    return out


def check_scan(dev) -> dict:
    """Every case in its stream dtypes (the edge shapes in f32 and bf16);
    returns {(label, xc dtype): numbers}."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(14)
    clock = sm_clock_hz()
    cases = []
    for label, B, S, di, N, dtypes in SCAN_CASES:
        for dt in ((dtypes,) if dtypes else ((F32,) * 4, (BF,) * 4)):
            cases.append((label, B, S, di, N, dt))
    out = {}
    for label, B, S, di, N, dtypes in cases:
        xc = torch.randn((B, S, di), generator=gen, device=dev)
        # dt as the model makes it: softplus around the init's 1e-3..0.1
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, di), generator=gen, device=dev) - 4.0)
        bm = torch.randn((B, S, N), generator=gen, device=dev)
        cm = torch.randn((B, S, N), generator=gen, device=dev)
        xc, dt, bm, cm = (t.to(d) for t, d in zip((xc, dt, bm, cm), dtypes))
        a = -torch.arange(1, N + 1, dtype=torch.float32,
                          device=dev).repeat(di, 1)    # the S4D-real A

        def kern():
            return ops.mamba_scan(xc, dt, bm, cm, a)

        def plain():
            return ref.mamba_scan_ref(xc, dt, bm, cm, a)
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = rel_err(got, want)
        row = worst_row_err(got, want)
        tol, row_tol = KERNEL_REL_TOL[xc.dtype], SCAN_ROW_TOL[xc.dtype]
        if not torch.isfinite(got.float()).all() or not err <= tol or \
                not row <= row_tol:
            fail(f"scan {label} {dtypes}: kernel differs from plain version "
                 f"({err:.3g} of max |plain|, tolerance {tol}; worst row "
                 f"{row:.3g}, tolerance {row_tol})")
        del got, want
        # per state element: dt*a, exp, two products, the add, h*C and
        # the sum over N (f32 on the CUDA cores); per channel dt*x
        flops = 7 * B * S * di * N + B * S * di
        b, how = bound(nbytes(xc, dt, bm, cm, a) + xc.numel()
                       * xc.element_size(), flops)
        # one exp per state update on the special-function unit
        sfu_ms = B * S * di * N / (SFU_PER_CLOCK_PER_SM * SMS * clock) * 1e3
        segments = -(-S // ops.scan_segment_len(B, S, di))
        big = S * di >= 2 ** 24
        res = {"max_abs_err": err, "worst_row_err": row, "sfu_ms": sfu_ms,
               "ms": time_ms(kern, 5 if big else 50, 2 if big else 5),
               "plain_ms": time_ms(plain, 1 if big else 3, 1),
               "library_ms": None,
               "device_ms": device_ms(kern, "mamba_scan_kernel",
                                      calls=5 if big else 20),
               "bound_ms": b, "bound_by": how}
        out[(label, xc.dtype)] = res
        dev_ms = "not measured" if res["device_ms"] is None \
            else f"{res['device_ms']:.4f} ms"
        names = "/".join(str(d)[6:] for d in dtypes)
        log(f"[scan] {label} ({B},{S},{di},{N}) {names}: max err / max "
            f"|plain| {err:.3g} (tol {tol}), worst row {row:.3g} (tol "
            f"{row_tol}); {segments} segment(s); kernel {res['ms']:.4f} ms "
            f"(device {dev_ms}), plain {res['plain_ms']:.4f} ms; bound "
            f"{b:.4f} ms by {how}; SFU floor {sfu_ms:.4f} ms ({B * S * di * N / 1e9:.3f} "
            f"G exp at 16 a clock per SM, {clock / 1e9:.3f} GHz)")
        del xc, dt, bm, cm, a
        torch.cuda.empty_cache()
    return out


# -- phases 11 and 12: the jamba-v0.1-52b model path ------------------------

def hybrid_forward_phase(params, cfg, dev) -> dict:
    """forward_loss at full width, one super-block deep, through the
    kernels (the resolver's hooks for attention_impl="pallas") and the
    reference path, in bf16 (B=2) and f32 (B=1)."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss

    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    if (hooks["flash_fn"], hooks["gmm_fn"], hooks["scan_fn"]) != \
            (ops.flash_attention, ops.moe_gmm, ops.mamba_scan):
        fail(f"hybrid: attention_impl='pallas' resolves to {hooks}")
    layers = cfg.block_defs * cfg.n_super
    kernel_launches = {
        "flash_attention": sum(m == "attn" for m, _ in layers),
        "moe_gmm": 3 * sum(f == "moe" for _, f in layers),
        "mamba_scan": sum(m == "mamba" for m, _ in layers)}
    rng = np.random.default_rng(2021)
    out = {}
    for dtype, B, rel in ((torch.bfloat16, 2, 1e-2), (torch.float32, 1, 1e-4)):
        S = 4096
        tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tok[:, :-1]).to(dev),
                 "targets": torch.from_numpy(tok[:, 1:]).to(dev)}
        losses, secs = {}, {}
        for label, kw in (("kernels", hooks), ("reference", {})):
            forward_loss(params, cfg, batch, compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            loss, parts = forward_loss(params, cfg, batch,
                                       compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
            launches, routes = dict(ops.LAUNCHES), dict(ops.ROUTES)
            want = {name: 0 for name in launches}
            if label == "kernels":
                want.update(kernel_launches)
            if launches != want:
                fail(f"hybrid {label} {dtype}: launches {launches}, "
                     f"expected {want}")
            route = "wgmma" if dtype == torch.bfloat16 else "simt"
            want_routes = {name: 0 for name in routes}
            for op in ("flash_attention", "moe_gmm"):
                want_routes[f"{op}.{route}"] = want[op]
            if routes != want_routes:
                fail(f"hybrid {label} {dtype}: routes {routes}, expected "
                     f"{want_routes}")
            losses[label] = float(loss)
            if not math.isfinite(losses[label]):
                fail(f"hybrid {label} {dtype}: loss {losses[label]}")
            log(f"[hybrid] {cfg.name} {len(layers)}L {str(dtype)[6:]} B={B} "
                f"S={S} via {label}: loss {losses[label]:.6f} (aux "
                f"{float(parts['aux']):.6f}), {secs[label]:.3f} s "
                f"({B * S / secs[label]:.1f} tokens/s), launches "
                f"{ {k: launches[k] for k in kernel_launches} } "
                f"({ {k: n for k, n in routes.items() if n} }), peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
            if dtype != torch.bfloat16 and label != "kernels":
                continue
            # where each path's time goes, on the main path's own shapes
            # (in f32 the kernels' path only: the CUDA-core routes)
            prof = profile_forward(
                lambda: forward_loss(params, cfg, batch,
                                     compute_dtype=dtype, **kw),
                secs[label], tag=f"hybrid {label} {str(dtype)[6:]}",
                kernels=("flash_attention_kernel", "moe_gmm_kernel",
                         "mamba_scan_kernel"))
            if label == "kernels":
                out[route] = {
                    "launches": {k: launches[k] for k in kernel_launches},
                    "device_ms": prof}
        d = abs(losses["kernels"] - losses["reference"]) \
            / abs(losses["reference"])
        if d > rel:
            fail(f"hybrid {dtype}: kernel loss {losses['kernels']} vs "
                 f"reference {losses['reference']} ({d:.3g} relative > "
                 f"{rel})")
        log(f"[hybrid] {str(dtype)[6:]}: kernels vs reference loss "
            f"{d:.3g} relative (tol {rel})")
        out[str(dtype)] = {"losses": losses, "secs": secs, "rel": d}
        del batch
        torch.cuda.empty_cache()
    return out


# -- phase 13: mlstm_chunk against its plain version ------------------------

MLSTM_TOL = {torch.float32: 5e-4, torch.bfloat16: 5e-2}
# the worst (b, t, h) row's ||err|| / ||plain|| over dv: a stale, skipped
# or mis-rescaled state entering one late chunk moves whole rows of it,
# which the elementwise gate above (5e-2 + 5e-2 |plain|) may not see
# (sound rows read at most ~3.5e-5 in f32, ~1.4e-2 on the bf16 tensor-core
# route at the xlstm shape, on an NVIDIA H100 80GB HBM3 at 700 W; a state
# dropped or left unrescaled at chunk 30 of 32 reads 1.0 and 3.5)
MLSTM_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the profiler's kernel names of each route: one substring catches a
# route's three kernels and none of the other's (mlstm_chunk_wgmma_gates,
# _states and _outputs; mlstm_chunk_kernel_gates, _states and _outputs)
MLSTM_KERNEL = {"wgmma": "mlstm_chunk_wgmma", "simt": "mlstm_chunk_kernel"}
# bytes of an element of the state scratch (C entering every chunk)
MLSTM_STATE_BYTES = {"wgmma": 2, "simt": 4}
# (label, layout, shape, stream dtypes q/k/v, gates or None for the
# case's dtype in both): the model layout is (B, H, S, dqk, dv) through
# mlstm_chunk_model, the kernel layout (BH, S, dqk, dv, block_s) through
# mlstm_chunk
MLSTM_CASES = [("xlstm-b2-model", "model", (2, 4, 4096, 512, 512), (BF, F32)),
               ("xlstm-b1-f32", "model", (1, 4, 4096, 512, 512), (F32, F32)),
               ("edge-2x128x32x32", "kernel", (2, 128, 32, 32, 64), None),
               ("edge-4x256x64x64", "kernel", (4, 256, 64, 64, 128), None),
               ("edge-1x128x16x48", "kernel", (1, 128, 16, 48, 32), None),
               ("ragged-dv80", "kernel", (2, 256, 64, 80, 128), None)]


def mlstm_flops(BH: int, S: int, dqk: int, dv: int, chunk: int) -> int:
    """The products the function needs per chunk of L steps, 2 FLOP per
    multiply-add: q k^T and the masked scores times v over the L(L+1)/2
    causal pairs only; q C (L x dqk x dv) from the second chunk on (the
    state starts at zero); the state update k^T v except after the last
    chunk (no state is returned)."""
    flops = 0
    for t0 in range(0, S, chunk):
        L = min(chunk, S - t0)
        flops += L * (L + 1) * (dqk + dv)
        flops += 2 * L * dqk * dv * ((t0 > 0) + (t0 + L < S))
    return BH * flops


def check_mlstm(dev) -> dict:
    """Every case in its dtypes (the kernel-layout ones in f32 and bf16),
    on each route that takes it; returns {(label, q dtype, route):
    numbers}."""
    from repro_torch.kernels import ops, ref
    gen = torch.Generator(device=dev).manual_seed(15)
    cases = []
    for label, layout, shape, dtypes in MLSTM_CASES:
        for dt in ((dtypes,) if dtypes else ((F32, F32), (BF, BF))):
            cases.append((label, layout, shape, dt))
    out = {}
    for label, layout, shape, (sdt, gdt) in cases:
        if layout == "model":
            B, H, S, dqk, dv = shape
            lead, glead, BH, chunk = (B, S, H), (B, S, H), B * H, 128
        else:
            BH, S, dqk, dv, bs = shape
            lead, glead, chunk = (BH, S), (BH, S, 1), min(bs, S, 128)
        q, k = (torch.randn((*lead, dqk), generator=gen, device=dev)
                .to(sdt) for _ in range(2))
        v = torch.randn((*lead, dv), generator=gen, device=dev).to(sdt)
        li = (torch.randn(glead, generator=gen, device=dev) - 5.0).to(gdt)
        lf = torch.nn.functional.logsigmoid(
            torch.randn(glead, generator=gen, device=dev) + 3.0).to(gdt)
        if layout == "model":
            def kern():
                return ops.mlstm_chunk_model(q, k, v, li, lf)

            def plain():
                return ref.mlstm_model_ref(q, k, v, li, lf)
            strides = [x for t in (q, k, v, v) for x in (
                t.stride(0), t.stride(2), t.stride(1))]
        else:
            def kern():
                return ops.mlstm_chunk(q, k, v, li, lf, block_s=bs)

            def plain():
                return ref.mlstm_ref(q, k, v, li, lf)
            strides = [x for t in (q, k, v, v) for x in (
                t.stride(0), 0, t.stride(1))]
        rule = ops.mlstm_route([sdt] * 3, dqk, dv, strides,
                               [t.data_ptr() for t in (q, k, v)])
        routes = ("wgmma", "simt") if rule == "wgmma" else ("simt",)
        want = plain()                         # once, for every route
        flops = mlstm_flops(BH, S, dqk, dv, chunk)
        moved = nbytes(q, k, v, li, lf) + q.numel() // dqk * dv \
            * q.element_size()
        b, how = bound(moved, flops, BF16_FLOPS_PER_S if sdt == BF
                       else FP32_FLOPS_PER_S)
        big = S >= 4096
        plain_ms = time_ms(plain, 3 if big else 5, 1)
        tol, row_tol = MLSTM_TOL[sdt], MLSTM_ROW_TOL[sdt]
        for route in routes:
            with ops._force_route("mlstm_chunk", route):
                before = ops.MLSTM_ROUTES[f"mlstm_chunk.{route}"]
                got = kern()
                torch.cuda.synchronize()
                if ops.MLSTM_ROUTES[f"mlstm_chunk.{route}"] != before + 1:
                    fail(f"mlstm {label} {sdt}: no launch on the {route} "
                         "route")
                if not torch.isfinite(got.float()).all():
                    fail(f"mlstm {label} {sdt} {route}: non-finite output")
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                far = bool((diff > tol + tol * want.float().abs()).any())
                del diff
                row = worst_row_err(got, want)
                if far or row > row_tol:
                    fail(f"mlstm {label} {sdt} {route}: kernel differs from "
                         f"plain version (elementwise gate "
                         f"{'failed' if far else 'passed'}: max abs err "
                         f"{err}, tolerance {tol} + {tol} |plain|; worst "
                         f"row {row}, tolerance {row_tol})")
                del got
                # both routes also write and read the state entering every
                # chunk (C at (dqk, dv) padded to 64 x 128): their own
                # traffic
                state = 2 * MLSTM_STATE_BYTES[route] * BH * -(-S // chunk) \
                    * -(-dqk // 64) * 64 * -(-dv // 128) * 128
                split = device_split(kern, MLSTM_KERNEL[route],
                                     calls=5 if big else 20)
                res = {"max_abs_err": err, "worst_row_err": row,
                       "ms": time_ms(kern, 5 if big else 50,
                                     2 if big else 5),
                       "plain_ms": plain_ms, "library_ms": None,
                       "device_ms": sum(split.values()) if split else None,
                       "split": split, "bound_ms": b, "bound_by": how,
                       "state_ms": state / HBM_BYTES_PER_S * 1e3}
            out[(label, sdt, route)] = res
            dev_ms = "not measured" if res["device_ms"] is None \
                else f"{res['device_ms']:.4f} ms: " + ", ".join(
                    f"{name.rsplit('_', 1)[-1]} {ms:.4f}"
                    for name, ms in res["split"].items())
            log(f"[mlstm] {label} {layout} {shape} {str(sdt)[6:]}/gates "
                f"{str(gdt)[6:]}: {route} route, max abs err {err:.3g} (tol "
                f"{tol}), worst row {row:.3g} (tol {row_tol}); kernel "
                f"{res['ms']:.4f} ms (device {dev_ms}), plain "
                f"{plain_ms:.4f} ms; bound {b:.4f} ms by {how} "
                f"({flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB), state "
                f"scratch written and read {state / 1e6:.1f} MB "
                f"({res['state_ms']:.4f} ms); kernel at "
                f"{flops / res['ms'] / 1e9:.2f} TFLOP/s")
        del q, k, v, li, lf, want
        torch.cuda.empty_cache()
    return out


# -- phases 14 and 15: the xlstm-350m model path ----------------------------

def xlstm_forward_phase(params, cfg, dev) -> dict:
    """forward_loss at full width and depth through the mlstm_chunk
    kernel (the resolver's hooks for attention_impl="pallas") and the
    chunked reference path, in bf16 (B=2) and f32 (B=1); per dtype the
    losses, times and, from the kernel forward's profile, the launches
    and device ms per mlstm_chunk call."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss

    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    if hooks["chunk_fn"] is not ops.mlstm_chunk_model:
        fail(f"xlstm: attention_impl='pallas' resolves to {hooks}")
    layers = cfg.block_defs * cfg.n_super
    n_mlstm = sum(m == "mlstm" for m, _ in layers)
    ln_v = math.log(cfg.vocab_size)
    rng = np.random.default_rng(2021)
    out = {}
    for dtype, B, rel in ((torch.bfloat16, 2, 1e-2), (torch.float32, 1, 1e-4)):
        S = 4096
        tok = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(tok[:, :-1]).to(dev),
                 "targets": torch.from_numpy(tok[:, 1:]).to(dev)}
        losses, secs, kern = {}, {}, {}
        for label, kw in (("kernel", hooks), ("reference", {})):
            forward_loss(params, cfg, batch, compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launches()
            t0 = time.perf_counter()
            loss, _ = forward_loss(params, cfg, batch, compute_dtype=dtype,
                                   **kw)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
            launches, routes = dict(ops.LAUNCHES), dict(ops.MLSTM_ROUTES)
            want = {name: 0 for name in launches}
            if label == "kernel":
                want["mlstm_chunk"] = n_mlstm
            if launches != want:
                fail(f"xlstm {label} {dtype}: launches {launches}, "
                     f"expected {want}")
            route = "wgmma" if dtype == torch.bfloat16 else "simt"
            want_routes = {name: 0 for name in routes}
            want_routes[f"mlstm_chunk.{route}"] = want["mlstm_chunk"]
            if routes != want_routes or any(ops.ROUTES.values()):
                fail(f"xlstm {label} {dtype}: routes {routes} "
                     f"{ops.ROUTES}, expected {want_routes}")
            losses[label] = float(loss)
            if not math.isfinite(losses[label]) or \
                    abs(losses[label] - ln_v) > 2.0:
                fail(f"xlstm {label} {dtype}: loss {losses[label]} not "
                     f"within 2.0 of ln {cfg.vocab_size} = {ln_v:.4f}")
            log(f"[xlstm] {cfg.name} {len(layers)}L {str(dtype)[6:]} B={B} "
                f"S={S} via {label}: loss {losses[label]:.6f}, "
                f"{secs[label]:.3f} s ({B * S / secs[label]:.1f} tokens/s), "
                f"mlstm_chunk launches {launches['mlstm_chunk']} "
                f"({ {k: n for k, n in routes.items() if n} }), peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
            if dtype != torch.bfloat16 and label != "kernel":
                continue                  # f32: the kernel forward's alone
            prof = profile_forward(
                lambda: forward_loss(params, cfg, batch,
                                     compute_dtype=dtype, **kw),
                secs[label], tag=f"xlstm {label} {str(dtype)[6:]}",
                kernels=(MLSTM_KERNEL[route],))
            if label == "kernel":
                kern = {"launches": launches["mlstm_chunk"],
                        "device_ms": prof[MLSTM_KERNEL[route]]}
        d = abs(losses["kernel"] - losses["reference"]) \
            / abs(losses["reference"])
        if d > rel:
            fail(f"xlstm {dtype}: kernel loss {losses['kernel']} vs "
                 f"reference {losses['reference']} ({d:.3g} relative > "
                 f"{rel})")
        log(f"[xlstm] {str(dtype)[6:]}: kernel vs reference loss {d:.3g} "
            f"relative (tol {rel})")
        out[str(dtype)] = {"losses": losses, "secs": secs, "rel": d, **kern}
        del batch
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to PyTorch",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} not found: run "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.scenarios import planning_grid
    from repro_torch.core.spec import CampaignSpec
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    t_start = t0 = time.perf_counter()
    build.library()
    log(f"[build] {time.perf_counter() - t0:.2f} s including nvcc "
        f"({build.last_build_seconds} s; None: cached) in {build.build_dir()}")
    log(f"[card] {torch.cuda.get_device_name(0)} | {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    grid = planning_grid()
    shapes = {"B": len(grid) * 17, "G": 10, "W": 16, "P": 3}
    kernels = check_kernels(dev, shapes)
    for name, k in kernels.items():
        dev_us = "not measured" if k["device_ms"] is None \
            else f"{1e3 * k['device_ms']:.2f} us"
        log(f"[kernel] {name}: exact={k['max_abs_err'] == 0.0} "
            f"{1e3 * k['ms']:.2f} us per call (device {dev_us}; plain "
            f"{1e3 * k['plain_ms']:.2f} us; bound "
            f"{1e3 * k['bound_ms']:.3f} us by {k['bound_by']})")

    main_run = drive("main", grid, list(range(17)))
    sweep_kernel = check_sweep(dev, grid, list(range(17)))
    split = main_run["split"]
    log(f"[split] main, fused route: prepare {split['prepare']:.4f} s, "
        f"planner {split['planner']:.4f} s, run {split['run']:.4f} s (the "
        f"kernel's device time {sweep_kernel['device_ms']} ms of it), "
        f"results {split['results']:.4f} s; wall {main_run['fused_s']:.4f} s")
    drive("hot", [hot_spec()], list(range(16)))
    for route in ("fused", "ops"):
        profile_window([replace(s, duration_h=24.0) for s in grid],
                       list(range(17)), route)
    dp_spec = CampaignSpec.from_json(
        (ROOT / "tests" / "data" / "dataplane.spec.json").read_text())
    drive("dataplane", [dp_spec], list(range(64)))
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")

    flash = check_flash(dev)
    gmm = check_gmm(dev)
    scan = check_scan(dev)
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")

    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    cfg = get_config("yi-9b")
    t0 = time.perf_counter()
    params = init_params(cfg, 2021, device=dev)
    torch.cuda.synchronize()
    log(f"[model] yi-9b: {param_count(params) / 1e9:.3f} B f32 parameters "
        f"({cfg.num_layers} layers, d_model {cfg.d_model}) initialised on "
        f"the card in {time.perf_counter() - t0:.2f} s")
    fwd = forward_phase(params, cfg, dev)
    serve_phase(params, cfg, dev)
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    del params                         # jamba's 53.2 GB need the room
    torch.cuda.empty_cache()

    cfg = replace(get_config("jamba-v0.1-52b"), num_layers=8)
    t0 = time.perf_counter()
    params = init_params(cfg, 2021, device=dev)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {param_count(params) / 1e9:.3f} B f32 "
        f"parameters ({cfg.num_layers} of 32 layers: one super-block; "
        f"d_model {cfg.d_model}, 16 experts of d_ff {cfg.moe.d_ff_expert}) "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
    hybrid = hybrid_forward_phase(params, cfg, dev)
    serve_phase(params, cfg, dev, tag="served")
    del params                         # the card to itself for xlstm
    torch.cuda.empty_cache()
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")

    mlstm = check_mlstm(dev)
    cfg = get_config("xlstm-350m")
    t0 = time.perf_counter()
    params = init_params(cfg, 2021, device=dev)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {param_count(params) / 1e6:.2f} M f32 "
        f"parameters ({cfg.num_layers} layers: {cfg.n_super} super-blocks "
        f"of 7 mLSTM + 1 sLSTM; d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads) initialised on the card in {time.perf_counter() - t0:.2f} s")
    xlstm = xlstm_forward_phase(params, cfg, dev)
    serve_phase(params, cfg, dev, tag="xserved")
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")

    # the main path's own shapes: the bf16 forwards' (B=2: yi-9b's
    # attention, jamba's up product and scan) on the wgmma routes, the f32
    # forwards' (B=1: yi-9b's attention, jamba's up product at C=640) on
    # the CUDA-core routes; where a window came back empty, the device
    # time comes from the forward's own profile
    yi = flash[("yi-9b", torch.bfloat16, "wgmma")]
    yi_f32 = flash[("yi-9b-b1", torch.float32, "simt")]
    main_gmm = gmm[("jamba-up-c1280", torch.bfloat16, "wgmma")]
    gmm_f32 = gmm[("jamba-up-c640", torch.float32, "simt")]
    main_scan = scan[("jamba-b2-model", torch.bfloat16)]
    for res, prof in ((yi, fwd["wgmma"]["device_ms"]),
                      (yi_f32, fwd["simt"]["device_ms"]),
                      (main_gmm, hybrid["wgmma"]["device_ms"]["moe_gmm_kernel"]),
                      (gmm_f32, hybrid["simt"]["device_ms"]["moe_gmm_kernel"]),
                      (main_scan,
                       hybrid["wgmma"]["device_ms"]["mamba_scan_kernel"])):
        if res["device_ms"] is None:
            res["device_ms"] = prof
    main_mlstm = mlstm[("xlstm-b2-model", torch.bfloat16, "wgmma")]
    mlstm_f32 = mlstm[("xlstm-b1-f32", torch.float32, "simt")]
    x_bf16, x_f32 = xlstm[str(torch.bfloat16)], xlstm[str(torch.float32)]
    for res, prof in ((main_mlstm, x_bf16["device_ms"]),
                      (mlstm_f32, x_f32["device_ms"])):
        if res["device_ms"] is None:
            res["device_ms"] = prof
    keys = ("max_abs_err", "ms", "plain_ms", "device_ms", "bound_ms",
            "bound_by", "library_ms")
    report = {"kernels": [
        {"name": name, "route": "cuda", "cuda_route": "simt",
         "source": CU_SOURCE, "replaces": REPLACES[name],
         "launches": main_run["launches_ops"][name],
         **kernels[name]} for name in REPLACES] + [
        {"name": "campaign_sweep", "route": "cuda", "cuda_route": "simt",
         "source": SWEEP_SOURCE, "replaces": SWEEP_REPLACES,
         "launches": main_run["launches"]["campaign_sweep"],
         **{key: sweep_kernel[key] for key in keys}}] + [
        {"name": "flash_attention", "route": "cuda", "cuda_route": "wgmma",
         "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
         "launches": fwd["wgmma"]["launches"],
         **{key: yi[key] for key in keys}},
        {"name": "flash_attention.simt", "route": "cuda",
         "cuda_route": "simt", "source": FLASH_SOURCE,
         "replaces": FLASH_REPLACES, "launches": fwd["simt"]["launches"],
         **{key: yi_f32[key] for key in keys}},
        {"name": "moe_gmm", "route": "cuda", "cuda_route": "wgmma",
         "source": GMM_SOURCE, "replaces": GMM_REPLACES,
         "launches": hybrid["wgmma"]["launches"]["moe_gmm"],
         **{key: main_gmm[key] for key in keys}},
        {"name": "moe_gmm.simt", "route": "cuda", "cuda_route": "simt",
         "source": GMM_SOURCE, "replaces": GMM_REPLACES,
         "launches": hybrid["simt"]["launches"]["moe_gmm"],
         **{key: gmm_f32[key] for key in keys}},
        {"name": "mamba_scan", "route": "cuda", "cuda_route": "simt",
         "source": SCAN_SOURCE, "replaces": SCAN_REPLACES,
         "launches": hybrid["wgmma"]["launches"]["mamba_scan"],
         **{key: main_scan[key] for key in keys}},
        {"name": "mlstm_chunk", "route": "cuda", "cuda_route": "wgmma",
         "source": MLSTM_SOURCE, "replaces": MLSTM_REPLACES,
         "launches": x_bf16["launches"],
         **{key: main_mlstm[key] for key in keys}},
        {"name": "mlstm_chunk.simt", "route": "cuda", "cuda_route": "simt",
         "source": MLSTM_SIMT_SOURCE, "replaces": MLSTM_REPLACES,
         "launches": x_f32["launches"],
         **{key: mlstm_f32[key] for key in keys}}]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
