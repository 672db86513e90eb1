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
             lanes x 1,344 ticks), once through the kernels and once
             through the plain versions on the same device and draws:
             integer counters equal in every lane, cost and accelerator
             hours within 1e-5 relative, launch counts 2N / N / N / N;
  4. profile the device's busy share of a 24 h grid sweep at the same
             widths (torch.profiler kernel time over wall time);
  5. data    the data-plane golden spec at 64 seeds, the same checks as 3;
  6. report  a ``{"kernels": [...]}`` line, the nvidia-smi line, and last
             ``{"ok": true, "device": {...}}``.

Exits 2 without a card or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import json
import math
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
CU_SOURCE = "src/repro_torch/kernels/csrc/campaign_sweep.cu"
REPLACES = {
    "campaign_preempt": "src/repro/kernels/campaign_sweep.py:69",
    "campaign_match": "src/repro/kernels/campaign_sweep.py:76",
    "campaign_advance": "src/repro/kernels/campaign_sweep.py:93",
    "campaign_bill": "src/repro/kernels/campaign_sweep.py:117",
}
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


def time_ms(fn, iters: int = 200) -> float:
    """Mean ms per call: CUDA events around ``iters`` back-to-back calls
    after a warm-up (the wrapper's host time is inside the window)."""
    for _ in range(10):
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


def device_ms(fn, kernel: str, calls: int = 50):
    """Mean device time (ms) of ``kernel`` over ``calls`` calls of
    ``fn``, from the profiler trace; None where the trace has none."""
    def many():
        for _ in range(calls):
            fn()
    hits = [e for e in profiled(many) if kernel in e.key]
    if not hits:
        return None
    return sum(e.self_device_time_total for e in hits) \
        / sum(e.count for e in hits) / 1e3


def bound(nbytes: int, flops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
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


# -- phases 3 and 4: a sweep through the kernels and the plain versions ----

def drive(label, specs, seeds):
    """One sweep through the kernels (launch counts read around it) and
    one through the plain versions, compared lane by lane."""
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

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = sweep(specs, seeds)
    torch.cuda.synchronize()
    t_kernel = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)

    t0 = time.perf_counter()
    want = sweep(specs, seeds, use_kernels=False)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0

    expect = {"campaign_preempt": 2 * n_ticks, "campaign_match": n_ticks,
              "campaign_advance": n_ticks, "campaign_bill": n_ticks}
    if launches != expect:
        fail(f"{label}: launches {launches}, expected {expect}")
    if len(got.rows) != lanes:
        fail(f"{label}: {len(got.rows)} rows for {lanes} lanes")
    for a, b in zip(got.rows, want.rows):
        lane = (a["scenario"], a["seed"])
        for k in INT_COUNTERS:
            if a[k] != b[k]:
                fail(f"{label} {lane}: {k} {a[k]} != plain {b[k]}")
        if a["by_provider"] != b["by_provider"]:
            fail(f"{label} {lane}: by_provider differs")
        if a["events_fired"] != b["events_fired"]:
            fail(f"{label} {lane}: events_fired differs")
        for k in ("cost", "accel_hours", "egress_usd"):
            if not math.isfinite(a[k]) or \
                    abs(a[k] - b[k]) > REL * max(abs(b[k]), 1.0):
                fail(f"{label} {lane}: {k} {a[k]} vs plain {b[k]}")
        if not (a["cost"] > 0 and a["accel_hours"] > 0
                and a["jobs_finished"] > 0):
            fail(f"{label} {lane}: empty campaign {a}")
    costs = [r["cost"] for r in got.rows]
    log(f"[{label}] {lanes} lanes x {n_ticks} ticks: kernels "
        f"{t_kernel:.3f} s ({lanes / t_kernel:.1f} campaigns/s, "
        f"{1e3 * t_kernel / n_ticks:.3f} ms/tick); plain "
        f"{t_plain:.3f} s ({lanes / t_plain:.1f} campaigns/s, "
        f"{1e3 * t_plain / n_ticks:.3f} ms/tick); cost "
        f"${min(costs):,.0f}..${max(costs):,.0f}; launches {launches}")
    return {"lanes": lanes, "ticks": n_ticks, "kernel_s": t_kernel,
            "plain_s": t_plain, "launches": launches}


def profile_window(specs, seeds) -> None:
    """Device busy share of a sweep at main-path widths: the sum of
    CUDA kernel time in a profiled run over an unprofiled run's wall
    time (host clock, ended by a synchronize)."""
    from repro_torch.core.api import sweep
    sweep(specs, seeds)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep(specs, seeds)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kern = profiled(lambda: sweep(specs, seeds))
    if not kern:
        log("[profile] device time not measured: the profiler trace "
            "holds no CUDA kernels")
        return
    busy_s = sum(e.self_device_time_total for e in kern) / 1e6
    n = sum(e.count for e in kern)
    ticks = round(specs[0].duration_h / specs[0].dt_h)
    log(f"[profile] {len(specs) * len(seeds)} lanes x {ticks} ticks: wall "
        f"{wall:.3f} s, device busy {busy_s:.3f} s "
        f"({100 * busy_s / wall:.1f}% of wall), {n} kernel launches "
        f"({n / ticks:.0f} per tick, mean "
        f"{1e6 * busy_s / n:.2f} us device time each)")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.1f} ms "
            f"{e.count:7d}x  {e.key[:90]}")


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
    smi = nvidia_smi()
    t0 = time.perf_counter()
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
    profile_window([replace(s, duration_h=24.0) for s in grid],
                   list(range(17)))
    dp_spec = CampaignSpec.from_json(
        (ROOT / "tests" / "data" / "dataplane.spec.json").read_text())
    drive("dataplane", [dp_spec], list(range(64)))

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": CU_SOURCE,
         "replaces": REPLACES[name],
         "launches": main_run["launches"][name],
         **kernels[name]} for name in REPLACES]}
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
