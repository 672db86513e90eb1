#!/usr/bin/env python3
"""Check the persistent sweep kernel's draw against PyTorch's on the card,
and time the sweep's fused and ops routes in turns.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/sweep_probe.py [--turns 2]

The fused kernel (csrc/campaign_sweep_fused.cu) must reproduce the eager
engine's integers, so its f32 draw has to round as PyTorch's CUDA ops
do.  This script builds the draw's device functions
(csrc/campaign_ops.cuh) into a small probe library under
``build/sweep_probe/`` and holds them, bit for bit, to PyTorch on the
card:

  * division by a Python int (``p * lam / j`` in the draw): PyTorch's
    CUDA kernel multiplies by the rounded reciprocal, which the kernel
    copies; printed beside true division;
  * ``ndtri`` against ``torch.special.ndtri`` at every one of the 2**24
    draws (and, for comparison, the CPU's ``ndtri`` against the card's);
  * the whole Poisson draw against ``ref.poisson`` at 4 M (u, lam)
    pairs, lam from 0 to 200 (both branches, many near lam = 8);
  * Philox against ``ref.philox_uniforms``.

Then the 1,020-lane planning grid runs on the fused and the ops route in
turns (fused, ops, fused, ops for ``--turns 2``), each with its wall
time, campaigns/s, prepare / planner / run / results split and every
lane compared with the first fused run.  Exits non-zero on any mismatch.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
PROBE_CU = r"""
#include <cuda_runtime.h>
#include "campaign_ops.cuh"

__global__ void k_ndtri(const float* u, float* z, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) z[i] = campaign::ndtri(u[i]);
}
__global__ void k_poisson(const float* u, const float* lam, int* k, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) k[i] = campaign::poisson_draw(u[i], lam[i]);
}
__global__ void k_philox(const long long* seeds, int B, int T, int G,
                         float* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= T * B * G) return;
  const int g = i % G, b = (i / G) % B, t = i / (G * B);
  const long long s = seeds[b];
  out[i] = campaign::philox_uniform((unsigned)(s & 0xffffffffLL),
                                    (unsigned)((s >> 32) & 0xffffffffLL),
                                    (unsigned)t, (unsigned)g);
}
extern "C" int probe_ndtri(const float* u, float* z, int n) {
  k_ndtri<<<(n + 255) / 256, 256>>>(u, z, n);
  return (int)cudaDeviceSynchronize();
}
extern "C" int probe_poisson(const float* u, const float* lam, int* k,
                             int n) {
  k_poisson<<<(n + 255) / 256, 256>>>(u, lam, k, n);
  return (int)cudaDeviceSynchronize();
}
extern "C" int probe_philox(const long long* seeds, int B, int T, int G,
                            float* out) {
  k_philox<<<(T * B * G + 255) / 256, 256>>>(seeds, B, T, G, out);
  return (int)cudaDeviceSynchronize();
}
"""


def log(msg: str) -> None:
    print(msg, flush=True)


def probe_library(build):
    out = ROOT / "build" / "sweep_probe"
    out.mkdir(parents=True, exist_ok=True)
    src, so = out / "probe.cu", out / "probe.so"
    src.write_text(PROBE_CU)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(CSRC),
                    "-shared", "-o", str(so), str(src)], check=True)
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.probe_ndtri.argtypes = [p, p, i]
    lib.probe_poisson.argtypes = [p, p, p, i]
    lib.probe_philox.argtypes = [p, i, i, i, p]
    return lib


def check_draw(lib, ref, dev) -> int:
    """Mismatches of the kernel's draw against PyTorch on the card."""
    bad = 0
    x = torch.randn(1 << 22, device=dev) * 7
    for j in (3, 7, 11, 23):
        a = x / j
        recip = x * (torch.ones((), device=dev) / j)
        true = x / torch.full_like(x, float(j))
        n = int((a != recip).sum())
        bad += n
        log(f"[div] x / {j}: {n} differ from x * fl(1/{j}), "
            f"{int((a != true).sum())} from true division")

    u = torch.arange(1 << 24, device=dev, dtype=torch.float32) * 2.0 ** -24
    uc = torch.clamp(u, ref._U_LO, ref._U_HI)
    want = torch.special.ndtri(uc)
    got = torch.empty_like(uc)
    if lib.probe_ndtri(uc.data_ptr(), got.data_ptr(), uc.numel()):
        raise RuntimeError("probe_ndtri failed")
    n = int((got != want).sum())
    bad += n
    cpu = int((torch.special.ndtri(uc.cpu()) != want.cpu()).sum())
    log(f"[ndtri] {n} of {uc.numel()} draws differ from "
        f"torch.special.ndtri on the card (the CPU's differs at {cpu})")

    gen = torch.Generator().manual_seed(5)
    n_pairs = 1 << 22
    q = n_pairs // 4
    uu = (torch.randint(0, 1 << 24, (n_pairs,), generator=gen).float()
          * 2.0 ** -24).to(dev)
    lam = torch.cat([torch.rand(q, generator=gen) * 8.5,
                     7.5 + torch.rand(q, generator=gen),
                     torch.rand(q, generator=gen) * 200,
                     torch.rand(n_pairs - 3 * q, generator=gen) * 30]).to(dev)
    want = ref.poisson(uu, lam)
    got = torch.empty(n_pairs, dtype=torch.int32, device=dev)
    if lib.probe_poisson(uu.data_ptr(), lam.data_ptr(), got.data_ptr(),
                         n_pairs):
        raise RuntimeError("probe_poisson failed")
    n = int((got != want).sum())
    bad += n
    log(f"[poisson] {n} of {n_pairs} draws differ from ref.poisson "
        f"({int(((got != want) & (lam > 8)).sum())} with lam > 8)")

    seeds = torch.tensor([0, 1, 2021, 2 ** 31 + 5], dtype=torch.int64,
                         device=dev)
    want = ref.philox_uniforms(
        seeds, torch.arange(300, dtype=torch.int64, device=dev), 10)
    got = torch.empty_like(want)
    if lib.probe_philox(seeds.data_ptr(), 4, 300, 10, got.data_ptr()):
        raise RuntimeError("probe_philox failed")
    n = int((got != want).sum())
    bad += n
    log(f"[philox] {n} of {want.numel()} uniforms differ")
    return bad


def time_routes(turns: int) -> int:
    from repro_torch.core.api import sweep
    from repro_torch.core.scenarios import planning_grid
    from repro_torch.kernels import ops
    grid, seeds = planning_grid(), list(range(17))
    first, bad = None, 0
    for route in ("fused", "ops") * turns:
        split = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ops._force_route("campaign_sweep", route):
            res = sweep(grid, seeds, timings=split)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows = [(r["preemptions"], r["jobs_finished"], r["nat_drops"],
                 r["by_provider"], r["events_fired"]) for r in res.rows]
        if first is None:
            first = rows
        diff = sum(a != b for a, b in zip(rows, first))
        bad += diff
        log(f"[grid] {route}: {wall:.3f} s ({len(rows) / wall:.1f} "
            f"campaigns/s), split "
            f"{json.dumps({k: round(v, 4) for k, v in split.items()})}, "
            f"{diff} lanes differ from the first fused run")
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(f"[card] {smi} | torch {torch.__version__} cuda {torch.version.cuda}")
    build.library()
    bad = check_draw(probe_library(build), ref, torch.device("cuda"))
    bad += time_routes(args.turns)
    log(f"[done] {bad} mismatches")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
