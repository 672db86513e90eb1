#!/usr/bin/env python3
"""Time the CUDA-core ("simt") routes of moe_gmm, flash attention and
mlstm_chunk at the main paths' shapes, and moe_gmm's CUDA-core kernel at
each of its row tiles over a range of capacities.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/simt_timings.py [--src DIR] [--ops gmm,flash,mlstm]
                                    [--tiles] [--xlstm]

``--src`` imports ``repro_torch`` from another tree's ``src`` (for
example a ``git archive`` of the parent commit unpacked under
``build/``), so that two versions of the kernels are timed on one card in
one call; its kernels are built into that tree's own ``build/``.  Each
case forces the simt route, checks the kernel against its plain version
(moe_gmm: max |err| / max |plain| within 1e-5 in f32, 1e-2 in bf16;
flash: max |err| within 2e-5 / 2e-2; mlstm_chunk: the worst (b, t, h)
row's relative error within 1e-4 / 3e-2, against the sequential plain
version) and prints the mean of a few calls (CUDA events, after a
warm-up) beside ``torch.bmm`` or ``scaled_dot_product_attention`` (TF32
off; no library call computes the mLSTM).  ``--ops`` picks the kernels.

``--xlstm`` also runs xlstm-350m at full width and depth (random weights
from the tree's ``init_params``, seed 2021) in f32 at B=1, S=4096 through
the kernel hooks (every mlstm_chunk launch on the simt route): the wall
time of one forward after a warm-up, and from a profiled one the device
busy time, the CUDA kernel launches and the mlstm_chunk kernels' device
time a call.

``--tiles`` also times the moe_gmm kernel of this tree at row tiles 16
and 128 for C from 8 to 256 (f32, jamba's E=16, D=4096, F=14336),
through the library's C entry, which takes the tile as an argument: the
measurement behind ``ops.gmm_row_tile``.  Needs a tree whose entry takes
the row tile.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
BF, F32 = torch.bfloat16, torch.float32
# (label, E, C, D, F, x dtype, w dtype)
GMM = [("jamba-up-c640", 16, 640, 4096, 14336, F32, F32),
       ("jamba-down-c640", 16, 640, 14336, 4096, F32, F32),
       ("jamba-up-c1280", 16, 1280, 4096, 14336, F32, F32),
       ("decode-c8", 16, 8, 4096, 14336, F32, F32),
       ("up-c48", 16, 48, 4096, 14336, F32, F32),
       ("jamba-up-c1280", 16, 1280, 4096, 14336, BF, BF)]
# (label, B, S, H, Hkv, D, dtype): yi-9b's attention, causal
FLASH = [("yi-9b", 2, 4096, 32, 4, 128, F32),
         ("yi-9b-b1", 1, 4096, 32, 4, 128, F32),
         ("yi-9b", 2, 4096, 32, 4, 128, BF),
         ("d80", 2, 2048, 16, 2, 80, F32),
         ("d256", 1, 2048, 8, 2, 256, F32)]
# (label, B, S, H, dqk, dv, stream dtype): xlstm-350m's mLSTM, f32 gates
MLSTM = [("xlstm-b1", 1, 4096, 4, 512, 512, F32),
         ("xlstm-b2", 2, 4096, 4, 512, 512, BF)]


def t_ms(fn, n: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def xlstm_forward(tag: str, dev) -> bool:
    """The xlstm-350m f32 B=1 forward through the kernel; True when its
    21 mlstm_chunk launches all took the simt route."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, init_params
    cfg = get_config("xlstm-350m")
    params = init_params(cfg, 2021, device=dev)
    tok = np.random.default_rng(2021).integers(0, cfg.vocab_size,
                                               (1, 4097)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(tok[:, :-1]).to(dev),
             "targets": torch.from_numpy(tok[:, 1:]).to(dev)}
    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))

    def fwd():
        return forward_loss(params, cfg, batch, compute_dtype=F32, **hooks)
    fwd()
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    loss, _ = fwd()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    routes = dict(ops.MLSTM_ROUTES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fwd()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.count]
    busy = sum(e.self_device_time_total for e in kern) / 1e6
    mlstm = [e for e in kern if "mlstm_chunk" in e.key]
    per_call = sum(e.self_device_time_total / e.count for e in mlstm) / 1e3
    print(f"[{tag}] xlstm-350m f32 B=1 S=4096 forward: loss "
          f"{float(loss):.6f}, wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({sum(e.count for e in kern)} kernel launches), mlstm_chunk "
          f"{per_call:.4f} ms a call ({sum(e.count for e in mlstm)} CUDA "
          f"launches of {len(mlstm)} kernels), routes {routes}", flush=True)
    return routes == {"mlstm_chunk.wgmma": 0, "mlstm_chunk.simt": 21}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--ops", default="gmm,flash,mlstm")
    ap.add_argument("--tiles", action="store_true")
    ap.add_argument("--xlstm", action="store_true")
    args = ap.parse_args()
    kinds = set(args.ops.split(","))
    if not torch.cuda.is_available():
        print("simt_timings: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels import build, ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tag = str(args.src)
    lib = build.library()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[{tag}] {smi}", flush=True)
    gen = torch.Generator(device=dev).manual_seed(13)
    ok = True

    for label, E, C, D, Fo, xd, wd in GMM if "gmm" in kinds else ():
        x = torch.randn((E, C, D), generator=gen, device=dev).to(xd)
        w = (torch.randn((E, D, Fo), generator=gen, device=dev)
             * D ** -0.5).to(wd)
        n = 3 if C >= 640 else 10
        with ops._force_route("moe_gmm", "simt"):
            got = ops.moe_gmm(x, w)
            want = ref.moe_gmm_ref(x, w)
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            del got, want
            ms = t_ms(lambda: ops.moe_gmm(x, w), n)
        bmm = t_ms(lambda: torch.bmm(x, w), n)
        ok &= err <= (1e-5 if xd == F32 else 1e-2)
        print(f"[{tag}] gmm {label} {str(xd)[6:]}/{str(wd)[6:]}: simt "
              f"{ms:.4f} ms ({2 * E * C * D * Fo / ms / 1e9:.1f} TFLOP/s), "
              f"bmm {bmm:.4f} ms, {ms / bmm:.3f}x bmm, err {err:.3g}",
              flush=True)
        del x, w
        torch.cuda.empty_cache()

    for label, B, S, H, Hkv, D, dt in FLASH if "flash" in kinds else ():
        q, k, v = (torch.randn((B, S, h, D), generator=gen, device=dev)
                   .to(dt) for h in (H, Hkv, Hkv))
        with ops._force_route("flash_attention", "simt"):
            got = ops.flash_attention(q, k, v, causal=True)
            want = ref.flash_attention_model_ref(q, k, v, causal=True)
            err = float((got.float() - want.float()).abs().max())
            del got, want
            ms = t_ms(lambda: ops.flash_attention(q, k, v, causal=True), 5)
        qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = t_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, is_causal=True, enable_gqa=True), 5)
        ok &= err <= (2e-5 if dt == F32 else 2e-2)
        print(f"[{tag}] flash {label} {str(dt)[6:]}: simt {ms:.4f} ms, "
              f"sdpa {sdpa:.4f} ms, {ms / sdpa:.3f}x sdpa, max abs err "
              f"{err:.3g}", flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    for label, B, S, H, dqk, dv, dt in MLSTM if "mlstm" in kinds else ():
        q, k = (torch.randn((B, S, H, dqk), generator=gen, device=dev).to(dt)
                for _ in range(2))
        v = torch.randn((B, S, H, dv), generator=gen, device=dev).to(dt)
        li = torch.randn((B, S, H), generator=gen, device=dev) - 5.0
        lf = F.logsigmoid(torch.randn((B, S, H), generator=gen,
                                      device=dev) + 3.0)
        with ops._force_route("mlstm_chunk", "simt"):
            got = ops.mlstm_chunk_model(q, k, v, li, lf).float()
            want = ref.mlstm_model_ref(q, k, v, li, lf).float()
            row = float(((got - want).norm(dim=-1)
                         / want.norm(dim=-1)).max())
            del got, want
            ms = t_ms(lambda: ops.mlstm_chunk_model(q, k, v, li, lf), 10)
        ok &= row <= (1e-4 if dt == F32 else 3e-2)
        print(f"[{tag}] mlstm {label} {str(dt)[6:]}: simt {ms:.4f} ms, "
              f"worst row {row:.3g}", flush=True)
        del q, k, v, li, lf
        torch.cuda.empty_cache()

    if args.xlstm:
        ok &= xlstm_forward(tag, dev)

    if args.tiles:
        stream = torch.cuda.current_stream().cuda_stream
        for C in (8, 16, 24, 32, 48, 64, 96, 128, 192, 256):
            x = torch.randn((16, C, 4096), generator=gen, device=dev)
            w = torch.randn((16, 4096, 14336), generator=gen, device=dev)
            o = torch.empty((16, C, 14336), device=dev)

            def tile(t):
                err = lib.moe_gmm(x.data_ptr(), w.data_ptr(), o.data_ptr(),
                                  0, 0, 16, C, 4096, 14336, t, stream)
                if err:
                    raise RuntimeError(f"moe_gmm: CUDA error {err}")
            row = ", ".join(f"{t}: {t_ms(lambda: tile(t), 5):.4f}"
                            for t in (16, 128))
            print(f"[{tag}] tiles C={C}: {row} ms (rule: "
                  f"{ops.gmm_row_tile(C)}); bmm "
                  f"{t_ms(lambda: torch.bmm(x, w), 5):.4f} ms", flush=True)
            del x, w, o
            torch.cuda.empty_cache()
    if not ok:
        print(f"[{tag}] FAIL: a kernel differs from its plain version",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
