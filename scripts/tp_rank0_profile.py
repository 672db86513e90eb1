#!/usr/bin/env python3
"""Where rank 0's step goes on the (16, 16) mesh: ``chip_smoke.py``
phase 23 b)'s yi-9b (or c)'s jamba) train_4k step, cut in depth,
profiled on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/tp_rank0_profile.py [LAYERS] [ARCH]

Rank 0 of torch's fake process group of 256 ranks (no collective moves
data; its all-to-all returns the rank's own buffer, as in phase 23)
holds its real bf16 shards of ARCH (yi-9b by default) at full width,
LAYERS deep (8 by default), and runs ``make_mesh_train_step`` on the
train_4k batch (16 rows a rank, grad_accum 8, remat): a warm-up step, a
timed step, then one step under ``torch.profiler`` tracing the card
alone: the device's busy time against the timed step's wall, the launch
count and the largest kernels, with the card's name and power limit.
"""
from __future__ import annotations

import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_rank0_profile: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.data import make_batch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import steps as st
    from repro_torch.sharding_ctx import make_mesh

    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    arch = sys.argv[2] if len(sys.argv) > 2 else "yi-9b"
    dev = torch.device("cuda")
    dr.fake_world(256)
    torch.distributed.all_to_all_single = \
        lambda out, x, *a, **k: out.copy_(x)
    mesh = make_mesh((16, 16), ("data", "model"), "cuda")
    cfg = replace(get_config(arch), num_layers=layers)
    shape = get_shape("train_4k")
    params, opt, _ = cs.rank0_state(cfg, mesh, dev)
    step = st.make_mesh_train_step(cfg, RunConfig(model=cfg, shape=shape),
                                   mesh)
    for i in range(2):
        batch = make_batch(cfg, shape, i, seed=7, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        print(f"[rank0] {arch} {layers} layers: step {i} {wall:.4f} s",
              flush=True)
    batch = make_batch(cfg, shape, 2, seed=7, device=dev)
    cs.profile_forward(lambda: step(params, opt, batch), wall,
                       tag=f"rank0-{arch}-{layers}", kernels=("gemm",))
    print(f"[rank0] {cs.nvidia_smi()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
