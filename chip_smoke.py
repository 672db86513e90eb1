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
             lanes x 1,344 ticks) on the "fused" route (the default: one
             campaign_sweep launch), and on a cut grid (the first 4
             seeds, 96 h: 240 lanes x 384 ticks; the eager routes' wall
             follows the ticks) on "fused", "ops" (the eager tick loop
             through the four per-op kernels, forced) and "plain"
             (use_kernels=False), on the same device and draws: on the
             cut grid every fused lane's integer counters,
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
  5. data    the data-plane golden spec at 64 seeds, the same checks as 3
             (the cut grid: 4 seeds, 96 h);
  6. flash   the flash attention kernel against its plain version at the
             yi-9b shape (B=2, S=4096, H=32, Hkv=4, D=128, causal; and
             B=1, the f32 forward's), the edge shapes of
             tests/test_kernels.py, q_offset and kv_len cases, and the
             model zoo's shapes (qwen3-moe-30b-a3b's after its qk-norm,
             internvl2-2b's H=16 / Hkv=8, whisper-large-v3's decoder at
             S=448, H=Hkv=20, D=64), in f32 (2e-5) and bf16 (2e-2)
             elementwise and
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
             and back), the decode C=8, an unaligned shape and
             qwen3-moe-30b-a3b's (E=128, C=640, 2048 -> 768 and back), f32 and
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
 14. xlstm   the jamba weights freed, xlstm-350m at full width, cut to
             one super-block (8 of 24 layers: 7 mLSTM + 1 sLSTM; random
             from the port's init_params): forward_loss at B=2, S=4096 in
             bf16 and B=1, S=4096 in f32, through the kernel
             (attention_impl="pallas": 7 mlstm_chunk launches, all on the
             wgmma route in bf16 and on the simt route in f32) and through
             the chunked reference path: finite loss within 2.0 of ln
             50304, kernel vs reference within 1e-2 (bf16) / 1e-4 (f32)
             relative; tokens/s, peak memory, one profiled forward (bf16,
             through the kernel: its device busy time);
 15. xserved BatchServer(slots=4, max_len=128) on the xlstm weights, f32,
             8 requests as in 8, and the prefill-vs-decode check;
 16. train   the xlstm weights freed, the training path (the reference
             path under autograd: no kernel of the port has a backward):
             a) the ten reduced architectures, f32, 3
             steps on the card and on the CPU from the same parameters
             and batches: losses within 1e-5 relative, grad_norm within
             1e-4, parameters within 2 x the summed learning rates;
             b) yi-9b at full width, 4 of 48 layers (1.229 B f32
             parameters: the whole depth's f32 train state would not fit
             80 GB), the Trainer at B=2, S=4096, grad_accum 2, remat, 6
             timed steps (as far as C17's grad-norm jump at step 6) and
             one profiled: losses finite and within 2.0
             of ln 64000, step 0's loss the mean of forward_loss on its
             two microbatches within 1e-6 and of the flash kernel's
             forward within 1e-4, grad_norm finite and > 0; step s,
             train tokens/s, peak memory, the device's busy share;
             c) the same in bf16 (bf16 parameters, the f32 master), B=4,
             tolerances 1e-2; d) the preemption round trip on b)'s model
             cut to one layer (save_blocking at step 2, save_async at
             step 4, a new Trainer resumes at 4, restore 2 and rerun
             3-4: parameters within rtol = atol = 1e-6 of the uninterrupted run's, bitwise
             equality reported), with the checkpoint's bytes, the save,
             restore and async-blocking seconds; a ``[train] {...}`` line
             gathers the numbers with the card's name and power limit;
 17. zoo     the rest of the model zoo, one model at a time on the card
 -20.        (random weights from init_params, seed 2021; each freed
             before the next): 17 qwen3-moe-30b-a3b at full width, 8 of
             48 layers (5.6 B parameters), 18 minicpm3-4b (MLA, 62
             layers), 19 internvl2-2b (24 layers, 256 patch embeds + 3,840
             tokens), 20 whisper-large-v3 (32 + 32 layers, 1,500 frame
             embeds, 448 tokens): forward_loss on the port's synthetic
             batch in bf16 B=2 (qwen3 also f32 B=1) through the kernels
             and through the reference path, within 1e-2 (bf16) / 1e-4
             (f32) relative, launches flash 8 / 0 / 24 / 32 (decoder
             self-attention only: MLA, the encoder and cross-attention
             run the chunked path, as in the JAX package) and moe_gmm 24
             / 0 / 0 / 0, all wgmma in bf16 and simt in f32, loss within
             2.0 of ln vocab, a profiled kernels forward (busy share);
             for qwen3, minicpm3 and whisper the server run of 8 (whisper
             against its zeroed cross cache, as the JAX server) and
             prefill vs decode (whisper: with the prefill's cross kv);
             for whisper, 8 decode steps from its prefill's caches, each
             within 1e-3 of the next prefill's logits; ``[time]`` after
             each model;
 21. distrib the distributed layer on a world of one NCCL rank (a
             file:// store in a temporary directory, destroyed at the
             phase's end): a) qwen3-moe-30b-a3b's MoE layer at full width
             (d_model 2048, 128 experts top-8 of 768), B*S = 2 x 4096
             tokens, capacity factor 2: apply_moe under use_mesh on a
             (1, 1) ("data", "model") mesh (the expert-parallel path:
             all-to-alls, local buffers, the "model" all-reduce) against
             apply_moe outside it (the naive path), both through moe_gmm,
             f32 and bf16 within 1e-5 / 1e-2 of max |y|, 3 moe_gmm launches
             a call on each path (counts set to 0 before each call), no
             drops on either (counted); the int8 dispatch's expert buffer
             within its slot's max |x| / 254 (plus f32 rounding) of the f32
             path's; ms a call;
             b) compressed_tree_psum_mean over a 1.229 B-element f32 tree
             (phase 16's yi-9b, 4 layers), two steps with error feedback:
             means equal dequantize(quantize(x + r)), residuals within
             scale / 2; wire bytes; c) ElasticRunner with
             make_mesh_train_step on make_elastic_mesh(1, pod_shape=(1,
             1)), phase 16's yi-9b f32 B=2: ensure(1), 3 steps,
             ensure(1, force=True) (14.75 GB drained to the host and
             re-sharded), 3 steps, handle_preemption through the
             Checkpointer; against an uninterrupted run of make_train_step
             (the runner freed first): losses and parameters within 1e-6,
             bitwise equality reported; rebuild seconds, s a step, peak
             memory; d) drive_pool over tests/data/outage_burst.instances.
             jsonl.gz (PodPool(max_pods=128), SimulatedElasticRunner at
             c)'s forced rebuild seconds and at 45 s, with and without
             notices): a ``[elastic] {...}`` line with the card's name and
             power limit;
 22. dryrun  the dry run against the card, each part in a subprocess
             (``python3 chip_smoke.py --phase22 a|b OUT.json``): a) the
             dry run (``repro_torch.launch.dryrun.dry_run``) of phase 16's
             bf16 train cell (yi-9b full width, 4 of 48 layers, B=4,
             S=4096, grad_accum 2, remat) on a mesh of one fake rank, fake
             tensors on the card: argument, temp and peak bytes, dot
             FLOPs, the roofline terms; b) the cell's real step on the
             card (bf16 parameters, the f32 master; 3 steps): the dry
             run's dot FLOPs equal FlopCounterMode's count of the real
             step exactly, its peak lies within 15 % of
             max_memory_allocated (the arguments included); the step
             time, model and dot FLOPs over step s x 989.4 TFLOP/s; c)
             ``python -m repro_torch.launch.dryrun --arch yi-9b --shape
             decode_32k`` on the (16, 16) mesh of 256 fake ranks ends
             ``[OK]``; its per-device bytes, FLOPs and collective bytes;
 23. tp      the mesh steps computing the way the rules store the state:
             a) one-rank: on a world of one NCCL rank (where a mesh step
             is the plain step, so no tensor-parallel code runs),
             ``Trainer(mesh=)`` on a (1, 1) mesh against ``Trainer()`` on phase 16's bf16 cell
             (yi-9b, 4 of 48 layers, B=4, S=4096, grad_accum 2, remat),
             3 steps: losses and parameters bitwise equal (one rank is
             the plain step); ``make_mesh_prefill_step`` with
             attention_impl="pallas", B=2 S=4096, in f32 against the
             reference path (the logits' gap within 1e-4 of the
             reference's 2-norm) and in bf16 bitwise equal to the plain
             prefill step through the same kernels, on yi-9b's 4 layers
             (flash 4 launches) and on qwen3-moe-30b-a3b's 8 layers
             through ``moe_sharded`` (inside ``use_mesh``: 8 calls,
             capacity factor 8: no drop, counted; flash 8 and moe_gmm 24
             launches); b) in a
             subprocess (``python3 chip_smoke.py --phase23 OUT.json``),
             rank 0 of the (16, 16) mesh of torch's fake process group
             (256 ranks: no data moves, so no value is compared) on real
             bf16 shards of yi-9b train_4k at full width and depth (48
             layers, 16 rows a rank, grad_accum 8, remat): a warm-up and
             a timed step, ``max_memory_allocated`` within 15 % of the
             dry run's peak for the cell
             (``artifacts/dryrun_torch/dryrun_yi-9b_train_4k_no.json``),
             ``FlopCounterMode``'s dot FLOPs equal to the dry run's; s a
             step and the rank's model FLOPs over s x 989.4 TFLOP/s;
             then rank 0's ``make_mesh_prefill_step`` with
             attention_impl="pallas" at full width and depth, B=32
             S=4096 (2 rows a rank), on yi-9b (flash on the rank's 2 q
             heads and the kv head they select: 48 launches) and on
             qwen3-moe-30b-a3b (flash 48, ``moe_gmm`` on
             ``moe_sharded``'s 8 local experts of F = 48: 144), the
             counts set to 0 just before each and read just after, the
             rank's vocabulary columns of the logits checked by shape
             (the fake group's all-to-all returns the rank's own send
             buffer, so that the dispatch's slot indices stay the
             rank's); c) in the same subprocess, rank 0 of (16, 16) on
             real bf16 shards of jamba-v0.1-52b train_4k at full width,
             cut to one super-block (8 of 32 layers), its Mamba split over
             "model" (the rank's 512 of d_inner 8,192): a warm-up and a
             timed step, ``max_memory_allocated``
             within 15 % of the dry run of the same cut cell
             (``artifacts/dryrun_torch/dryrun_jamba-v0.1-52b_train_4k_no_
             8L.json``), dot FLOPs equal to its, no sub-block computed
             whole; then its pallas mesh prefill, B=32 S=4096: flash 1
             and ``moe_gmm`` 12 launches (4 ``moe_sharded`` calls); b)
             again, the archs whose heads (16, 16)'s "model" does not
             divide: xlstm-350m train_4k at full width, one super-block
             (8 of 24 layers: the mLSTM split on dh, the sLSTM's
             recurrence whole), its 16 rows a rank in one microbatch
             (grad_accum 1, not train_4k's 8: the sLSTM's step loop
             once), one step under ``FlopCounterMode``, held as c) to its
             cut cell's dry run at grad_accum 1 (the whole set
             {"slstm_recurrence"}); the mesh prefills of
             xlstm-350m, minicpm3-4b (MLA on query rows) and
             whisper-large-v3 (attention and cross-attention on query
             rows; flash twice a decoder layer, on the rank's two chunks
             of rows with their q_offset) at full width, 8 layers
             (whisper's decoder), B=32 S=4096, the batch as the rank's
             DTensor rows: launches as expected, dot FLOPs equal to the
             cut cell's dry run and ``max_memory_allocated`` within 15 %
             of its peak (whisper's counted on the reference path, its
             flash launches on the pallas one, whose peak is held at or
             below the dry run's plus 15 %: flash keeps no scores).
             Phase 6 gains the flash case at a rank's heads
             (``yi-9b-tp16``: B=2, S=4096, H=2, Hkv=1, D=128) and at a
             rank's share of whisper's rows (``whisper-tp16``: B=2, 512
             queries at q_offset 3,584 against 4,096 keys, H=Hkv=5,
             D=64, the model layout's q_offset), phase 9
             the moe_gmm cases at a rank's experts (``qwen3-tp16-up`` /
             ``-down``: E=8, C=12,800, D=2048, F=48 and back;
             ``jamba-tp16-up`` / ``-down``: E=1, C=25,600, D=4096, F=896
             and back);
 24. examples the examples' counterparts on the card, each part's wall
             printed: a) ``examples/quickstart_torch.py``'s ``main``: the
             campaign half (two ``run`` calls: 2 campaign_sweep launches,
             counted from 0 just before), its spec's JSON line count and
             fired timeline held to the JAX example's (the budget floor's
             data-driven hour within 2 h, cost and GPU-days within the
             statistical bands), 200 train steps of reduced yi-9b (the
             last loss below the first), ``restore`` at step 200, 6
             requests served, 72 tokens; then ``python -m
             repro_torch.campaigns run tests/data/paper_replay.spec.json``
             in-process (1 launch) and its JSON payload; each sweep held
             to the plain versions, the CLI's 1,344-tick lane at its 96 h
             cut; b)
             ``examples/serve_overlay_torch.py``: its two lines equal the
             JAX example's byte for byte; c)
             ``examples/elastic_cloud_train_torch.py`` on a world of one
             NCCL rank it makes itself (pods (1, 1), at most one): 30
             finite losses, the fleet, spend ($530) and ledger lines equal
             to the JAX example's, the rebuild count reported;
 25. planning the what-if planning front door on the fused sweep: a)
             ``sweep(default_suite(), range(8))`` (152 lanes, 6 engine
             batches) and ``sweep(pareto_grid(), range(17))`` (204 lanes,
             4 batches) at full duration through ``drive``: 6 and 4
             campaign_sweep launches, no per-op launch (counted from 0
             just before), each wall, its ``timings=`` split and the
             frontier (``analysis.pareto.frontier``) printed; b) the same
             grids cut to their first 2 seeds at 96 h on the fused and
             plain routes: every lane's integer counters, by_provider
             and events_fired equal, cost, accelerator hours and egress
             within 1e-5 relative, and the kernel against its plain
             version on each cut batch's packed arguments; c) ``python -m
             repro_torch.campaigns pareto --duration-h 96 --seeds
             2021,2022`` in-process: 4 launches, its payload's frontier
             equal to an in-process sweep's; d)
             ``examples/whatif_sweep_torch.py``'s ``main`` at its
             defaults (19 specs x 8 seeds): 6 launches;
 26. report  a ``{"kernels": [...]}`` line (each entry with its route,
             "cuda", and "cuda_route", the kernel's route on the main path:
             "wgmma" or "simt"; flash attention and moe_gmm have one entry
             per route, the simt one, "flash_attention.simt",
             "moe_gmm.simt" and "mlstm_chunk.simt", at the f32 forwards'
             shapes and launches; the four per-op campaign kernels with
             their launches on the ops route, and "campaign_sweep", the
             persistent kernel, with its time per sweep; flash
             attention's and moe_gmm's entries add "mesh_launches", their
             launches in phase 23 b) and c)'s mesh prefills on rank 0 of
             (16, 16), keyed by arch and depth, and
             "one_rank_mesh_launches", phase 23 a)'s on a
             one-rank mesh, which is the plain step; campaign_sweep's
             adds "examples_launches", phase 24's, and
             "planning_launches", phase 25's),
             the nvidia-smi line, and last
             ``{"ok": true, "device": {...}}``.

Device times are per wrapper call: a call that launches several CUDA
kernels (mlstm_chunk: three on either route; mamba_scan with its
sequence in segments: two) counts all of them.

Exits 2 without a card or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import ast
import contextlib
import json
import math
import os
import re
import shutil
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


@contextlib.contextmanager
def counting_drops(dropped: list):
    """Appends, for every capacity stage an MoE call places its slots
    in (``moe._positions``: the naive path's buffers, the sharded path's
    send buckets and local buffers), the number of valid slots that did
    not fit."""
    from repro_torch.models import moe as moe_mod
    positions = moe_mod._positions

    def counting(ids, n, cap, valid=None):
        pos, keep = positions(ids, n, cap, valid)
        fit = keep if valid is None else keep | ~valid
        dropped.append(int((~fit).sum()))
        return pos, keep
    moe_mod._positions = counting
    try:
        yield dropped
    finally:
        moe_mod._positions = positions


def profiled(fn, cpu: bool = True):
    """Run ``fn`` under torch.profiler; returns its CUDA kernel
    averages (empty where the profiler sees no device activity).
    ``cpu=False`` traces the card's activity alone: summing a model
    forward's ~220 k launches then takes a third of the time (38 against
    106 s for the xlstm forward on an NVIDIA H100 80GB HBM3 at 700 W),
    with the same device times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CUDA] + \
        ([ProfilerActivity.CPU] if cpu else [])
    with profile(activities=activities) as prof:
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
# the eager routes' cut grid (``cut_grid``)
CUT_SEEDS = 4
CUT_HOURS = 96.0


def ticks_of(spec) -> int:
    n_ticks, now = 0, 0.0              # the engines' float tick walk
    while now < spec.duration_h:
        n_ticks, now = n_ticks + 1, now + spec.dt_h
    return n_ticks


def cut_grid(specs, seeds, n_seeds=CUT_SEEDS):
    """The grid the eager routes of ``drive`` run: the first ``n_seeds``
    seeds, each campaign cut to CUT_HOURS (their wall is ~294 launches a
    tick from Python, so it follows the ticks, not the lanes)."""
    return ([replace(s, duration_h=min(s.duration_h, CUT_HOURS))
             for s in specs], seeds[:n_seeds])


def compare_lanes(label, rows, other_rows, name) -> None:
    """Each lane's integer counters, fleet, fired events exactly, and its
    cost, accelerator hours and egress within REL, against the lane of
    the same (spec, seed) in ``other_rows``."""
    if len(rows) != len(other_rows):
        fail(f"{label} {name}: {len(other_rows)} rows for {len(rows)}")
    for i, (a, b) in enumerate(zip(rows, other_rows)):
        lane = (a.get("scenario"), a.get("seed"), i)
        for k in INT_COUNTERS:
            if a[k] != b[k]:
                fail(f"{label} {lane}: {k} {a[k]} != {name} {b[k]}")
        if a["by_provider"] != b["by_provider"]:
            fail(f"{label} {lane}: by_provider differs from {name}")
        if list(a["events_fired"]) != list(b["events_fired"]):
            fail(f"{label} {lane}: events_fired differs from {name}")
        for k in ("cost", "accel_hours", "egress_usd"):
            if not math.isfinite(a[k]) or \
                    abs(a[k] - b[k]) > REL * max(abs(b[k]), 1.0):
                fail(f"{label} {lane}: {k} {a[k]} vs {name} {b[k]}")


def batch_keys(specs) -> list:
    """The distinct engine batch keys of ``specs``, in first-seen order
    (the key does not depend on the seed)."""
    from repro_torch.core.sweep_result import _prepare
    keys = []
    for s in specs:
        key = repr(_prepare(s, 0)[0])
        if key not in keys:
            keys.append(key)
    return keys


def drive(label, specs, seeds, cut=False, batches=1,
          eager=("ops", "plain"), cut_seeds=CUT_SEEDS):
    """One sweep on each route of the engine, same device and draws:
    "fused" (the default on the card: one campaign_sweep launch per
    engine batch; ``specs`` must span exactly ``batches``), and the eager
    routes named in ``eager``: "ops" (the eager tick loop through the
    per-op kernels, forced) and "plain" (use_kernels=False).  Launch
    counts are read around each kernel route's run; every lane of each
    eager route is compared with the fused lane of the same grid.  With
    ``cut``, the eager routes run the cut grid of ``cut_grid`` (its first
    ``cut_seeds`` seeds) and the fused route runs both grids (the full
    one timed); without, all routes run the one grid."""
    from repro_torch.core.api import sweep
    from repro_torch.kernels import ops

    keys = batch_keys(specs)
    if len(keys) != batches:
        fail(f"{label}: specs span {len(keys)} engine batches, expected "
             f"{batches}")
    n_ticks = ticks_of(specs[0])
    lanes = len(specs) * len(seeds)
    zero = {name: 0 for name in ops.LAUNCHES}
    e_specs, e_seeds = cut_grid(specs, seeds, cut_seeds) if cut \
        else (specs, seeds)
    e_ticks, e_lanes = ticks_of(e_specs[0]), len(e_specs) * len(e_seeds)

    def run(route, grid=(specs, seeds)):
        ops.reset_launches()
        split = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if route == "plain":
            res = sweep(*grid, use_kernels=False, timings=split)
        else:
            with ops._force_route("campaign_sweep", route):
                res = sweep(*grid, timings=split)
        torch.cuda.synchronize()
        return (res, time.perf_counter() - t0, dict(ops.LAUNCHES),
                dict(ops.SWEEP_ROUTES), split)

    got, t_fused, launches, routes, split = run("fused")
    if launches != {**zero, "campaign_sweep": batches} or \
            routes != {"campaign_sweep.fused": batches,
                       "campaign_sweep.ops": 0}:
        fail(f"{label} fused: launches {launches}, routes {routes}; "
             f"expected {batches} campaign_sweep launch(es) and no per-op "
             "launch")
    ref_rows = run("fused", (e_specs, e_seeds))[0].rows if cut else got.rows
    walls, launches_ops = {}, None
    for route in eager:
        other, walls[route], counted, routed, _ = run(route,
                                                      (e_specs, e_seeds))
        if route == "ops":
            launches_ops = counted
            expect = {**zero, **{k: n * e_ticks * batches
                                 for k, n in OPS_PER_TICK.items()}}
            if counted != expect or routed["campaign_sweep.ops"] != batches:
                fail(f"{label} ops: launches {counted}, expected {expect}")
        elif any(counted.values()):
            fail(f"{label} plain: launches {counted}")
        compare_lanes(label, ref_rows, other.rows, route)

    if len(got.rows) != lanes or len(ref_rows) != e_lanes:
        fail(f"{label}: {len(got.rows)} / {len(ref_rows)} rows for "
             f"{lanes} / {e_lanes} lanes")
    for a in got.rows:
        if not (a["cost"] > 0 and a["accel_hours"] > 0
                and a["jobs_finished"] > 0):
            fail(f"{label} {(a['scenario'], a['seed'])}: empty campaign {a}")
    costs = [r["cost"] for r in got.rows]

    def rate(t, n_lanes=lanes, ticks=n_ticks):
        return (f"{t:.3f} s ({n_lanes / t:.1f} campaigns/s, "
                f"{1e3 * t / ticks:.3f} ms/tick)")
    on_cut = "" if not cut else \
        f" ({', '.join(eager)} on the cut grid: {e_lanes} lanes x " \
        f"{e_ticks} ticks)"
    ops_txt = "" if launches_ops is None else \
        f", ops launches { {k: launches_ops[k] for k in OPS_PER_TICK} }"
    log(f"[{label}] {lanes} lanes x {n_ticks} ticks in {batches} "
        f"batch(es): fused {rate(t_fused)}; "
        + "; ".join(f"{r} {rate(walls[r], e_lanes, e_ticks)}"
                    for r in eager)
        + f"{on_cut}; cost ${min(costs):,.0f}..${max(costs):,.0f}; fused "
        f"launches {launches['campaign_sweep']}{ops_txt}")
    return {"lanes": lanes, "ticks": n_ticks, "fused_s": t_fused,
            "ops_s": walls.get("ops"), "plain_s": walls.get("plain"),
            "launches": launches, "launches_ops": launches_ops,
            "split": split, "eager_grid": (e_lanes, e_ticks),
            "result": got}


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


def check_sweep(dev, specs, seeds, timed=True) -> dict:
    """The persistent sweep kernel against its plain version on the
    grid's packed arguments: integer fields and flags exactly, f32 fields
    within 1e-6 relative; with ``timed``, its time per sweep (CUDA
    events), device time (profiler), the plain version's time and the
    bound, else only the largest f32 error."""
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
                fail(f"campaign_sweep: {k} differs from the plain version "
                     f"({eng.B} lanes x {eng.N} ticks)")
        elif not torch.equal(got[k], v):
            fail(f"campaign_sweep: {k} differs from the plain version "
                 f"({eng.B} lanes x {eng.N} ticks)")
    if not timed:
        return {"max_abs_err": err, "lanes": eng.B, "ticks": eng.N}
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
    # the model zoo's shapes (phases 17-20): qwen3-moe-30b-a3b's after its
    # qk-norm (q and k RMS-normed per head, as the model feeds them),
    # internvl2-2b's over 256 patches + 3,840 tokens, whisper-large-v3's
    # decoder self-attention (D 64, 448 queries: 3.5 tiles of 128)
    ("qwen3-qknorm", True, (2, 4096, 4096, 32, 4, 128, True),
     {"qk_norm": True}),
    ("internvl2", True, (2, 4096, 4096, 16, 8, 128, True), {}),
    ("whisper-dec", True, (2, 448, 448, 20, 20, 64, True), {}),
    # a "model" rank's heads of yi-9b on the (16, 16) mesh (phase 23):
    # 2 q heads reading 1 kv head
    ("yi-9b-tp16", True, (2, 4096, 4096, 2, 1, 128, True), {}),
    # a (16, 16) rank's share of whisper's decoder self-attention in its
    # mesh prefill (phase 23 b, S=4096): its group of 5 of 20 heads, its
    # later chunk of query rows (of 8 chunks of 512) against every key
    # before it, through the model layout's q_offset
    ("whisper-tp16", True, (2, 512, 4096, 5, 5, 64, True),
     {"q_offset": 3584}),
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
            if kw.get("qk_norm"):
                from repro_torch.models.layers import rms_head_norm
                one = torch.ones(D, device=dev)
                q, k = rms_head_norm(q, one), rms_head_norm(k, one)
            if model:
                q_off = kw.get("q_offset", 0)

                def kern():
                    return ops.flash_attention(q, k, v, causal=causal,
                                               q_offset=q_off)

                def plain():
                    return ref.flash_attention_model_ref(
                        q, k, v, causal=causal, q_offset=q_off)
                qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))
                mask = None
                if q_off:
                    kpos = torch.arange(Skv, device=dev)
                    mask = (q_off + torch.arange(Sq, device=dev)[:, None]
                            >= kpos[None, :])
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
    kern = profiled(fn, cpu=False)
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
    drops, so a prefill that drops would differ by design; an
    encoder-decoder's decode cache takes the prefill's cross kv)."""
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import BatchServer, Request
    from repro_torch.models import decode_step, init_cache, prefill

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
    kern = profiled(steps8, cpu=False)
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
    dropped = []
    batch = {"tokens": prompt}
    if cfg.is_encdec:                  # the frames the prefill encodes
        batch["enc_embeds"] = 0.02 * torch.randn(
            (1, cfg.encoder.n_frames, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(5))
    with counting_drops(dropped):
        pre, pre_caches = prefill(params, cfg, batch,
                                  compute_dtype=torch.float32)
    n_moe = cfg.n_super * sum(f == "moe" for _, f in cfg.block_defs)
    if len(dropped) != n_moe or any(dropped):
        fail(f"{tag}: the prefill's MoE layers dropped {dropped} tokens "
             f"({n_moe} layers); the check needs a drop-free prompt")
    caches = init_cache(cfg, 1, 9, torch.float32, device=dev)
    if cfg.is_encdec:                  # decode against the same encoding
        for c, pc in zip(caches, pre_caches):
            for name in c:
                c[name]["cross"] = pc[name]["cross"]
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
             ("unaligned", 3, 72, 40, 56),
             # qwen3-moe-30b-a3b's at B*S = 8192 (phase 17): 128 experts
             # of C = 640, d_model 2048 -> F 768 and back
             ("qwen3-up-c640", 128, 640, 2048, 768),
             ("qwen3-down-c640", 128, 640, 768, 2048),
             # a (16, 16) rank's local experts in phase 23 b)'s qwen3
             # prefill (B*S = 2 x 4096 a rank): 128 / 16 = 8 experts of
             # F = 768 / 16 = 48, 12,800 slots (moe_sharded's local
             # capacity at factors 1.25 and 1.25)
             ("qwen3-tp16-up", 8, 12800, 2048, 48),
             ("qwen3-tp16-down", 8, 12800, 48, 2048),
             # and in its jamba prefill (phase 23 c): 16 / 16 = 1 expert
             # of F = 14336 / 16 = 896, 25,600 slots (16 ranks' 1,280
             # sends at factor 1.25)
             ("jamba-tp16-up", 1, 25600, 4096, 896),
             ("jamba-tp16-down", 1, 25600, 896, 4096)]
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
    """forward_loss at full width (``XLSTM_LAYERS`` deep) through the
    mlstm_chunk kernel (the resolver's hooks for attention_impl="pallas")
    and the chunked reference path, in bf16 (B=2) and f32 (B=1); per dtype the
    losses, times and launches, and from the bf16 kernel forward's
    profile (the only one) the device ms per mlstm_chunk call."""
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
            if label != "kernel":
                continue
            # one profile, the bf16 kernel forward's: each of the ~220 k
            # launches of the sLSTM step loop costs the profiler too
            kern = {"launches": launches["mlstm_chunk"], "device_ms": None}
            if dtype == torch.bfloat16:
                prof = profile_forward(
                    lambda: forward_loss(params, cfg, batch,
                                         compute_dtype=dtype, **kw),
                    secs[label], tag=f"xlstm {label} {str(dtype)[6:]}",
                    kernels=(MLSTM_KERNEL[route],))
                kern["device_ms"] = prof[MLSTM_KERNEL[route]]
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


# -- phase 16: training -----------------------------------------------------

TRAIN_ARCHS = ("whisper-large-v3", "qwen3-moe-30b-a3b", "kimi-k2-1t-a32b",
               "minicpm3-4b", "yi-9b", "nemotron-4-15b", "minitron-8b",
               "jamba-v0.1-52b", "internvl2-2b", "xlstm-350m")
# yi-9b at full width, 4 of its 48 layers: 48 layers' f32 train state
# (params + grads + mu + nu, ~141 GB) would not fit the card's 80 GB
TRAIN_LAYERS = 4
TRAIN_STEPS = 6


def train_vs_cpu(dev) -> None:
    """a) the reduced models, f32, REDUCED_SHAPE: 3 train steps on the
    card and on the CPU from the same parameters and batches; losses
    within 1e-5 relative, grad_norm within 1e-4, every parameter within
    2 x the summed learning rates (the bound of tests/test_torch_train.py:
    an AdamW step moves an element by about lr whatever its gradient)."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, get_reduced
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten, map_tree

    for arch in TRAIN_ARCHS:
        cfg = get_reduced(arch)
        run = RunConfig(model=cfg, shape=REDUCED_SHAPE,
                        compute_dtype="float32")
        cpu_p = init_params(cfg, 2021, device="cpu")
        out = {}
        ops.reset_launches()
        for where, p in (("cpu", cpu_p),
                         ("card", map_tree(lambda x: x.to(dev, copy=True),
                                           cpu_p))):
            step, opt, ms = make_train_step(cfg, run), adamw_init(p), []
            for s in range(3):
                p, opt, m = step(p, opt, make_batch(
                    cfg, REDUCED_SHAPE, s, seed=7,
                    device="cpu" if where == "cpu" else dev))
                ms.append({k: float(v) for k, v in m.items()})
            out[where] = (ms, [x.detach().cpu() for _, x in flatten(p)])
        if any(ops.LAUNCHES.values()):
            fail(f"train {arch}: the train step launched {ops.LAUNCHES}")
        bound = 2 * sum(m["lr"] for m in out["cpu"][0])
        loss_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                       for a, b in zip(out["card"][0], out["cpu"][0]))
        gn_rel = max(abs(a["grad_norm"] - b["grad_norm"]) / b["grad_norm"]
                     for a, b in zip(out["card"][0], out["cpu"][0]))
        p_err = max(float((a - b).abs().max())
                    for a, b in zip(out["card"][1], out["cpu"][1]))
        if not (loss_rel <= 1e-5 and gn_rel <= 1e-4 and p_err <= bound):
            fail(f"train {arch}: card vs CPU loss {loss_rel:.3g} (tol "
                 f"1e-5), grad_norm {gn_rel:.3g} (tol 1e-4), params "
                 f"{p_err:.3g} (bound {bound:.3g})")
        log(f"[train] {cfg.name} f32 3 steps, card vs CPU: loss "
            f"{loss_rel:.3g} relative (tol 1e-5), grad_norm {gn_rel:.3g} "
            f"(tol 1e-4), params max abs {p_err:.3g} (bound {bound:.3g}); "
            f"losses {[round(m['loss'], 6) for m in out['card'][0]]}")


def full_width_train(dev, dtype: str, batch: int) -> dict:
    """b) / c) yi-9b at full width, TRAIN_LAYERS deep, S=4096,
    grad_accum 2, remat on (as ``build`` sets it for a full config):
    before step 0, forward_loss without a gradient on its two
    microbatches, on the reference path and through the flash kernel
    (attention_impl="pallas"); then TRAIN_STEPS timed steps and one
    profiled."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss, param_count

    cfg, shape, run = train.build("yi-9b", reduced=False, batch=batch,
                                  seq=4096, compute_dtype=dtype,
                                  grad_accum=2)
    cfg = replace(cfg, num_layers=TRAIN_LAYERS)
    run = run.replace(model=cfg)
    rel = 1e-2 if dtype == "bfloat16" else 1e-6
    torch.cuda.reset_peak_memory_stats()
    tr = train.Trainer(cfg, shape, run, seed=2021, device=dev)
    n_params = param_count(tr.params)
    b0, n = tr.pipe.batch(0), batch // 2
    mbs = [{k: v[i * n:(i + 1) * n] for k, v in b0.items()} for i in (0, 1)]
    hooks = _resolve_kernels(run.replace(attention_impl="pallas"))
    before = {}
    with torch.no_grad():
        for label, kw in (("reference", {}), ("kernel", hooks)):
            ops.reset_launches()
            before[label] = sum(float(forward_loss(
                tr.params, cfg, mb, compute_dtype=getattr(torch, dtype),
                run_cfg=run, **kw)[0]) for mb in mbs) / 2
            want = 2 * TRAIN_LAYERS if label == "kernel" else 0
            if ops.LAUNCHES["flash_attention"] != want:
                fail(f"train {dtype}: {label} forward launched "
                     f"{ops.LAUNCHES}, expected {want} flash launches")
    ops.reset_launches()
    secs, losses, gnorms = [], [], []
    for s in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses += tr.train(s + 1, log_every=0)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        gnorms.append(tr.last_metrics["grad_norm"])
    if not all(math.isfinite(g) and g > 0 for g in gnorms):
        fail(f"train {dtype}: grad_norm {gnorms}")
    if any(ops.LAUNCHES.values()):
        fail(f"train {dtype}: the train steps launched {ops.LAUNCHES}")
    ln_v = math.log(cfg.vocab_size)
    if not all(math.isfinite(x) and abs(x - ln_v) <= 2.0 for x in losses):
        fail(f"train {dtype}: losses {losses} not within 2.0 of ln "
             f"{cfg.vocab_size} = {ln_v:.4f}")
    d_ref = abs(losses[0] - before["reference"]) / abs(before["reference"])
    d_kern = abs(losses[0] - before["kernel"]) / abs(before["kernel"])
    tol_kern = 1e-2 if dtype == "bfloat16" else 1e-4
    if not (d_ref <= rel and d_kern <= tol_kern):
        fail(f"train {dtype}: step 0's loss {losses[0]} vs forward_loss "
             f"{before['reference']} ({d_ref:.3g}, tol {rel}) and through "
             f"the flash kernel {before['kernel']} ({d_kern:.3g}, tol "
             f"{tol_kern})")
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(secs[2:]))
    # one more step, profiled: the device's busy share of a step
    kern = profiled(lambda: tr.train(TRAIN_STEPS + 1, log_every=0),
                    cpu=False)
    busy = sum(e.self_device_time_total for e in kern) / 1e6 if kern \
        else None
    tokens = batch * shape.seq_len
    res = {"dtype": dtype, "params": n_params, "batch": batch,
           "seq": shape.seq_len, "grad_accum": 2, "losses": losses,
           "grad_norms": gnorms,
           "step_s": secs, "median_step_s": step_s,
           "tokens_per_s": tokens / step_s, "peak_bytes": peak,
           "busy_s": busy, "busy_share": busy / step_s if busy else None,
           "loss_vs_forward": d_ref, "loss_vs_kernel_forward": d_kern}
    log(f"[train] {cfg.name} {TRAIN_LAYERS}L full width {dtype} "
        f"({n_params / 1e9:.3f} B params) B={batch} S={shape.seq_len} "
        f"grad_accum 2 remat: losses {[round(x, 4) for x in losses]}, "
        f"grad_norm {[round(g, 4) for g in gnorms]}; "
        f"step 0 vs forward_loss {d_ref:.3g} (tol {rel}), vs the flash "
        f"kernel's forward {d_kern:.3g} (tol {tol_kern}); step s "
        f"{[round(x, 3) for x in secs]}, median of steps 2-"
        f"{TRAIN_STEPS - 1} {step_s:.3f} s ({tokens / step_s:.1f} train "
        f"tokens/s); peak {peak / 2 ** 30:.1f} GiB")
    if kern:
        log(f"[train] profile {dtype}: device busy {busy:.3f} s of a "
            f"{step_s:.3f} s step ({100 * busy / step_s:.1f}%), "
            f"{sum(e.count for e in kern)} kernel launches")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"[train]   {e.self_device_time_total / 1e3:9.1f} ms "
                f"{e.count:6d}x  {e.key[:90]}")
    else:
        log(f"[train] profile {dtype}: device time not measured: the "
            "profiler trace holds no CUDA kernels")
    return res


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


PREEMPT_LAYERS = 1             # d)'s depth: the checkpoints' disk time


def preemption_round_trip(dev) -> dict:
    """d) on the model of b) (f32, full width) cut to PREEMPT_LAYERS: train
    4 steps with a save_blocking at step 2 and a save_async at step 4; a
    new Trainer on the directory restores step 4 (the latest); restore
    step 2, run steps 3-4; the parameters equal the uninterrupted run's
    within rtol = atol = 1e-6 (the JAX package's test's tolerance).
    Where the disk cannot hold two checkpoints, the reduced yi-9b of a)
    at the same depth instead.  The directory is deleted afterwards."""
    from repro_torch.configs import get_reduced
    from repro_torch.launch import train
    from repro_torch.models import param_count
    from repro_torch.tree import flatten

    ckpt = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    ckpt.mkdir(parents=True)
    cfg, shape, run = train.build("yi-9b", reduced=False, batch=2, seq=4096,
                                  grad_accum=2)
    cfg = replace(cfg, num_layers=PREEMPT_LAYERS)
    need = 2 * 3 * 4 * param_count(train.init_params(cfg, 0,
                                                     device="meta"))
    free = shutil.disk_usage(ckpt).free
    model = "full width"
    if free < 1.2 * need:
        log(f"[train] preemption: {free / 1e9:.1f} GB free, two "
            f"checkpoints need {need / 1e9:.1f} GB: the round trip runs "
            f"on reduced yi-9b, {PREEMPT_LAYERS} layers, instead")
        cfg = replace(get_reduced("yi-9b"), num_layers=PREEMPT_LAYERS)
        model = "reduced"
    run = run.replace(model=cfg)
    try:
        tr = train.Trainer(cfg, shape, run, ckpt_dir=str(ckpt), seed=2021,
                           device=dev)
        tr.train(2, log_every=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.ckpt.save_blocking(2, tr.trees())
        save_s = time.perf_counter() - t0
        tr.train(4, log_every=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.ckpt.save_async(4, tr.trees())
        async_block_s = time.perf_counter() - t0
        tr.ckpt.wait()
        async_total_s = time.perf_counter() - t0
        nbytes = _dir_bytes(ckpt / "step_0000000004")
        full = tr.params
        del tr
        torch.cuda.empty_cache()

        tr = train.Trainer(cfg, shape, run, ckpt_dir=str(ckpt), seed=2021,
                           device=dev)
        if tr.step_num != 4:
            fail(f"train preemption: a new Trainer resumed at step "
                 f"{tr.step_num}, not the latest checkpoint's 4")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.restore(str(ckpt), step=2)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        tr.train(4, log_every=0)
        pairs = list(zip([x.detach() for _, x in flatten(tr.params)],
                         [x.detach() for _, x in flatten(full)]))
        err = max(float((a - b).abs().max()) for a, b in pairs)
        close = all(torch.allclose(a, b, rtol=1e-6, atol=1e-6)
                    for a, b in pairs)
        bitwise = all(torch.equal(a, b) for a, b in pairs)
        if not close:
            fail(f"train preemption: resumed parameters differ from the "
                 f"uninterrupted run's by {err:.3g} (rtol = atol = 1e-6)")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    res = {"model": model, "checkpoint_bytes": nbytes, "save_blocking_s":
           save_s, "save_async_blocks_s": async_block_s,
           "save_async_total_s": async_total_s, "restore_s": restore_s,
           "max_abs_err": err, "bitwise": bitwise}
    log(f"[train] preemption round trip ({model}, {PREEMPT_LAYERS} "
        f"layer(s), f32): checkpoint "
        f"{nbytes / 1e9:.2f} GB (params + mu + nu), save_blocking "
        f"{save_s:.2f} s, save_async blocks the step {async_block_s:.2f} s "
        f"(written after {async_total_s:.2f} s), restore {restore_s:.2f} "
        f"s; resumed vs uninterrupted max abs {err:.3g} (rtol = atol = "
        f"1e-6), bitwise equal: {bitwise}")
    return res

# -- phases 17-20: the rest of the model zoo ---------------------------------

# (arch, layers kept (None: the full depth), the batch's seq_len, an f32
# B=1 forward on the CUDA-core routes too, a server run): qwen3's 48
# layers would be ~120 GB in f32, 8 of them (~5.6 B parameters) fit the
# card; internvl2-2b's 4,096 positions are 256 patches + 3,840 tokens;
# whisper-large-v3's decoder reads 448 tokens over 1,500 frames
ZOO = (("qwen3-moe-30b-a3b", 8, 4096, True, True),
       ("minicpm3-4b", None, 4096, False, True),
       ("internvl2-2b", None, 4096, False, False),
       ("whisper-large-v3", None, 448, False, True))


def zoo_launches(cfg) -> dict:
    """A forward's kernel launches: flash once per decoder self-attention
    (MLA, an encoder and cross-attention run the chunked path, as in the
    JAX package), moe_gmm three times per MoE layer."""
    layers = cfg.block_defs * cfg.n_super
    attn = sum(m == "attn" for m, _ in layers)
    return {"flash_attention": 0 if cfg.attention_type == "mla" else attn,
            "moe_gmm": 3 * sum(f == "moe" for _, f in layers)}


def zoo_forward_phase(params, cfg, dev, seq: int, with_f32: bool) -> dict:
    """forward_loss at full width through the kernels (the resolver's
    hooks for attention_impl="pallas") and the reference path, bf16 B=2
    (and f32 B=1 with ``with_f32``), on the port's own synthetic batch
    (make_batch: zipf tokens, 0.02 N(0,1) frame or patch embeds): the
    launches and routes of zoo_launches, a finite loss within 2.0 of
    ln vocab, kernels vs reference within 1e-2 (bf16) / 1e-4 (f32)
    relative; the wall, and a profiled kernels forward (the device's
    busy share, device ms per launch)."""
    from repro_torch.configs import REDUCED_SHAPE, RunConfig, ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import _resolve_kernels
    from repro_torch.models import forward_loss

    hooks = _resolve_kernels(RunConfig(model=cfg, shape=REDUCED_SHAPE,
                                       attention_impl="pallas"))
    kernel_launches = zoo_launches(cfg)
    ln_v = math.log(cfg.vocab_size)
    runs = [(torch.bfloat16, 2, 1e-2)] + \
        ([(torch.float32, 1, 1e-4)] if with_f32 else [])
    out = {}
    for dtype, B, rel in runs:
        batch = make_batch(cfg, ShapeConfig("zoo", seq, B, "train"), 0,
                           seed=2021, device=dev)
        shapes = {k: tuple(v.shape) for k, v in batch.items()}
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
                fail(f"zoo {cfg.name} {label} {dtype}: launches {launches}, "
                     f"expected {want}")
            route = "wgmma" if dtype == torch.bfloat16 else "simt"
            want_routes = {name: 0 for name in routes}
            for op in ("flash_attention", "moe_gmm"):
                want_routes[f"{op}.{route}"] = want[op]
            if routes != want_routes:
                fail(f"zoo {cfg.name} {label} {dtype}: routes {routes}, "
                     f"expected {want_routes}")
            losses[label] = float(loss)
            if not math.isfinite(losses[label]) or \
                    abs(losses[label] - ln_v) > 2.0:
                fail(f"zoo {cfg.name} {label} {dtype}: loss "
                     f"{losses[label]} not within 2.0 of ln "
                     f"{cfg.vocab_size} = {ln_v:.4f}")
            log(f"[zoo] {cfg.name} {cfg.num_layers}L {str(dtype)[6:]} "
                f"{shapes} via {label}: loss {losses[label]:.6f} (aux "
                f"{float(parts['aux']):.6f}), {secs[label]:.3f} s "
                f"({batch['tokens'].numel() / secs[label]:.1f} tokens/s), "
                f"launches { {k: launches[k] for k in kernel_launches} } "
                f"({ {k: n for k, n in routes.items() if n} }), peak "
                f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
            if label == "kernels":
                prof = profile_forward(
                    lambda: forward_loss(params, cfg, batch,
                                         compute_dtype=dtype, **kw),
                    secs[label], tag=f"zoo {cfg.name} {str(dtype)[6:]}",
                    kernels=("flash_attention_kernel", "moe_gmm_kernel"))
                out[route] = {"launches": {k: launches[k]
                                           for k in kernel_launches},
                              "device_ms": prof}
        d = abs(losses["kernels"] - losses["reference"]) \
            / abs(losses["reference"])
        if d > rel:
            fail(f"zoo {cfg.name} {dtype}: kernel loss {losses['kernels']} "
                 f"vs reference {losses['reference']} ({d:.3g} relative > "
                 f"{rel})")
        log(f"[zoo] {cfg.name} {str(dtype)[6:]}: kernels vs reference loss "
            f"{d:.3g} relative (tol {rel})")
        out[str(dtype)] = {"losses": losses, "secs": secs, "rel": d}
        del batch
        torch.cuda.empty_cache()
    return out


def encdec_continue(params, cfg, dev) -> None:
    """An encoder-decoder's prefill, then 8 decode steps from its caches
    (self kv copied into a longer cache, cross kv as the prefill made
    it), f32 B=1: step t's logits within 1e-3 of the prefill of t + 1
    tokens."""
    from repro_torch.models import decode_step, init_cache, prefill

    rng = np.random.default_rng(3)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 16))
                           .astype(np.int32)).to(dev)
    enc = 0.02 * torch.randn((1, cfg.encoder.n_frames, cfg.d_model),
                             device=dev,
                             generator=torch.Generator(device=dev)
                             .manual_seed(6))
    f32 = torch.float32
    _, pre = prefill(params, cfg, {"tokens": tok[:, :8], "enc_embeds": enc},
                     compute_dtype=f32)
    caches = init_cache(cfg, 1, 16, f32, device=dev)
    for c, pc in zip(caches, pre):
        for name in c:
            for kv in ("k", "v"):
                c[name]["self"][kv][:, :8] = pc[name]["self"][kv]
            c[name]["cross"] = pc[name]["cross"]
    errs = []
    for t in range(8, 16):
        got, caches = decode_step(params, cfg, caches, tok[:, t:t + 1], t,
                                  compute_dtype=f32)
        want, _ = prefill(params, cfg, {"tokens": tok[:, :t + 1],
                                        "enc_embeds": enc},
                          compute_dtype=f32)
        vocab = cfg.vocab_size
        errs.append(float((got[..., :vocab] - want[..., :vocab])
                          .abs().max()))
    if not max(errs) <= 1e-3:
        fail(f"encdec {cfg.name}: decode from the prefill's caches vs "
             f"the next prefill: max abs errs {errs} (tol 1e-3)")
    log(f"[encdec] {cfg.name} f32: prefill of 8 tokens, then 8 decode "
        f"steps from its caches vs the prefill of t + 1 tokens: max abs "
        f"err {max(errs):.3g} (first step {errs[0]:.3g}; tol 1e-3)")


def zoo_phases(dev, t_start: float) -> dict:
    """Phases 17-20: each model of ZOO initialised on the card (seed
    2021), its forwards, its server run, then freed."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, param_count
    out = {}
    for arch, layers, seq, with_f32, serve in ZOO:
        cfg = get_config(arch)
        full = cfg.num_layers
        if layers is not None:
            cfg = replace(cfg, num_layers=layers)
        t0 = time.perf_counter()
        params = init_params(cfg, 2021, device=dev)
        torch.cuda.synchronize()
        enc = f" + {cfg.encoder.num_layers} encoder" if cfg.is_encdec else ""
        log(f"[model] {cfg.name}: {param_count(params) / 1e9:.3f} B f32 "
            f"parameters ({cfg.num_layers} of {full} layers{enc}; d_model "
            f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}) "
            f"initialised on the card in {time.perf_counter() - t0:.2f} s; "
            f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")
        out[arch] = zoo_forward_phase(params, cfg, dev, seq, with_f32)
        if serve:
            serve_phase(params, cfg, dev, tag=f"zoo-serve {arch}")
        if cfg.is_encdec:
            encdec_continue(params, cfg, dev)
        del params
        torch.cuda.empty_cache()
        log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    return out


# -- phase 21: the distributed layer -------------------------------------------

# a) qwen3-moe-30b-a3b's MoE layer at full width, B*S = 2 x 4096 tokens, at
# the config's capacity factor of 1.25: 640 slots an expert (local capacity
# factor 1: the sharded path's expert buffers are the naive path's), the
# shape gmm cases qwen3-up-c640 / qwen3-down-c640 hold against the plain
# version; the busiest expert takes ~590 of them from these inputs, so
# neither path drops (counted)
MOE_TOKENS = (2, 4096)
# c) the elastic runner: steps before and after the forced rebuild
ELASTIC_STEPS = 3
TRACE = "tests/data/outage_burst.instances.jsonl.gz"


def sharded_moe_check(dev) -> dict:
    """a) ``apply_moe`` under ``use_mesh`` on a (1, 1) ("data", "model")
    mesh (the sharded path: all-to-alls, local buffers, the "model"
    all-reduce) and ``apply_moe`` outside it (the naive path), both
    through the moe_gmm kernel, against ``apply_moe`` with no ``gmm_fn``
    (the naive path's einsums: the plain version), f32 and bf16: max
    |err| / max |plain| within 1e-5 / 1e-2 for each path, and sharded vs
    naive within the same; 3 moe_gmm launches a call on each kernel
    path, none on the plain one; no drops on any (counted); the int8
    dispatch against the f32 sharded path: every element of the expert
    buffer within half its slot's scale, max |x| / 254 (the int8 wire's
    bound), plus f32 rounding; ms per call of each."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import moe_sharded as ms
    from repro_torch.sharding_ctx import make_mesh, use_mesh

    cfg = replace(get_config("qwen3-moe-30b-a3b"), num_layers=1)
    cf = cfg.moe.capacity_factor
    p = init_params(cfg, 2021, device=dev)["stack"][0]["b0"]["ffn"]
    torch.cuda.empty_cache()
    mesh = make_mesh((1, 1), ("data", "model"), "cuda")
    x32 = torch.randn(MOE_TOKENS + (cfg.d_model,), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(5))
    n_tok = math.prod(MOE_TOKENS)
    slots = moe_mod.capacity(n_tok, cfg.moe)
    bufs = {}
    expert_ffn = ms._expert_ffn

    def capturing_ffn(pl, buf, ffn_type, gmm_fn):
        bufs["last"] = buf.detach().clone()
        return expert_ffn(pl, buf, ffn_type, gmm_fn)

    def call(x, path, quant="none"):
        """path: "plain" (naive, einsums), "naive" or "sharded" (moe_gmm)."""
        moe = replace(cfg.moe, local_capacity_factor=1.0,
                      dispatch_quant=quant)
        gmm = None if path == "plain" else ops.moe_gmm
        with torch.no_grad():
            if path != "sharded":
                return moe_mod.apply_moe(p, x, moe, cfg.ffn_type,
                                         gmm_fn=gmm)[0]
            with use_mesh(mesh):
                return moe_mod.apply_moe(p, x, moe, cfg.ffn_type,
                                         gmm_fn=gmm)[0]

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()
                     / b.float().abs().max())

    out = {"capacity_factor": cf, "slots": slots, "tokens": n_tok}
    paths = ("plain", "naive", "sharded")
    for dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        x = x32.to(dtype)
        ys, launches, drops = {}, {}, {}
        for path in paths:
            ops.reset_launches()
            with counting_drops([]) as dropped:
                ys[path] = call(x, path)
                torch.cuda.synchronize()
            launches[path] = ops.LAUNCHES["moe_gmm"]
            # one capacity stage on the naive paths, two on the sharded
            drops[path] = dropped
        if launches != {"plain": 0, "naive": 3, "sharded": 3}:
            fail(f"distributed moe {dtype}: moe_gmm launches {launches}, "
                 "expected 3 a call on each kernel path, 0 on the plain one")
        if [len(drops[k]) for k in paths] != [1, 1, 2] \
                or any(sum(v) for v in drops.values()):
            fail(f"distributed moe {dtype}: drops by stage {drops} at "
                 f"capacity factor {cf} ({slots} slots an expert); the "
                 "comparison needs none")
        for path in paths:
            if ys[path].shape != x.shape \
                    or not torch.isfinite(ys[path]).all():
                fail(f"distributed moe {dtype}: {path} output "
                     f"{tuple(ys[path].shape)} not finite or shaped "
                     f"{tuple(x.shape)}")
        errs = {"naive vs plain": rel(ys["naive"], ys["plain"]),
                "sharded vs plain": rel(ys["sharded"], ys["plain"]),
                "sharded vs naive": rel(ys["sharded"], ys["naive"])}
        if max(errs.values()) > tol:
            fail(f"distributed moe {dtype}: {errs} of max |y| (tol {tol})")
        out[str(dtype)] = {"errs": errs, "launches": launches}
    ms._expert_ffn = capturing_ffn
    try:
        y32 = call(x32, "sharded")
        buf32 = bufs["last"]
        y8 = call(x32, "sharded", quant="int8")
        buf8 = bufs["last"]
    finally:
        ms._expert_ffn = expert_ffn
    # |err| <= scale / 2 with scale = max|x| / 127 + 1e-12, plus the f32
    # roundings of x / scale and of q * scale (each <= 127 x 2**-24 of
    # the scale)
    scale = buf32.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    excess = float(((buf8 - buf32).abs() - scale * (0.5 + 1e-4)).max())
    y8_err = rel(y8, y32)
    if excess > 0 or not math.isfinite(y8_err):
        fail(f"distributed moe int8: the dispatched buffer exceeds its int8 "
             f"bound by {excess:.3g}; output err {y8_err:.3g}")
    out["int8"] = {"buffer_excess": excess, "err": y8_err}
    x16 = x32.to(torch.bfloat16)
    for label, x, path, quant in (("plain f32", x32, "plain", "none"),
                                  ("naive f32", x32, "naive", "none"),
                                  ("sharded f32", x32, "sharded", "none"),
                                  ("plain bf16", x16, "plain", "none"),
                                  ("naive bf16", x16, "naive", "none"),
                                  ("sharded bf16", x16, "sharded", "none"),
                                  ("sharded int8", x32, "sharded", "int8")):
        out[f"{label} ms"] = time_ms(lambda: call(x, path, quant),
                                     iters=5, warmup=1)
    # where a bf16 call's device time goes, on each kernel path
    for label, path in (("naive bf16", "naive"), ("sharded bf16", "sharded")):
        kern = profiled(lambda: call(x16, path), cpu=False)
        if not kern:
            log(f"[distributed] profile {label}: device time not measured: "
                "the profiler trace holds no CUDA kernels")
            continue
        busy = sum(e.self_device_time_total for e in kern) / 1e3
        out[f"{label} busy ms"] = busy
        log(f"[distributed] profile {label}: device busy {busy:.2f} ms of a "
            f"{out[label + ' ms']:.2f} ms call, "
            f"{sum(e.count for e in kern)} kernel launches")
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"[distributed]   {e.self_device_time_total / 1e3:8.2f} ms "
                f"{e.count:4d}x  {e.key[:90]}")
    f32, b16 = out[str(torch.float32)], out[str(torch.bfloat16)]
    log(f"[distributed] moe: qwen3-moe-30b-a3b layer, {n_tok} tokens, "
        f"capacity factor {cf} ({slots} slots an expert, no drops on any "
        f"path); of max |y|, f32 (tol 1e-5) " + ", ".join(
            f"{k} {v:.3g}" for k, v in f32["errs"].items())
        + "; bf16 (tol 1e-2) " + ", ".join(
            f"{k} {v:.3g}" for k, v in b16["errs"].items())
        + f"; moe_gmm launches a call {f32['launches']}; int8 dispatch: "
        f"buffer within its bound (excess {excess:.3g}), output "
        f"{y8_err:.3g} of max |y|; ms a call: " + ", ".join(
            f"{k[:-3]} {v:.3f}" for k, v in out.items()
            if k.endswith(" ms") and "busy" not in k))
    return out


def compression_check(dev) -> dict:
    """b) ``compressed_tree_psum_mean`` on one rank ("pod" of 1) over a
    gradient-sized tree, phase 16's yi-9b parameters (TRAIN_LAYERS
    deep, 1.229 B f32 elements), two steps with error feedback: each
    mean equals dequantize(quantize(x + r)) exactly, each residual is
    within scale / 2 (plus f32 rounding); ``wire_bytes``."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim.compress import (compressed_tree_psum_mean,
                                            dequantize_int8, quantize_int8,
                                            wire_bytes)
    from repro_torch.sharding_ctx import make_mesh
    from repro_torch.tree import leaves

    cfg = replace(get_config("yi-9b"), num_layers=TRAIN_LAYERS)
    grads = init_params(cfg, 2021, device=dev)
    group = make_mesh((1,), ("pod",), "cuda").get_group("pod")
    n = sum(x.numel() for x in leaves(grads))
    resid, secs, worst = None, [], 0.0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        means, new_resid = compressed_tree_psum_mean(grads, group, resid)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        olds = leaves(resid) if resid is not None else [None] * len(means)
        for x, r, m, nr in zip(leaves(grads), olds, leaves(means),
                               leaves(new_resid)):
            q, s = quantize_int8(x if r is None else x + r)
            if not torch.equal(m, dequantize_int8(q, s)):
                fail("distributed compress: a mean is not dequantize("
                     "quantize(x + r))")
            worst = max(worst, float(nr.abs().max() / s))
        resid = new_resid
        del means
    if worst > 0.5 + 1e-4:
        fail(f"distributed compress: a residual reaches {worst:.6f} of its "
             "scale (bound 0.5)")
    wb = {"int8": wire_bytes(grads, 2), "f32_ring": wire_bytes(grads, 2,
                                                               False)}
    log(f"[distributed] compress: {n / 1e9:.3f} B f32 elements, 2 steps "
        f"with error feedback, {secs[0]:.3f} / {secs[1]:.3f} s a step; "
        f"means exact, residual <= {worst:.6f} of the scale (bound 0.5); "
        f"wire bytes a sync at 2 pods: int8 {wb['int8']:,}, f32 ring "
        f"{wb['f32_ring']:,.0f}")
    return {"elements": n, "step_s": secs, "worst_resid": worst,
            "wire_bytes": wb}


def elastic_runner_check(dev) -> dict:
    """c) ``ElasticRunner`` with ``make_mesh_train_step`` on
    ``make_elastic_mesh(1, pod_shape=(1, 1))``: phase 16's yi-9b (full
    width, TRAIN_LAYERS deep, f32, B=2, S=4096, grad_accum 2, remat):
    ensure(1), ELASTIC_STEPS steps, ensure(1, force=True) (the state
    drained to the host and freed on the card, the DTensors re-sharded on
    the pod count's mesh, the step rebuilt), as many
    steps again; then handle_preemption through the port's Checkpointer.
    Freed, and an uninterrupted run of ``make_train_step`` from the same
    state on the same batches: losses and parameters within 1e-6,
    bitwise equality reported; the peak device memory of the run and of
    each ensure."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core.elastic import ElasticRunner
    from repro_torch.data import make_batch
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_mesh_train_step, make_train_step
    from repro_torch.models import init_params, param_count
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten, map_tree

    cfg, shape, run = train.build("yi-9b", reduced=False, batch=2, seq=4096,
                                  compute_dtype="float32", grad_accum=2)
    cfg = replace(cfg, num_layers=TRAIN_LAYERS)
    run = run.replace(model=cfg)
    host_p = map_tree(lambda t: t.cpu(), init_params(cfg, 2021, device=dev))
    host_o = adamw_init(host_p)
    torch.cuda.empty_cache()
    n_params = param_count(host_p)
    steps = 2 * ELASTIC_STEPS
    batches = [make_batch(cfg, shape, s, seed=2021, device=dev)
               for s in range(steps)]
    ckpt = ROOT / "build" / "elastic_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        runner = ElasticRunner(
            lambda mesh: make_mesh_train_step(cfg, run, mesh), host_p,
            host_o, pod_shape=(1, 1), checkpointer=Checkpointer(str(ckpt),
                                                                keep=1),
            device_type="cuda")
        rebuild_s, rebuild_peak, peaks, losses, secs = [], [], [], [], []
        for s in range(steps):
            if s % ELASTIC_STEPS == 0:
                # each ensure's own peak device memory, and the run's
                peaks.append(torch.cuda.max_memory_allocated())
                torch.cuda.reset_peak_memory_stats()
                runner.ensure(1, force=s > 0)
                rebuild_s.append(runner.rebuild_s)
                rebuild_peak.append(torch.cuda.max_memory_allocated())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(runner.step(batches[s])["loss"]))
            secs.append(time.perf_counter() - t0)
        peak = max(peaks + [torch.cuda.max_memory_allocated()])
        t0 = time.perf_counter()
        runner.handle_preemption(steps)
        preempt_s = time.perf_counter() - t0
        ckpt_bytes = _dir_bytes(ckpt / f"step_{steps:010d}")
        if runner.rebuilds != 2:
            fail(f"distributed runner: {runner.rebuilds} rebuilds, not 2")
        got = [t.full_tensor().cpu() for _, t in flatten(runner.params)]
        del runner
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.empty_cache()

    p = map_tree(lambda t: t.to(dev), host_p)
    o = map_tree(lambda t: t.to(dev), host_o)
    step = make_train_step(cfg, run)
    ref = []
    for s in range(steps):
        p, o, m = step(p, o, batches[s])
        ref.append(float(m["loss"]))
    want = [t.detach().cpu() for _, t in flatten(p)]
    del p, o
    torch.cuda.empty_cache()
    loss_err = max(abs(a - b) for a, b in zip(losses, ref))
    p_err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    close = all(torch.allclose(a, b, rtol=1e-6, atol=1e-6)
                for a, b in zip(got, want))
    bitwise = losses == ref and all(torch.equal(a, b)
                                    for a, b in zip(got, want))
    if not (close and loss_err <= 1e-6 * max(abs(x) for x in ref)):
        fail(f"distributed runner: losses {losses} vs uninterrupted {ref} "
             f"({loss_err:.3g}), parameters max abs {p_err:.3g} (rtol = "
             "atol = 1e-6)")
    step_s = float(np.median(secs[1:]))
    res = {"params": n_params, "losses": losses, "reference": ref,
           "loss_err": loss_err, "param_err": p_err, "bitwise": bitwise,
           "rebuild_s": rebuild_s, "step_s": secs, "median_step_s": step_s,
           "peak_bytes": peak, "rebuild_peak_bytes": rebuild_peak,
           "preemption_s": preempt_s,
           "checkpoint_bytes": ckpt_bytes}
    log(f"[distributed] runner: yi-9b {TRAIN_LAYERS}L full width f32 "
        f"({n_params / 1e9:.3f} B params), B=2 S=4096 grad_accum 2 remat, "
        f"make_mesh_train_step on a (1, 1) elastic mesh: rebuild_s ensure "
        f"{rebuild_s[0]:.2f} s, forced {rebuild_s[1]:.2f} s (drain "
        f"{_tree_gb(host_p, host_o):.2f} GB to the host, re-shard, step "
        f"rebuilt); {step_s:.3f} s a step (median of {steps - 1}); losses "
        f"{[round(x, 6) for x in losses]}, vs the uninterrupted run "
        f"{loss_err:.3g}, parameters max abs {p_err:.3g} (rtol = atol = "
        f"1e-6), bitwise equal: {bitwise}; peak {peak / 2 ** 30:.1f} GiB "
        f"(during the ensures {rebuild_peak[0] / 2 ** 30:.2f} / "
        f"{rebuild_peak[1] / 2 ** 30:.2f} GiB); "
        f"handle_preemption {preempt_s:.2f} s ({ckpt_bytes / 1e9:.2f} GB)")
    return res


def _tree_gb(*trees) -> float:
    from repro_torch.tree import leaves
    return sum(nbytes(*leaves(t)) for t in trees) / 1e9


def goodput_study(rebuild_s: float, smi: str) -> dict:
    """d) ``drive_pool`` over the outage campaign's instance trace
    (TRACE, read by the port's ``CampaignTrace.from_jsonl``) into
    ``PodPool(max_pods=128)`` and ``SimulatedElasticRunner``: at c)'s
    measured forced-rebuild seconds and at 45 s, with and without
    preemption notices; a ``[elastic] {...}`` line."""
    import gzip

    from repro_torch.core.elastic import (PodPool, SimulatedElasticRunner,
                                          drive_pool)
    from repro_torch.core.events import CampaignTrace

    with gzip.open(ROOT / TRACE, "rt") as f:
        trace = CampaignTrace.from_jsonl(f.read())
    reports = []
    for cost in (rebuild_s, 45.0):
        for notice in (True, False):
            rep = drive_pool(trace, PodPool(max_pods=128),
                             SimulatedElasticRunner(rebuild_s=cost),
                             notice=notice)
            if not (0.0 < rep.goodput_fraction <= 1.0 and rep.rebuilds > 0
                    and (rep.steps_lost == 0.0) == notice):
                fail(f"elastic: report {rep.to_dict()} at rebuild_s {cost}, "
                     f"notice {notice}")
            reports.append({"rebuild_s": cost, "notice": notice,
                            **rep.to_dict()})
    out = {"card": smi, "trace": trace.name, "seed": trace.seed,
           "events": len(trace), "reports": reports}
    log("[elastic] " + json.dumps(out))
    return out


def distributed_phase(dev, smi: str) -> dict:
    """Phase 21: a world of one NCCL rank (a file:// store in a temporary
    directory), destroyed at the phase's end; a) - c) on it, then d)."""
    import tempfile

    import torch.distributed as dist

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            out = {"moe": sharded_moe_check(dev),
                   "compress": compression_check(dev),
                   "runner": elastic_runner_check(dev)}
        finally:
            dist.destroy_process_group()
    out["goodput"] = goodput_study(out["runner"]["rebuild_s"][1], smi)
    return out


# -- phase 22: the dry run against the card -----------------------------------

PEAK_TOL = 0.15                # predicted against measured peak, relative
DRYRUN_STEPS = 3               # real steps: one to warm up, two timed


def dryrun_cell():
    """Phase 16's bf16 train cell (c): yi-9b at full width, TRAIN_LAYERS
    of 48 layers deep, B=4, S=4096, grad_accum 2, remat (``build`` sets
    it for a full config), bf16 parameters with the f32 master."""
    from repro_torch.launch import train
    cfg, shape, run = train.build("yi-9b", reduced=False, batch=4,
                                  seq=4096, compute_dtype="bfloat16",
                                  grad_accum=2)
    cfg = replace(cfg, num_layers=TRAIN_LAYERS)
    return cfg, shape, run.replace(model=cfg)


def dryrun_part(part: str, out: str, device: str = "cuda") -> int:
    """One part of phase 22 in a process of its own (``python3
    chip_smoke.py --phase22 a|b OUT.json``): a) the dry run of
    ``dryrun_cell`` on a mesh of one fake rank, on ``device``; b) the same
    cell's real step on the card: its FLOPs by ``FlopCounterMode``, the
    step's peak by ``max_memory_allocated`` (the step's arguments
    included, as the dry run's peak includes them) and the step time."""
    sys.path.insert(0, str(ROOT / "src"))
    cfg, shape, run = dryrun_cell()
    if part == "a":
        from repro_torch.launch.dryrun import dry_run
        res = dry_run(cfg, shape, run, (1, 1), device)
    else:
        from torch.utils.flop_counter import FlopCounterMode

        from repro_torch.analysis.roofline import model_flops
        from repro_torch.data import make_batch
        from repro_torch.launch.steps import make_train_step
        from repro_torch.models import init_params
        from repro_torch.optim import adamw_init
        from repro_torch.tree import map_tree

        dev = torch.device("cuda")
        params = map_tree(lambda x: x.to(torch.bfloat16),
                          init_params(cfg, 2021, device=dev))
        opt, step = adamw_init(params), make_train_step(cfg, run)
        secs, peaks = [], []
        for s in range(DRYRUN_STEPS):
            batch = make_batch(cfg, shape, s, seed=7, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            float(m["loss"])
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
        batch = make_batch(cfg, shape, DRYRUN_STEPS, seed=7, device=dev)
        with FlopCounterMode(display=False) as fc:
            step(params, opt, batch)
        torch.cuda.synchronize()
        res = {"dot_flops": int(fc.get_total_flops()),
               "peak_bytes": max(peaks[1:]), "peaks": peaks,
               "step_s": secs, "model_flops": model_flops(cfg, shape)}
    Path(out).write_text(json.dumps(res))
    return 0


def dryrun_phase(smi: str) -> dict:
    """Phase 22, each part in a subprocess: a) the dry run of phase 16's
    bf16 train cell on one fake rank; b) that cell's real step: the dry
    run's dot FLOPs equal FlopCounterMode's count exactly, its peak lies
    within PEAK_TOL of max_memory_allocated; c) ``python -m
    repro_torch.launch.dryrun --arch yi-9b --shape decode_32k`` on the
    (16, 16) mesh of 256 fake ranks ends [OK]."""
    import tempfile

    from repro_torch.analysis.roofline import PEAK_FLOPS

    torch.cuda.empty_cache()           # the card to the subprocesses
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    got = {}
    with tempfile.TemporaryDirectory() as tmp:
        for part in ("a", "b"):
            t0 = time.perf_counter()
            path = Path(tmp) / f"{part}.json"
            proc = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"), "--phase22",
                 part, str(path)], cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"dryrun part {part} exited {proc.returncode}: "
                     f"{proc.stderr[-3000:]}")
            got[part] = json.loads(path.read_text())
            got[part]["wall_s"] = time.perf_counter() - t0
    a, b = got["a"], got["b"]
    mem, rf = a["memory"], a["roofline"]
    log(f"[dryrun] a) yi-9b {TRAIN_LAYERS} of 48 layers, bf16 B=4 S=4096 "
        f"grad_accum 2 remat, mesh 1x1 of fake tensors on the card: "
        f"argument {mem['argument_bytes'] / 1e9:.3f} GB, temp "
        f"{mem['temp_bytes'] / 1e9:.3f} GB, peak "
        f"{mem['peak_bytes'] / 1e9:.3f} GB, output "
        f"{mem['output_bytes'] / 1e9:.3f} GB; dot FLOPs "
        f"{a['counted']['dot_flops']:.6e}, model FLOPs "
        f"{rf['model_flops']:.6e} (useful {rf['useful_ratio']:.4f}); "
        f"roofline compute {rf['compute_s']:.4f} s, memory "
        f"{rf['memory_s']:.4f} s, collective {rf['collective_s']:.4f} s "
        f"({rf['bottleneck']}); traced in {a['trace_s']} s "
        f"({a['wall_s']:.1f} s with the process)")
    if a["counted"]["dot_flops"] != b["dot_flops"]:
        fail(f"dryrun: the dry run's dot FLOPs {a['counted']['dot_flops']} "
             f"!= FlopCounterMode's {b['dot_flops']} on the real step")
    rel = mem["peak_bytes"] / b["peak_bytes"] - 1
    if abs(rel) > PEAK_TOL:
        fail(f"dryrun: predicted peak {mem['peak_bytes'] / 1e9:.3f} GB vs "
             f"max_memory_allocated {b['peak_bytes'] / 1e9:.3f} GB "
             f"({100 * rel:+.1f} %, tol {100 * PEAK_TOL:.0f} %)")
    step_s = float(np.median(b["step_s"][1:]))
    log(f"[dryrun] b) the real step on the card: dot FLOPs "
        f"{b['dot_flops']:.6e} (FlopCounterMode; equal to the dry run's), "
        f"peak {b['peak_bytes'] / 1e9:.3f} GB (max_memory_allocated of "
        f"steps {[round(x / 1e9, 3) for x in b['peaks']]}; predicted "
        f"{100 * rel:+.2f} %, tol {100 * PEAK_TOL:.0f} %); step s "
        f"{[round(x, 4) for x in b['step_s']]}, median of the last "
        f"{DRYRUN_STEPS - 1} {step_s:.4f} s; model FLOPs / (step s x "
        f"{PEAK_FLOPS / 1e12:.1f} TFLOP/s) "
        f"{b['model_flops'] / (step_s * PEAK_FLOPS):.4f}, dot FLOPs / (step "
        f"s x {PEAK_FLOPS / 1e12:.1f} TFLOP/s) "
        f"{b['dot_flops'] / (step_s * PEAK_FLOPS):.4f} | {smi}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "yi-9b", "--shape", "decode_32k"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=600)
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not lines or \
            not lines[-1].startswith("[OK] yi-9b/decode_32k/16x16 "):
        fail(f"dryrun c) exited {proc.returncode}: {lines[-3:]} "
             f"{proc.stderr[-3000:]}")
    log(f"[dryrun] c) {lines[-1]} ({time.perf_counter() - t0:.1f} s with "
        f"the process)")
    return {"a": a, "b": b, "c": lines[-1]}


# -- phase 23: the mesh steps computing the way the rules store the state ----

TP_STEPS = 3                   # trainer steps compared, one-rank mesh
TP_LOGIT_TOL = 1e-4            # f32 prefill, kernels vs the reference path
TP_ARTIFACT = "artifacts/dryrun_torch/dryrun_yi-9b_train_4k_no.json"
# c) jamba train_4k cut to one super-block: ``python -m
# repro_torch.launch.dryrun --arch jamba-v0.1-52b --shape train_4k
# --layers 8 --device cpu --out artifacts/dryrun_torch``
JAMBA_LAYERS = 8
JAMBA_TP_ARTIFACT = ("artifacts/dryrun_torch/dryrun_jamba-v0.1-52b_train_4k_"
                     f"no_{JAMBA_LAYERS}L.json")
# b) the archs whose heads (16, 16)'s "model" does not divide: xlstm-350m
# train_4k cut to one super-block with its 16 rows a rank in one
# microbatch (XLSTM_ACCUM: its sLSTM's 4,096-step loop runs once, not
# once a microbatch), and the mesh prefills (B=32, S=4,096, as
# TP16_PREFILLS) of xlstm-350m, minicpm3-4b and whisper-large-v3 cut to
# TP16_SPLIT_LAYERS (whisper's decoder; its encoder's 32 stay), each held
# to its dry run (``python -m repro_torch.launch.dryrun --arch A --shape
# train_4k --layers 8 --grad-accum 1`` / ``--shape prefill_32k --layers 8
# --seq-len 4096``, ``--device cpu --out artifacts/dryrun_torch``): (arch,
# the kernels' launches expected: flash twice a whisper decoder layer, on
# the rank's two chunks of query rows)
XLSTM_LAYERS = 8
XLSTM_ACCUM = 1
TP16_SPLIT_LAYERS = 8
TP16_SEQ = 4096
TP16_SPLIT_PREFILLS = (
    ("xlstm-350m", {"flash_attention": 0, "moe_gmm": 0}),
    ("minicpm3-4b", {"flash_attention": 0, "moe_gmm": 0}),
    ("whisper-large-v3", {"flash_attention": 2 * TP16_SPLIT_LAYERS,
                          "moe_gmm": 0}))


def cut_artifact(arch, shape, layers, suffix="") -> str:
    return (f"artifacts/dryrun_torch/dryrun_{arch}_{shape}_no_{layers}L"
            f"{suffix}.json")


def _one_rank_mesh():
    from repro_torch.sharding_ctx import make_mesh
    return make_mesh((1, 1), ("data", "model"), "cuda")


def _wrap(params, mesh):
    """DTensors of a one-rank mesh over ``params``' own storage."""
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as sh
    from repro_torch.tree import map_tree
    return map_tree(lambda t, ns: DTensor.from_local(
        t, mesh, ns.placements, run_check=False),
        params, sh.param_shardings(params, mesh))


def tp_trainer_check(dev, smi: str) -> dict:
    """a) ``Trainer(mesh=...)`` on a one-rank mesh against ``Trainer()``:
    phase 16's bf16 cell (yi-9b at full width, TRAIN_LAYERS of 48
    layers, B=4, S=4096, grad_accum 2, remat), TP_STEPS steps: losses and
    every parameter bitwise equal (a mesh of one rank is the plain
    step); s a step of each."""
    from repro_torch.launch.train import Trainer

    cfg, shape, run = dryrun_cell()
    out = {}
    t0 = time.perf_counter()
    plain = Trainer(cfg, shape, run, device=dev)
    t1 = time.perf_counter()
    losses = plain.train(TP_STEPS, log_every=0)
    torch.cuda.synchronize()
    out["plain_s"] = (time.perf_counter() - t1) / TP_STEPS
    want = plain.params
    del plain
    torch.cuda.empty_cache()
    mesh = _one_rank_mesh()
    tm = Trainer(cfg, shape, run, device=dev, mesh=mesh)
    t1 = time.perf_counter()
    got = tm.train(TP_STEPS, log_every=0)
    torch.cuda.synchronize()
    out["mesh_s"] = (time.perf_counter() - t1) / TP_STEPS
    from repro_torch.tree import flatten
    same = all(torch.equal(d.to_local(), w) for (_, d), (_, w)
               in zip(flatten(tm.params), flatten(want)))
    if got != losses or not same:
        fail(f"tp a) Trainer(mesh=) on one rank differs from Trainer(): "
             f"losses {got} vs {losses}, parameters equal {same}")
    out.update(losses=losses, wall_s=time.perf_counter() - t0)
    log(f"[tp] a) one-rank: Trainer(mesh=(1, 1)) vs Trainer(): yi-9b "
        f"{TRAIN_LAYERS} of 48 layers, bf16 B=4 S=4096 grad_accum 2 remat, "
        f"{TP_STEPS} steps: losses {[round(x, 6) for x in losses]} and "
        f"every parameter bitwise equal; s a step {out['plain_s']:.4f} "
        f"plain, {out['mesh_s']:.4f} mesh | {smi}")
    del tm, want
    torch.cuda.empty_cache()
    return out


def tp_prefill_check(dev, smi, arch, layers, expect) -> dict:
    """a) ``make_mesh_prefill_step`` on a one-rank mesh, B=2 S=4096,
    with ``attention_impl="pallas"`` (flash and moe_gmm): in f32 against
    the reference path, the logits' gap within TP_LOGIT_TOL of the
    reference's 2-norm; in bf16 equal to the plain prefill step through
    the same kernels, bitwise (one rank is the plain step), its gap to
    the bf16 reference path reported; the launches ``expect`` on each
    kernels' step (counts set to 0 just before it) and none on the
    reference's; an MoE model's layers through ``moe_sharded`` (calls
    counted; the step runs inside ``use_mesh``, as a one-rank mesh step
    is the plain step), capacity factor 8 so that no token drops
    (counted)."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (make_mesh_prefill_step,
                                          make_prefill_step)
    from repro_torch.models import init_params
    from repro_torch.models import moe_sharded as ms
    from repro_torch.sharding_ctx import use_mesh

    cfg = replace(get_config(arch), num_layers=layers)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    shape = ShapeConfig("tp", 4096, 2, "prefill")
    mesh = _one_rank_mesh()
    plain_params = init_params(cfg, 2021, device=dev)
    params = _wrap(plain_params, mesh)
    gen = torch.Generator(device=dev).manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (2, 4096), generator=gen,
                        device=dev, dtype=torch.int32)
    calls, dropped = [0], []
    sharded = ms.apply_moe_sharded

    def counted(*a, **k):
        calls[0] += 1
        return sharded(*a, **k)
    got = {}
    ms.apply_moe_sharded = counted
    try:
        with counting_drops(dropped), torch.no_grad():
            for dt in ("float32", "bfloat16"):
                for impl in ("pallas", "reference", "plain"):
                    run = RunConfig(model=cfg, shape=shape, compute_dtype=dt,
                                    attention_impl="reference"
                                    if impl == "reference" else "pallas")
                    torch.cuda.synchronize()
                    ops.reset_launches()
                    calls[0] = 0
                    t0 = time.perf_counter()
                    # a one-rank mesh step is the plain step: the MoE
                    # takes the expert-parallel dispatch inside the
                    # caller's use_mesh, as from the plain step
                    with use_mesh(mesh):
                        if impl == "plain":
                            logits, _ = make_prefill_step(cfg, run)(
                                plain_params, {"tokens": tok})
                        else:
                            logits, _ = make_mesh_prefill_step(
                                cfg, run, mesh)(params, {"tokens": tok})
                            logits = logits.to_local()
                    torch.cuda.synchronize()
                    got[dt, impl] = (logits[..., :cfg.vocab_size].float(),
                                     time.perf_counter() - t0,
                                     {k: ops.LAUNCHES[k] for k in expect},
                                     calls[0])
    finally:
        ms.apply_moe_sharded = sharded

    def gap(a, b):
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))
    want_calls = sum(f == "moe" for _, f in cfg.block_defs) * cfg.n_super
    res = {}
    for dt in ("float32", "bfloat16"):
        (lk, sk, nk, ck), (lr, sr, nr, cr), (lp, _, np_, _) = (
            got[dt, impl] for impl in ("pallas", "reference", "plain"))
        rel, same = gap(lk, lr), bool(torch.equal(lk, lp))
        ok = nk == expect and np_ == expect and not any(nr.values()) \
            and ck == want_calls and cr == want_calls and not sum(dropped)
        ok = ok and (same if dt == "bfloat16" else
                     math.isfinite(rel) and rel <= TP_LOGIT_TOL)
        if not ok:
            fail(f"tp a) {arch} mesh prefill {dt}: kernels vs reference "
                 f"{rel:.3e} (f32 tol {TP_LOGIT_TOL}), equal to the plain "
                 f"step {same}, launches {nk} / {np_} (want {expect}) / "
                 f"{nr} (want none), moe_sharded calls {ck} / {cr} (want "
                 f"{want_calls}), drops {sum(dropped)}")
        log(f"[tp] a) one-rank: {arch} {layers} layers, "
            f"make_mesh_prefill_step on a (1, 1) mesh (the plain step), {dt} B=2 S=4096: attention_impl=pallas launches "
            f"{nk} (counts 0 just before), reference none; logits' gap to "
            f"the reference path {rel:.3e} of its 2-norm (the largest "
            f"element's {float((lk - lr).abs().max() / lr.abs().max()):.3e}"
            f" of max |reference|"
            f"{'; tol ' + str(TP_LOGIT_TOL) if dt == 'float32' else ''}); "
            f"bitwise equal to the plain step's: {same}; moe_sharded calls "
            f"{ck}, drops {sum(dropped)}; {sk:.4f} s kernels, {sr:.4f} s "
            f"reference | {smi}")
        res[dt] = {"launches": nk, "rel": rel, "same": same,
                   "kernels_s": sk, "reference_s": sr}
    # ROADMAP C16: how far each bf16 path's logits lie from the f32
    # reference path's, by the 2-norm and by the largest element
    want = got["float32", "reference"][0]
    res["bfloat16"]["vs_f32"] = {
        impl: {"norm": gap(got["bfloat16", impl][0], want),
               "max": float((got["bfloat16", impl][0] - want).abs().max()
                            / want.abs().max())}
        for impl in ("pallas", "reference")}
    far = res["bfloat16"]["vs_f32"]
    log(f"[tp] a) C16: {arch} bf16 logits against the f32 reference "
        f"path's: through flash {far['pallas']['norm']:.3e} of its 2-norm "
        f"(largest element {far['pallas']['max']:.3e} of max |f32|), the "
        f"chunked reference path {far['reference']['norm']:.3e} "
        f"({far['reference']['max']:.3e}) | {smi}")
    del params, plain_params
    torch.cuda.empty_cache()
    return res


def rank0_place(tree, shardings, mesh, fill):
    """DTensors placed by ``shardings`` on ``mesh`` (torch's fake group)
    over rank 0's pieces of ``tree``'s meta leaves, each made by
    ``fill(shape, dtype)``."""
    from torch.distributed.tensor import DTensor

    from repro_torch.tree import map_tree

    def one(t, ns):
        local = list(t.shape)
        for size, pl in zip(mesh.mesh.shape, ns.placements):
            if pl.is_shard():
                local[pl.dim] //= int(size)
        x = fill(local, t.dtype)
        return DTensor.from_local(x, mesh, ns.placements, run_check=False,
                                  shape=tuple(t.shape), stride=t.stride())
    return map_tree(one, tree, shardings)


def rank0_state(cfg, mesh, dev, with_opt: bool = True):
    """Rank 0's real bf16 shards of ``cfg``'s parameters (random, seeded)
    and (``with_opt``; else None) zeroed AdamW state with the f32
    master, as DTensors placed by the rules on ``mesh`` (a mesh of
    torch's fake process group); with their bytes."""
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as sh
    from repro_torch.launch import steps as st
    from repro_torch.tree import map_tree

    gen = torch.Generator(device=dev).manual_seed(2021)

    def rand(shape_, dt):
        return (torch.randn(shape_, generator=gen, device=dev) * 0.02).to(dt)

    pstruct = st.params_struct(cfg, torch.bfloat16)
    params = rank0_place(pstruct, sh.param_shardings(pstruct, mesh), mesh,
                         rand)
    if not with_opt:
        return params, None, sum(x.to_local().numel()
                                 * x.to_local().element_size()
                                 for x in leaves_of(params))
    ostruct = st.opt_struct(cfg, pstruct)
    opt = rank0_place(ostruct, sh.opt_shardings(ostruct, mesh), mesh,
                      lambda s_, dt: torch.zeros(s_, dtype=dt, device=dev))
    with torch.no_grad():
        for d, m in zip(leaves_of(params), leaves_of(opt["master"])):
            m.to_local().copy_(d.to_local())
    nbytes = sum(x.to_local().numel() * x.to_local().element_size()
                 for x in leaves_of(params) + leaves_of(opt))
    return params, opt, nbytes


# b), c) the mesh prefills of rank 0 of (16, 16): (arch, layers (None:
# full depth), the kernels' launches expected); B=32 S=4096 global, 2 rows
# a rank
TP16_PREFILLS = (("yi-9b", None, {"flash_attention": 48, "moe_gmm": 0}),
                 ("qwen3-moe-30b-a3b", None, {"flash_attention": 48,
                                              "moe_gmm": 3 * 48}),
                 ("jamba-v0.1-52b", JAMBA_LAYERS, {"flash_attention": 1,
                                                   "moe_gmm": 3 * 4}))
TP16_BATCH = 32


def tp_rank0_prefill(arch, layers, expect, mesh, dev) -> dict:
    """b) rank 0 of (16, 16): ``make_mesh_prefill_step`` with
    attention_impl="pallas" on the rank's real bf16 shards of ``arch``
    at full width and depth, B=32 S=4096 (2 rows a rank): flash on the
    rank's 2 q heads and the kv head they select, ``moe_gmm`` on
    ``moe_sharded``'s 8 local experts of F = 48; the launch counts set
    to 0 just before the step and read just after.  Torch's fake group
    moves no data (the gathered weights are whatever the buffers held),
    so no value is compared; its all-to-all returns the rank's own send
    buffer (``tp_rank0_part``), so that the dispatch's slot indices are
    the rank's own."""
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st

    cfg = get_config(arch)
    if layers:
        cfg = replace(cfg, num_layers=layers)
    shape = ShapeConfig("tp16", 4096, TP16_BATCH, "prefill")
    run = RunConfig(model=cfg, shape=shape, attention_impl="pallas")
    params, _, args = rank0_state(cfg, mesh, dev, with_opt=False)
    gen = torch.Generator(device=dev).manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (TP16_BATCH, 4096), generator=gen,
                        device=dev, dtype=torch.int32)
    step = st.make_mesh_prefill_step(cfg, run, mesh)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = step(params, {"tokens": tok})
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k: ops.LAUNCHES[k] for k in expect}
    return {"launches": launches, "expect": expect, "s": secs,
            "depth": f"{cfg.num_layers} of "
                     f"{get_config(arch).num_layers} layers",
            "argument_bytes": args,
            "logits_local": list(logits.to_local().shape),
            "whole": sorted(step.whole)}


def tp_rank0_part(out: str) -> int:
    """b) in a process of its own (``python3 chip_smoke.py --phase23
    OUT.json``): rank 0 of the (16, 16) mesh of torch's fake process
    group (256 ranks) on the card, yi-9b train_4k at full width and
    depth (48 layers, B=256 global: 16 rows a rank, grad_accum 8, remat,
    bf16 with the f32 master) on the rank's real shards
    (``rank0_state``): one warm-up and one timed ``make_mesh_train_step``
    steps, their ``max_memory_allocated`` (arguments included) and
    seconds, then ``FlopCounterMode`` over one more step; then the mesh
    prefills of ``TP16_PREFILLS`` (``tp_rank0_prefill``).  The fake
    group moves no data: no value is compared."""
    sys.path.insert(0, str(ROOT / "src"))
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.data import make_batch
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import steps as st
    from repro_torch.sharding_ctx import make_mesh

    dev = torch.device("cuda")
    dr.fake_world(256)
    mesh = make_mesh((16, 16), ("data", "model"), "cuda")
    cfg, shape = get_config("yi-9b"), get_shape("train_4k")
    run = RunConfig(model=cfg, shape=shape)
    params, opt, args = rank0_state(cfg, mesh, dev)
    step = st.make_mesh_train_step(cfg, run, mesh)
    secs, peaks = [], []
    for i in range(2):
        batch = make_batch(cfg, shape, i, seed=7, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
    batch = make_batch(cfg, shape, 3, seed=7, device=dev)
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    torch.cuda.synchronize()
    whole = sorted(step.whole)
    del params, opt, step, batch
    torch.cuda.empty_cache()

    def a2a_own(out_, x, *args_, **kwargs):
        """The fake group's all-to-all, as if every rank sent what this
        one sends: the received slot indices stay in range."""
        out_.copy_(x)
    torch.distributed.all_to_all_single = a2a_own
    jamba = tp_rank0_train("jamba-v0.1-52b", JAMBA_LAYERS, mesh, dev,
                           steps=2)
    prefill = {arch: tp_rank0_prefill(arch, layers, expect, mesh, dev)
               for arch, layers, expect in TP16_PREFILLS}
    xlstm = tp_rank0_train("xlstm-350m", XLSTM_LAYERS, mesh, dev, steps=0,
                           grad_accum=XLSTM_ACCUM)
    split = {arch: tp_rank0_split_prefill(arch, expect, mesh, dev)
             for arch, expect in TP16_SPLIT_PREFILLS}
    Path(out).write_text(json.dumps({
        "dot_flops": int(fc.get_total_flops()), "peaks": peaks,
        "step_s": secs, "argument_bytes": args, "whole": whole,
        "model_flops_rank": model_flops(cfg, shape) / 256,
        "jamba": jamba, "prefill": prefill, "xlstm": xlstm,
        "split_prefill": split}))
    return 0


def tp_rank0_train(arch, layers, mesh, dev, steps=1,
                   grad_accum=None) -> dict:
    """c) (jamba-v0.1-52b) and b) (xlstm-350m) rank 0 of (16, 16):
    train_4k at full width, one super-block (``layers`` layers), 16 rows
    a rank, grad_accum 8 (or ``grad_accum``), remat, bf16 with the f32
    master, on the rank's real shards: ``steps`` timed
    ``make_mesh_train_step`` steps (the first a warm-up where there are
    two), then ``FlopCounterMode`` over one
    more, each with its ``max_memory_allocated``; the sub-blocks
    computed whole.  Torch's fake group moves no data (its all-to-all
    the rank's own buffer, ``tp_rank0_part``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.roofline import model_flops
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.data import make_batch
    from repro_torch.launch import steps as st

    cfg = replace(get_config(arch), num_layers=layers)
    shape = get_shape("train_4k")
    if grad_accum:
        shape = replace(shape, grad_accum=grad_accum)
    run = RunConfig(model=cfg, shape=shape)
    params, opt, args = rank0_state(cfg, mesh, dev)
    step = st.make_mesh_train_step(cfg, run, mesh)
    secs, peaks = [], []
    for i in range(steps):
        batch = make_batch(cfg, shape, i, seed=7, device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
    batch = make_batch(cfg, shape, steps, seed=7, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as fc:
        step(params, opt, batch)
    torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    peaks.append(torch.cuda.max_memory_allocated())
    whole = sorted(step.whole)
    del params, opt, step, batch
    torch.cuda.empty_cache()
    return {"dot_flops": int(fc.get_total_flops()), "peaks": peaks,
            "step_s": secs, "counted_s": counted_s, "argument_bytes": args,
            "whole": whole, "model_flops_rank": model_flops(cfg, shape) / 256}


def tp_rank0_split_prefill(arch, expect, mesh, dev) -> dict:
    """b) rank 0 of (16, 16): ``make_mesh_prefill_step`` of ``arch`` at
    full width, ``TP16_SPLIT_LAYERS`` layers, B=32 S=``TP16_SEQ`` (2 rows
    a rank), bf16, on the rank's real shards and its
    rows of the batch (DTensors placed by ``batch_shardings``, as the
    dry run places them): with attention_impl="pallas" (the launch
    counts set to 0 just before, read just after) and, where it launches
    flash, again on the reference path; the reference path's run under
    ``FlopCounterMode`` with its ``max_memory_allocated`` (the pallas
    run's where the two are one path); the sub-blocks computed whole."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, get_config, get_shape
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st

    cfg = replace(get_config(arch), num_layers=TP16_SPLIT_LAYERS)
    shape = replace(get_shape("prefill_32k"), seq_len=TP16_SEQ)
    params, _, args = rank0_state(cfg, mesh, dev, with_opt=False)
    gen = torch.Generator(device=dev).manual_seed(9)

    def fill(shape_, dt):
        if dt == torch.int32:
            return torch.randint(0, cfg.vocab_size, shape_, generator=gen,
                                 device=dev, dtype=dt)
        return torch.randn(shape_, generator=gen, device=dev).to(dt)
    specs = st.input_specs(cfg, shape, st.BF16)
    batch = rank0_place(specs, sh.batch_shardings(specs, mesh), mesh, fill)
    args += sum(x.to_local().numel() * x.to_local().element_size()
                for x in leaves_of(batch))
    out = {"expect": expect, "argument_bytes": args,
           "depth": f"{cfg.num_layers} of {get_config(arch).num_layers} "
                    "layers"}
    impls = ("pallas", "reference") if expect["flash_attention"] \
        else ("pallas",)
    for impl in impls:
        run = RunConfig(model=cfg, shape=shape, attention_impl=impl)
        step = st.make_mesh_prefill_step(cfg, run, mesh)
        counted = impl == impls[-1]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        with torch.no_grad(), (FlopCounterMode(display=False) if counted
                               else contextlib.nullcontext()) as fc:
            logits, caches = step(params, batch)
        torch.cuda.synchronize()
        out[f"{impl}_s"] = time.perf_counter() - t0
        if impl == "pallas":
            out["launches"] = {k: ops.LAUNCHES[k] for k in expect}
            out["logits_local"] = list(logits.to_local().shape)
        out[f"{impl}_peak"] = torch.cuda.max_memory_allocated()
        if counted:
            out["dot_flops"] = int(fc.get_total_flops())
            out["peak"] = out[f"{impl}_peak"]
            out["whole"] = sorted(step.whole)
        del logits, caches, step
    del params, batch
    torch.cuda.empty_cache()
    return out


def leaves_of(tree) -> list:
    from repro_torch.tree import leaves
    return leaves(tree)


def tp_phase(dev, smi: str) -> dict:
    """Phase 23: a) one-rank, on a world of one NCCL rank (a mesh step
    of one rank is the plain step): ``Trainer(mesh=)``, the mesh prefill
    through flash (yi-9b 4 layers) and through flash and ``moe_gmm``
    with ``moe_sharded`` (qwen3 8 layers); b) rank 0 of (16, 16) on real
    tensors (a subprocess): the train step's peak within PEAK_TOL of the
    dry run's for the cell (``TP_ARTIFACT``, written by ``python -m
    repro_torch.launch.dryrun --arch yi-9b --shape train_4k --device cpu
    --out artifacts/dryrun_torch``), its dot FLOPs equal to the dry
    run's; the mesh prefills' launches (``TP16_PREFILLS``)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.analysis.roofline import PEAK_FLOPS

    out = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            out["trainer"] = tp_trainer_check(dev, smi)
            out["yi"] = tp_prefill_check(dev, smi, "yi-9b", TRAIN_LAYERS,
                                         {"flash_attention": TRAIN_LAYERS})
            out["qwen3"] = tp_prefill_check(
                dev, smi, "qwen3-moe-30b-a3b", 8,
                {"flash_attention": 8, "moe_gmm": 24})
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    predicted = json.loads((ROOT / TP_ARTIFACT).read_text())[0]
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "b.json"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--phase23",
             str(path)], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=900)
        if proc.returncode != 0:
            fail(f"tp b) exited {proc.returncode}: {proc.stderr[-3000:]}")
        b = json.loads(path.read_text())
        b["wall_s"] = time.perf_counter() - t0
    peak = max(b["peaks"][1:])
    want_peak = predicted["memory"]["peak_bytes"]
    rel = want_peak / peak - 1
    want_flops = predicted["counted"]["dot_flops"]
    if b["dot_flops"] != want_flops or abs(rel) > PEAK_TOL:
        fail(f"tp b) rank 0 of (16, 16): dot FLOPs {b['dot_flops']} vs the "
             f"dry run's {want_flops}; peak {peak / 1e9:.3f} GB vs "
             f"predicted {want_peak / 1e9:.3f} GB ({100 * rel:+.1f} %, tol "
             f"{100 * PEAK_TOL:.0f} %)")
    step_s = float(np.median(b["step_s"][1:]))
    log(f"[tp] b) rank 0 of (16, 16) on real tensors (torch's fake process "
        f"group of 256 ranks moves no data: no value is compared), yi-9b "
        f"train_4k full width and depth, 16 rows a rank, grad_accum 8, "
        f"remat, bf16: arguments {b['argument_bytes'] / 1e9:.3f} GB; "
        f"max_memory_allocated {[round(x / 1e9, 3) for x in b['peaks']]} "
        f"GB, the dry run's peak {want_peak / 1e9:.3f} GB "
        f"({100 * rel:+.2f} %, tol {100 * PEAK_TOL:.0f} %); dot FLOPs "
        f"{b['dot_flops']:.6e} (FlopCounterMode; equal to the dry run's); "
        f"step s {[round(x, 4) for x in b['step_s']]}, the last "
        f"{step_s:.4f} s; the rank's model FLOPs / (step s x "
        f"{PEAK_FLOPS / 1e12:.1f} TFLOP/s) "
        f"{b['model_flops_rank'] / (step_s * PEAK_FLOPS):.4f}, dot FLOPs "
        f"{b['dot_flops'] / (step_s * PEAK_FLOPS):.4f}; whole over "
        f"\"model\": {b['whole'] or 'none'} ({b['wall_s']:.1f} s with the "
        f"process) | {smi}")
    jamba_check(b["jamba"], smi)
    jamba_check(b["xlstm"], smi, "xlstm-350m", XLSTM_LAYERS, "b)",
                ("slstm_recurrence",), XLSTM_ACCUM)
    for arch, _ in TP16_SPLIT_PREFILLS:
        split_prefill_check(arch, b["split_prefill"][arch], smi)
    for arch, layers, expect in TP16_PREFILLS:
        pre = b["prefill"][arch]
        want_shape = [TP16_BATCH // 16, 1, padded_vocab(arch) // 16]
        if pre["launches"] != expect or pre["logits_local"] != want_shape:
            fail(f"tp b) rank 0 of (16, 16) {arch} mesh prefill: launches "
                 f"{pre['launches']} (want {expect}), local logits "
                 f"{pre['logits_local']} (want {want_shape})")
        depth, part = ("and depth", "b)") if layers is None else \
            (f"{layers} layers", "c)")
        log(f"[tp] {part} rank 0 of (16, 16), {arch} full width {depth}, "
            f"make_mesh_prefill_step attention_impl=pallas, bf16 B=32 "
            f"S=4096 global (2 rows a rank; fake group: no value "
            f"compared): launches {pre['launches']} (counts 0 just before; "
            f"want {expect}), the rank's last-token logits "
            f"{pre['logits_local']} (its vocabulary columns), whole over "
            f"\"model\": {pre['whole'] or 'none'}; arguments "
            f"{pre['argument_bytes'] / 1e9:.3f} GB; {pre['s']:.4f} s | "
            f"{smi}")
    out["rank0"] = b
    return out


def jamba_check(j, smi, arch="jamba-v0.1-52b", layers=JAMBA_LAYERS,
                part="c)", whole=(), accum=8) -> None:
    """c)'s gates (and b)'s for xlstm-350m): the peak of the steps after
    the first within PEAK_TOL of the cut cell's dry run (its dry run at
    ``accum`` microbatches), the dot FLOPs equal to its, nothing
    computed whole but ``whole`` (the sLSTM's recurrence), as in the dry
    run."""
    from repro_torch.analysis.roofline import PEAK_FLOPS
    from repro_torch.configs import get_config

    suffix = "" if accum == 8 else f"_ga{accum}"
    predicted = json.loads((ROOT / cut_artifact(arch, "train_4k", layers,
                                                suffix)).read_text())[0]
    peak = max(j["peaks"][1:] or j["peaks"])
    want_peak = predicted["memory"]["peak_bytes"]
    rel = want_peak / peak - 1
    want_flops = predicted["counted"]["dot_flops"]
    if j["dot_flops"] != want_flops or abs(rel) > PEAK_TOL or \
            j["whole"] != list(whole) or predicted["tp_whole"] != list(whole):
        fail(f"tp {part} rank 0 of (16, 16) {arch} {layers} layers: dot "
             f"FLOPs {j['dot_flops']} vs the dry run's {want_flops}; peak "
             f"{peak / 1e9:.3f} GB vs predicted {want_peak / 1e9:.3f} GB "
             f"({100 * rel:+.1f} %, tol {100 * PEAK_TOL:.0f} %); whole "
             f"{j['whole']} (dry run {predicted['tp_whole']}), want "
             f"{list(whole)}")
    # no timed step: the counted one's seconds, FlopCounterMode's cost in
    step_s = j["step_s"][-1] if j["step_s"] else j["counted_s"]
    cut = "" if accum == 8 else \
        f" (cut from train_4k's 8; its dry run at {accum} too)"
    log(f"[tp] {part} rank 0 of (16, 16) on real tensors (fake group: no "
        f"value compared), {arch} train_4k full width, {layers} of "
        f"{get_config(arch).num_layers} layers, 16 rows a rank, grad_accum "
        f"{accum}{cut}, remat, bf16: arguments "
        f"{j['argument_bytes'] / 1e9:.3f} GB; "
        f"max_memory_allocated {[round(x / 1e9, 3) for x in j['peaks']]} "
        f"GB, the cut cell's dry run {want_peak / 1e9:.3f} GB "
        f"({100 * rel:+.2f} %, tol {100 * PEAK_TOL:.0f} %); dot FLOPs "
        f"{j['dot_flops']:.6e} (equal to the dry run's); step s "
        f"{[round(x, 4) for x in j['step_s']]}, {step_s:.4f} s a step (the "
        f"last timed; {j['counted_s']:.1f} s under FlopCounterMode); the "
        f"rank's "
        f"model FLOPs / (step s x {PEAK_FLOPS / 1e12:.1f} TFLOP/s) "
        f"{j['model_flops_rank'] / (step_s * PEAK_FLOPS):.4f}, dot FLOPs "
        f"{j['dot_flops'] / (step_s * PEAK_FLOPS):.4f}; whole over "
        f"\"model\": {list(whole) or 'none'} | {smi}")


def split_prefill_check(arch, pre, smi) -> None:
    """b)'s gates of a mesh prefill of ``TP16_SPLIT_PREFILLS``: the
    launches expected, the local logits' shape, the reference run's dot
    FLOPs equal to the cut cell's dry run and its peak within PEAK_TOL of
    it, nothing computed whole but what the dry run names (the sLSTM's
    recurrence); where the pallas run is another path (whisper: flash),
    its peak at most the dry run's plus PEAK_TOL (flash keeps no
    scores, so it may lie below)."""
    predicted = json.loads((ROOT / cut_artifact(
        arch, "prefill_32k", TP16_SPLIT_LAYERS, f"_S{TP16_SEQ}"))
        .read_text())[0]
    want_peak = predicted["memory"]["peak_bytes"]
    rel = want_peak / pre["peak"] - 1
    want_flops = predicted["counted"]["dot_flops"]
    want_shape = [TP16_BATCH // 16, 1, padded_vocab(arch) // 16]
    whole = ["slstm_recurrence"] if arch == "xlstm-350m" else []
    rel_pallas = want_peak / pre["pallas_peak"] - 1
    if pre["launches"] != pre["expect"] or pre["logits_local"] != \
            want_shape or pre["dot_flops"] != want_flops or \
            abs(rel) > PEAK_TOL or pre["whole"] != whole or \
            predicted["tp_whole"] != whole or \
            pre["pallas_peak"] > (1 + PEAK_TOL) * want_peak:
        fail(f"tp b) rank 0 of (16, 16) {arch} prefill S={TP16_SEQ} "
             f"({pre['depth']}): launches {pre['launches']} (want "
             f"{pre['expect']}), local logits {pre['logits_local']} (want "
             f"{want_shape}), dot FLOPs {pre['dot_flops']} vs the dry run's "
             f"{want_flops}, peak {pre['peak'] / 1e9:.3f} GB vs predicted "
             f"{want_peak / 1e9:.3f} GB ({100 * rel:+.1f} %, tol "
             f"{100 * PEAK_TOL:.0f} %), pallas peak "
             f"{pre['pallas_peak'] / 1e9:.3f} GB (at most "
             f"{(1 + PEAK_TOL) * want_peak / 1e9:.3f}), whole "
             f"{pre['whole']} (dry run {predicted['tp_whole']}, want "
             f"{whole})")
    ref = f", reference {pre['reference_s']:.4f} s (counted)" \
        if "reference_s" in pre else " (counted)"
    pallas_peak = "" if "reference_s" not in pre else \
        (f"; the pallas run's max_memory_allocated "
         f"{pre['pallas_peak'] / 1e9:.3f} GB ({100 * rel_pallas:+.2f} % "
         f"to the dry run's, held at most +{100 * PEAK_TOL:.0f} %)")
    log(f"[tp] b) rank 0 of (16, 16), {arch} full width, {pre['depth']}, "
        f"make_mesh_prefill_step bf16 B=32 S={TP16_SEQ} global (2 rows a "
        f"rank; fake group: no value compared): attention_impl="
        f"pallas launches {pre['launches']} (counts 0 just before; want "
        f"{pre['expect']}), the rank's last-token logits "
        f"{pre['logits_local']}; dot FLOPs {pre['dot_flops']:.6e} "
        f"(FlopCounterMode, equal to the cut cell's dry run); "
        f"max_memory_allocated {pre['peak'] / 1e9:.3f} GB, the dry run's "
        f"{want_peak / 1e9:.3f} GB ({100 * rel:+.2f} %, tol "
        f"{100 * PEAK_TOL:.0f} %){pallas_peak}; whole over \"model\": "
        f"{pre['whole'] or 'none'}; arguments "
        f"{pre['argument_bytes'] / 1e9:.3f} GB; pallas "
        f"{pre['pallas_s']:.4f} s{ref} | {smi}")


# -- phase 24: the examples' counterparts -------------------------------------

# what the JAX examples print (``examples/*.py`` on the CPU), kept in
# tests/data/jax_examples.json, which tests/test_torch_examples.py holds
# equal to their live output; their counterparts are held to it
def jax_example_lines() -> dict:
    return json.loads((ROOT / "tests" / "data" / "jax_examples.json")
                      .read_text())


# the quickstart's budget floor fires at an hour that depends on the
# spend of the engine's own draws: held within FLOOR_HOURS
FLOOR_HOURS = 2.0
# the quickstart's cost and GPU-days within the statistical tier's band
STAT_BAND = 0.02
QUICKSTART_STEPS, QUICKSTART_TOKENS = 200, 72


def load_example(name: str):
    """``examples/<name>.py`` as a module (the examples are scripts)."""
    import importlib
    if str(ROOT / "examples") not in sys.path:
        sys.path.insert(0, str(ROOT / "examples"))
    return importlib.import_module(name)


def run_example(tag: str, fn, phase: str = "examples"):
    """(fn's result, its standard output's lines, its wall s); the lines
    are logged under ``[phase] tag``."""
    import io
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    for line in lines:
        log(f"[{phase}] {tag} | {line}")
    return out, lines, wall


def hold_to_plain(dev, label, specs, seeds, rows) -> dict:
    """The main path's sweep at its own shape against the plain versions:
    the persistent kernel on the same packed arguments (``check_sweep``:
    integers exact, f32 within 1e-6 relative) and each lane's results
    against a ``use_kernels=False`` run of the same draws
    (``compare_lanes``)."""
    from repro_torch.core.api import sweep
    held = check_sweep(dev, specs, seeds, timed=False)
    plain = sweep(specs, seeds, device=dev, use_kernels=False).rows
    compare_lanes(label, rows, plain, "plain")
    return held


def quickstart_part(dev) -> dict:
    """a) the quickstart and the CLI; campaign_sweep's launches counted
    from 0 just before each, then each of their sweeps held to the plain
    versions at its own shape."""
    from repro_torch import campaigns
    from repro_torch.core.api import sweep
    from repro_torch.core.spec import CampaignSpec
    from repro_torch.kernels import ops

    want = jax_example_lines()["quickstart"]
    want_fired = [ast.literal_eval(ln[len("  fired: "):]) for ln in want
                  if ln.startswith("  fired: ")]
    want_floor = want_fired.pop()
    want_cost, want_days = (float(x.replace(",", "")) for x in re.search(
        r"\$([0-9,]+) for ([0-9,.]+) GPU-days", want[1]).groups())
    ckpt = ROOT / "build" / "quickstart_ckpt"
    example = load_example("quickstart_torch")
    ops.reset_launches()
    try:
        got, lines, wall = run_example("quickstart", lambda: example.main(
            device=dev, steps=QUICKSTART_STEPS, ckpt_dir=str(ckpt)))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    launches = dict(ops.LAUNCHES)
    fired = list(got["campaign"].events_fired)
    res, losses, done = got["campaign"], got["losses"], got["served"]
    tokens = sum(len(r.out) for r in done)
    floor = fired[-1] if fired else {}
    ok = (lines[0] == want[0] and fired[:-1] == want_fired
          and {k: v for k, v in floor.items() if k != "t"}
          == {k: v for k, v in want_floor.items() if k != "t"}
          and abs(floor["t"] - want_floor["t"]) <= FLOOR_HOURS
          and abs(res.cost - want_cost) <= STAT_BAND * want_cost
          and abs(res.accel_days - want_days) <= STAT_BAND * want_days)
    if not ok:
        fail(f"examples a) quickstart's campaign: {lines[:2]}, fired "
             f"{fired}, against the JAX example's {want_fired} + "
             f"{want_floor} (its hour within {FLOOR_HOURS}), cost "
             f"{res.cost} / GPU-days {res.accel_days} against "
             f"{want_cost} / {want_days} within {STAT_BAND}")
    want_launches = {k: 2 if k == "campaign_sweep" else 0 for k in launches}
    if launches != want_launches:
        fail(f"examples a) quickstart's launches {launches}, want "
             f"{want_launches} (one fused sweep per run call; the trainer "
             "and the server take the reference path)")
    if not (len(losses) == QUICKSTART_STEPS and losses[-1] < losses[0]
            and all(map(math.isfinite, losses))
            and got["restored_step"] == QUICKSTART_STEPS
            and len(done) == 6 and tokens == QUICKSTART_TOKENS):
        fail(f"examples a) quickstart: {len(losses)} losses "
             f"{losses[:1]} -> {losses[-1:]}, restored step "
             f"{got['restored_step']}, {len(done)} requests, {tokens} tokens")

    spec = ROOT / "tests" / "data" / "paper_replay.spec.json"
    payload = ROOT / "build" / "cli_run.json"
    ops.reset_launches()
    rc, cli_lines, cli_wall = run_example("cli", lambda: campaigns.main(
        ["run", str(spec), "--json", str(payload)]))
    cli_launches = ops.LAUNCHES["campaign_sweep"]
    body = json.loads(payload.read_text())
    payload.unlink()
    if rc != 0 or cli_launches != 1 or body["engine"] != "torch" \
            or body["kind"] != "campaign" or not cli_lines[0].startswith(
                "campaign 'paper' seed=2021 engine=torch"):
        fail(f"examples a) the CLI: exit {rc}, {cli_launches} launches, "
             f"payload engine {body.get('engine')} kind {body.get('kind')}, "
             f"first line {cli_lines[:1]}")

    # the CLI's payload against an in-process fused run of the same draws,
    # and the kernel held to its plain version at the CLI lane's own
    # shape (1,344 ticks); only the eager use_kernels=False lane
    # comparison runs the lane cut to CUT_HOURS, as ``drive``'s eager
    # routes do
    t0 = time.perf_counter()
    qs = got["spec"]
    cli_spec = CampaignSpec.from_json(spec.read_text())
    compare_lanes("examples a) the CLI",
                  [{**body["results"], "events_fired": body["events_fired"]}],
                  sweep([cli_spec], [2021], device=dev).rows, "fused")
    cli_cut, = cut_grid([cli_spec], [2021])[0]
    compare_lanes("examples a) the CLI's lane at 96 h",
                  sweep([cli_cut], [2021], device=dev).rows,
                  sweep([cli_cut], [2021], device=dev,
                        use_kernels=False).rows, "plain")
    held = [hold_to_plain(dev, "examples a) quickstart run", [qs], [2021],
                          [{**res.to_dict(), "events_fired": fired}]),
            hold_to_plain(dev, "examples a) quickstart sweep", [qs],
                          list(range(2021, 2025)), got["sweep"].rows),
            check_sweep(dev, [cli_spec], [2021], timed=False)]
    held_s = time.perf_counter() - t0
    log(f"[examples] a) quickstart: {wall:.2f} s (campaign_sweep launches "
        f"{launches['campaign_sweep']}; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} over {QUICKSTART_STEPS} steps; restored at step "
        f"{got['restored_step']}; {len(done)} requests, {tokens} tokens); "
        f"the CLI {cli_wall:.2f} s (1 launch; cost "
        f"${body['results']['cost']:,.2f}, its payload equal to an "
        f"in-process fused run); each sweep held to the plain versions (the "
        f"CLI's lane-by-lane use_kernels=False run cut to 96 h) in "
        f"{held_s:.2f} s ("
        + ", ".join(f"{h['lanes']} lane(s) x {h['ticks']} ticks: kernel "
                    f"f32 max abs err {h['max_abs_err']:.3g}" for h in held)
        + "; lanes equal the use_kernels=False runs)")
    return {"wall_s": wall, "launches": launches["campaign_sweep"],
            "losses": [losses[0], losses[-1]], "cli_wall_s": cli_wall,
            "cli_launches": cli_launches, "cost": res.cost,
            "accel_days": res.accel_days, "budget_floor_h": floor["t"],
            "held_s": held_s}


def examples_phase(dev, smi: str) -> dict:
    """Phase 24: a) the quickstart and the CLI, b) the overlay server,
    c) the elastic example on a world of one NCCL rank it makes
    itself."""
    out = {"quickstart": quickstart_part(dev)}

    want = jax_example_lines()
    example = load_example("serve_overlay_torch")
    _, lines, wall = run_example("serve_overlay",
                                 lambda: example.main(device=dev))
    if lines != want["serve_overlay"]:
        fail(f"examples b) serve_overlay printed {lines}, the JAX example "
             f"{want['serve_overlay']}")
    log(f"[examples] b) serve_overlay: {wall:.2f} s, both lines equal the "
        "JAX example's byte for byte")
    out["serve_overlay"] = {"wall_s": wall}

    import torch.distributed as dist
    if dist.is_initialized():
        fail("examples c) a process group is still open")
    ckpt = ROOT / "build" / "elastic_example_ckpt"
    example = load_example("elastic_cloud_train_torch")
    try:
        got, lines, wall = run_example("elastic", lambda: example.main(
            device=dev, ckpt_dir=str(ckpt)))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    losses = got["losses"]
    # the fleet line up to its pod count (the one-card form has one pod)
    fleet, preempted, _, ledger = want["elastic_cloud_train"]
    fleet = fleet[:fleet.index("->") + 3]
    if not (len(losses) == 30 and all(map(math.isfinite, losses))
            and tuple(got["pod_shape"]) == (1, 1) and got["max_pods"] == 1
            and lines[0].startswith(fleet)
            and lines[1] == preempted and lines[-1] == ledger
            and not dist.is_initialized()):
        fail(f"examples c) elastic: {lines}, {len(losses)} losses, pods "
             f"{got['pod_shape']} x {got['max_pods']}; the JAX example's "
             f"lines {fleet!r}, {preempted!r}, {ledger!r}")
    log(f"[examples] c) elastic: {wall:.2f} s on one NCCL rank, pods (1, 1), "
        f"{got['rebuilds']} mesh rebuild(s) (the JAX example on 4 devices, "
        f"pods (2, 1): 4), loss {losses[0]:.4f} -> {losses[-1]:.4f}; fleet, "
        f"spend and ledger lines equal the JAX example's | {smi}")
    out["elastic"] = {"wall_s": wall, "rebuilds": got["rebuilds"],
                      "losses": [losses[0], losses[-1]]}
    return out


# -- phase 25: the what-if planning front door --------------------------------

# the planning grids: (label, library entry, seeds, engine batches)
PLANNING_GRIDS = (("suite", "default_suite", 8, 6),
                  ("pareto", "pareto_grid", 17, 4))
# b)'s cut: the first PLANNING_CUT_SEEDS seeds at CUT_HOURS
PLANNING_CUT_SEEDS = 2


def planning_phase(dev, smi: str) -> dict:
    """Phase 25: a) + b) each planning grid through ``drive``: the fused
    route at full duration (one launch per engine batch, counted from 0
    just before; its wall, ``timings=`` split and frontier printed), and
    the cut grid on the fused and plain routes, lane for lane; the fused
    kernel held to its plain version on each full-duration batch's
    packed arguments; c) ``campaigns pareto`` in-process; d)
    ``examples/whatif_sweep_torch.py``'s ``main``."""
    from repro_torch import campaigns
    from repro_torch.analysis.pareto import frontier
    from repro_torch.core import scenarios
    from repro_torch.core.api import sweep
    from repro_torch.kernels import ops

    out = {}
    for label, entry, n_seeds, batches in PLANNING_GRIDS:
        specs = getattr(scenarios, entry)()
        tag = f"planning {label}"
        res = drive(tag, specs, list(range(n_seeds)), cut=True,
                    batches=batches, eager=("plain",),
                    cut_seeds=PLANNING_CUT_SEEDS)
        split = res["split"]
        log(f"[{tag}] {entry}() x {n_seeds} seeds, fused route: wall "
            f"{res['fused_s']:.4f} s = prepare {split['prepare']:.4f} + "
            f"planner {split['planner']:.4f} + run {split['run']:.4f} + "
            f"results {split['results']:.4f} s (host clock) | {smi}")
        front = frontier(res["result"])
        for line in front.table().splitlines():
            log(f"[{tag}] {line}")
        # the kernel on each full-duration batch of a)'s grid, after every
        # timeline event has fired, against its plain version
        groups = {}
        for s in specs:
            groups.setdefault(batch_keys([s])[0], []).append(s)
        t0 = time.perf_counter()
        held = [check_sweep(dev, group, list(range(n_seeds)), timed=False)
                for group in groups.values()]
        held_s = time.perf_counter() - t0
        log(f"[{tag}] the kernel on each full-duration batch's packed "
            "arguments against its plain version: exact integers, f32 max "
            "abs err "
            + ", ".join(f"{h['max_abs_err']:.3g} ({h['lanes']} lanes x "
                        f"{h['ticks']} ticks)" for h in held)
            + f"; {held_s:.2f} s")
        out[label] = {"launches": res["launches"]["campaign_sweep"],
                      "wall_s": res["fused_s"], "split": split,
                      "plain_cut_s": res["plain_s"],
                      "held_s": held_s,
                      "frontier": [p.scenario for p in front.frontier]}

    # c) the CLI's pareto, its payload against an in-process fused sweep
    path = ROOT / "build" / "cli_pareto.json"
    argv = ["pareto", "--duration-h", str(CUT_HOURS), "--seeds",
            "2021,2022", "--json", str(path)]
    ops.reset_launches()
    rc, lines, wall = run_example("pareto", lambda: campaigns.main(argv),
                                   "planning")
    launches = dict(ops.LAUNCHES)
    body = json.loads(path.read_text())
    path.unlink()
    grid = [replace(s, duration_h=CUT_HOURS)
            for s in scenarios.pareto_grid()]
    want = frontier(sweep(grid, [2021, 2022], device=dev)).to_dict()
    if rc != 0 or launches != {**{k: 0 for k in launches},
                               "campaign_sweep": 4} \
            or {k: body[k] for k in want} != want:
        fail(f"planning c) campaigns pareto: exit {rc}, launches "
             f"{launches}, payload {body} against {want}")
    log(f"[planning] c) campaigns {' '.join(argv[:-2])}: {wall:.3f} s, "
        f"{launches['campaign_sweep']} launches, frontier "
        f"{[p['scenario'] for p in body['points'] if p['on_frontier']]} "
        f"equal to the in-process sweep's | {smi}")
    out["cli"] = {"launches": launches["campaign_sweep"], "wall_s": wall}

    # d) the what-if example at its defaults: default_suite() x 8 seeds
    example = load_example("whatif_sweep_torch")
    ops.reset_launches()
    sw, lines, wall = run_example("whatif", lambda: example.main([]),
                                   "planning")
    launches = dict(ops.LAUNCHES)
    rows = sw.rows
    if launches != {**{k: 0 for k in launches}, "campaign_sweep": 6} \
            or len(rows) != 152 or len(sw.scenario_names()) != 19 \
            or not all(math.isfinite(r["cost"]) and r["cost"] > 0
                       and r["accel_days"] > 0 for r in rows):
        fail(f"planning d) whatif_sweep_torch: launches {launches}, "
             f"{len(rows)} rows")
    log(f"[planning] d) whatif_sweep_torch: {wall:.3f} s, "
        f"{launches['campaign_sweep']} launches, {len(rows)} lanes | {smi}")
    out["whatif"] = {"launches": launches["campaign_sweep"], "wall_s": wall}
    return out


def tp16_key(arch, tp16) -> str:
    """The kernels line's name of a rank-0 (16, 16) mesh prefill."""
    return (f"{arch} prefill ({tp16[arch]['depth']}), rank 0 of "
            f"(16, 16)")


def padded_vocab(arch) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).padded_vocab()


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

    main_run = drive("main", grid, list(range(17)), cut=True)
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
    drive("dataplane", [dp_spec], list(range(64)), cut=True)
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
    cfg = replace(get_config("xlstm-350m"), num_layers=XLSTM_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, 2021, device=dev)
    torch.cuda.synchronize()
    log(f"[model] {cfg.name}: {param_count(params) / 1e6:.2f} M f32 "
        f"parameters ({cfg.num_layers} of 24 layers: {cfg.n_super} "
        f"super-block(s) "
        f"of 7 mLSTM + 1 sLSTM; d_model {cfg.d_model}, {cfg.num_heads} "
        f"heads) initialised on the card in {time.perf_counter() - t0:.2f} s")
    xlstm = xlstm_forward_phase(params, cfg, dev)
    serve_phase(params, cfg, dev, tag="xserved")
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    del params                         # the card to itself for training
    torch.cuda.empty_cache()

    train_vs_cpu(dev)
    trained = {"card": smi,
               "float32": full_width_train(dev, "float32", 2),
               "bfloat16": full_width_train(dev, "bfloat16", 4),
               "preemption": preemption_round_trip(dev)}
    log("[train] " + json.dumps(trained))
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    zoo_phases(dev, t_start)
    distributed_phase(dev, smi)
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    dryrun_phase(smi)
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    tp = tp_phase(dev, smi)
    tp16 = {**tp["rank0"]["prefill"], **tp["rank0"]["split_prefill"]}
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    t0 = time.perf_counter()
    examples = examples_phase(dev, smi)
    log(f"[examples] phase {time.perf_counter() - t0:.1f} s | {smi}")
    log(f"[time] {time.perf_counter() - t_start:.1f} s since the start")
    t0 = time.perf_counter()
    planning = planning_phase(dev, smi)
    log(f"[planning] phase {time.perf_counter() - t0:.1f} s | {smi}")
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
         "examples_launches": {
             "quickstart (two run calls)": examples["quickstart"][
                 "launches"],
             "campaigns run": examples["quickstart"]["cli_launches"]},
         "planning_launches": {
             "default_suite() x 8 seeds (6 batches)": planning["suite"][
                 "launches"],
             "pareto_grid() x 17 seeds (4 batches)": planning["pareto"][
                 "launches"],
             "campaigns pareto": planning["cli"]["launches"],
             "whatif_sweep_torch": planning["whatif"]["launches"]},
         **{key: sweep_kernel[key] for key in keys}}] + [
        {"name": "flash_attention", "route": "cuda", "cuda_route": "wgmma",
         "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
         "launches": fwd["wgmma"]["launches"],
         "mesh_launches": {
             tp16_key(arch, tp16): tp16[arch]["launches"][
                 "flash_attention"] for arch in tp16},
         "one_rank_mesh_launches": {
             "yi-9b prefill": tp["yi"]["bfloat16"]["launches"][
                 "flash_attention"],
             "qwen3 prefill": tp["qwen3"]["bfloat16"]["launches"][
                 "flash_attention"]},
         **{key: yi[key] for key in keys}},
        {"name": "flash_attention.simt", "route": "cuda",
         "cuda_route": "simt", "source": FLASH_SOURCE,
         "replaces": FLASH_REPLACES, "launches": fwd["simt"]["launches"],
         **{key: yi_f32[key] for key in keys}},
        {"name": "moe_gmm", "route": "cuda", "cuda_route": "wgmma",
         "source": GMM_SOURCE, "replaces": GMM_REPLACES,
         "launches": hybrid["wgmma"]["launches"]["moe_gmm"],
         "mesh_launches": {
             tp16_key(arch, tp16): tp16[arch]["launches"][
                 "moe_gmm"] for arch in tp16 if tp16[arch]["launches"][
                     "moe_gmm"]},
         "one_rank_mesh_launches": {"qwen3 prefill": tp["qwen3"][
             "bfloat16"]["launches"]["moe_gmm"]},
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
    log(f"[time] whole script {time.perf_counter() - t_start:.1f} s | {smi}")
    print(json.dumps(report))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--phase22":
        sys.exit(dryrun_part(sys.argv[2], sys.argv[3]))
    if len(sys.argv) == 3 and sys.argv[1] == "--phase23":
        sys.exit(tp_rank0_part(sys.argv[2]))
    sys.exit(main())
