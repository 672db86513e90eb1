"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

The sources in ``csrc/`` are compiled into one shared library with a
plain C interface (no PyTorch headers, so the build takes seconds).
Each source compiles in its own nvcc process, all started together,
and one more nvcc links the objects:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c -o <obj> csrc/<source>.cu     (per source)
    nvcc -shared -o <lib> <objs>

The library lands in ``build/repro_torch_kernels/`` under the
repository root, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads the cached library.  Nothing
is built or imported at module import: :func:`library` does it on the
first kernel launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = ["SOURCES", "HEADERS", "NVCC_FLAGS", "build_dir", "library",
           "last_build_seconds"]

_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "campaign_sweep.cu", _CSRC / "flash_attention.cu",
           _CSRC / "moe_gmm.cu", _CSRC / "mamba_scan.cu",
           _CSRC / "mlstm_chunk.cu", _CSRC / "mlstm_chunk_wgmma.cu")
# hopper.cuh: included by every source but campaign_sweep.cu;
# mlstm_gates.cuh (the mLSTM's gate pass): by both mLSTM sources
HEADERS = (_CSRC / "hopper.cuh", _CSRC / "mlstm_gates.cuh")
# IEEE division and square root, no fast math: the allocator's floors
# depend on every f32 operation rounding on its own
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
last_build_seconds: Optional[float] = None


def build_dir() -> Path:
    """``build/repro_torch_kernels`` under the repository root."""
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    default = os.path.join(home, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                       "the machine with the card (CUDA toolkit on PATH "
                       "or under $CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds) -> None:
    """Run the commands side by side; raise with the first failure's
    output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): "
                          f"{' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(out: Path) -> None:
    global last_build_seconds
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [out.parent / f"{tag}.{src.stem}.o" for src in SOURCES]
    tmp = out.parent / f"{tag}.tmp.so"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
              for src, obj in zip(SOURCES, objs)])
    _run_all([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)                 # atomic: readers never see half
    last_build_seconds = time.perf_counter() - t0


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.campaign_alloc.argtypes = [p, p, p, i, i, p]
    lib.campaign_advance.argtypes = [p, p, p, p, i, i, p]
    lib.campaign_bill.argtypes = [p, p, p, p, p, i, i, i, p]
    # q, k, v, o, strides, bf16, B, H, Hkv, Sq, Skv, D, causal, kv_len,
    # q_offset, scale, stream
    lib.flash_attention.argtypes = [p, p, p, p, p, *[i] * 10,
                                    ctypes.c_float, p]
    # the same without the type flag, bf16 only (the tensor-core route)
    lib.flash_attention_wgmma.argtypes = [p, p, p, p, p, *[i] * 9,
                                          ctypes.c_float, p]
    # x, w, o, x_bf16, w_bf16, E, C, D, F, row_tile, stream
    lib.moe_gmm.argtypes = [p, p, p, *[i] * 7, p]
    # x, w, o, E, C, D, F, stream (bf16, the tensor-core route)
    lib.moe_gmm_wgmma.argtypes = [p, p, p, *[i] * 4, p]
    # xc, dt, bm, cm, a, y, carry, types, B, S, di, N, seg_len, stream
    lib.mamba_scan.argtypes = [p, p, p, p, p, p, p, *[i] * 6, p]
    # q, k, v, logi, logf, o, strides, types, B, H, S, dqk, dv, chunk,
    # scale, scratch, stream; each route's scratch bytes from B, H, S,
    # dqk, dv, chunk (the tensor-core route takes bf16 q/k/v)
    for fn in (lib.mlstm_chunk, lib.mlstm_chunk_wgmma):
        fn.argtypes = [p, p, p, p, p, p, p, *[i] * 7, ctypes.c_float, p, p]
    for fn in (lib.mlstm_chunk_scratch, lib.mlstm_chunk_wgmma_scratch):
        fn.argtypes = [i] * 6
        fn.restype = ctypes.c_longlong
    for fn in (lib.campaign_alloc, lib.campaign_advance, lib.campaign_bill,
               lib.flash_attention, lib.flash_attention_wgmma, lib.moe_gmm,
               lib.moe_gmm_wgmma, lib.mamba_scan, lib.mlstm_chunk,
               lib.mlstm_chunk_wgmma):
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its hash is new."""
    global _lib
    with _lock:
        if _lib is None:
            out = build_dir() / f"repro_torch_kernels-{_digest()}.so"
            if not out.exists():
                _compile(out)
            _lib = _bind(ctypes.CDLL(str(out)))
        return _lib
