#!/usr/bin/env python3
"""Plant faults in copies of the tensor-core mLSTM kernel and show that
the mLSTM check of ``chip_smoke.py`` (phase 13) catches them.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/mlstm_planted_faults.py

For the sound kernel and for each fault, ``src/`` and ``chip_smoke.py`` are
copied into a fresh directory under ``build/`` (git-ignored; the checkout
itself is never edited), the fault is written into the copy's
``csrc/mlstm_chunk_wgmma.cu``, and phase 13 runs there on the xlstm-350m
case alone (B=2, H=4, S=4096, dqk=dv=512, bf16 q/k/v, f32 gates: 32
chunks of 128), which holds the tensor-core route to the sequential plain
version with the elementwise gate and the worst-row gate.  The faults:

  drop     the state (C and n) entering chunk 30 of 32 is zero;
  rescale  the update that makes the state entering chunk 30 skips the
           rescale exp(m0 - Mc) (of C and of n).

Each run prints its ``[mlstm]`` lines or the check's failure, which gives
both gates' readings.  Exits 0 when the sound copy passes and both faults
fail.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KERNEL = Path("src/repro_torch/kernels/csrc/mlstm_chunk_wgmma.cu")
FAULTS = {
    "sound": [],
    "drop": [("    // -- the state entering chunk c ---",
              "    if (c == 30) {                          // planted fault\n"
              "      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;\n"
              "      n_reg = 0.0f;\n"
              "    }\n"
              "    // -- the state entering chunk c ---")],
    "rescale": [("    const float decay = cv[c * kChunkVals + kDecay];",
                 "    const float decay =                     // planted fault\n"
                 "        c == 29 ? 1.0f : cv[c * kChunkVals + kDecay];")],
}
RUN = """
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke
chip_smoke.MLSTM_CASES = [c for c in chip_smoke.MLSTM_CASES
                          if c[0] == "xlstm-b2-model"]
chip_smoke.check_mlstm(torch.device("cuda"))
"""


def run(name: str, edits) -> bool:
    """True when phase 13 passes on a copy with ``edits`` applied."""
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"fault-{name}-", dir=ROOT / "build"))
    try:
        shutil.copytree(ROOT / "src", work / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy2(ROOT / "chip_smoke.py", work / "chip_smoke.py")
        source = (work / KERNEL).read_text()
        for old, new in edits:
            if source.count(old) != 1:
                raise SystemExit(f"{name}: anchor not found once: {old!r}")
            source = source.replace(old, new)
        (work / KERNEL).write_text(source)
        out = subprocess.run([sys.executable, "-c", RUN], cwd=work,
                             capture_output=True, text=True, timeout=900)
        text = (out.stdout + out.stderr).strip().splitlines()
        lines = [ln for ln in text if ln.startswith(("[mlstm]",
                                                     "chip_smoke:"))]
        for ln in lines or text[-5:]:
            print(f"[fault {name}] {ln}", flush=True)
        return out.returncode == 0
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    passed = {name: run(name, edits) for name, edits in FAULTS.items()}
    ok = passed["sound"] and not passed["drop"] and not passed["rescale"]
    print(f"[fault] sound {'passed' if passed['sound'] else 'FAILED'}; "
          f"drop {'caught' if not passed['drop'] else 'MISSED'}; rescale "
          f"{'caught' if not passed['rescale'] else 'MISSED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
