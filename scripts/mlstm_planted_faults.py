#!/usr/bin/env python3
"""Plant faults in copies of an mLSTM kernel and show that the mLSTM check
of ``chip_smoke.py`` (phase 13) catches them.

Run from the repository root on a machine with one NVIDIA H100:

    python3 scripts/mlstm_planted_faults.py [--route wgmma|simt]

For the sound kernel and for each fault, ``src/`` and ``chip_smoke.py`` are
copied into a fresh directory under ``build/`` (git-ignored; the checkout
itself is never edited), the fault is written into the copy's kernel, and
phase 13 runs there on one xlstm-350m case alone (S=4096, H=4,
dqk=dv=512: 32 chunks of 128), which holds the route to the sequential
plain version with the elementwise gate and the worst-row gate:

  wgmma (the default)  ``csrc/mlstm_chunk_wgmma.cu``, the tensor-core
                       route, on the B=2 case (bf16 q/k/v, f32 gates);
  simt                 ``csrc/mlstm_chunk.cu``, the CUDA-core route, on
                       the f32 B=1 case.

The faults, planted in the route's states kernel:

  drop     the state (C and n) entering chunk 30 of 32 is zero;
  rescale  the update that makes the state entering chunk 30 skips the
           rescale exp(m0 - Mc) (of C and of n).

Each run prints its ``[mlstm]`` lines or the check's failure, which gives
both gates' readings.  Exits 0 when the sound copy passes and both faults
fail.
"""
from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
DROP_ANCHOR = "    // -- the state entering chunk c ---"
# route: (kernel source, phase 13's case, the code that zeroes a thread's
# share of the state (C and n), the line that reads the chunk's rescale
# exp(m0 - Mc) and the same line with the fault planted at chunk 29)
ROUTES = {
    "wgmma": (CSRC / "mlstm_chunk_wgmma.cu", "xlstm-b2-model",
              "      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;\n"
              "      n_reg = 0.0f;\n",
              "    const float decay = cv[c * kChunkVals + kDecay];",
              "    const float decay =                     // planted fault\n"
              "        c == 29 ? 1.0f : cv[c * kChunkVals + kDecay];"),
    "simt": (CSRC / "mlstm_chunk.cu", "xlstm-b1-f32",
             "      for (int r = 0; r < 4; ++r)\n"
             "        for (int e = 0; e < 8; ++e) acc[r][e] = 0.0f;\n"
             "      for (int r = 0; r < 4; ++r) n_reg[r] = 0.0f;\n",
             "    const float dc = decay;",
             "    const float dc = c == 29 ? 1.0f : decay;  // planted fault"),
}
RUN = """
import sys
import torch
sys.path.insert(0, "src")
import chip_smoke
chip_smoke.MLSTM_CASES = [c for c in chip_smoke.MLSTM_CASES
                          if c[0] == {case!r}]
chip_smoke.check_mlstm(torch.device("cuda"))
"""


def faults(zero_state: str, rescale: str, rescale_fault: str) -> dict:
    """The sound copy and the two faults, as (anchor, replacement) edits."""
    return {
        "sound": [],
        "drop": [(DROP_ANCHOR,
                  "    if (c == 30) {                          "
                  "// planted fault\n" + zero_state + "    }\n" +
                  DROP_ANCHOR)],
        "rescale": [(rescale, rescale_fault)],
    }


def run(name: str, edits, kernel: Path, case: str) -> bool:
    """True when phase 13 passes on a copy with ``edits`` applied."""
    (ROOT / "build").mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix=f"fault-{name}-", dir=ROOT / "build"))
    try:
        shutil.copytree(ROOT / "src", work / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy2(ROOT / "chip_smoke.py", work / "chip_smoke.py")
        source = (work / kernel).read_text()
        for old, new in edits:
            if source.count(old) != 1:
                raise SystemExit(f"{name}: anchor not found once: {old!r}")
            source = source.replace(old, new)
        (work / kernel).write_text(source)
        out = subprocess.run([sys.executable, "-c", RUN.format(case=case)],
                             cwd=work,
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
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--route", choices=sorted(ROUTES), default="wgmma")
    route = parser.parse_args().route
    kernel, case, *edits = ROUTES[route]
    print(f"[fault] route {route}: {kernel} on {case}", flush=True)
    passed = {name: run(name, planted, kernel, case)
              for name, planted in faults(*edits).items()}
    ok = passed["sound"] and not passed["drop"] and not passed["rescale"]
    print(f"[fault] sound {'passed' if passed['sound'] else 'FAILED'}; "
          f"drop {'caught' if not passed['drop'] else 'MISSED'}; rescale "
          f"{'caught' if not passed['rescale'] else 'MISSED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
