"""Render markdown tables from the port's dry-run artifacts.

The port's copy of the JAX package's ``analysis/report.py``, reading the
port's keys: ``counted`` (dot FLOPs and collective bytes counted from the
dispatcher) where the JAX results hold ``hlo_parsed``, ``trace_s`` where
they hold ``compile_s``; ``fit_md`` adds the per-device peak against the
card's 80 GB and the useful ratio.

    PYTHONPATH=src python -m repro_torch.analysis.report DIR \\
        [roofline|roofline2|fit|dryrun]
    PYTHONPATH=src python -m repro_torch.analysis.report DIR compare \\
        BEFORE_DIR

``compare_md`` sets each cell's peak, useful ratio and collective bytes
beside an earlier run's (``git archive`` an older commit's
``artifacts/dryrun_torch`` into a directory to compare with it).
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(art_dir):
    cells = {}
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        for r in json.load(open(path)):
            cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt_bytes(b):
    for unit, d in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6)):
        if b >= d:
            return f"{b / d:.2f}{unit}"
    return f"{b:.0f}B"


def roofline_md(cells, mesh="16x16"):
    out = ["| arch | shape | compute s | memory s | collective s | "
           "bottleneck | dotF/dev | MODEL_FLOPS | useful | "
           "coll B/dev | mem/dev |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        if r.get("status") == "skipped":
            out.append(f"| {arch} | {shape} | — | — | — | skipped "
                       f"(full attention) | — | — | — | — | — |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {arch} | {shape} | ERROR | | | | | | | | |")
            continue
        rf = r["roofline"]
        arg = (r["memory"]["argument_bytes"] or 0)
        out.append(
            f"| {arch} | {shape} | {rf['compute_s']:.4f} | "
            f"{rf['memory_s']:.4f} | {rf['collective_s']:.4f} | "
            f"**{rf['bottleneck']}** | {rf['hlo_flops_device']:.2e} | "
            f"{rf['model_flops']:.2e} | {min(rf['useful_ratio'], 9.99):.2f} | "
            f"{fmt_bytes(r['counted']['collective_bytes'])} | "
            f"{fmt_bytes(arg)} |")
    return "\n".join(out)


def dryrun_md(cells):
    out = ["| arch | shape | mesh | status | trace s | arg bytes/dev | "
           "temp bytes/dev | dot GF/dev | coll B/dev |",
           "|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(cells.items()):
        if r.get("status") == "skipped":
            out.append(f"| {arch} | {shape} | {m} | SKIP (full attn) "
                       f"| | | | | |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {arch} | {shape} | {m} | ERROR | | | | | |")
            continue
        out.append(
            f"| {arch} | {shape} | {m} | ok | {r['trace_s']:.0f} | "
            f"{fmt_bytes(r['memory']['argument_bytes'] or 0)} | "
            f"{fmt_bytes(r['memory']['temp_bytes'] or 0)} | "
            f"{r['counted']['dot_flops'] / 1e9:.0f} | "
            f"{fmt_bytes(r['counted']['collective_bytes'])} |")
    return "\n".join(out)


CARD_BYTES = 80e9        # an H100 SXM's device memory (data sheet)


def fit_md(cells, mesh="16x16"):
    """Per cell of ``mesh``: the trace time, the argument and peak bytes a
    device holds against the card's 80 GB, the dot FLOPs a device runs,
    the useful ratio (model FLOPs over every device's dot FLOPs), the
    collective bytes a device sends and the roofline's bound."""
    out = ["| arch | shape | trace s | arg/dev | peak/dev | of 80 GB | "
           "fits | dotF/dev | useful | coll B/dev | bound |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh:
            continue
        if r.get("status") == "skipped":
            out.append(f"| {arch} | {shape} | skipped (full attention) "
                       f"| | | | | | | | |")
            continue
        if r.get("status") != "ok":
            out.append(f"| {arch} | {shape} | ERROR | | | | | | | | |")
            continue
        mem, rf = r["memory"], r["roofline"]
        peak = mem["peak_bytes"]
        out.append(
            f"| {arch} | {shape} | {r['trace_s']:.1f} | "
            f"{fmt_bytes(mem['argument_bytes'])} | {fmt_bytes(peak)} | "
            f"{100 * peak / CARD_BYTES:.1f}% | "
            f"{'yes' if peak <= CARD_BYTES else 'no'} | "
            f"{rf['hlo_flops_device']:.2e} | {rf['useful_ratio']:.3f} | "
            f"{fmt_bytes(r['counted']['collective_bytes'])} | "
            f"{rf['bottleneck']} |")
    return "\n".join(out)


def compare_md(cells, before, mesh="16x16"):
    """Per cell of ``mesh``: the peak bytes a device holds, the useful
    ratio and the collective bytes a device sends in ``before`` (an
    earlier run's cells) and in ``cells``, whether the cell now fits the
    card, its bound and the sub-blocks computed whole on every "model"
    rank (``tp_whole``)."""
    out = ["| arch | shape | peak/dev before | after | fits | useful "
           "before | after | coll B/dev before | after | bound | whole |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for (arch, shape, m), r in sorted(cells.items()):
        if m != mesh or r.get("status") == "skipped":
            continue
        b = before.get((arch, shape, m), {})
        if r.get("status") != "ok" or b.get("status") != "ok":
            out.append(f"| {arch} | {shape} | ERROR | | | | | | | | |")
            continue
        peak = r["memory"]["peak_bytes"]
        out.append(
            f"| {arch} | {shape} | "
            f"{fmt_bytes(b['memory']['peak_bytes'])} | {fmt_bytes(peak)} | "
            f"{'yes' if peak <= CARD_BYTES else 'no'} | "
            f"{b['roofline']['useful_ratio']:.3f} | "
            f"{r['roofline']['useful_ratio']:.3f} | "
            f"{fmt_bytes(b['counted']['collective_bytes'])} | "
            f"{fmt_bytes(r['counted']['collective_bytes'])} | "
            f"{r['roofline']['bottleneck']} | "
            f"{', '.join(r.get('tp_whole', [])) or '-'} |")
    return "\n".join(out)


if __name__ == "__main__":
    art = sys.argv[1] if len(sys.argv) > 1 else "artifacts/dryrun"
    cells = load(art)
    mode = sys.argv[2] if len(sys.argv) > 2 else "roofline"
    if mode == "roofline":
        print(roofline_md(cells))
    elif mode == "roofline2":
        print(roofline_md(cells, mesh="2x16x16"))
    elif mode == "fit":
        print(fit_md(cells))
    elif mode == "compare":                 # DIR compare BEFORE_DIR
        print(compare_md(cells, load(sys.argv[3])))
    else:
        print(dryrun_md(cells))
