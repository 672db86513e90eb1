"""The port's cost model (``analysis/roofline.py``) and report
(``analysis/report.py``) against the JAX package's.

  * ``count_params`` / ``model_flops`` / ``state_bytes`` /
    ``cache_bytes`` / ``hbm_bytes`` equal the JAX module's on all 40
    (arch x shape) cells, on both production meshes' chip counts;
  * the terms follow the H100 SXM's constants (989.4 TFLOP/s bf16,
    3.35 TB/s, 50 GB/s of collective bandwidth a card), and no TPU
    constant survives;
  * the renderers, mirroring ``tests/test_roofline.py``, on the port's
    keys (``counted``, ``trace_s``): ok, skipped and error rows.
"""
import json

import pytest

from repro.analysis import roofline as jrl
from repro.configs import get_config as jget_config
from repro.configs import get_shape as jget_shape
from repro_torch.analysis import report
from repro_torch.analysis import roofline as rl
from repro_torch.configs import cells, get_config, get_shape

CELLS = [(a, s) for a, s, _ in cells()]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_accounting_equals_the_jax_module(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    sh, jsh = get_shape(shape), jget_shape(shape)
    assert rl.count_params(cfg) == jrl.count_params(jcfg)
    assert rl.model_flops(cfg, sh) == jrl.model_flops(jcfg, jsh)
    assert rl.cache_bytes(cfg, sh) == jrl.cache_bytes(jcfg, jsh)
    for n in (256, 512):
        assert rl.state_bytes(cfg, sh, n) == jrl.state_bytes(jcfg, jsh, n)
        assert rl.hbm_bytes(cfg, sh, n) == jrl.hbm_bytes(jcfg, jsh, n)


def test_h100_constants():
    assert rl.PEAK_FLOPS == 989.4e12
    assert rl.HBM_BW == 3.35e12
    assert rl.ICI_BW == 50e9
    assert (rl.PEAK_FLOPS, rl.HBM_BW) != (jrl.PEAK_FLOPS, jrl.HBM_BW)


def test_terms_follow_the_h100_constants():
    cfg, shape = get_config("xlstm-350m"), get_shape("train_4k")
    mf = rl.model_flops(cfg, shape)
    dot = mf / 256 * 1.5
    r = rl.compute_roofline(cfg, shape, 256, dot, 1e9)
    assert r.compute_s == pytest.approx(dot / 989.4e12)
    assert r.memory_s == pytest.approx(rl.hbm_bytes(cfg, shape, 256)
                                       / 3.35e12)
    assert r.collective_s == pytest.approx(1e9 / 50e9)
    assert r.useful_ratio == pytest.approx(1 / 1.5)
    assert r.bottleneck == "collective"
    assert r.to_dict()["hlo_flops_device"] == dot
    # the same inputs on the JAX model's TPU constants: other terms
    j = jrl.compute_roofline(jget_config("xlstm-350m"),
                             jget_shape("train_4k"), 256, dot, 1e9)
    assert j.compute_s == pytest.approx(r.compute_s * 989.4e12 / 197e12)
    assert j.memory_s == pytest.approx(r.memory_s * 3.35e12 / 819e9)


def test_bottleneck_flips_with_the_dominant_term():
    cfg, decode = get_config("qwen3-moe-30b-a3b"), get_shape("decode_32k")
    mf = rl.model_flops(cfg, decode)
    assert rl.compute_roofline(cfg, decode, 256, mf / 256,
                               1e9).bottleneck == "collective"
    assert rl.compute_roofline(cfg, decode, 256, mf / 256,
                               0.0).bottleneck == "memory"
    assert rl.compute_roofline(cfg, decode, 256, 1e15,
                               0.0).bottleneck == "compute"


# -- the renderers, on the port's keys -------------------------------------

def _cell(arch="xlstm-350m", shape="train_4k", mesh="16x16", status="ok"):
    return {"arch": arch, "shape": shape, "mesh": mesh, "status": status,
            "trace_s": 12.3,
            "memory": {"argument_bytes": 2.5e9, "temp_bytes": 1.5e9,
                       "peak_bytes": 4.0e9},
            "counted": {"dot_flops": 8.0e12, "collective_bytes": 3.0e8},
            "roofline": {"compute_s": 0.0406, "memory_s": 0.0031,
                         "collective_s": 0.006, "bottleneck": "compute",
                         "hlo_flops_device": 8.0e12,
                         "model_flops": 1.3e16, "useful_ratio": 0.66}}


def test_fmt_bytes_units():
    assert report.fmt_bytes(512) == "512B"
    assert report.fmt_bytes(2.5e6) == "2.50MB"
    assert report.fmt_bytes(3.0e9) == "3.00GB"
    assert report.fmt_bytes(1.2e12) == "1.20TB"


def test_roofline_md_renders_ok_skipped_and_error_rows():
    cells_ = {
        ("a1", "train_4k", "16x16"): _cell("a1"),
        ("a2", "train_4k", "16x16"): _cell("a2", status="skipped"),
        ("a3", "train_4k", "16x16"): _cell("a3", status="error"),
        ("a4", "train_4k", "2x16x16"): _cell("a4", mesh="2x16x16"),
    }
    md = report.roofline_md(cells_)
    assert md.splitlines()[0].startswith("| arch | shape |")
    assert "| a1 | train_4k | 0.0406 |" in md
    assert "**compute**" in md and "300.00MB" in md and "2.50GB" in md
    assert "skipped" in md and "ERROR" in md
    assert "a4" not in md
    assert "a4" in report.roofline_md(cells_, mesh="2x16x16")


def test_dryrun_md_renders_all_statuses():
    cells_ = {
        ("a1", "train_4k", "16x16"): _cell("a1"),
        ("a2", "train_4k", "16x16"): _cell("a2", status="skipped"),
        ("a3", "train_4k", "16x16"): _cell("a3", status="boom"),
    }
    md = report.dryrun_md(cells_)
    assert md.splitlines()[0].startswith(
        "| arch | shape | mesh | status | trace s |")
    assert "| a1 | train_4k | 16x16 | ok | 12 | 2.50GB | 1.50GB | 8000 |" \
        in md
    assert "SKIP (full attn)" in md and "ERROR" in md


def test_fit_md_gives_peak_against_the_card_and_useful_ratio():
    cells_ = {
        ("a1", "train_4k", "16x16"): _cell("a1"),
        ("a2", "long_500k", "16x16"): _cell("a2", "long_500k",
                                           status="skipped"),
        ("a3", "train_4k", "16x16"): _cell("a3", status="error"),
    }
    md = report.fit_md(cells_)
    assert "| a1 | train_4k | 12.3 | 2.50GB | 4.00GB | 5.0% | yes | " \
        "8.00e+12 | 0.660 | 300.00MB | compute |" in md
    assert "| a2 | long_500k | skipped (full attention) |" in md
    assert "| a3 | train_4k | ERROR |" in md


def test_load_merges_artifact_files(tmp_path):
    (tmp_path / "one.json").write_text(json.dumps(
        [_cell("a1"), _cell("a1", shape="decode_32k")]))
    (tmp_path / "two.json").write_text(json.dumps([_cell("a2")]))
    assert set(report.load(str(tmp_path))) == {
        ("a1", "train_4k", "16x16"), ("a1", "decode_32k", "16x16"),
        ("a2", "train_4k", "16x16")}
