"""Port-side programs of ``tests/test_torch_dryrun.py`` and
``tests/test_torch_dryrun_flops.py``, each in a process of its own (the
dry run makes torch's fake process group the process's default group).

    PYTHONPATH=src python tests/torch_dryrun_cells.py CASE OUT.json

imports no JAX; the test files hold what it writes to the JAX package.

CASE "mesh22": ``dry_run`` of the reduced archs in ``MESH22_ARCHS`` on the
(2, 2) ("data", "model") mesh for the train, prefill and decode cells of
``reduced_shape``: the whole result dict of each.
CASE "production": the argument bytes (``dryrun.step_inputs``) of every
(arch x shape) cell on (16, 16) and (2, 16, 16), no step traced.
CASE "flops": ``dry_run`` on one rank, mesh (1, 1): prefill and decode of
every reduced arch, and train with remat off for ``TRAIN_ARCHS``; the dot
FLOPs of each.
CASE "gaps": the train cells of ``TRAIN_ARCHS`` on one rank at each
(batch, seq_len) of ``GAP_SHAPES``; the dot FLOPs of each.
"""
import json
import sys

from repro_torch.configs import (ARCH_IDS, SHAPES, RunConfig, ShapeConfig,
                                 get_config, get_reduced)
from repro_torch.launch import dryrun as dr

MESH22_ARCHS = ("yi-9b", "jamba-v0.1-52b", "xlstm-350m", "whisper-large-v3",
                "internvl2-2b")
TRAIN_ARCHS = ("yi-9b", "jamba-v0.1-52b", "xlstm-350m")
KINDS = ("train", "prefill", "decode")
# (global_batch, seq_len, grad_accum) of the reduced cells of each kind:
# on (2, 2) a batch of 4 splits over "data"; the FLOP cells run on one rank
MESH22_SHAPE = {"train": (4, 32, 2), "prefill": (4, 32, 1),
                "decode": (4, 32, 1)}
FLOPS_SHAPE = {"train": (2, 128, 1), "prefill": (2, 64, 1),
               "decode": (2, 64, 1)}
GAP_SHAPES = ((4, 64), (2, 128), (2, 256))


def reduced_shape(kind, sizes):
    b, s, accum = sizes[kind]
    return ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind,
                       grad_accum=accum)


def reduced_run(cfg, shape):
    """bf16 and the reference path, as the dry run; remat off."""
    return RunConfig(model=cfg, shape=shape, remat=False)


def _mesh22():
    out = {}
    for arch in MESH22_ARCHS:
        cfg = get_reduced(arch)
        for kind in KINDS:
            shape = reduced_shape(kind, MESH22_SHAPE)
            out[f"{arch}/{kind}"] = dr.dry_run(
                cfg, shape, reduced_run(cfg, shape), (2, 2), "cpu")
    return out


def _production():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding_ctx import make_mesh

    dr.fake_world()
    out = {}
    for mesh_shape in ((16, 16), (2, 16, 16)):
        mesh = make_mesh(mesh_shape, dr._names(mesh_shape), "cpu")
        label = "x".join(map(str, mesh_shape))
        for arch in ARCH_IDS:
            for shape in SHAPES.values():
                _, n = dr.step_inputs(
                    get_config(arch), shape, mesh, "cpu",
                    FakeTensorMode(allow_non_fake_inputs=True))
                out[f"{arch}/{shape.name}/{label}"] = n
    return out


def _flops():
    out = {}
    for arch in ARCH_IDS:
        cfg = get_reduced(arch)
        for kind in KINDS:
            if kind == "train" and arch not in TRAIN_ARCHS:
                continue
            shape = reduced_shape(kind, FLOPS_SHAPE)
            r = dr.dry_run(cfg, shape, reduced_run(cfg, shape), (1, 1),
                           "cpu")
            out[f"{arch}/{kind}"] = r["counted"]["dot_flops"]
    return out


def _gaps():
    out = {}
    for arch in TRAIN_ARCHS:
        cfg = get_reduced(arch)
        for b, s in GAP_SHAPES:
            shape = reduced_shape("train", {"train": (b, s, 1)})
            r = dr.dry_run(cfg, shape, reduced_run(cfg, shape), (1, 1),
                           "cpu")
            out[f"{arch}/{b}/{s}"] = r["counted"]["dot_flops"]
    return out


if __name__ == "__main__":
    case, path = sys.argv[1:3]
    result = {"mesh22": _mesh22, "production": _production,
              "flops": _flops, "gaps": _gaps}[case]()
    with open(path, "w") as f:
        json.dump(result, f)
