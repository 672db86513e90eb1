"""Multi-pod dry run of the port: trace every (arch x shape) cell's mesh
step on fake tensors over the production mesh(es) of 256 / 512 fake
ranks, and count what one device holds, computes and sends.

The port of the JAX package's ``launch/dryrun.py``.  Where the JAX dry
run lowers and compiles the step with GSPMD on 512 placeholder host
devices and reads XLA's memory analysis and the HLO, this one builds the
port's own mesh steps (``launch/steps.make_mesh_*_step``) on a
``DeviceMesh`` of torch's fake process group (no rank but this one
exists, no collective moves data), places every input as a DTensor of
fake tensors (shapes and dtypes only: nothing is allocated) and runs the
step once under ``analysis/counters.counting``.  bf16 parameters and the
reference path (``attention_impl="reference"``), as in the JAX dry run:
no kernel runs on fake tensors, so a dry run launches none.

It runs in its own process: the fake process group becomes the
process's default group, as the JAX dry run's device count locks at
import.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape decode_32k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --device cpu \\
        --out artifacts/dryrun_torch

Each cell gives one JSON dict, in the JAX schema where a counterpart
exists: ``trace_s`` stands for ``lower_s`` / ``compile_s``, ``counted``
(dot FLOPs, collective bytes and their kinds, per device) for
``hlo_parsed``; there is no ``xla_cost``.  ``memory``: ``argument_bytes``
(the rank's shards of the step's inputs, the decode position's int32
scalar included), ``output_bytes`` (the rank's pieces of the outputs),
``temp_bytes`` (the peak of live bytes over the step less the
arguments; outputs alive at the end included) and ``peak_bytes``
(argument + temp).  ``tp_whole``: the sub-block kinds the step computes
whole on every "model" rank, where it has no tensor-parallel form
("slstm_recurrence": the sLSTM's recurrence where "model" does not
divide its heads; "mamba", "mlstm", "slstm", "mla", "attn", "cross",
"ffn" where "model" splits none of their weights or its blocks' chunks
do not divide the rows).  ``--moe-quant`` /
``--moe-local-cf`` configure the expert-parallel dispatch the mesh
steps run (``models/moe_sharded.py``), as the JAX CLI's do.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.analysis.counters import counting, tensor_bytes
from repro_torch.configs import RunConfig, cells, get_config, get_shape
from repro_torch.device import resolve_device
from repro_torch.launch import steps as st
from repro_torch.tree import leaves, map_tree

WORLD = 512                  # ranks of the fake world: the multi-pod mesh
SKIP_REASON = "full attention; no sub-quadratic path"


def fake_world(world_size: int = WORLD) -> None:
    """Makes torch's fake process group of ``world_size`` ranks this
    process's default group, as rank 0 (no-op when one exists).  Raises
    when this torch has no fake backend or ``FakeStore``."""
    if dist.is_initialized():
        return
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            "the dry run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg.FakeStore)") from e
    if "fake" not in dist.Backend.backend_list:
        raise RuntimeError("this torch registers no 'fake' process-group "
                           "backend: the dry run cannot build its mesh")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _place(mesh, sizes, tree, shardings, device):
    """A tree of DTensors of fake tensors: each leaf of ``tree`` (meta
    tensors) placed as its ``NamedSharding`` says, the rank's piece made
    on ``device`` (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor

    def one(t, ns):
        pl = ns.placements
        local = list(t.shape)
        for size, p in zip(sizes, pl):
            if p.is_shard():
                local[p.dim] //= size
        x = torch.empty(local, dtype=t.dtype, device=device)
        return DTensor.from_local(x, mesh, pl, run_check=False,
                                  shape=tuple(t.shape), stride=t.stride())
    return map_tree(one, tree, shardings)


def _names(mesh_shape) -> tuple:
    return ("pod", "data", "model") if len(mesh_shape) == 3 \
        else ("data", "model")


def step_inputs(cfg, shape, mesh, device, mode):
    """(the positional arguments of ``shape``'s mesh step, their bytes on
    this rank): parameters (bf16), and the optimizer state and batch
    (train), the batch (prefill), or the caches, token and position
    (decode), as DTensors of fake tensors of ``mode`` (a
    ``FakeTensorMode``) on ``device``, placed by the sharding rules.  The
    decode position is a host int; its bytes count as the JAX step's
    int32 scalar."""
    from repro_torch import sharding as sh
    from repro_torch.sharding_ctx import abstract_mesh

    sizes = tuple(mesh.size(i) for i in range(mesh.ndim))
    # the rules read only the axes' names and sizes: on the abstract
    # twin they read no rank-layout tensor (which a fake mode converts)
    rules = abstract_mesh(sizes, mesh.mesh_dim_names)
    pstruct = st.params_struct(cfg, st.BF16)
    specs = st.input_specs(cfg, shape, st.BF16)
    plan = [(pstruct, sh.param_shardings(pstruct, rules))]
    if shape.kind == "train":
        ostruct = st.opt_struct(cfg, pstruct)
        plan += [(ostruct, sh.opt_shardings(ostruct, rules)),
                 (specs, sh.batch_shardings(specs, rules))]
    elif shape.kind == "prefill":
        plan.append((specs, sh.batch_shardings(specs, rules)))
    else:
        caches, token = specs["caches"], {"t": specs["token"]}
        plan += [(caches, sh.cache_shardings(caches, rules)),
                 (token, sh.batch_shardings(token, rules))]
    with mode:
        args = [_place(mesh, sizes, t, s, device) for t, s in plan]
    nbytes = tensor_bytes(x for a in args for x in leaves(a))
    if shape.kind == "decode":
        args = args[:2] + [args[2]["t"], shape.seq_len - 1]
        nbytes += specs["pos"].element_size()
    return args, nbytes


_STEPS = {"train": st.make_mesh_train_step,
          "prefill": st.make_mesh_prefill_step,
          "decode": st.make_mesh_decode_step}


def dry_run(cfg, shape, run, mesh_shape=(16, 16), device=None) -> dict:
    """Traces ``run``'s step for ``shape`` on a mesh of ``mesh_shape``
    (("data", "model"), or ("pod", "data", "model") for three axes) over
    the fake world (made here when the process has none) and returns the
    cell's result dict.  ``cfg`` may be cut in depth; ``device``: where
    the fake tensors and the mesh live, the card unless told
    otherwise."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.sharding_ctx import make_mesh

    dev = resolve_device(device)
    fake_world()
    mesh = make_mesh(tuple(mesh_shape), _names(mesh_shape), dev.type)
    n_chips = mesh.size()
    step = _STEPS[shape.kind](cfg, run, mesh)
    # the mesh's rank layout is a real tensor that DTensor reads for
    # shapes: let the fake mode take it in (no data is read anywhere)
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    args, argument_bytes = step_inputs(cfg, shape, mesh, dev, mode)
    with mode:
        arg_leaves = [x for a in args for x in leaves(a)
                      if isinstance(x, torch.Tensor)]
        t0 = time.perf_counter()
        with counting(external=arg_leaves, device_type=dev.type) as c:
            out = step(*args)
        trace_s = time.perf_counter() - t0
        output_bytes = tensor_bytes(leaves(out))
    temp_bytes = c.peak_bytes - c.external_bytes
    roof = rl.compute_roofline(cfg, shape, n_chips, c.dot_flops,
                               c.collective_bytes)
    return {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "x".join(map(str, mesh_shape)), "n_chips": n_chips,
        "trace_s": round(trace_s, 1),
        "memory": {"argument_bytes": argument_bytes,
                   "output_bytes": output_bytes,
                   "temp_bytes": temp_bytes,
                   "peak_bytes": argument_bytes + temp_bytes},
        "counted": {"dot_flops": c.dot_flops,
                    "collective_bytes": c.collective_bytes,
                    "collective_bytes_by_kind":
                        dict(c.collective_bytes_by_kind)},
        "roofline": roof.to_dict(),
        "state_bytes_per_dev": rl.state_bytes(cfg, shape, n_chips),
        "tp_whole": sorted(step.whole),
        "status": "ok",
    }


def run_cell(arch, shape_name, *, multi_pod=False, run_overrides=None,
             moe_overrides=None, device=None, layers=None):
    """Dry-runs one production cell on (16, 16), or (2, 16, 16) with
    ``multi_pod``; returns its result dict (JSON-serializable).
    ``layers``: the depth cut to that many layers (the cell's arch is
    then recorded as ``ARCH@<layers>L``); a ``grad_accum`` or
    ``seq_len`` in ``run_overrides`` replaces the shape's (recorded as
    ``SHAPE@ga<n>`` / ``SHAPE@S<n>``)."""
    cfg = get_config(arch)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    if moe_overrides and cfg.moe is not None:
        # e.g. {"dispatch_quant": "int8"} or {"local_capacity_factor": 1.0}
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))
    shape = get_shape(shape_name)
    run_overrides = dict(run_overrides or {})
    name = shape_name
    for key, tag in (("grad_accum", "ga"), ("seq_len", "S")):
        if key in run_overrides:
            n = run_overrides.pop(key)
            shape = dataclasses.replace(shape, **{key: n})
            name += f"@{tag}{n}"
    run = RunConfig(model=cfg, shape=shape)
    if run_overrides:
        run = run.replace(**run_overrides)
    r = dry_run(cfg, shape, run, (2, 16, 16) if multi_pod else (16, 16),
                device)
    r["arch"] = f"{arch}@{layers}L" if layers else arch
    r["shape"] = name
    return r


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", choices=("no", "yes", "both"),
                    default="no")
    ap.add_argument("--out", default=None, help="artifact dir for JSON")
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--q-chunk", type=int, default=None)
    ap.add_argument("--moe-quant", default=None, choices=("none", "int8"))
    ap.add_argument("--moe-local-cf", type=float, default=None)
    ap.add_argument("--grad-accum", type=int, default=None)
    ap.add_argument("--seq-len", type=int, default=None,
                    help="the cell's sequence length in place of the "
                         "shape's (the JSON file and the cell's shape say "
                         "so)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (a whole "
                         "number of super-blocks; the JSON file and the "
                         "cell's arch say so)")
    ap.add_argument("--device", default=None,
                    help="where the fake tensors and the mesh live: the "
                         "card unless told otherwise (cpu)")
    args = ap.parse_args(argv)
    moe_overrides = {}
    if args.moe_quant:
        moe_overrides["dispatch_quant"] = args.moe_quant
    if args.moe_local_cf:
        moe_overrides["local_capacity_factor"] = args.moe_local_cf

    overrides = {}
    if args.remat_policy:
        overrides["remat_policy"] = args.remat_policy
    if args.q_chunk:
        overrides["attention_q_chunk"] = args.q_chunk
    if args.grad_accum:
        overrides["grad_accum"] = args.grad_accum
    if args.seq_len:
        overrides["seq_len"] = args.seq_len

    if args.all:
        todo = list(cells())
    else:
        cfgc = get_config(args.arch)
        todo = [(args.arch, args.shape,
                 args.shape == "long_500k" and not cfgc.is_subquadratic)]
    pods = {"no": [False], "yes": [True], "both": [False, True]}[
        args.multi_pod]

    results, failures = [], 0
    for arch, shape_name, skip in todo:
        for mp in pods:
            mesh = "2x16x16" if mp else "16x16"
            tag = f"{arch}/{shape_name}/{mesh}"
            if skip:
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": mesh, "status": "skipped",
                                "reason": SKIP_REASON})
                print(f"[SKIP] {tag}")
                continue
            try:
                r = run_cell(arch, shape_name, multi_pod=mp,
                             run_overrides=overrides or None,
                             moe_overrides=moe_overrides or None,
                             device=args.device, layers=args.layers)
                results.append(r)
                rf, m = r["roofline"], r["memory"]
                print(f"[OK] {tag}  trace={r['trace_s']:.1f}s "
                      f"arg/dev={m['argument_bytes']:.3e}B "
                      f"temp/dev={m['temp_bytes']:.3e}B "
                      f"peak/dev={m['peak_bytes']:.3e}B "
                      f"dotF/dev={rf['hlo_flops_device']:.3e} "
                      f"coll/dev={r['counted']['collective_bytes']:.3e}B "
                      f"useful={rf['useful_ratio']:.3f} "
                      f"bound={rf['bottleneck']} "
                      f"whole={','.join(r['tp_whole']) or '-'} "
                      f"terms(c/m/x)=({rf['compute_s']:.4f}/"
                      f"{rf['memory_s']:.4f}/{rf['collective_s']:.4f})s")
            except Exception as e:  # noqa: BLE001 — record, keep sweeping
                failures += 1
                results.append({"arch": arch, "shape": shape_name,
                                "mesh": mesh, "status": "error",
                                "error": repr(e)})
                print(f"[FAIL] {tag}: {e}")
                traceback.print_exc(limit=4)
            sys.stdout.flush()

    if args.out:
        import pathlib
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        suffix = (args.arch or "all") + "_" + (args.shape or "all")
        cut = f"_{args.layers}L" if args.layers else ""
        cut += f"_ga{args.grad_accum}" if args.grad_accum else ""
        cut += f"_S{args.seq_len}" if args.seq_len else ""
        path = out / f"dryrun_{suffix}_{args.multi_pod}{cut}.json"
        path.write_text(json.dumps(results, indent=1))
        print(f"wrote {path}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
