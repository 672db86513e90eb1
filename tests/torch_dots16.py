"""Per-device dot FLOPs and collective bytes of a reduced arch's step on
a production-sized mesh ((16, 16) by default).

    PYTHONPATH=src python tests/torch_dots16.py [--mesh 16x16] ARCH \\
        train|prefill|train,prefill B S
    XLA_FLAGS=--xla_force_host_platform_device_count=256 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_dots16.py --jax [--mesh 16x16] \\
        ARCH KIND B S
    XLA_FLAGS=--xla_force_host_platform_device_count=256 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_dots16.py --jax --pin OUT.json

The first form traces the port's mesh step through its dry run (fake
tensors, a fake world of the mesh's ranks); ``--jax`` compiles the JAX
package's jitted step with ``in_shardings`` from its rules on the host
devices and counts the dots and collectives of the compiled program
(``hlo.analyze``).  bf16, remat off.  Prints ``ARCH KIND DOT_FLOPS
COLLECTIVE_BYTES`` for each kind (for the port also the sub-blocks
every "model" rank computes whole), then ``RESULT`` and all of it as
JSON, keyed ``ARCH/KIND``.  ``--pin`` writes
the JAX step's counts of the ``PINNED`` cells at (16, 16), B=32, S=64,
with the JAX version, to OUT.json (``tests/data/jax_dots16.json``, which
``tests/test_torch_tp16_counts.py`` holds the port's dry runs to).
"""
import json
import sys

# the cells whose heads (16, 16)'s "model" does not divide, reduced
PINNED = [("xlstm-350m", "train"), ("xlstm-350m", "prefill"),
          ("minicpm3-4b", "train"), ("minicpm3-4b", "prefill"),
          ("whisper-large-v3", "train"), ("whisper-large-v3", "prefill")]
PIN_MESH, PIN_B, PIN_S = (16, 16), 32, 64


def port(arch, kind, b, s, mesh=(16, 16)):
    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.launch import dryrun as dr
    cfg = get_reduced(arch)
    shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind)
    r = dr.dry_run(cfg, shape, RunConfig(model=cfg, shape=shape,
                                         remat=False), mesh, "cpu")
    return {"dot_flops": r["counted"]["dot_flops"],
            "collective_bytes": r["counted"]["collective_bytes"],
            "tp_whole": r["tp_whole"]}


def jax_step(arch, kind, b, s, mesh=(16, 16)):
    import jax
    import jax.numpy as jnp

    from repro import sharding as sh
    from repro.analysis import hlo
    from repro.configs import RunConfig, ShapeConfig, get_reduced
    from repro.launch import steps as st
    from repro.sharding_ctx import make_mesh, use_mesh
    jmesh = make_mesh(tuple(mesh), ("data", "model"))
    with use_mesh(jmesh):
        cfg = get_reduced(arch)
        shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind)
        run = RunConfig(model=cfg, shape=shape, remat=False)
        ps = st.params_struct(cfg, jnp.bfloat16)
        specs = st.input_specs(cfg, shape)
        psh = sh.param_shardings(ps, jmesh)
        bsh = sh.batch_shardings(specs, jmesh)
        if kind == "prefill":
            fn = jax.jit(st.make_prefill_step(cfg, run),
                         in_shardings=(psh, bsh))
            args = (ps, specs)
        else:
            opt = st.opt_struct(cfg, ps)
            fn = jax.jit(st.make_train_step(cfg, run), in_shardings=(
                psh, sh.opt_shardings(opt, jmesh), bsh))
            args = (ps, opt, specs)
        text = fn.lower(*args).compile().as_text()
    a = hlo.analyze(text)
    return {"dot_flops": a["dot_flops"],
            "collective_bytes": a["collective_bytes"]}


def pin(path):
    import jax
    cells = {f"{arch}/{kind}": jax_step(arch, kind, PIN_B, PIN_S, PIN_MESH)
             for arch, kind in PINNED}
    with open(path, "w") as f:
        json.dump({"source": "python tests/torch_dots16.py --jax --pin",
                   "jax": jax.__version__, "mesh": list(PIN_MESH),
                   "global_batch": PIN_B, "seq_len": PIN_S,
                   "dtype": "bfloat16", "remat": False, "cells": cells},
                  f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    argv = sys.argv[1:]
    use_jax = "--jax" in argv
    argv = [a for a in argv if a != "--jax"]
    if "--pin" in argv:
        pin(argv[argv.index("--pin") + 1])
        sys.exit(0)
    mesh = (16, 16)
    if "--mesh" in argv:
        i = argv.index("--mesh")
        mesh = tuple(int(n) for n in argv[i + 1].split("x"))
        del argv[i:i + 2]
    arch, kinds, b, s = argv[-4:]
    result = {}
    for kind in kinds.split(","):
        out = (jax_step if use_jax else port)(arch, kind, int(b), int(s),
                                               mesh)
        print(arch, kind, out["dot_flops"], out["collective_bytes"],
              *([out["tp_whole"]] if "tp_whole" in out else []))
        result[f"{arch}/{kind}"] = out
    print("RESULT " + json.dumps(result))
