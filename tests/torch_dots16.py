"""Per-device dot FLOPs of a reduced arch's step on a (16, 16) mesh.

    PYTHONPATH=src python tests/torch_dots16.py ARCH train|prefill B S
    XLA_FLAGS=--xla_force_host_platform_device_count=256 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_dots16.py --jax ARCH KIND B S

The first form traces the port's mesh step through its dry run (fake
tensors, a fake world of 256 ranks); ``--jax`` compiles the JAX
package's jitted step with ``in_shardings`` from its rules on 256 host
devices and counts the dots of the compiled program (``hlo.analyze``).
bf16, remat off.  Prints ``ARCH KIND DOT_FLOPS`` and, for the port, the
sub-blocks every "model" rank computes whole.  The two counts show how
far the port's split at (16, 16) is from GSPMD's.
"""
import sys


def port(arch, kind, b, s):
    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.launch import dryrun as dr
    cfg = get_reduced(arch)
    shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind)
    r = dr.dry_run(cfg, shape, RunConfig(model=cfg, shape=shape,
                                         remat=False), (16, 16), "cpu")
    print(arch, kind, r["counted"]["dot_flops"], r["tp_whole"])


def jax_step(arch, kind, b, s):
    import jax
    import jax.numpy as jnp

    from repro import sharding as sh
    from repro.analysis import hlo
    from repro.configs import RunConfig, ShapeConfig, get_reduced
    from repro.launch import steps as st
    from repro.sharding_ctx import make_mesh, use_mesh
    mesh = make_mesh((16, 16), ("data", "model"))
    with use_mesh(mesh):
        cfg = get_reduced(arch)
        shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind)
        run = RunConfig(model=cfg, shape=shape, remat=False)
        ps = st.params_struct(cfg, jnp.bfloat16)
        specs = st.input_specs(cfg, shape)
        psh = sh.param_shardings(ps, mesh)
        bsh = sh.batch_shardings(specs, mesh)
        if kind == "prefill":
            fn = jax.jit(st.make_prefill_step(cfg, run),
                         in_shardings=(psh, bsh))
            args = (ps, specs)
        else:
            opt = st.opt_struct(cfg, ps)
            fn = jax.jit(st.make_train_step(cfg, run), in_shardings=(
                psh, sh.opt_shardings(opt, mesh), bsh))
            args = (ps, opt, specs)
        text = fn.lower(*args).compile().as_text()
    print(arch, kind, hlo.analyze(text)["dot_flops"])


if __name__ == "__main__":
    argv = sys.argv[1:]
    run = jax_step if argv[:1] == ["--jax"] else port
    arch, kind, b, s = argv[-4:]
    run(arch, kind, int(b), int(s))
