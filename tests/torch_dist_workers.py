"""Rank programs of the port's distributed CPU tests.

    PYTHONPATH=src python tests/torch_dist_workers.py CASE INPUTS.npz OUT_DIR

spawns 4 ranks on the CPU (gloo, a ``file://`` store in OUT_DIR, so no
port is taken), runs CASE on each and writes OUT_DIR/rank<r>.npz.  It
imports no JAX: ``tests/test_torch_distributed.py`` and
``tests/test_torch_elastic.py`` hold what it writes to the JAX package.

CASE "moe": every case of ``moe_cases`` — ``apply_moe_sharded`` on the
(2, 2) ("data", "model") and (2, 1, 2) ("pod", "data", "model") meshes
(outputs, aux, drops at both capacity stages, gradients), then
``compressed_psum_mean`` over a ("pod",) mesh of 4 ranks for 3 steps.
CASE "elastic": ``tests/test_system.py``'s 2 pods -> preemption -> 1 pod
scenario through ``ElasticRunner`` and ``make_mesh_train_step``.
CASE "steps": ``make_mesh_prefill_step`` and ``make_mesh_decode_step`` on
both meshes against the plain steps on the global batch (each rank
computes both; the largest gaps and the placements go to the npz).
CASE "example": ``examples/elastic_cloud_train_torch.py``'s ``main`` on
the world of 4 (pods (2, 1)), fed the JAX tree of INPUTS' ``param/...``
leaves and its ``batch/<step>/...`` batches; its lines, losses and
rebuild count go to the npz.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "p2d1m2": ((2, 1, 2), ("pod", "data", "model"))}
FFNS = ("swiglu", "gelu")
# (name, capacity_factor, local_capacity_factor, dispatch_quant, grads)
VARIANTS = (("nodrop", 8.0, 1.25, "none", True),
            ("drops", 1.0, 1.0, "none", False),
            ("int8", 8.0, 1.25, "int8", False))
MOE = dict(num_experts=8, top_k=2, d_ff_expert=32)
D_MODEL = 16
X_SHAPE = (4, 16, D_MODEL)       # global (B, S, D); B split over pod x data
ELASTIC_BATCH = 4                # global batch of the elastic run
ELASTIC_STEPS = 6                # steps before and after the preemption
# the mesh prefill / decode steps: reduced archs with attention KV caches,
# Mamba states (and MoE: a capacity factor no rank's rows overflow, so the
# naive dispatch keeps every token on a rank as on the whole batch) and
# mLSTM / sLSTM states
STEP_ARCHS = ("yi-9b", "jamba-v0.1-52b", "xlstm-350m")
STEP_BATCH, STEP_SEQ, DECODE_STEPS = 4, 16, 3


def moe_cases():
    """(key, mesh key, ffn_type, variant) for every MoE case."""
    return [(f"{m}-{f}-{v[0]}", m, f, v)
            for m in MESHES for f in FFNS for v in VARIANTS]


def _moe_rank(inp, out):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch import sharding as sh
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import moe_sharded as ms
    from repro_torch.sharding_ctx import make_mesh, use_mesh

    meshes = {k: make_mesh(s, n, "cpu") for k, (s, n) in MESHES.items()}
    # count the drops of both capacity stages through the one helper that
    # places slots: the send buckets (no ``valid``), the local buffers
    drops = {}
    positions = moe_mod._positions

    def counting(ids, n, cap, valid=None):
        pos, keep = positions(ids, n, cap, valid)
        stage = "send" if valid is None else "local"
        lost = ~keep if valid is None else valid & ~keep
        drops[stage] = drops.get(stage, 0) + int(lost.sum())
        drops[f"{stage}_keep"] = keep.numpy().copy()
        return pos, keep
    moe_mod._positions = counting

    for key, mkey, ffn, (_, cf, lcf, quant, grads) in moe_cases():
        mesh = meshes[mkey]
        names = mesh.mesh_dim_names
        coord = dict(zip(names, mesh.get_coordinate()))
        shape = dict(zip(names, mesh.mesh.shape))
        n_batch = shape.get("pod", 1) * shape["data"]
        b_idx = coord.get("pod", 0) * shape["data"] + coord["data"]
        moe = MoEConfig(**MOE, capacity_factor=cf,
                        local_capacity_factor=lcf, dispatch_quant=quant)
        p = {k: torch.from_numpy(inp[f"{ffn}/{k}"]).requires_grad_(grads)
             for k in ("router", "wi", "wg", "wo") if f"{ffn}/{k}" in inp}
        rows = X_SHAPE[0] // n_batch
        x = torch.from_numpy(inp["x"][b_idx * rows:(b_idx + 1) * rows]
                             ).requires_grad_(grads)
        drops.clear()
        with use_mesh(mesh):           # through the model's own entry
            y, aux = moe_mod.apply_moe(p, x, moe, ffn)
        res = {"y": y.detach().numpy(), "aux": aux.detach().numpy(),
               "b_idx": np.int64(b_idx), "model": np.int64(coord["model"]),
               "send_drops": np.int64(drops["send"]),
               "local_drops": np.int64(drops["local"]),
               "send_keep": drops["send_keep"],
               "local_keep": drops["local_keep"]}
        if grads:
            y.sum().backward()
            res["gx"] = x.grad.numpy()
            for k, v in p.items():
                res[f"g{k}"] = v.grad.numpy()
        out.update({f"{key}/{k}": v for k, v in res.items()})
        if key.endswith("nodrop"):
            # the same weights as DTensors placed by the rules
            dp = {k: distribute_tensor(
                v.detach(), mesh,
                sh.param_shardings({"ffn": {k: v}}, mesh)["ffn"][k]
                .placements) for k, v in p.items()}
            with torch.no_grad():
                yd, _ = ms.apply_moe_sharded(dp, x.detach(), moe, ffn, mesh)
            out[f"{key}/y_dtensor"] = yd.numpy()
    moe_mod._positions = positions

    from repro_torch.optim.compress import compressed_psum_mean
    pod = make_mesh((WORLD,), ("pod",), "cpu")
    r = dist.get_rank()
    resid = None
    for s in range(inp["grads"].shape[0]):
        m, resid = compressed_psum_mean(torch.from_numpy(inp["grads"][s, r]),
                                        pod.get_group("pod"), resid)
        out[f"compress/mean{s}"] = m.numpy()
        out[f"compress/resid{s}"] = resid.numpy()


def _elastic_rank(inp, out, work):
    from repro_torch.checkpoint import Checkpointer, restore
    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.core.elastic import ElasticRunner, PodPool
    from repro_torch.data import make_batch
    from repro_torch.launch.steps import make_mesh_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.tree import flatten, map_tree

    cfg = get_reduced("yi-9b")
    shape = ShapeConfig("smoke", seq_len=32, global_batch=ELASTIC_BATCH,
                        kind="train")
    run = RunConfig(model=cfg, shape=shape, compute_dtype="float32",
                    remat=False)
    params = init_params(cfg, 0, device="cpu")
    opt = adamw_init(params)
    ck = Checkpointer(os.path.join(work, "ckpt"), keep=2)
    runner = ElasticRunner(lambda mesh: make_mesh_train_step(cfg, run, mesh),
                           params, opt, pod_shape=(2, 1), checkpointer=ck,
                           device_type="cpu")
    pool = PodPool()
    pool.on_change(lambda n: runner.ensure(max(n, 1)))
    pool.join("pod-a")
    pool.join("pod-b")
    assert runner.n_pods == 2, runner.n_pods
    losses, gnorms, nones = [], [], 0
    for step in range(2 * ELASTIC_STEPS):
        if step == ELASTIC_STEPS:
            runner.checkpoint(step)
            ck.wait()
            pool.preemption_notice("pod-b")
            runner.handle_preemption(step)
            # the state the checkpoint must hold, gathered over the mesh
            held = {"params": map_tree(lambda t: t.full_tensor(),
                                       runner.params),
                    "opt": map_tree(lambda t: t.full_tensor(), runner.opt)}
            if dist.get_rank() == 0:
                _, back = restore(os.path.join(work, "ckpt"), held,
                                  step=step)
                err = max(float((a - b).abs().max())
                          for name in held
                          for (_, a), (_, b) in zip(flatten(held[name]),
                                                    flatten(back[name])))
                out["restore_err"] = np.float64(err)
            pool.leave("pod-b")                   # spot reclaim
            assert runner.n_pods == 1
        m = runner.step(make_batch(cfg, shape, step, device="cpu"))
        if m is None:
            nones += 1
        else:
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
    if runner.params is not None:
        # the final state, gathered over the mesh: held leaf for leaf to
        # the single-process step's
        for name in ("params", "opt"):
            full = map_tree(lambda t: t.full_tensor(), getattr(runner, name))
            if dist.get_rank() == 0:
                for path, t in flatten(full):
                    out["final/" + "/".join(map(str, (name,) + path))] = \
                        t.numpy()
    out["losses"] = np.array(losses)
    out["grad_norms"] = np.array(gnorms)
    out["nones"] = np.int64(nones)
    out["rebuilds"] = np.int64(runner.rebuilds)
    out["rebuild_s"] = np.float64(runner.rebuild_s)


def _steps_rank(out):
    import dataclasses

    from torch.distributed.tensor import distribute_tensor

    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.launch.steps import (make_decode_step,
                                          make_mesh_decode_step,
                                          make_mesh_prefill_step,
                                          make_prefill_step)
    from repro_torch.models import init_cache, init_params
    from repro_torch.sharding_ctx import make_mesh
    from repro_torch.tree import flatten, map_tree

    def gap(got, want):
        """(max |got - want|, max |want|) over two trees; the padded
        vocabulary's masked logits (-finfo.max in both) left out of the
        scale."""
        pairs = list(zip(flatten(got), flatten(want)))
        assert [p for (p, _), _ in pairs] == [p for _, (p, _) in pairs]
        return (max(float((a.full_tensor() - b).abs().max())
                    for (_, a), (_, b) in pairs),
                max(float(b.abs()[b.abs() < 1e30].max())
                    for _, (_, b) in pairs))

    def same_placements(tree, shardings):
        return all(tuple(d.placements) == tuple(ns.placements)
                   for (_, d), (_, ns) in zip(flatten(tree),
                                              flatten(shardings)))

    for mkey, (mshape, names) in MESHES.items():
        mesh = make_mesh(mshape, names, "cpu")
        for arch in STEP_ARCHS:
            cfg = get_reduced(arch)
            if cfg.moe is not None:
                cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                    cfg.moe, capacity_factor=8.0))
            shape = ShapeConfig("steps", STEP_SEQ, STEP_BATCH, "prefill")
            run = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
            g = torch.Generator().manual_seed(7)
            params = init_params(cfg, 0, device="cpu")
            dparams = map_tree(
                lambda t, ns: distribute_tensor(t, mesh, ns.placements),
                params, sh.param_shardings(params, mesh))
            tokens = torch.randint(0, cfg.vocab_size, (STEP_BATCH, STEP_SEQ),
                                   generator=g, dtype=torch.int32)
            key = f"{mkey}/{arch}"
            with torch.no_grad():
                want_l, want_c = make_prefill_step(cfg, run)(
                    params, {"tokens": tokens})
                got_l, got_c = make_mesh_prefill_step(cfg, run, mesh)(
                    dparams, {"tokens": tokens})
                out[f"{key}/prefill_logits"] = np.array(gap(got_l, want_l))
                out[f"{key}/prefill_caches"] = np.array(gap(got_c, want_c))
                out[f"{key}/prefill_placed"] = np.bool_(same_placements(
                    got_c, sh.cache_shardings(got_c, mesh)))

                caches = map_tree(
                    lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
                    init_cache(cfg, STEP_BATCH, STEP_SEQ, torch.float32,
                               device="cpu"))
                csh = sh.cache_shardings(caches, mesh)
                dcaches = map_tree(
                    lambda t, ns: distribute_tensor(t, mesh, ns.placements),
                    caches, csh)
                plain = make_decode_step(cfg, run)
                step = make_mesh_decode_step(cfg, run, mesh)
                worst = (0.0, 0.0)
                for i in range(DECODE_STEPS):
                    tok = torch.randint(0, cfg.vocab_size, (STEP_BATCH, 1),
                                        generator=g, dtype=torch.int32)
                    want_l, caches = plain(params, caches, tok, 5 + i)
                    got_l, dcaches = step(dparams, dcaches, tok, 5 + i)
                    e = gap(got_l, want_l)
                    worst = (max(worst[0], e[0]), max(worst[1], e[1]))
                out[f"{key}/decode_logits"] = np.array(worst)
                out[f"{key}/decode_caches"] = np.array(gap(dcaches, caches))
                out[f"{key}/decode_placed"] = np.bool_(
                    same_placements(dcaches, csh))


def load_example(name):
    """``examples/<name>.py`` as a module: the examples are scripts, not
    a package."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_rank(inp, out, work):
    from repro_torch.configs import get_reduced
    from repro_torch.models.convert import params_from_jax

    example = load_example("elastic_cloud_train_torch")
    jtree = {}
    for k, v in inp.items():
        if k.startswith("param/"):
            node, keys = jtree, k[len("param/"):].split("/")
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = v
    params = params_from_jax(jtree, get_reduced("yi-9b"), device="cpu")

    def batch_fn(step):
        return {k: inp[f"batch/{step}/{k}"] for k in ("tokens", "targets")}
    got = example.main(params_host=params, batch_fn=batch_fn, device="cpu",
                       ckpt_dir=os.path.join(work, "ckpt"))
    out["lines"] = np.array(got["lines"])
    out["losses"] = np.array(got["losses"])
    out["rebuilds"] = np.int64(got["rebuilds"])


def _rank(rank, case, inputs, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    try:
        inp = dict(np.load(inputs)) if inputs != "-" else {}
        out = {}
        if case == "moe":
            _moe_rank(inp, out)
        elif case == "steps":
            _steps_rank(out)
        elif case == "example":
            _example_rank(inp, out, out_dir)
        else:
            _elastic_rank(inp, out, out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(case, inputs, out_dir):
    store = os.path.join(out_dir, "store")     # a file store starts empty
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_rank, args=(case, inputs, out_dir), nprocs=WORLD, join=True)


if __name__ == "__main__":
    case, inputs, out_dir = sys.argv[1:4]
    os.makedirs(out_dir, exist_ok=True)
    spawn(case, inputs, out_dir)
