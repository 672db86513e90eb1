"""Rank programs of ``tests/test_torch_tp.py``: the mesh steps computing
tensor-parallel over "model" on 4 gloo ranks.

    PYTHONPATH=src python tests/torch_tp_workers.py INPUTS.npz OUT_DIR

spawns 4 ranks on the CPU (gloo, a ``file://`` store in OUT_DIR), runs
every case on each and writes OUT_DIR/rank<r>.npz.  It imports no JAX:
the test file holds what it writes to the JAX package.

  * "train": for each mesh of ``MESHES`` and each arch of
    ``TRAIN_ARCHS``, ``STEPS`` f32 steps of ``make_mesh_train_step`` on
    the weights and batches of INPUTS (JAX layout), and the port's plain
    ``make_train_step`` on the same global batches (rank 0): the losses,
    grad norms and the final parameters and AdamW state, gathered;
  * "steps": ``make_mesh_prefill_step`` / ``make_mesh_decode_step`` of
    the archs in ``STEP_ARCHS`` against the plain steps on the global
    batch (the largest gaps, the placements, the sub-blocks computed
    whole);
  * "hooks": the (2, 2) mesh prefill of the archs in ``HOOK_ARCHS``
    with ``attention_impl="pallas"`` against ``"reference"``, the
    kernel wrappers counted (on the CPU each takes its plain version):
    flash on the rank's heads, ``moe_gmm`` on ``moe_sharded``'s local
    experts, as many calls as the plain pallas prefill makes;
  * "loss": ``layers.vocab_parallel_loss`` over the "model" ranks of the
    (2, 2) mesh against ``cross_entropy_loss`` on the whole logits, and
    the gradients of both with respect to the logits;
  * "remat": a remat forward's gradient taken outside the mesh context
    against the one taken inside;
  * "trainer": ``Trainer(mesh=...)`` against ``Trainer()`` for
    ``STEPS`` steps, the mesh trainer's npz checkpoint restored by a
    plain trainer.

    PYTHONPATH=src python tests/torch_tp_workers.py --dry OUT.json ARCH...

runs the dry-run cases in this process (``dry``).

    PYTHONPATH=src python tests/torch_tp_workers.py --mixers INPUTS.npz DIR
    PYTHONPATH=src python tests/torch_tp_workers.py --dry-mixers OUT.json

are the programs of ``tests/test_torch_tp_mixers.py``: the 4 ranks'
"train" cases of ``MIXER_TRAIN_ARCHS``, ``UNDIVIDED_ARCHS`` and
``C15_ARCH`` (also fed its batches as DTensors placed by
``batch_shardings``, "c15"), the "steps" cases of ``MIXER_STEP_ARCHS``
and ``UNDIVIDED_ARCHS``, and unit checks of ``tp.halves`` and
``tp.slice_of``; and the (2, 2) dot FLOPs of
``FLOPS_ARCHS`` (``dry_mixers``).
"""
import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4
MESHES = {"d2m2": ((2, 2), ("data", "model")),
          "p2d1m2": ((2, 1, 2), ("pod", "data", "model"))}
# "yi-9b-mqa": reduced yi-9b with one kv head, which "model" cannot
# split: each rank's q heads select the kv head they read (GQA selection)
TRAIN_ARCHS = ("yi-9b", "minitron-8b", "whisper-large-v3", "internvl2-2b",
               "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "yi-9b-mqa")
STEP_ARCHS = ("qwen3-moe-30b-a3b", "whisper-large-v3", "internvl2-2b",
              "minicpm3-4b", "yi-9b-mqa")
MQA = "-mqa"
# "...-1h": one head (and one kv head), which "model" cannot split: the
# mLSTM, the sLSTM and MLA run whole on every "model" rank
ONE_HEAD = "-1h"
HOOK_ARCHS = ("yi-9b", "qwen3-moe-30b-a3b")
# the mixers that the mesh steps split over "model" like the reference
# (``tests/test_torch_tp_mixers.py``): train parity, prefill / decode
MIXER_TRAIN_ARCHS = ("xlstm-350m", "minicpm3-4b", "kimi-k2-1t-a32b")
MIXER_STEP_ARCHS = ("jamba-v0.1-52b", "xlstm-350m")
# their undivided-heads forms, against the plain steps only
UNDIVIDED_ARCHS = ("xlstm-350m-1h", "minicpm3-4b-1h")
C15_ARCH = "qwen3-moe-30b-a3b"
# the (2, 2) dot-FLOP cells (bf16, remat off): archs, and the (global
# batch, seq_len) of each kind
FLOPS_ARCHS = ("jamba-v0.1-52b", "xlstm-350m", "minicpm3-4b",
               "kimi-k2-1t-a32b")
FLOPS_SIZES = {"train": (8, 128), "prefill": (8, 64), "decode": (8, 64)}
BATCH, SEQ, ACCUM, STEPS = 8, 16, 2, 3
STEP_BATCH, STEP_SEQ, DECODE_STEPS = 4, 16, 3
LOSS_SHAPE, LOSS_VOCAB = (2, 8, 64), 50   # (B, S, padded vocab), vocab


def config(arch):
    """The reduced config of ``arch`` (``MQA`` appended: one kv head);
    an MoE's capacity factor 8, so that no rank's dispatch drops a token
    (every path keeps all)."""
    from repro_torch.configs import get_reduced
    cfg = get_reduced(arch.removesuffix(MQA).removesuffix(ONE_HEAD))
    if arch.endswith(MQA):
        cfg = dataclasses.replace(cfg, num_kv_heads=1)
    if arch.endswith(ONE_HEAD):
        cfg = dataclasses.replace(cfg, num_heads=1, num_kv_heads=1)
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=8.0))
    return cfg


def batch_arrays(cfg, rng, b, s):
    """A training batch of numpy arrays (the VLM's text shortened so that
    its patches and tokens fill ``s``)."""
    st = s - (cfg.frontend.num_patches if cfg.frontend is not None else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, st)).astype(
               np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (b, st)).astype(
               np.int32)}
    if cfg.is_encdec:
        out["enc_embeds"] = rng.standard_normal(
            (b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend is not None:
        out["patch_embeds"] = rng.standard_normal(
            (b, cfg.frontend.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _flat(prefix, tree):
    from repro_torch.models.convert import params_to_jax
    from repro_torch.tree import flatten
    return {prefix + "/".join(map(str, p)): a
            for p, a in flatten(params_to_jax(tree))}


def _distribute(tree, shardings, mesh):
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.tree import map_tree
    return map_tree(lambda t, ns: distribute_tensor(t.clone(), mesh,
                                                    ns.placements),
                    tree, shardings)


def _full(tree):
    from repro_torch.tree import map_tree
    return map_tree(lambda t: t.full_tensor().detach(), tree)


def _train(inp, out, meshes, archs=TRAIN_ARCHS, batch_fn=None,
           prefix="train"):
    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch import steps as st
    from repro_torch.models.convert import params_from_jax
    from repro_torch.optim import adamw_init

    rank = dist.get_rank()
    for mkey, mesh in meshes.items():
        for arch in archs:
            cfg = config(arch)
            shape = ShapeConfig("tp", SEQ, BATCH, "train", grad_accum=ACCUM)
            run = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
            jtree = {}
            for k, v in inp.items():
                if k.startswith(f"{arch}/param/"):
                    node, path = jtree, k[len(f"{arch}/param/"):].split("/")
                    for p in path[:-1]:
                        node = node.setdefault(p, {})
                    node[path[-1]] = v
            params = params_from_jax(jtree, cfg, device="cpu")
            opt = adamw_init(params)
            dp = _distribute(params, sh.param_shardings(params, mesh), mesh)
            do = _distribute(opt, sh.opt_shardings(opt, mesh), mesh)
            step = st.make_mesh_train_step(cfg, run, mesh)
            plain = st.make_train_step(cfg, run)
            key = f"{prefix}/{mkey}/{arch}"
            m_mesh, m_plain = [], []
            for i in range(STEPS):
                batch = {k.split("/")[-1]: torch.from_numpy(v)
                         for k, v in inp.items()
                         if k.startswith(f"{arch}/step{i}/")}
                _, _, m = step(dp, do, batch_fn(batch, mesh) if batch_fn
                               else batch)
                m_mesh.append((float(m["loss"]), float(m["grad_norm"])))
                if rank == 0:
                    _, _, m = plain(params, opt, batch)
                    m_plain.append((float(m["loss"]), float(m["grad_norm"])))
            out[f"{key}/metrics"] = np.array(m_mesh)
            out[f"{key}/whole"] = np.array(sorted(step.whole), dtype=str)
            fp, fo = _full(dp), _full(do)
            if rank == 0:
                out[f"{key}/plain_metrics"] = np.array(m_plain)
                out.update(_flat(f"{key}/params/", fp))
                out.update(_flat(f"{key}/mu/", fo["mu"]))
                out.update(_flat(f"{key}/nu/", fo["nu"]))
                out[f"{key}/step"] = fo["step"].numpy()
                out.update(_flat(f"{key}/plain_params/", params))
                out.update(_flat(f"{key}/plain_mu/", opt["mu"]))
                out.update(_flat(f"{key}/plain_nu/", opt["nu"]))


def _steps(out, meshes, archs=STEP_ARCHS):
    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch.steps import (make_decode_step,
                                          make_mesh_decode_step,
                                          make_mesh_prefill_step,
                                          make_prefill_step)
    from repro_torch.models import init_cache, init_params
    from repro_torch.tree import flatten, map_tree

    def gap(got, want):
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

    for mkey, mesh in meshes.items():
        for arch in archs:
            cfg = config(arch)
            shape = ShapeConfig("steps", STEP_SEQ, STEP_BATCH, "prefill")
            run = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
            rng = np.random.default_rng(7)
            params = init_params(cfg, 0, device="cpu")
            dparams = _distribute(params, sh.param_shardings(params, mesh),
                                  mesh)
            batch = {k: torch.from_numpy(v) for k, v in batch_arrays(
                cfg, rng, STEP_BATCH, STEP_SEQ).items() if k != "targets"}
            key = f"steps/{mkey}/{arch}"
            with torch.no_grad():
                want_l, want_c = make_prefill_step(cfg, run)(params, batch)
                pre = make_mesh_prefill_step(cfg, run, mesh)
                got_l, got_c = pre(dparams, batch)
                out[f"{key}/prefill_logits"] = np.array(gap(got_l, want_l))
                out[f"{key}/prefill_caches"] = np.array(gap(got_c, want_c))
                out[f"{key}/prefill_placed"] = np.bool_(same_placements(
                    got_c, sh.cache_shardings(got_c, mesh)))
                out[f"{key}/prefill_whole"] = np.array(sorted(pre.whole),
                                                       dtype=str)
                g = torch.Generator().manual_seed(11)
                caches = map_tree(
                    lambda t: torch.randn(t.shape, generator=g).to(t.dtype),
                    init_cache(cfg, STEP_BATCH, STEP_SEQ, torch.float32,
                               device="cpu"))
                csh = sh.cache_shardings(caches, mesh)
                dcaches = _distribute(caches, csh, mesh)
                plain = make_decode_step(cfg, run)
                step = make_mesh_decode_step(cfg, run, mesh)
                worst = (0.0, 0.0)
                for i in range(DECODE_STEPS):
                    tok = torch.from_numpy(rng.integers(
                        0, cfg.vocab_size, (STEP_BATCH, 1)).astype(np.int32))
                    want_l, caches = plain(params, caches, tok, 5 + i)
                    got_l, dcaches = step(dparams, dcaches, tok, 5 + i)
                    e = gap(got_l, want_l)
                    worst = (max(worst[0], e[0]), max(worst[1], e[1]))
                out[f"{key}/decode_logits"] = np.array(worst)
                out[f"{key}/decode_caches"] = np.array(gap(dcaches, caches))
                out[f"{key}/decode_placed"] = np.bool_(
                    same_placements(dcaches, csh))


def _hooks(out, mesh):
    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import (make_mesh_prefill_step,
                                          make_prefill_step)
    from repro_torch.models import init_params

    calls = {"flash_attention": 0, "moe_gmm": 0}
    wrapped = {k: getattr(ops, k) for k in calls}

    def counter(name):
        def fn(*a, **k):
            calls[name] += 1
            return wrapped[name](*a, **k)
        return fn
    for arch in HOOK_ARCHS:
        cfg = config(arch)
        shape = ShapeConfig("hooks", STEP_SEQ, STEP_BATCH, "prefill")
        params = init_params(cfg, 0, device="cpu")
        dparams = _distribute(params, sh.param_shardings(params, mesh), mesh)
        batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab_size, (STEP_BATCH, STEP_SEQ)).astype(np.int32))}
        got, n = {}, {}
        for impl in ("pallas", "reference", "plain"):
            run = RunConfig(model=cfg, shape=shape, compute_dtype="float32",
                            attention_impl="reference"
                            if impl == "reference" else "pallas")
            for k in calls:
                calls[k] = 0
            for k in calls:
                setattr(ops, k, counter(k))
            try:
                with torch.no_grad():
                    if impl == "plain":
                        make_prefill_step(cfg, run)(params, batch)
                    else:
                        got[impl] = make_mesh_prefill_step(cfg, run, mesh)(
                            dparams, batch)
            finally:
                for k, fn in wrapped.items():
                    setattr(ops, k, fn)
            n[impl] = [calls[k] for k in sorted(calls)]
        key = f"hooks/{arch}"
        out[f"{key}/logits"] = np.float64(
            (got["pallas"][0].to_local() - got["reference"][0].to_local())
            .abs().max())
        out[f"{key}/scale"] = np.float64(
            got["reference"][0].to_local().abs().max())
        out[f"{key}/caches"] = np.float64(max(
            float((a.to_local() - b.to_local()).abs().max())
            for a, b in zip(leaves_of(got["pallas"][1]),
                            leaves_of(got["reference"][1]))))
        out[f"{key}/calls"] = np.array([n[k] for k in
                                        ("pallas", "reference", "plain")])


def leaves_of(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


def _loss(inp, out, mesh):
    from repro_torch.models import tp
    from repro_torch.models.layers import (cross_entropy_loss,
                                           vocab_parallel_loss)
    from repro_torch.sharding_ctx import use_mesh

    logits = torch.from_numpy(inp["loss/logits"])
    targets = torch.from_numpy(inp["loss/targets"])
    whole = logits.clone().requires_grad_(True)
    want = cross_entropy_loss(whole, targets, LOSS_VOCAB)
    want.backward()
    with use_mesh(mesh):
        m, c = tp.model_size(), tp.model_rank()
        n = logits.shape[-1] // m
        mine = logits[..., c * n:(c + 1) * n].clone().requires_grad_(True)
        got = vocab_parallel_loss(mine, targets)
        got.backward()
    out["loss/got"] = got.detach().numpy()
    out["loss/want"] = want.detach().numpy()
    out["loss/grad_gap"] = np.float64(
        (mine.grad - whole.grad[..., c * n:(c + 1) * n]).abs().max())


def _remat_elsewhere(out, mesh):
    """The gradient of a remat forward run under the mesh, taken outside
    it (as the card's autograd engine takes it, on a thread of its own
    where the caller's mesh is not set), against the one taken inside:
    the recompute must re-enter the mesh."""
    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.models import forward_loss, init_params, tp
    from repro_torch.sharding_ctx import use_mesh
    from repro_torch.tree import leaves, map_tree

    cfg = config("yi-9b")
    shape = ShapeConfig("tp", SEQ, BATCH, "train")
    run = RunConfig(model=cfg, shape=shape, compute_dtype="float32",
                    remat=True)
    params = init_params(cfg, 0, device="cpu")
    stored = map_tree(tp.stored, _distribute(
        params, sh.param_shardings(params, mesh), mesh))
    ps = [s_.local for s_ in leaves(stored)]
    for p in ps:
        p.requires_grad_(True)
    rng = np.random.default_rng(5)
    batch = {k: torch.from_numpy(v)[:BATCH // 2] for k, v in
             batch_arrays(cfg, rng, BATCH, SEQ).items()}
    grads = []
    for inside in (True, False):
        with use_mesh(mesh):
            loss, _ = forward_loss(stored, cfg, batch,
                                   compute_dtype=torch.float32, run_cfg=run)
            if inside:
                grads.append(torch.autograd.grad(loss, ps))
        if not inside:
            grads.append(torch.autograd.grad(loss, ps))
    out["remat/gap"] = np.float64(max(float((a - b).abs().max())
                                      for a, b in zip(*grads)))


def _trainer(out, mesh, work):
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.launch.train import Trainer

    cfg = config("yi-9b")
    shape = ShapeConfig("tp", SEQ, BATCH, "train", grad_accum=ACCUM)
    run = RunConfig(model=cfg, shape=shape, compute_dtype="float32")
    ck = os.path.join(work, "trainer_ckpt")
    tm = Trainer(cfg, shape, run, device="cpu", mesh=mesh, ckpt_dir=ck)
    losses = tm.train(STEPS, ckpt_every=STEPS, log_every=0)
    out["trainer/mesh_losses"] = np.array(losses)
    held = tm.trees()
    dist.barrier()
    if dist.get_rank() == 0:
        tp_ = Trainer(cfg, shape, run, device="cpu")
        out["trainer/plain_losses"] = np.array(
            tp_.train(STEPS, log_every=0))
        back = Trainer(cfg, shape, run, device="cpu", ckpt_dir=ck)
        out["trainer/restored_step"] = np.int64(back.step_num)
        out.update(_flat("trainer/held/", held["params"]))
        out.update(_flat("trainer/restored/", back.params))
        out.update(_flat("trainer/plain/", tp_.params))


def _batch_dtensors(batch, mesh):
    """``batch`` as DTensors placed by ``sharding.batch_shardings``."""
    from repro_torch import sharding as sh
    return _distribute(batch, sh.batch_shardings(batch, mesh), mesh)


def _halves(out, mesh):
    """``tp.halves`` on the (2, 2) mesh: each "model" rank's stored
    columns of a column-parallel [x | z] product (B, S, 2 d) -> its
    slice of x and of z, and the gradient of its columns for seeded
    cotangents of x and z."""
    from repro_torch.models import tp
    from repro_torch.sharding_ctx import use_mesh

    g = torch.Generator().manual_seed(13)
    xz = torch.randn(2, 3, 16, generator=g)
    gx, gz = torch.randn(2, 3, 8, generator=g), torch.randn(2, 3, 8,
                                                           generator=g)
    with use_mesh(mesh):
        m, c = tp.model_size(), tp.model_rank()
        mine = xz.chunk(m, -1)[c].clone().requires_grad_(True)
        x, z = tp.halves(mine)
        ((x * gx.chunk(m, -1)[c]).sum()
         + (z * gz.chunk(m, -1)[c]).sum()).backward()
    want_x, want_z = xz.chunk(2, -1)
    out["units/halves"] = np.float64(max(
        float((x - want_x.chunk(m, -1)[c]).abs().max()),
        float((z - want_z.chunk(m, -1)[c]).abs().max())))
    out["units/halves_grad"] = np.float64(float(
        (mine.grad - torch.cat([gx, gz], -1).chunk(m, -1)[c]).abs().max()))


def _shared_slice(out, mesh):
    """``tp.slice_of`` on a leaf the rule splits on another dim than the
    compute's (Mamba's ``A_log``: rows over "data", columns over
    "model"; the compute takes the rank's rows over "model"): the
    gradient of the rank's stored piece for a loss summed over the
    ranks, against the plain gradient; and what ``tp.whole`` then a
    slice would give (it takes the rank's columns of a gradient that
    only the rank's rows hold)."""
    from torch.distributed.tensor import Shard

    from repro_torch.models import tp
    from repro_torch.sharding_ctx import use_mesh

    g = torch.Generator().manual_seed(17)
    w = torch.randn(8, 6, generator=g)
    cot = torch.randn(8, 6, generator=g)
    pl = (Shard(0), Shard(1))
    with use_mesh(mesh):
        v = tp.view()
        d, c = v.coordinate("data"), v.coordinate("model")
        m = v.size("model")
        local = w.chunk(v.size("data"), 0)[d].chunk(m, 1)[c].clone()
        grads = {}
        for how in ("shared", "whole"):
            leaf = local.clone().requires_grad_(True)
            st = tp.Stored(leaf, pl, w.shape)
            rows = tp.slice_of(st, 0) if how == "shared" else \
                tp.whole(st).chunk(m, 0)[c]
            (rows * cot.chunk(m, 0)[c]).sum().backward()
            grads[how] = leaf.grad
    # every rank adds its rows' share: the plain gradient of the sum over
    # the 4 ranks is cot for each of the 2 "data" ranks
    want = (2 * cot).chunk(v.size("data"), 0)[d].chunk(m, 1)[c]
    out["units/shared_slice_grad"] = np.float64(
        float((grads["shared"] - want).abs().max()))
    out["units/whole_slice_grad"] = np.float64(
        float((grads["whole"] - want).abs().max()))


def _mixers(inp, out, meshes):
    """The cases of ``tests/test_torch_tp_mixers.py``."""
    _train(inp, out, meshes,
           MIXER_TRAIN_ARCHS + (C15_ARCH,) + UNDIVIDED_ARCHS)
    _train(inp, out, meshes, (C15_ARCH,), batch_fn=_batch_dtensors,
           prefix="c15")
    _steps(out, meshes, MIXER_STEP_ARCHS + UNDIVIDED_ARCHS)
    _halves(out, meshes["d2m2"])
    _shared_slice(out, meshes["d2m2"])


def _rank(rank, inputs, out_dir, mode="all"):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                            rank=rank, world_size=WORLD)
    try:
        from repro_torch.sharding_ctx import make_mesh
        inp = dict(np.load(inputs))
        meshes = {k: make_mesh(s, n, "cpu") for k, (s, n) in MESHES.items()}
        out = {}
        if mode == "mixers":
            _mixers(inp, out, meshes)
        else:
            _train(inp, out, meshes)
            _steps(out, meshes)
            _hooks(out, meshes["d2m2"])
            _loss(inp, out, meshes["d2m2"])
            _remat_elsewhere(out, meshes["d2m2"])
            _trainer(out, meshes["d2m2"], out_dir)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def spawn(inputs, out_dir, mode="all"):
    store = os.path.join(out_dir, "store")     # a file store starts empty
    if os.path.exists(store):
        os.remove(store)
    mp.spawn(_rank, args=(inputs, out_dir, mode), nprocs=WORLD, join=True)


def dry(path, archs):
    """The port's dry runs on torch's fake process group: the per-device
    train dot FLOPs of each reduced arch on (2, 2) (B=8, S=128, bf16,
    remat off), and yi-9b at full width on (16, 16): train_4k cut to 2
    of its 48 layers, decode_32k at full depth."""
    import json

    from repro_torch.configs import (RunConfig, ShapeConfig, get_config,
                                     get_reduced, get_shape)
    from repro_torch.launch import dryrun as dr

    out = {"flops": {}}
    for arch in archs:
        cfg = get_reduced(arch)
        shape = ShapeConfig("train", seq_len=128, global_batch=8,
                            kind="train")
        r = dr.dry_run(cfg, shape, RunConfig(model=cfg, shape=shape,
                                             remat=False), (2, 2), "cpu")
        out["flops"][arch] = r["counted"]["dot_flops"]
    for kind, name, layers in (("train", "train_4k", 2),
                               ("decode", "decode_32k", None)):
        cfg = get_config("yi-9b")
        if layers:
            cfg = dataclasses.replace(cfg, num_layers=layers)
        shape = get_shape(name)
        r = dr.dry_run(cfg, shape, RunConfig(model=cfg, shape=shape),
                       (16, 16), "cpu")
        out[kind] = {"peak_bytes": r["memory"]["peak_bytes"],
                     "useful_ratio": r["roofline"]["useful_ratio"],
                     "collective_bytes": r["counted"]["collective_bytes"],
                     "tp_whole": r["tp_whole"]}
    with open(path, "w") as f:
        json.dump(out, f)


def dry_mixers(path):
    """The per-device dot FLOPs and the sub-blocks computed whole of the
    port's dry runs of ``FLOPS_ARCHS`` on (2, 2), reduced, bf16, remat
    off: train, prefill and decode at ``FLOPS_SIZES``."""
    import json

    from repro_torch.configs import RunConfig, ShapeConfig, get_reduced
    from repro_torch.launch import dryrun as dr

    out = {}
    for arch in FLOPS_ARCHS:
        cfg = get_reduced(arch)
        for kind, (b, s) in FLOPS_SIZES.items():
            shape = ShapeConfig(kind, seq_len=s, global_batch=b, kind=kind)
            r = dr.dry_run(cfg, shape, RunConfig(model=cfg, shape=shape,
                                                 remat=False), (2, 2), "cpu")
            out[f"{arch}/{kind}"] = {"dot_flops": r["counted"]["dot_flops"],
                                     "tp_whole": r["tp_whole"]}
    with open(path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "--dry":
        dry(sys.argv[2], sys.argv[3:])
    elif sys.argv[1] == "--dry-mixers":
        dry_mixers(sys.argv[2])
    else:
        mode = "all"
        if sys.argv[1] == "--mixers":
            mode, sys.argv = "mixers", sys.argv[1:]
        inputs, out_dir = sys.argv[1:3]
        os.makedirs(out_dir, exist_ok=True)
        spawn(inputs, out_dir, mode)
