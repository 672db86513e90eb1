#!/usr/bin/env python3
"""The mesh steps on four ranks with every value compared.

    python3 scripts/tp_mesh_check.py          # 4 cards of one host, NCCL
    python3 scripts/tp_mesh_check.py --cpu    # 4 gloo ranks, reduced archs
    python3 scripts/tp_mesh_check.py --only jamba-v0.1-52b   # one case

Spawns 4 ranks on a (2, 2) ("data", "model") mesh (``tcp://localhost``,
a free port).  Every rank builds the same seeded weights and inputs,
runs the plain step on the global batch as the reference, and the mesh
step on its own shards, tensor-parallel over "model" (``models/tp.py``):

  * yi-9b (4 of 48 layers at full width; kv heads split over "model")
    and qwen3-moe-30b-a3b (8 of 48 layers, ``moe_sharded`` with its
    experts over "data", capacity factor 8 so that no path drops a
    token): ``make_mesh_prefill_step`` (B=2, S=4096) against
    ``make_prefill_step`` with attention_impl "pallas" (flash on the
    rank's heads, ``moe_gmm`` on its local experts; launches counted,
    the counts set to 0 just before) and "reference", in f32 and bf16;
    then 3 ``make_mesh_decode_step`` steps on the prefill's caches (the
    sequence split over "model") against ``make_decode_step``;
  * jamba-v0.1-52b (8 of 32 layers: one super-block of 7 Mamba and 1
    attention layers, 4 MoE), f32 only, B=2 at S=1024: the same prefill
    and decode checks, Mamba split over "model" on ``d_inner`` (flash 1
    and ``moe_gmm`` 12 launches).  Its 13.3 B weights are stored in bf16
    (cast leaf by leaf after the init) and S is cut so that the plain
    step's f32 expert buffers at capacity factor 8 (16 experts of d_ff
    14,336) fit one card beside them;
  * yi-9b: 2 f32 ``make_mesh_train_step`` steps (B=2, S=4096, remat)
    against ``make_train_step``: loss and gradient norm.

Gates: f32 logits and caches within TOL of the plain step's 2-norm, loss
and grad norm within TOL relative, every launch count as expected;
bf16 gaps are reported (the sums run in another order).  An MoE's top-k
routing is discontinuous: a token whose k-th and (k+1)-th router
probabilities differ by less than the f32 rounding of a reordered sum
can take another expert on the mesh, and every value downstream of it
then differs by O(1).  The routing of both paths is recorded
(``moe._router``) and the tokens whose expert sets differ are counted
(``flips``, summed over the ranks that hold distinct rows); a cache is
gated where no MoE layer before it flipped a token, the logits where
none did.  Prints the
cards' names and power limits (``nvidia-smi``), then one JSON line of
rank 0's results, and exits 1 when a gate fails.
"""
from __future__ import annotations

import json
import socket
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

WORLD = 4
TOL = 1e-4
DECODE_STEPS = 3
TRAIN_STEPS = 2
# (arch, layers kept on the card, flash / moe_gmm launches a pallas
# prefill makes on each rank at that depth, compute dtypes, the weights'
# dtype on the card, the sequence length on the card)
CASES = (("yi-9b", 4, {"flash_attention": 4, "moe_gmm": 0},
          ("float32", "bfloat16"), torch.float32, 4096),
         ("qwen3-moe-30b-a3b", 8, {"flash_attention": 8, "moe_gmm": 24},
          ("float32", "bfloat16"), torch.float32, 4096),
         ("jamba-v0.1-52b", 8, {"flash_attention": 1, "moe_gmm": 12},
          ("float32",), torch.bfloat16, 1024))


def rel(got, want) -> float:
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want).clamp(min=1e-30))


class Routes:
    """Records each ``moe._router`` call's top-k experts, per token."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.router, self.calls = moe, moe._router, None

    def __enter__(self):
        self.calls = []

        def router(*a, **k):
            probs, top_p, top_e = self.router(*a, **k)
            self.calls.append(top_e.sort(dim=-1).values)
            return probs, top_p, top_e
        self.moe._router = router
        return self.calls

    def __exit__(self, *exc):
        self.moe._router = self.router


def flips(plain, mesh, B, coord, n) -> list:
    """Per router call: the tokens of this rank's rows (data coordinate
    ``coord`` of ``n``) whose expert set differs between the plain
    path's call (every row) and the mesh path's."""
    out = []
    for p, m in zip(plain, mesh):
        b = B // n
        p = p.reshape(B, -1, p.shape[-1])[coord * b:(coord + 1) * b]
        out.append(int((p.reshape(m.shape) != m).any(dim=-1).sum()))
    return out


def config(arch, layers, cpu):
    from repro_torch.configs import get_config, get_reduced
    cfg = get_reduced(arch) if cpu else replace(get_config(arch),
                                                num_layers=layers)
    if cfg.moe is not None:
        cfg = replace(cfg, moe=replace(cfg.moe, capacity_factor=8.0))
    return cfg


def cast_in_place(tree, dtype) -> None:
    """Each float leaf of ``tree`` (nested dicts and lists) cast to
    ``dtype`` in turn, so that one leaf's copy at a time sits beside the
    originals."""
    for k, v in list(tree.items() if isinstance(tree, dict)
                     else enumerate(tree)):
        if isinstance(v, (dict, list)):
            cast_in_place(v, dtype)
        elif v.is_floating_point():
            tree[k] = v.to(dtype)


def check_arch(arch, layers, expect, dtypes, store, seq, mesh, dev,
               cpu) -> dict:
    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    from repro_torch.launch import steps as st
    from repro_torch.models import init_params

    cfg = config(arch, layers, cpu)
    B, S = (4, 16) if cpu else (2, seq)
    coord = mesh.get_coordinate()[0]            # "data"
    n = mesh.mesh.shape[0]
    if cpu:
        expect = None               # the plain versions count no launch
    params = init_params(cfg, 2021, device=dev)
    if not cpu and store != torch.float32:
        cast_in_place(params, store)
    gen = torch.Generator(device=dev).manual_seed(9)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                        device=dev, dtype=torch.int32)
    new = torch.randint(0, cfg.vocab_size, (DECODE_STEPS, B, 1),
                        generator=gen, device=dev, dtype=torch.int32)
    V = cfg.vocab_size
    out = {}
    for dt in dtypes:
        for impl in ("pallas", "reference"):
            run = RunConfig(model=cfg, shape=ShapeConfig("mesh", S, B,
                                                         "prefill"),
                            compute_dtype=dt, attention_impl=impl)
            with torch.no_grad(), Routes() as want_r:
                want_l, want_c = st.make_prefill_step(cfg, run)(
                    params, {"tokens": tok})
            with torch.no_grad(), Routes() as got_r:
                dp = st.distribute(params, sh.param_shardings(params, mesh),
                                   mesh)
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                ops.reset_launches()
                got_l, got_c = st.make_mesh_prefill_step(cfg, run, mesh)(
                    dp, {"tokens": tok})
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                launches = {k: ops.LAUNCHES[k] for k in
                            ("flash_attention", "moe_gmm")}
            res = {"prefill_logits": rel(got_l.full_tensor()[..., :V],
                                         want_l[..., :V]),
                   "prefill_caches": cache_gaps(got_c, want_c),
                   "prefill_flips": flips(want_r, got_r, B, coord, n),
                   "launches": launches}
            plain, step = (st.make_decode_step(cfg, run),
                           st.make_mesh_decode_step(cfg, run, mesh))
            res["decode_logits"], res["decode_flips"] = [], []
            for i in range(DECODE_STEPS):
                pos = S - DECODE_STEPS + i
                with torch.no_grad(), Routes() as want_r:
                    want_d, want_c = plain(params, want_c, new[i], pos)
                with torch.no_grad(), Routes() as got_r:
                    got_d, got_c = step(dp, got_c, new[i], pos)
                res["decode_logits"].append(rel(
                    got_d.full_tensor()[..., :V], want_d[..., :V]))
                res["decode_flips"].append(flips(want_r, got_r, B, coord, n))
            res["decode_caches"] = cache_gaps(got_c, want_c)
            del dp, got_c, want_c
            res["launches_ok"] = expect is None or launches == (
                expect if impl == "pallas" else {k: 0 for k in expect})
            out[f"{dt}/{impl}"] = res
    sum_flips(out, cfg, dev)
    if arch == "yi-9b":
        out["train"] = check_train(cfg, params, mesh, dev, cpu)
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cache_gaps(got, want) -> list:
    """[(super-block, the gap of its cache leaves)] in order."""
    from repro_torch.tree import flatten
    gaps = {}
    for (path, g), (_, w) in zip(flatten(got), flatten(want)):
        gaps[path[0]] = max(gaps.get(path[0], 0.0), rel(g.full_tensor(), w))
    return sorted(gaps.items())


def sum_flips(out, cfg, dev) -> None:
    """Sums each case's flips over the ranks that hold distinct rows (the
    "data" ranks; the "model" ranks repeat them), then sets its "ok":
    f32 caches of the super-blocks that no flipped MoE layer precedes,
    and logits with no flip before them, within TOL; the launches."""
    per_layer = sum(f == "moe" for _, f in cfg.block_defs)
    for key, res in out.items():
        for name in ("prefill_flips", "decode_flips"):
            t = torch.tensor(res[name], dtype=torch.int64,
                             device=dev).flatten()
            if t.numel():
                dist.all_reduce(t)
                t = t // 2                      # "model" repeats each row
            t = t.cpu()
            res[name] = t.tolist()
        pre = res["prefill_flips"]
        first = next((i // max(per_layer, 1) for i, f in enumerate(pre)
                      if f), None)
        ok = res.pop("launches_ok")
        if key.startswith("float32"):
            ok = ok and all(g <= TOL for j, g in res["prefill_caches"]
                            if first is None or j <= first)
            ok = ok and (first is not None or res["prefill_logits"] <= TOL)
            clean = first is None and not any(res["decode_flips"])
            ok = ok and (not clean or (
                max(res["decode_logits"]) <= TOL
                and all(g <= TOL for _, g in res["decode_caches"])))
        res["first_flip_block"] = first
        res["ok"] = bool(ok)


def check_train(cfg, params, mesh, dev, cpu) -> dict:
    from repro_torch import sharding as sh
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data import make_batch
    from repro_torch.launch import steps as st
    from repro_torch.optim import adamw_init
    from repro_torch.tree import map_tree

    B, S = (4, 16) if cpu else (2, 4096)
    shape = ShapeConfig("mesh", S, B, "train")
    run = RunConfig(model=cfg, shape=shape, compute_dtype="float32",
                    remat=True)
    mine = map_tree(lambda t: t.detach().clone(), params)
    opt = adamw_init(mine)
    dp = st.distribute(mine, sh.param_shardings(mine, mesh), mesh)
    do = st.distribute(opt, sh.opt_shardings(opt, mesh), mesh)
    step, plain = (st.make_mesh_train_step(cfg, run, mesh),
                   st.make_train_step(cfg, run))
    res = {"loss": [], "grad_norm": []}
    for i in range(TRAIN_STEPS):
        batch = make_batch(cfg, shape, i, seed=7, device=dev)
        _, _, got = step(dp, do, batch)
        mine, opt, want = plain(mine, opt, batch)
        for k in res:
            res[k].append(abs(float(got[k]) / float(want[k]) - 1))
    res["ok"] = all(x <= TOL for k in ("loss", "grad_norm") for x in res[k])
    return res


def rank_main(rank, cpu, port, out_path, cases):
    from repro_torch.sharding_ctx import make_mesh
    if cpu:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo" if cpu else "nccl",
                            init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), dev.type)
        t0 = time.perf_counter()
        res = {c[0]: check_arch(*c, mesh, dev, cpu) for c in cases}
        res["s"] = time.perf_counter() - t0
        Path(f"{out_path}.{rank}").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main() -> int:
    import tempfile
    cpu = "--cpu" in sys.argv[1:]
    only = sys.argv[sys.argv.index("--only") + 1] \
        if "--only" in sys.argv[1:] else None
    cases = [c for c in CASES if only in (None, c[0])]
    if not cpu:
        if torch.cuda.device_count() < WORLD:
            print(f"tp_mesh_check: needs {WORLD} cards "
                  f"({torch.cuda.device_count()} visible)", file=sys.stderr)
            return 2
        from repro_torch.kernels import build
        build.library()             # once, before the ranks load it
    with tempfile.TemporaryDirectory() as tmp:
        out = str(Path(tmp) / "rank")
        mp.spawn(rank_main, args=(cpu, free_port(), out, cases),
                 nprocs=WORLD, join=True)
        ranks = [json.loads(Path(f"{out}.{r}").read_text())
                 for r in range(WORLD)]
    ok = all(res[c[0]][key]["ok"] for res in ranks for c in cases
             for key in res[c[0]])
    if not cpu:
        import subprocess
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip())
    print(json.dumps({"ok": ok, "rank0": ranks[0],
                      "s": [r["s"] for r in ranks]}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
