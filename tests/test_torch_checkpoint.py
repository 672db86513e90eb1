"""The port's checkpointer and trainer: round trip, atomicity, retention
and async saves (as ``test_checkpoint.py`` holds the JAX package's),
checkpoints that cross between the two packages in both directions, and
the trainer's preemption -> restore -> bitwise-identical continuation,
on the CPU at reduced size."""
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as jax_restore
from repro.checkpoint import save as jax_save
from repro.configs import get_reduced as jax_get_reduced
from repro.data.pipeline import make_batch as jax_make_batch
from repro.launch import steps as jax_steps
from repro.launch.train import Trainer as JaxTrainer
from repro.launch.train import build as jax_build
from repro.models import model as jm
from repro.optim import adamw as jadamw
from repro_torch.checkpoint import Checkpointer, latest_step, restore, save
from repro_torch.configs import get_reduced
from repro_torch.launch import train
from repro_torch.models.convert import params_from_jax, params_to_jax
from repro_torch.optim import adamw_init, adamw_update
from repro_torch.tree import flatten, map_tree
from test_torch_train import one_cpu_thread  # noqa: F401


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((4, 8), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.randn(3, generator=g).to(torch.bfloat16)},
            "stack": [{"w": torch.randn((2, 3), generator=g)}
                      for _ in range(3)]}


def _assert_equal_trees(a, b):
    fa, fb = list(flatten(a)), list(flatten(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x, y), p


def _flat_np(tree) -> dict:
    return {"/".join(map(str, p)): np.asarray(a, np.float32)
            for p, a in flatten(tree)}


def test_roundtrip(tmp_path):
    t = _tree()
    save(str(tmp_path), 5, {"params": t})
    step, out = restore(str(tmp_path), {"params": _tree(1)})
    assert step == 5
    _assert_equal_trees(out["params"], t)
    with np.load(tmp_path / "step_0000000005" / "params.npz") as z:
        # the stack on a leading axis, bf16 as f32: the JAX package's file
        assert sorted(z.files) == ["a", "nested/b", "nested/c", "stack/w"]
        assert z["stack/w"].shape == (3, 2, 3)
        assert z["nested/c"].dtype == np.float32


def test_latest_and_retention(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save_blocking(s, {"params": _tree(s)})
    assert latest_step(str(tmp_path)) == 4
    dirs = sorted(os.listdir(tmp_path))
    assert dirs == ["step_0000000003", "step_0000000004"]


def test_no_partial_checkpoint_visible(tmp_path):
    """Atomicity: only fully-renamed step dirs count."""
    os.makedirs(tmp_path / ".tmp-9-123")       # simulated dead partial write
    (tmp_path / ".tmp-9-123" / "params.npz").write_bytes(b"garbage")
    assert latest_step(str(tmp_path)) is None


def test_async_checkpoint_saves_the_state_at_the_call(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=3)
    t = _tree()
    want = map_tree(torch.clone, t)
    ck.save_async(7, {"params": t})
    t["a"].add_(1.0)                      # the next step's in-place update
    ck.wait()
    assert latest_step(str(tmp_path)) == 7
    _assert_equal_trees(restore(str(tmp_path), {"params": t})[1]["params"],
                        want)


def test_a_failed_async_save_raises_on_wait(tmp_path):
    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    ck = Checkpointer(str(blocker))
    ck.save_async(1, {"params": _tree()})
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                              # reported once


# -- across the packages ---------------------------------------------------

def _jax_state(cfg, dtype):
    """Reduced JAX parameters and an optimizer state after one update."""
    p = jax.jit(jm.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda x: x.astype(dtype), p)
    opt = jadamw.adamw_init(p)
    grads = jax.tree.map(lambda x: 0.5 * x.astype(jnp.float32), p)
    p, opt, _ = jadamw.adamw_update(grads, opt, p, lr=1e-3)
    return p, opt


def _port_struct(cfg, dtype):
    p = train.init_params(cfg, 1, device="cpu")
    p = map_tree(lambda x: x.to(dtype), p)
    return p, adamw_init(p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_in_the_port(tmp_path, dtype):
    jcfg, cfg = jax_get_reduced("yi-9b"), get_reduced("yi-9b")
    jp, jopt = _jax_state(jcfg, jnp.dtype(dtype))
    jax_save(str(tmp_path), 3, {"params": jp, "opt": jopt})
    tp, topt = _port_struct(cfg, getattr(torch, dtype))
    step, trees = restore(str(tmp_path), {"params": tp, "opt": topt})
    assert step == 3
    assert ("master" in trees["opt"]) == (dtype == "bfloat16")
    for name, want in (("params", jp), ("opt", jopt)):
        got = trees[name]
        assert [x.dtype for _, x in flatten(got)] == \
            [x.dtype for _, x in flatten({"params": tp, "opt": topt}[name])]
        got, want = _flat_np(params_to_jax(got)), _flat_np(
            jax.tree.map(np.asarray, want))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_restores_in_jax(tmp_path, dtype):
    jcfg, cfg = jax_get_reduced("yi-9b"), get_reduced("yi-9b")
    jstruct = _jax_state(jcfg, jnp.dtype(dtype))
    tp = params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      jstruct[0]), cfg, device="cpu")
    tp = map_tree(lambda x: x.to(getattr(torch, dtype)), tp)
    topt = adamw_init(tp)
    tp, topt, _ = adamw_update(map_tree(lambda x: 0.5 * x.float(), tp),
                               topt, tp, lr=1e-3)
    save(str(tmp_path / "port"), 4, {"params": tp, "opt": topt})
    step, trees = jax_restore(str(tmp_path / "port"),
                              {"params": jstruct[0], "opt": jstruct[1]})
    assert step == 4
    for name, got, want in (("params", trees["params"], tp),
                            ("opt", trees["opt"], topt)):
        assert [x.dtype for x in jax.tree.leaves(got)] == \
            [x.dtype for x in jax.tree.leaves(jstruct[name == "opt"])]
        got = _flat_np(jax.tree.map(np.asarray, got))
        want = _flat_np(params_to_jax(want))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the two packages write the same files: key sets and manifest
    jax_save(str(tmp_path / "jax"), 4, {"params": jstruct[0],
                                        "opt": jstruct[1]})
    for name in ("params", "opt"):
        with np.load(tmp_path / "port" / "step_0000000004" / f"{name}.npz") \
                as a, np.load(tmp_path / "jax" / "step_0000000004" /
                              f"{name}.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in b.files:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
    ma, mb = (json.loads((tmp_path / d / "step_0000000004" /
                          "manifest.json").read_text())
              for d in ("port", "jax"))
    assert set(ma) == set(mb) and ma["trees"] == mb["trees"] \
        and ma["step"] == mb["step"]


def test_jax_trainer_resumes_from_the_port_trainer(tmp_path):
    """A run moves from the port's launcher to the JAX package's: the JAX
    ``Trainer`` on the same directory restores the port's last step, and
    the JAX train step goes on from that state.  (``Trainer.train`` of
    the JAX package itself fails under this JAX, ROADMAP C2, so the
    steps run through ``jax.jit(make_train_step)``.)"""
    d = str(tmp_path)
    losses = train.main(["--arch", "yi-9b", "--reduced", "--steps", "4",
                         "--ckpt-every", "4", "--ckpt-dir", d,
                         "--device", "cpu"])
    assert len(losses) == 4 and latest_step(d) == 4
    port = train.Trainer(*train.build("yi-9b"), ckpt_dir=d, device="cpu")
    assert port.step_num == 4
    cfg, shape, run = jax_build("yi-9b")
    tr = JaxTrainer(cfg, shape, run, ckpt_dir=d)
    assert tr.step_num == 4
    params, opt = jax.device_get((tr.params, tr.opt))
    for got, want in ((params, port.params), (opt, port.opt)):
        got, want = _flat_np(got), _flat_np(params_to_jax(want))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    step = jax.jit(jax_steps.make_train_step(cfg, run))
    for s in (4, 5):
        params, opt, m = step(params, opt, jax_make_batch(cfg, shape, s))
        assert np.isfinite(float(m["loss"]))
    assert int(opt["step"]) == 6


# -- the trainer -----------------------------------------------------------

def _quiet(*_):
    pass


def test_trainer_restore_is_bitwise_identical(tmp_path):
    """Train 10 steps saving at 5; restart from 5 and re-run 5 steps; the
    parameters and optimizer state equal the uninterrupted run's bit for
    bit (determinism is the elastic-restart contract)."""
    cfg, shape, run = train.build("yi-9b", reduced=True)
    d = str(tmp_path / "a")
    tr1 = train.Trainer(cfg, shape, run, ckpt_dir=d, seed=3, device="cpu")
    full = tr1.train(10, ckpt_every=5, log_every=0, log=_quiet)

    tr2 = train.Trainer(cfg, shape, run, ckpt_dir=d, seed=3, device="cpu")
    assert tr2.step_num == 10            # restored the latest
    assert tr2.restore(d, step=5) == 5 and tr2.step_num == 5
    resumed = tr2.train(10, ckpt_every=100, log_every=0, log=_quiet)
    assert resumed == full[5:]
    _assert_equal_trees(tr2.params, tr1.params)
    _assert_equal_trees(tr2.opt, tr1.opt)


def test_sigterm_leaves_a_checkpoint_at_the_current_step(tmp_path):
    cfg, shape, run = train.build("yi-9b", reduced=True)
    tr = train.Trainer(cfg, shape, run, ckpt_dir=str(tmp_path),
                       device="cpu")
    said = []

    def log(msg):
        said.append(msg)
        if tr.step_num == 3:               # the notice arrives mid-run
            os.kill(os.getpid(), signal.SIGTERM)
    previous = signal.getsignal(signal.SIGTERM)
    try:
        tr.install_signal_handlers()
        losses = tr.train(10, ckpt_every=100, log_every=1, log=log)
    finally:
        signal.signal(signal.SIGTERM, previous)
    assert len(losses) == 3 and tr.step_num == 3
    assert said[-1] == "preemption notice honored at step 3"
    assert latest_step(str(tmp_path)) == 3
    step, trees = restore(str(tmp_path), tr.trees())
    _assert_equal_trees(trees["params"], tr.params)
    assert int(trees["opt"]["step"]) == 3


def test_a_non_finite_loss_raises(tmp_path):
    cfg, shape, run = train.build("yi-9b", reduced=True)
    tr = train.Trainer(cfg, shape, run, device="cpu")
    with torch.no_grad():
        tr.params["lm_head"]["w"][0, 0] = float("nan")
    with pytest.raises(FloatingPointError, match="step 0"):
        tr.train(2, log_every=0)


def test_bf16_trainer_keeps_the_master_and_checkpoints_it(tmp_path):
    cfg, shape, run = train.build("xlstm-350m", reduced=True,
                                  compute_dtype="bfloat16", batch=2, seq=16)
    tr = train.Trainer(cfg, shape, run, ckpt_dir=str(tmp_path),
                       device="cpu")
    assert {x.dtype for _, x in flatten(tr.params)} == {torch.bfloat16}
    assert {x.dtype for _, x in flatten(tr.opt["master"])} == {torch.float32}
    losses = tr.train(2, ckpt_every=2, log_every=0)
    assert all(np.isfinite(losses))
    again = train.Trainer(cfg, shape, run, ckpt_dir=str(tmp_path),
                          device="cpu")
    assert again.step_num == 2
    _assert_equal_trees(again.opt, tr.opt)
    _assert_equal_trees(again.params, tr.params)
