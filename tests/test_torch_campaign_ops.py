"""The port's campaign tick ops against the JAX package's oracles.

The same numpy inputs go through ``repro.kernels.ref`` (jnp) and
``repro_torch.kernels.ref`` (PyTorch): the integer ops must agree
exactly, billing to 1e-6 relative (the f32 sums may associate
differently).  The wrappers in ``repro_torch.kernels.ops`` run the plain
versions for CPU tensors, count no launch doing so, and reject what the
kernels do not take.  The CUDA kernels themselves are tested in
``test_torch_kernels_cuda.py`` (on the card only).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref as tref
from test_torch_kernels_cuda import (alloc_rows as _alloc_rows,
                                     fma_flip_rows as _near_integer_rows)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- plain versions against the JAX oracles --------------------------------

@pytest.mark.parametrize("R,C", [(8, 5), (20, 10), (12, 16), (64, 18)])
def test_alloc_matches_jax_oracle(R, C):
    counts, k = _alloc_rows(R * C, R, C)
    want = np.asarray(jref.campaign_alloc_ref(jnp.asarray(counts),
                                              jnp.asarray(k)))
    got = tref.campaign_alloc_ref(_t(counts), _t(k)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).all() and (got <= counts).all()
    np.testing.assert_array_equal(got.sum(1), np.minimum(k, counts.sum(1)))


@pytest.mark.parametrize("C", [10, 18])
def test_alloc_near_integer_rows_match_jax_oracle(C):
    counts, k = _near_integer_rows(C, 64, C)
    want = np.asarray(jref.campaign_alloc_ref(jnp.asarray(counts),
                                              jnp.asarray(k)))
    got = tref.campaign_alloc_ref(_t(counts), _t(k)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("B,G", [(4, 3), (16, 10), (9, 12)])
def test_preempt_and_match_are_the_allocator(B, G):
    counts, k = _alloc_rows(B + G, max(B, 5), G)
    want = np.asarray(jref.campaign_match_ref(jnp.asarray(counts),
                                              jnp.asarray(k)))
    np.testing.assert_array_equal(
        tref.campaign_match_ref(_t(counts), _t(k)).numpy(), want)
    np.testing.assert_array_equal(
        tref.campaign_preempt_ref(_t(counts), _t(k)).numpy(), want)


@pytest.mark.parametrize("R,W", [(8, 16), (20, 16), (5, 9)])
def test_advance_matches_jax_oracle(R, W):
    rng = np.random.default_rng(R * W)
    busy = rng.integers(0, 30, (R, W)).astype(np.int32)
    wfin1 = rng.integers(1, W, (R, 1))
    mask = (np.arange(W)[None, :] >= wfin1).astype(np.int32)
    adv_w, fin_w = jref.campaign_advance_ref(jnp.asarray(busy),
                                             jnp.asarray(mask))
    adv, fin = tref.campaign_advance_ref(_t(busy), _t(mask))
    np.testing.assert_array_equal(adv.numpy(), np.asarray(adv_w))
    np.testing.assert_array_equal(fin.numpy(), np.asarray(fin_w))
    assert adv.dtype == fin.dtype == torch.int32


@pytest.mark.parametrize("B,G,P", [(4, 3, 2), (16, 10, 3), (7, 12, 5)])
def test_bill_matches_jax_oracle(B, G, P):
    rng = np.random.default_rng(B * G * P)
    live = rng.integers(0, 2000, (B, G)).astype(np.int32)
    rate = rng.uniform(0.1, 5.0, (B, G)).astype(np.float32)
    onehot = np.eye(P, dtype=np.float32)[rng.integers(0, P, G)]
    spent_w, prov_w = jref.campaign_bill_ref(
        jnp.asarray(live), jnp.asarray(rate), jnp.asarray(onehot))
    spent, prov = tref.campaign_bill_ref(_t(live), _t(rate), _t(onehot))
    np.testing.assert_allclose(spent.numpy(), np.asarray(spent_w),
                               rtol=1e-6)
    np.testing.assert_allclose(prov.numpy(), np.asarray(prov_w), rtol=1e-6)


# -- the wrappers on CPU tensors -------------------------------------------

def test_cpu_wrappers_run_plain_versions_and_count_no_launch():
    ops.reset_launches()
    counts, k = _alloc_rows(7, 10, 18)
    np.testing.assert_array_equal(
        ops.campaign_preempt(_t(counts), _t(k)).numpy(),
        tref.campaign_alloc_ref(_t(counts), _t(k)).numpy())
    ops.campaign_match(_t(counts[:, :10].copy()), _t(k))
    busy = _t(counts[:, :16].copy())
    ops.campaign_advance(busy, torch.ones_like(busy))
    ops.campaign_bill(_t(counts[:, :3].copy()),
                      torch.ones(10, 3), torch.eye(3))
    assert set(ops.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "device"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    counts = torch.ones((6, 8), dtype=torch.int32)
    k = torch.ones(6, dtype=torch.int32)
    if bad == "dtype":
        counts = counts.to(torch.int64)
    elif bad == "shape":
        k = torch.ones(5, dtype=torch.int32)
    elif bad == "contiguity":
        counts = torch.ones((8, 6), dtype=torch.int32).t()
    else:
        counts, k = counts.to("meta"), k.to("meta")
    with pytest.raises((TypeError, ValueError)):
        ops.campaign_preempt(counts, k)
