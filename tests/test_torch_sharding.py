"""The port's sharding rules against the JAX package's, with no ranks:
every leaf of all ten architectures at their full configs, on the
(16, 16) and (2, 16, 16) production layouts and the (4, 2) and (3, 5)
meshes (abstract meshes on both sides).

The port's parameters and caches are built on the meta device, the JAX
trees by ``jax.eval_shape``.  The port's trees unstack each stack into
a list of super-blocks, so a port leaf under ``stack[i]`` (or
``encoder/stack[i]``, or cache ``[i]``) is matched to the JAX leaf of
its path without the index, and its spec is the JAX spec without the
stack's leading ``None``.  ``spec_for`` is held to the JAX one on random
shapes and logical axes (hypothesis).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro import sharding as jsh
from repro import sharding_ctx as jctx
from repro.configs import ARCH_IDS
from repro.configs import get_config as jget_config
from repro.configs.base import SHAPES
from repro.launch import steps as jsteps
from repro_torch import sharding as sh
from repro_torch import sharding_ctx as ctx
from repro_torch.configs import get_config
from repro_torch.models import init_cache, init_params
from repro_torch.optim import adamw_init
from repro_torch.tree import flatten, map_tree

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "3x5": ((3, 5), ("data", "model"))}
# (batch, max_len) of the JAX package's decode cells (decode_32k,
# long_500k: batch 1, so KV seq takes "data" too)
CACHE_SHAPES = ((128, 32768), (1, 524288))
LOGICAL = (None, "batch", "tokens", "data", "model", "expert", "heads",
           "ff", "vocab", "seq")


def _meshes(key):
    sizes, names = MESHES[key]
    return ctx.abstract_mesh(sizes, names), jctx.abstract_mesh(sizes, names)


def _jax_specs(tree):
    """{path of dict keys: spec tuple} of a JAX tree of NamedShardings."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: hasattr(x, "spec"))
    return {tuple(p.key for p in path): tuple(s.spec) for path, s in leaves}


def _compare(port_tree, jax_specs, all_stacked=False):
    """Every port leaf's spec equals its JAX leaf's, the stack's leading
    None dropped (on every leaf with ``all_stacked``, else on the leaves
    under a list index); every JAX leaf is matched."""
    seen = set()
    for path, s in flatten(port_tree):
        key = tuple(p for p in path if not isinstance(p, int))
        want = jax_specs[key]
        if (all_stacked or len(key) < len(path)) and want:
            assert want[0] is None, (key, want)
            want = want[1:]
        assert s.spec == want, (path, s.spec, want)
        seen.add(key)
    assert seen == set(jax_specs), set(jax_specs) ^ seen


@functools.lru_cache(maxsize=None)
def _structs(arch):
    """(port params, port opt, JAX params, JAX opt), bf16 params so that
    both optimizer states hold the f32 master."""
    cfg = get_config(arch)
    params = init_params(cfg, torch.Generator(), device="meta")
    params = map_tree(lambda p: p.to(torch.bfloat16), params)
    jcfg = jget_config(arch)
    jps = jsteps.params_struct(jcfg, jnp.bfloat16)
    return params, adamw_init(params), jps, jsteps.opt_struct(jcfg, jps)


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_and_opt_specs_equal_the_jax_rules(arch, mesh_key):
    mesh, jmesh = _meshes(mesh_key)
    params, opt, jps, jopt = _structs(arch)
    assert "master" in opt and "master" in jopt
    _compare(sh.param_shardings(params, mesh),
             _jax_specs(jsh.param_shardings(jps, jmesh)))
    _compare(sh.opt_shardings(opt, mesh),
             _jax_specs(jsh.opt_shardings(jopt, jmesh)))


@pytest.mark.parametrize("mesh_key", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_and_batch_specs_equal_the_jax_rules(arch, mesh_key):
    mesh, jmesh = _meshes(mesh_key)
    cfg, jcfg = get_config(arch), jget_config(arch)
    for batch, max_len in CACHE_SHAPES:
        cache = init_cache(cfg, batch, max_len, device="meta")
        jcache = jsteps.cache_struct(jcfg, batch, max_len)
        # every JAX cache leaf leads with n_super
        _compare(sh.cache_shardings(cache, mesh),
                 _jax_specs(jsh.cache_shardings(jcache, jmesh)),
                 all_stacked=True)
    for shape in ("train_4k", "prefill_32k"):
        jbatch = jsteps.input_specs(jcfg, SHAPES[shape])
        for rows in (None, 3):           # 3 rows: no mesh divides them
            jb = {k: jax.ShapeDtypeStruct(
                ((rows,) + v.shape[1:]) if rows else v.shape, v.dtype)
                for k, v in jbatch.items()}
            batch = {k: torch.empty(v.shape, device="meta")
                     for k, v in jb.items()}
            got = {k: s.spec for k, s in
                   sh.batch_shardings(batch, mesh).items()}
            want = {k: tuple(s.spec) for k, s in
                    jsh.batch_shardings(jb, jmesh).items()}
            assert got == want, (shape, rows)


def test_replicated_and_batch_axes():
    for key in MESHES:
        mesh, jmesh = _meshes(key)
        assert sh.batch_axes(mesh) == jsh.batch_axes(jmesh)
        assert sh.replicated(mesh).spec == tuple(jsh.replicated(jmesh).spec)


@settings(max_examples=200, deadline=None)
@given(mesh_key=st.sampled_from(sorted(MESHES)),
       dims=st.lists(st.sampled_from([1, 2, 3, 4, 5, 6, 8, 10, 15, 16, 30,
                                      32, 48, 64, 96, 256, 512, 768]),
                     min_size=0, max_size=5),
       data=st.data())
def test_spec_for_equals_the_jax_one(mesh_key, dims, data):
    mesh, jmesh = _meshes(mesh_key)
    logical = data.draw(st.lists(st.sampled_from(LOGICAL),
                                 min_size=len(dims), max_size=len(dims)))
    assert ctx.spec_for(mesh, dims, logical) \
        == tuple(jctx.spec_for(jmesh, dims, logical))
    for axis in logical:
        phys = ctx._physical(mesh, axis)
        assert phys == jctx._physical(jmesh, axis)
        assert ctx.axis_size(mesh, phys) == jctx.axis_size(jmesh, phys)


def test_constrain_outside_a_mesh_and_on_plain_tensors():
    x = torch.from_numpy(np.arange(12.0).reshape(3, 4))
    assert ctx.constrain(x, "batch", None) is x
    mesh, _ = _meshes("4x2")
    with ctx.use_mesh(mesh):
        assert ctx.current_mesh() is mesh
        assert ctx.constrain(x, "batch", "model") is x
    assert ctx.current_mesh() is None
