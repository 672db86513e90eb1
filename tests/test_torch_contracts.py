"""Contracts of the port that the JAX package's static analyzer cannot
see (it scans only ``src/repro/``):

  * no module of ``repro_torch``, not ``chip_smoke.py`` and not the CUDA
    test file imports JAX or the JAX package;
  * every op in the port's timeline registry has concrete
    ``TorchLaneOps`` members (the port's twin of rule REG001/REG002);
  * the entry points (the sweep, the model, the server, the meshes and
    the elastic runner) run on the card unless told otherwise;
  * spec JSON crosses between the packages byte for byte, and both
    packages batch every spec by the same key.
"""
import ast
from pathlib import Path

import pytest
import torch

from repro.core import scenarios
from repro.core.spec import CampaignSpec as JaxSpec
from repro.core.sweep import _prepare as jax_prepare
from repro_torch.core import api, timeline
from repro_torch.core.spec import CampaignSpec
from repro_torch.core.sweep_result import _prepare
from repro_torch.core.sweep_torch import TorchLaneOps

ROOT = Path(__file__).resolve().parents[1]
# the CUDA test file runs on the card's machine, which has no JAX; the
# gloo rank programs run in processes that import none; so do the
# examples' counterparts
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_kernels_cuda.py",
       ROOT / "tests" / "torch_dist_workers.py"] \
    + sorted((ROOT / "examples").glob("*_torch.py"))
SPEC_FILES = sorted((ROOT / "tests" / "data").glob("*.spec.json"))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists(), path
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, (path, bad)


@pytest.mark.parametrize("op", sorted(timeline.OPS))
def test_every_registered_op_has_concrete_lane_ops_members(op):
    for member in timeline.OPS[op].requires:
        assert hasattr(TorchLaneOps, member), (op, member)
        value = getattr(TorchLaneOps, member)
        if callable(value):
            assert member in TorchLaneOps.__dict__, (op, member)


def test_every_event_compiles_to_registered_ops():
    for kind, et in timeline.REGISTRY.items():
        assert set(et.ops) <= set(timeline.OPS), kind


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = CampaignSpec(duration_h=1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.sweep([spec], [0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.run(spec, seeds=0)
    assert api.run(spec, seeds=0, device="cpu").engine == "torch"
    # the model path: weights, caches, the server and its CLI
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import init_cache, init_params
    cfg = get_reduced("yi-9b")
    for call in (lambda: init_params(cfg, 0),
                 lambda: init_cache(cfg, 2, 8),
                 lambda: serve.BatchServer(cfg),
                 lambda: serve.main(["--arch", "yi-9b", "--reduced"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert init_params(cfg, 0, device="cpu")["embed"]["table"].device.type \
        == "cpu"
    assert serve.BatchServer(cfg, device="cpu").device.type == "cpu"
    # the distributed layer: meshes and the elastic runner default to
    # device_type="cuda"; with device_type="cpu" they still need the
    # caller's process group, and never create one (gloo) on their own
    import torch.distributed as dist
    from repro_torch.core.elastic import ElasticRunner
    from repro_torch.launch.mesh import (make_elastic_mesh, make_host_mesh,
                                         make_production_mesh)
    from repro_torch.sharding_ctx import make_mesh
    for call in (lambda: make_elastic_mesh(1, pod_shape=(1, 1)),
                 lambda: make_host_mesh(),
                 lambda: make_production_mesh(),
                 lambda: make_mesh((1, 1), ("data", "model")),
                 lambda: ElasticRunner(lambda mesh: None, {}, {})):
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            call()
    assert not dist.is_initialized()
    for call in (lambda: make_elastic_mesh(1, pod_shape=(1, 1),
                                           device_type="cpu"),
                 lambda: make_host_mesh(device_type="cpu")):
        with pytest.raises(RuntimeError, match="no process group"):
            call()
    assert not dist.is_initialized()
    assert ElasticRunner(lambda mesh: None, {}, {},
                         device_type="cpu").mesh is None


def _all_specs():
    specs = [(p.name, JaxSpec.from_json(p.read_text())) for p in SPEC_FILES]
    specs += [(f"suite:{s.name}", s) for s in scenarios.default_suite()]
    specs += [(f"pareto:{s.name}", s) for s in scenarios.pareto_grid()]
    return specs


_SPECS = _all_specs()


@pytest.mark.parametrize("name,spec", _SPECS, ids=[n for n, _ in _SPECS])
def test_spec_json_round_trips_and_batch_keys_agree(name, spec):
    text = spec.to_json()
    ported = CampaignSpec.from_json(text)
    assert ported.to_json() == text
    # the DataPlane in the key is each package's own class: compare
    # the keys by value through their reprs
    assert repr(_prepare(ported, 5)[0]) == repr(jax_prepare(spec, 5)[0])


@pytest.mark.parametrize("size_gb", [0.0, 2.0, 25.0, 100.0])
def test_stage_ticks_is_the_jax_expression(size_gb):
    from repro.core.dataplane import stage_ticks as jax_stage_ticks
    from repro_torch.core.dataplane import stage_ticks
    for gbps in (0.0, 0.5, 1.5, 3.0, 4.0, 16.0):
        for dt in (0.1, 0.25, 1.0):
            assert stage_ticks(size_gb, gbps, dt) \
                == jax_stage_ticks(size_gb, gbps, dt)


def test_planning_grid_is_the_jax_grid_and_one_batch():
    from repro_torch.core.scenarios import paper_baseline, planning_grid
    grid = planning_grid()
    assert [s.to_json() for s in grid] \
        == [s.to_json() for s in scenarios.planning_grid()]
    assert len({repr(_prepare(s, 0)[0]) for s in grid}) == 1
    assert paper_baseline().to_json() == scenarios.paper_baseline().to_json()
