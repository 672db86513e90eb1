"""The port's front door: ``sweep(specs, seeds)`` and ``run(...)``.

Both run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the tick ops' plain versions; with no card
and no explicit CPU request they raise.  The engine is the statistical
count-plane sweep of core/sweep_torch.py, so it has no per-instance
event stream: ``collect="trace"`` / ``"stream"`` raise.
"""
from __future__ import annotations

import numbers
from typing import Iterable, Sequence, Union

import numpy as np

from repro_torch.core.spec import CampaignResult, CampaignSpec
from repro_torch.core.sweep_result import SweepResult
from repro_torch.core.sweep_torch import run_torch_detailed

__all__ = ["run", "sweep", "CampaignResult", "SweepResult"]


def _no_trace_error() -> ValueError:
    return ValueError(
        "the torch engine is statistical: it has no per-instance event "
        'stream to trace; use collect="summary", or a trace-capable '
        "engine of the JAX package")


def _check_collect(collect: str) -> None:
    if collect not in ("summary", "trace", "stream"):
        raise ValueError(f"unknown collect mode {collect!r} "
                         "(expected 'summary', 'trace' or 'stream')")
    if collect != "summary":
        raise _no_trace_error()


def _as_seed(s) -> int:
    """Seeds are exact campaign identities: floats and bools raise."""
    if isinstance(s, (bool, np.bool_)):
        raise TypeError(f"seeds must be integers, got {s!r} (bool)")
    if isinstance(s, numbers.Real) and not isinstance(s, numbers.Integral):
        raise TypeError(f"seeds must be integers, got {s!r} "
                        f"({type(s).__name__})")
    return int(s)


def sweep(specs: Sequence[CampaignSpec], seeds: Sequence[int],
          device=None, collect: str = "summary", **engine_kw
          ) -> SweepResult:
    """Run every (spec x seed) lane on the torch engine.  ``engine_kw``
    passes ``uniforms`` / ``use_kernels`` through to
    :func:`~repro_torch.core.sweep_torch.run_torch_detailed`."""
    _check_collect(collect)
    specs = [s.to_spec() for s in specs]
    if not specs:
        raise ValueError("sweep() needs at least one spec")
    seeds = [_as_seed(seed) for seed in seeds]
    if not seeds:
        raise ValueError("sweep() needs at least one seed")
    lanes = [(spec, seed) for spec in specs for seed in seeds]
    detailed = run_torch_detailed(lanes, device=device, **engine_kw)
    return SweepResult([{"scenario": spec.name, "seed": seed, **res,
                         "events_fired": events}
                        for (spec, seed), (res, events)
                        in zip(lanes, detailed)])


def run(spec_or_specs: Union[CampaignSpec, Sequence[CampaignSpec]],
        seeds: Union[int, Sequence[int]] = 2021, device=None,
        collect: str = "summary", **engine_kw
        ) -> Union[CampaignResult, SweepResult]:
    """One spec and one seed -> :class:`CampaignResult` (``engine=
    "torch"``); anything else -> :meth:`sweep`'s :class:`SweepResult`."""
    _check_collect(collect)
    single_spec = hasattr(spec_or_specs, "to_spec")
    specs = [spec_or_specs] if single_spec else list(spec_or_specs)
    if isinstance(seeds, str):
        seeds = [int(seeds)]
    elif not isinstance(seeds, Iterable):
        seeds = [_as_seed(seeds)]
    seeds = [_as_seed(s) for s in seeds]
    if single_spec and len(seeds) == 1:
        spec = specs[0].to_spec()
        (res, events), = run_torch_detailed([(spec, seeds[0])],
                                            device=device, **engine_kw)
        return CampaignResult.from_results(
            res, spec=spec, seed=seeds[0], engine="torch",
            events_fired=tuple(events))
    return sweep(specs, seeds, device=device, **engine_kw)
