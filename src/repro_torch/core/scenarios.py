"""What-if campaign specs for pre-burst planning sweeps.

The port carries the two library entries its main path needs: the
paper baseline and the dense planning grid, identical to the JAX
package's ``scenarios.paper_baseline`` / ``scenarios.planning_grid``.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.spec import CampaignSpec, paper_spec

__all__ = ["paper_baseline", "planning_grid"]


def paper_baseline() -> CampaignSpec:
    return paper_spec()


def planning_grid(price_scales: Sequence[float] = (0.8, 0.9, 1.0,
                                                   1.1, 1.25),
                  floors: Sequence[float] = (0.1, 0.2, 0.3, 0.4),
                  budgets: Sequence[float] = (40000.0, 58000.0, 80000.0)
                  ) -> List[CampaignSpec]:
    """Every (price drift x budget floor x budget) paper variant: 60
    specs by default, 1,020 lanes at 17 seeds.  Every member keeps the
    paper catalog and capacity, so the whole grid shares one structural
    batch key and runs as one engine batch."""
    return [paper_spec(
                name=f"grid-p{int(p * 100):03d}-f{int(f * 100):02d}"
                     f"-b{int(b / 1000)}k",
                price_scale=p, budget_floor_fraction=f, budget=b)
            for p in price_scales for f in floors for b in budgets]
