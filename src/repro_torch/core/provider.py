"""Cloud provider catalog: capacity, spot pricing, preemption, NAT quirks.

The port's own copy of the catalog the sweep engine batches on (the
T4 spot pools the paper ran on, the heterogeneous §III pool and the
sub-GPU slicing transform), and of the pod-slice table the elastic
example provisions from (``tpu_catalog``).  Values and field order
match the JAX package's catalog exactly, so a spec's JSON and its batch
key are the same in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

__all__ = ["RegionSpec", "ProviderSpec", "T4_FP32_TFLOPS", "t4_catalog",
           "tpu_catalog", "heterogeneous_catalog", "slice_provider"]

# fp32 peaks (paper's EFLOP accounting; §III GPU generations): TFLOP/s
T4_FP32_TFLOPS = 8.141
V100_FP32_TFLOPS = 14.13
P100_FP32_TFLOPS = 9.3
M60_FP32_TFLOPS = 4.825          # per GPU (half a Tesla M60 board)


@dataclass(frozen=True)
class RegionSpec:
    name: str
    capacity: int                 # max accelerators fillable in this region
    preempt_rate_per_hour: float  # per-instance hazard at low utilization
    # hazard multiplier at full capacity utilization (spot gets tighter)
    preempt_scale_at_full: float = 3.0


@dataclass(frozen=True)
class ProviderSpec:
    name: str
    accel: str                    # "t4" | "v100" | ... | "v5e-slice"
    spot_price_per_day: float     # $ per accelerator-day (spot)
    ondemand_price_per_day: float
    regions: Tuple[RegionSpec, ...]
    nat_idle_timeout_s: float = float("inf")
    group_mechanism: str = ""     # VMSS / InstanceGroups / SpotFleet
    # fp32 peak of this provider's accelerator; None -> the spec's
    # homogeneous accel_tflops
    fp32_tflops: Optional[float] = None

    @property
    def total_capacity(self) -> int:
        return sum(r.capacity for r in self.regions)


def t4_catalog() -> Dict[str, ProviderSpec]:
    """The paper's three providers (T4 spot). Azure $2.9/T4-day is the
    paper's number; AWS/GCP from contemporaneous public spot prices."""
    return {
        "azure": ProviderSpec(
            "azure", "t4", spot_price_per_day=2.9,
            ondemand_price_per_day=12.7,
            regions=(RegionSpec("eastus", 500, 0.0008),
                     RegionSpec("westus2", 300, 0.0010),
                     RegionSpec("westeurope", 250, 0.0010),
                     RegionSpec("southcentralus", 150, 0.0015)),
            nat_idle_timeout_s=240.0,          # the 4-minute NAT quirk
            group_mechanism="VMSS"),
        "gcp": ProviderSpec(
            "gcp", "t4", spot_price_per_day=4.3,
            ondemand_price_per_day=16.8,
            regions=(RegionSpec("us-central1", 500, 0.008),
                     RegionSpec("us-east1", 300, 0.010),
                     RegionSpec("europe-west1", 250, 0.012)),
            group_mechanism="InstanceGroups"),
        "aws": ProviderSpec(
            "aws", "t4", spot_price_per_day=4.8,
            ondemand_price_per_day=18.9,
            regions=(RegionSpec("us-east-1", 450, 0.012),
                     RegionSpec("us-west-2", 350, 0.015),
                     RegionSpec("eu-west-1", 250, 0.018)),
            group_mechanism="SpotFleet"),
    }


def tpu_catalog() -> Dict[str, ProviderSpec]:
    """The JAX package's price table of pod slices (``tpu_catalog`` in
    its ``core/provider.py``), copied as data: three made-up clouds
    whose provisioning unit is a TPU v5e pod slice, the member of the
    elastic "pod" mesh axis, priced per slice-day.  The elastic example
    provisions from it so that its fleet, spend and ledger equal the JAX
    example's.  These are that package's modelling figures for a TPU
    slice: no price or capacity here describes an H100 offer, and none
    was measured."""
    return {
        "cloud-a": ProviderSpec(
            "cloud-a", "v5e-slice", spot_price_per_day=1060.0,
            ondemand_price_per_day=2470.0,
            regions=(RegionSpec("a-east", 8, 0.004),
                     RegionSpec("a-west", 4, 0.006)),
            nat_idle_timeout_s=240.0, group_mechanism="VMSS"),
        "cloud-b": ProviderSpec(
            "cloud-b", "v5e-slice", spot_price_per_day=1420.0,
            ondemand_price_per_day=2900.0,
            regions=(RegionSpec("b-central", 6, 0.012),),
            group_mechanism="InstanceGroups"),
        "cloud-c": ProviderSpec(
            "cloud-c", "v5e-slice", spot_price_per_day=1510.0,
            ondemand_price_per_day=3100.0,
            regions=(RegionSpec("c-east", 6, 0.015),),
            group_mechanism="SpotFleet"),
    }


def slice_provider(p: ProviderSpec, slices: int, *,
                   price_factor: float = 1.0, tflops_factor: float = 1.0,
                   default_tflops: Optional[float] = None) -> ProviderSpec:
    """The provider's sub-GPU-slice variant (Sfiligoi 2022): ``slices``
    fractional-GPU slots per physical device, priced and rated at
    ``1/slices`` of the whole GPU times the overhead factors."""
    if slices < 1:
        raise ValueError(f"slices must be >= 1, got {slices}")
    full = p.fp32_tflops if p.fp32_tflops is not None else \
        (default_tflops if default_tflops is not None else T4_FP32_TFLOPS)
    return replace(
        p, name=f"{p.name}/{slices}", accel=f"{p.accel}/{slices}",
        spot_price_per_day=p.spot_price_per_day / slices * price_factor,
        ondemand_price_per_day=(p.ondemand_price_per_day / slices
                                * price_factor),
        fp32_tflops=full / slices * tflops_factor,
        regions=tuple(replace(r, capacity=r.capacity * slices)
                      for r in p.regions))


def heterogeneous_catalog(capacity_scale: float = 1.0
                          ) -> Dict[str, ProviderSpec]:
    """The paper's §III heterogeneous pool: T4 workhorses plus the
    V100 / P100 / M60 spot SKUs, one ProviderSpec per (cloud, GPU)."""
    def _cap(n: int) -> int:
        return max(1, int(n * capacity_scale))

    def _regions(*specs) -> Tuple[RegionSpec, ...]:
        return tuple(replace(r, capacity=_cap(r.capacity)) for r in specs)

    cat: Dict[str, ProviderSpec] = {}
    for name, spec in t4_catalog().items():
        cat[f"{name}-t4"] = replace(
            spec, name=f"{name}-t4", regions=_regions(*spec.regions),
            fp32_tflops=T4_FP32_TFLOPS)
    cat.update({
        "azure-v100": ProviderSpec(
            "azure-v100", "v100", spot_price_per_day=13.2,
            ondemand_price_per_day=73.4, fp32_tflops=V100_FP32_TFLOPS,
            regions=_regions(RegionSpec("eastus", 150, 0.0020),
                             RegionSpec("westeurope", 100, 0.0025)),
            nat_idle_timeout_s=240.0, group_mechanism="VMSS"),
        "azure-m60": ProviderSpec(
            "azure-m60", "m60", spot_price_per_day=2.7,
            ondemand_price_per_day=27.4, fp32_tflops=M60_FP32_TFLOPS,
            regions=_regions(RegionSpec("eastus", 200, 0.0012),
                             RegionSpec("southcentralus", 120, 0.0018)),
            nat_idle_timeout_s=240.0, group_mechanism="VMSS"),
        "gcp-v100": ProviderSpec(
            "gcp-v100", "v100", spot_price_per_day=17.8,
            ondemand_price_per_day=59.5, fp32_tflops=V100_FP32_TFLOPS,
            regions=_regions(RegionSpec("us-central1", 200, 0.015),
                             RegionSpec("europe-west4", 100, 0.018)),
            group_mechanism="InstanceGroups"),
        "gcp-p100": ProviderSpec(
            "gcp-p100", "p100", spot_price_per_day=10.3,
            ondemand_price_per_day=35.0, fp32_tflops=P100_FP32_TFLOPS,
            regions=_regions(RegionSpec("us-east1", 250, 0.012),
                             RegionSpec("europe-west1", 150, 0.014)),
            group_mechanism="InstanceGroups"),
        "aws-v100": ProviderSpec(
            "aws-v100", "v100", spot_price_per_day=22.0,
            ondemand_price_per_day=73.4, fp32_tflops=V100_FP32_TFLOPS,
            regions=_regions(RegionSpec("us-east-1", 200, 0.018),
                             RegionSpec("us-west-2", 150, 0.020)),
            group_mechanism="SpotFleet"),
        "aws-m60": ProviderSpec(
            "aws-m60", "m60", spot_price_per_day=3.4,
            ondemand_price_per_day=15.6, fp32_tflops=M60_FP32_TFLOPS,
            regions=_regions(RegionSpec("us-east-1", 250, 0.014),
                             RegionSpec("eu-west-1", 150, 0.016)),
            group_mechanism="SpotFleet"),
    })
    return cat
