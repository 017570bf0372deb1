"""Three-term roofline of one step from the step-cost walker's totals.

    compute    = step FLOPs       / peak FLOP/s
    memory     = step bytes       / HBM bytes/s
    collective = collective bytes / link bytes/s

The reference's ``tools/roofline.py`` rates compiled XLA programs against a
TPU v5e; the port's walker (``tools/step_cost.py``) gives per-device totals
of the step traced on fake tensors, so each term divides by one device's
peaks. ``V5E`` is kept beside ``H100`` so that a report can be read against
either; a report carries its chip, and ``roofline_fraction`` is taken
against that chip's peak. Every time here is a model evaluated against a
data sheet's figures, not a measurement.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

from .step_cost import StepCosts

__all__ = ["ChipSpec", "H100", "V5E", "RooflineReport", "roofline_terms"]


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops: float     # bf16 FLOP/s
    hbm_bw: float         # bytes/s
    link_bw: float        # interconnect bytes/s a device sends


V5E = ChipSpec("tpu-v5e", 197e12, 819e9, 50e9)

# NVIDIA H100 SXM5 data sheet: 989 TFLOP/s bf16 dense (1,979 is with
# sparsity), 3.35 TB/s of HBM3, and "NVLink: 900GB/s" (fourth-generation
# NVLink, 18 links of 50 GB/s, counting both directions; the NVLink Switch
# System joins up to 256 such GPUs). The collective term divides the bytes
# that the ring model says each device *sends* (tools/step_cost.py), and a
# device sends over all 18 links into the switch at once but in one
# direction only, so it takes half of the aggregate: 450 GB/s.
H100 = ChipSpec("h100-sxm", 989e12, 3.35e12, 450e9)


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # per-device step totals (named as the reference's HLO totals)
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    collectives: Dict[str, float] = field(default_factory=dict)
    model_flops: float = 0.0           # analytic 6*N*D (global)
    raw_cost_analysis_flops: float = 0.0
    raw_cost_analysis_bytes: float = 0.0
    chip: ChipSpec = H100

    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic (perfect-overlap) step time = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / (chips * step FLOPs): usefulness of what runs."""
        tot = self.chips * self.hlo_flops
        return self.model_flops / tot if tot > 0 else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the modeled step
        time: (MODEL_FLOPS / step_time) / (chips * the report's chip's peak)."""
        if self.step_time_s <= 0:
            return 0.0
        achieved = self.model_flops / self.step_time_s
        return achieved / (self.chips * self.chip.peak_flops)

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips, "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes, "collective_bytes": self.collective_bytes,
            "collectives": self.collectives, "model_flops": self.model_flops,
            "raw_cost_analysis_flops": self.raw_cost_analysis_flops,
            "raw_cost_analysis_bytes": self.raw_cost_analysis_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s, "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def roofline_terms(
    arch: str, shape: str, mesh: str, chips: int,
    costs: StepCosts, model_fl: float,
    raw_flops: float = 0.0, raw_bytes: float = 0.0,
    chip: ChipSpec = H100,
) -> RooflineReport:
    r = RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        hlo_flops=costs.flops, hlo_bytes=costs.bytes,
        collective_bytes=costs.collective_bytes,
        collectives=dict(costs.collectives),
        model_flops=model_fl,
        raw_cost_analysis_flops=raw_flops, raw_cost_analysis_bytes=raw_bytes,
        chip=chip,
    )
    r.compute_s = costs.flops / chip.peak_flops
    r.memory_s = costs.bytes / chip.hbm_bw
    r.collective_s = costs.collective_bytes / chip.link_bw
    return r
