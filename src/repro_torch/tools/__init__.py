"""Dry-run tooling, the reference's ``tools`` package: analytic model FLOPs
(``flops.py``), the three-term roofline with an H100 spec beside the v5e
(``roofline.py``), and the step-cost walker that takes the HLO walker's
place (``step_cost.py``)."""

from .flops import model_flops
from .roofline import H100, V5E, ChipSpec, RooflineReport, roofline_terms
from .step_cost import StepCostMode, StepCosts

__all__ = ["ChipSpec", "H100", "RooflineReport", "StepCostMode", "StepCosts", "V5E",
           "model_flops", "roofline_terms"]
