"""repro_torch — MFTune ported to PyTorch and CUDA for one NVIDIA H100.

A second package beside the JAX reference ``repro``. The tuner loop's
host-side bookkeeping is carried over as numpy; the surrogate descent
(``kernels/forest_eval``), the rank aggregation and the Shapley chain walk
run on the card through hand-written CUDA kernels (``csrc/``), each with a
plain PyTorch version that the CPU path and the tests use.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
