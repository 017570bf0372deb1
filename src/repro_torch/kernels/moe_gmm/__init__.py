"""Grouped expert matmul (kernel K9): ``ops.grouped_matmul`` dispatches
between the CUDA kernel ``csrc/moe_gmm.cu`` and its plain PyTorch version
in ``ref.py``."""
