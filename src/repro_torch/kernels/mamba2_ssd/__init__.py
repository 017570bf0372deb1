"""Mamba2 SSD chunk scan (kernel K8): ``ops.ssd_scan`` and ``ops.ssd_heads``
dispatch between the CUDA kernel ``csrc/mamba2_ssd.cu`` and its plain
PyTorch version in ``ref.py``."""
