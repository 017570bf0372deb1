"""Fused RMSNorm (kernels K10 forward and K11 backward): ``ops.rmsnorm``
dispatches between the CUDA kernels ``csrc/rmsnorm.cu`` and their plain
PyTorch versions in ``ref.py``, through one ``torch.autograd.Function``."""
