"""RWKV6 chunked WKV scan (kernel K12): ``ops.wkv_scan`` and
``ops.wkv_heads`` dispatch between the CUDA kernel ``csrc/rwkv6_wkv.cu``
and its plain PyTorch version in ``ref.py``."""
