"""Split-KV decode attention (kernel K7): ``ops.decode_attention``
dispatches between the CUDA kernel ``csrc/flash_decode.cu`` and its plain
PyTorch version in ``ref.py``."""
