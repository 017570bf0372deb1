"""FlashAttention forward (kernel K4): ``ops.flash_attention`` dispatches
between the CUDA kernel ``csrc/flash_attn_fwd.cu`` and its plain PyTorch
version in ``ref.py``."""
