"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (``forest_eval``: K1 descent, ``rank``: K2 radix rank, ``chain``:
K3 Shapley chain walk; ``flash_attn``: K4 flash-attention forward, K5 and
K6 its backward; ``moe_gmm``: K9 grouped expert matmul; ``rmsnorm``: K10
fused RMSNorm and K11 its backward; ``rwkv6_wkv``: K12 the RWKV6 chunked
WKV scan; ``mamba2_ssd``: K8 the Mamba2 SSD chunk scan; ``flash_decode``:
K7 split-KV decode attention)."""
