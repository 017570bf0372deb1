"""deepseek-v3-671b [moe] — MLA + 1 shared + 256 routed experts top-8 + MTP.

61L d_model=7168 128H (GQA kv=128) d_ff=2048(expert) vocab=129280,
MoE 256e top-8 [arXiv:2412.19437; hf]. First 3 layers dense (d_ff 18432).
"""

from .base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,               # dense-layer FFN width
    vocab=129280,
    d_head=128,
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_ff_expert=2048,
        first_dense_layers=3,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    mtp_depth=1,
)
