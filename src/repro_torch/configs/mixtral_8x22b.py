"""mixtral-8x22b [moe] — 8 experts top-2 with SWA [arXiv:2401.04088; hf].

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768, MoE 8e top-2.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=4,
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=32_768,
    attn_type="swa",
    window=4_096,
    n_experts=8,
    top_k=2,
    block_pattern=("moe",),
    norm="rmsnorm",
    act="silu",
    glu=True,
)
