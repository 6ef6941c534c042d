"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

24L d_model=1024 16H (GQA kv=8) d_ff=512 vocab=49155, MoE 32e top-8.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=3,
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49_155,
    n_experts=32,
    top_k=8,
    block_pattern=("moe",),
    norm="rmsnorm",
    act="silu",
    glu=True,
    tie_embeddings=True,
)
