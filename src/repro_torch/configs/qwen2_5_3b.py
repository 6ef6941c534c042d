"""qwen2.5-3b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B; hf].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=4,
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    glu=True,
    rope_theta=1_000_000.0,
)
