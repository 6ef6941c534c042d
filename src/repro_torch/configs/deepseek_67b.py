"""deepseek-67b [dense] — llama-arch [arXiv:2401.02954; hf].

95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=5,
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22_016,
    vocab_size=102_400,
    norm="rmsnorm",
    act="silu",
    glu=True,
)
