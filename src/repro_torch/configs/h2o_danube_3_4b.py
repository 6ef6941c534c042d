"""h2o-danube-3-4b [dense] — llama+mistral mix with SWA [arXiv:2401.16818; unverified].

24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000, sliding-window attention.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=3,
    name="h2o-danube-3-4b",
    family="dense",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10_240,
    vocab_size=32_000,
    attn_type="swa",
    window=4_096,
    norm="rmsnorm",
    act="silu",
    glu=True,
)
