"""olmo-1b [dense] — non-parametric LN [arXiv:2402.00838; hf].

16L d_model=2048 16H (GQA kv=16) d_ff=8192 vocab=50304.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=2,
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50_304,
    norm="nonparam_ln",
    act="silu",
    glu=True,
    tie_embeddings=True,
)
