"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 [arXiv:2402.19427; hf].

26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000.  Griffin pattern:
two RG-LRU recurrent blocks per local-attention block; local window 2048;
head_dim 256; GeGLU MLP.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=2,
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256_000,
    head_dim=256,
    attn_type="swa",
    window=2048,
    block_pattern=("rglru", "rglru", "attn"),
    rnn_width=2560,
    norm="rmsnorm",
    act="gelu",
    glu=True,
    tie_embeddings=True,
)
