"""internvl2-26b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.  LM backbone only;
the InternViT frontend is a stub supplying precomputed patch embeddings.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=4,
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16_384,
    vocab_size=92_553,
    norm="rmsnorm",
    act="silu",
    glu=True,
    frontend="vision",
    frontend_len=1024,      # precomputed ViT patch embeddings (stub)
)
