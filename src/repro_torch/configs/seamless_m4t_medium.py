"""seamless-m4t-medium [audio] — enc-dec multimodal [arXiv:2308.11596; hf].

12L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=256206.  Transformer backbone
only; the audio frontend is a stub supplying precomputed frame embeddings.
FFN activation is ReLU (as in the original architecture) — this is the one
assigned LM arch where DSLOT early-negative-termination applies end-to-end.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=2,
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256_206,
    norm="layernorm",
    act="relu",
    glu=False,
    encoder_layers=12,
    cross_attention=True,
    frontend="audio",
    frontend_len=1024,      # precomputed speech frame embeddings (stub)
    rope_theta=10_000.0,
)
