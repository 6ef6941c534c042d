"""mamba2-780m [ssm] — SSD state-space duality [arXiv:2405.21060; unverified].

48L d_model=1536 (attention-free) vocab=50280, ssm_state=128.
"""

from .base import ModelConfig

CONFIG = ModelConfig(
    scan_unroll=4,
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_conv=4,
    ssm_chunk=256,
    block_pattern=("ssm",),
    norm="rmsnorm",
)
