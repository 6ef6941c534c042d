"""Config system: architecture + shape cells for the assigned benchmark grid
(a copy of ``repro.configs.base``).

Every assigned architecture is a ``ModelConfig``; every input-shape row is a
``ShapeConfig``.  A (ModelConfig, ShapeConfig) pair is one dry-run/roofline
cell.  ``reduced()`` produces the CPU smoke-test variant of any architecture
(same family/block pattern, tiny dims).

``DslotConfig`` has no ``use_pallas`` field: in the port the device of the
tensors picks the kernel or its plain version.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class DslotConfig:
    """Execution config for the paper's digit-serial inference mode."""
    enabled: bool = False
    n_bits: int = 8
    n_planes: int = 8          # runtime precision knob (<= n_bits)
    sort_columns: bool = True  # beyond-paper: cluster dead output columns
    block_m: int = 128
    block_n: int = 128
    block_k: int | None = None  # logical K chunk of the termination check
                                # (None = the reference's auto choice)
    act_scale: float | None = None  # calibrated fixed activation-quant step
                                # stored at prepare time (None = per-call max)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads
    # attention
    attn_type: str = "full"          # full | swa
    window: int = 0                  # swa / local-attn window
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm: str = "rmsnorm"            # rmsnorm | nonparam_ln | layernorm
    act: str = "silu"                # silu | gelu | relu
    glu: bool = True
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid block pattern, tiled to n_layers (e.g. RG-LRU 1:2)
    block_pattern: tuple[str, ...] = ("attn",)
    rnn_width: int = 0               # rglru width (0 -> d_model)
    # enc-dec
    encoder_layers: int = 0
    cross_attention: bool = False
    # modality frontend stub ([audio]/[vlm]): precomputed embeddings
    frontend: str = ""               # "" | audio | vision
    frontend_len: int = 0            # frames/patches prepended to the sequence
    # execution
    tie_embeddings: bool = False
    remat: bool = True
    scan_layers: bool = True
    scan_unroll: int = 1             # pattern-periods per scan step: full remat
                                     # saves one carry per STEP, so memory for
                                     # saved activations scales 1/scan_unroll
    attn_chunk: int = 1024           # flash-style KV chunking
    dtype: str = "bfloat16"
    dslot: DslotConfig = field(default_factory=DslotConfig)

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid / SWA)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_type == "swa"

    def pattern_for_layers(self) -> tuple[str, ...]:
        reps = -(-self.n_layers // len(self.block_pattern))
        return (self.block_pattern * reps)[: self.n_layers]

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pat_len = len(self.block_pattern)
        n_layers = max(pat_len, 2 if pat_len == 1 else pat_len)
        return dataclasses.replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            window=min(self.window, 32) if self.window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=4.0,   # dropless at test scale -> exact decode
            ssm_state=16 if self.ssm_state else 0,
            ssm_headdim=16 if self.ssm_state else 64,
            ssm_chunk=8,
            rnn_width=64 if self.rnn_width else 0,
            encoder_layers=min(self.encoder_layers, 2),
            frontend_len=8 if self.frontend else 0,
            attn_chunk=16,
            dtype="float32",
        )


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                        # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1            # grad-accumulation steps (train only)

    def reduced(self) -> "ShapeConfig":
        return dataclasses.replace(
            self, seq_len=32, global_batch=2, microbatches=min(self.microbatches, 2))


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256, microbatches=8),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}
