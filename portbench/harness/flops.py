"""Frozen FLOP and byte arithmetic, from shapes alone, and the chip's
published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)."""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12      # tensor cores, bf16 in, f32 accumulate
PEAK_HBM_BYTES = 3.35e12      # HBM3


def _dims(model: dict) -> tuple[int, int, int, int, int]:
    d, H, Hkv = model["d_model"], model["n_heads"], model["n_kv_heads"]
    hd = model.get("head_dim") or d // H
    return d, H, Hkv, hd, model["d_ff"]


def attn_params(model: dict) -> int:
    d, H, Hkv, hd, _ = _dims(model)
    return d * H * hd + 2 * d * Hkv * hd + H * hd * d


def mlp_params(model: dict) -> int:
    d, _, _, _, f = _dims(model)
    return (3 if model.get("glu", True) else 2) * d * f


def decoder_layer_params(model: dict) -> int:
    """The products every decoder row runs through in one layer: its
    self-attention, the MLP and, in an encoder-decoder, the cross
    attention's query and output projections (its keys and values are
    products of the encoder rows, counted by ``cross_kv_flops``)."""
    d, H, _, hd, _ = _dims(model)
    p = attn_params(model) + mlp_params(model)
    if model["family"] == "encdec":
        p += 2 * d * H * hd
    return p


def decoder_flops(model: dict, rows: int, ctx_sum: int, logit_rows: int,
                  enc_len: int = 0) -> float:
    """Dense FLOPs of ``rows`` decoder tokens whose causal contexts sum to
    ``ctx_sum`` keys, ``logit_rows`` of them through the head; in an
    encoder-decoder each row also attends ``enc_len`` encoder keys."""
    d, V, L = model["d_model"], model["vocab_size"], model["n_layers"]
    f = 2.0 * rows * decoder_layer_params(model) * L
    f += 4.0 * L * d * (ctx_sum + rows * enc_len)
    return f + 2.0 * logit_rows * d * V


def encoder_flops(model: dict, rows_per_seq: int, seqs: int) -> float:
    """The encoder over ``seqs`` sequences of ``rows_per_seq`` (non-causal:
    every row attends every row), with the decoder's cross-attention keys
    and values of its output."""
    d, _, Hkv, hd, _ = _dims(model)
    Le, L = model["encoder_layers"], model["n_layers"]
    rows = rows_per_seq * seqs
    f = 2.0 * rows * (attn_params(model) + mlp_params(model)) * Le
    f += 4.0 * Le * d * rows * rows_per_seq
    return f + 2.0 * rows * 2 * d * Hkv * hd * L


def causal_ctx_sum(p0: int, p1: int) -> int:
    """Sum of the causal contexts of positions p0 .. p1 - 1 (position p
    attends p + 1 keys)."""
    return (p1 * (p1 + 1) - p0 * (p0 + 1)) // 2


def weight_bytes(model: dict) -> int:
    """Bytes a weight of the served model takes: 2 where bf16 holds every
    weight, 4 otherwise."""
    return 2 if model["dtype"] in ("bfloat16", "float16") else 4


def dslot_least_s(M: int, K: int, N: int, w_bytes: int) -> float:
    """The least time of one DSLOT up-projection (M, K) @ (K, N): its
    product once at the bf16 peak, or q (1 byte), W (``w_bytes``) and the
    output (2 bytes) each moved once, whichever is longer."""
    ops = 2.0 * M * K * N / PEAK_BF16_FLOPS
    moved = (M * K + K * N * w_bytes + M * N * 2) / PEAK_HBM_BYTES
    return max(ops, moved)
