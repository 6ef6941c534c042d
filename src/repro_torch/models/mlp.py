"""MLP blocks (SwiGLU / GeGLU / ReLU) with the DSLOT digit-serial execution
mode for inference (port of ``repro.models.mlp``).

When ``cfg.dslot.enabled`` and the activation is ReLU without a GLU (the only
case where early negative termination holds), the up-projection runs through
the port's ``DslotDense`` (``name="mlp_up_dslot"``) with fused ReLU and
per-tile early termination: on CUDA tensors that is the CUDA kernel.
``prepare_mlp_dslot`` attaches the one-time weight lowering to every
up-projection in a params tree; a stacked group of layers gets a list with
one ``DslotWeights`` per layer.  The runtime precision comes from the active
``repro_torch.runtime`` precision scope, and termination statistics go out
through ``repro_torch.models.stats``.

Inside ``pspec.model_shard`` the float MLP is Megatron's pair: ``up`` and
``gate`` column-parallel over ``d_ff`` (the input through "f"), ``down``
row-parallel ("g").  The DSLOT path never splits.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.ops import dslot_prepare
from repro_torch.layers import DslotDense

from . import pspec, stats
from .layers import Params, apply_dense, init_dense, row_parallel


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * 1 / (1 + exp(-x)), each op rounded to x's dtype
    (``F.silu`` rounds once, which differs in bf16)."""
    return x * (1 / (1 + torch.exp(-x)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form) op by op in x's dtype, its constants
    rounded to that dtype first, as the reference's trace has them."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)
    inner = (x + x ** 3 * c(0.044715)) * c((2 / torch.pi) ** 0.5)
    return x * ((1 + torch.tanh(inner)) * c(0.5))


_ACTS = {
    "silu": _silu,
    "gelu": _gelu,
    "relu": lambda x: torch.clamp_min(x, 0.0),
}


def init_mlp(cfg, gen, device) -> Params:
    dt = getattr(torch, cfg.dtype)
    p = {"up": init_dense(gen, cfg.d_model, cfg.d_ff, dt, device),
         "down": init_dense(gen, cfg.d_ff, cfg.d_model, dt, device)}
    if cfg.glu:
        p["gate"] = init_dense(gen, cfg.d_model, cfg.d_ff, dt, device)
    return p


def mlp_uses_dslot(cfg) -> bool:
    """The digit-serial path applies: ReLU (termination contract), no GLU."""
    return bool(cfg.dslot.enabled and cfg.act == "relu" and not cfg.glu)


def apply_mlp(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if mlp_uses_dslot(cfg):
        return _apply_mlp_dslot(p, x, cfg)
    act = _ACTS[cfg.act]
    split = pspec.active_splits(cfg).mlp
    if split:
        x = pspec.copy_to_model(x)
    up = apply_dense(p["up"], x)
    h = act(apply_dense(p["gate"], x)) * up if cfg.glu else act(up)
    if split:
        return row_parallel(p["down"], h)
    return apply_dense(p["down"], h)


def _dslot_up_layer(cfg) -> DslotDense:
    d = cfg.dslot
    return DslotDense(
        d_in=cfg.d_model, d_out=cfg.d_ff, name="mlp_up_dslot",
        n_bits=d.n_bits, n_planes=d.n_planes, relu=True, signed=True,
        sort_columns=d.sort_columns, block_m=d.block_m, block_n=d.block_n,
        block_k=d.block_k)


def _apply_mlp_dslot(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Digit-serial inference path: fused up-projection + ReLU with early
    termination of provably negative output tiles, on the prepared state in
    ``p["up"]["dslot"]`` when ``prepare_mlp_dslot`` has run."""
    h, st = _dslot_up_layer(cfg).apply(p["up"], x.to(torch.float32))
    stats.record("mlp_dslot_skipped_frac", st.skipped_frac)
    stats.record("mlp_dslot_planes_used",
                 st.planes_used.to(torch.float32).mean())
    return apply_dense(p["down"], h.to(x.dtype))


def prepare_mlp_dslot(params, cfg, mesh=None, tp_axis="model"):
    """Attach the one-time DSLOT lowering to every MLP up-projection in a
    model params tree.

    Walks the nested dict/list/tuple tree for MLP-shaped subtrees (a dict
    with ``up``/``down`` dense-param dicts and no ``gate``) and stores the
    prepared state under ``[...]["up"]["dslot"]``: a ``DslotWeights`` for a
    (K, N) weight, a list of one ``DslotWeights`` per layer for a stacked
    (G, K, N) group.  Weights are prepared in f32, like the reference, so
    the termination tables equal the reference's.  Returns the params
    unchanged when the digit-serial path does not apply.

    ``mesh``/``tp_axis`` prepare every up-projection tensor-parallel: each
    rank keeps its own output columns, and execution gathers the rest with
    results equal to the unsharded path's (``kernels/ops.py``).
    """
    if not mlp_uses_dslot(cfg):
        return params
    d = cfg.dslot

    def prep_one(w):
        return dslot_prepare(
            w.to(torch.float32), n_bits=d.n_bits, relu=True, signed=True,
            sort_columns=d.sort_columns, block_m=d.block_m, block_n=d.block_n,
            block_k=d.block_k, x_scale=d.act_scale, mesh=mesh,
            tp_axis=tp_axis)

    def walk(node):
        if isinstance(node, dict):
            if ("up" in node and "down" in node
                    and isinstance(node["up"], dict) and "w" in node["up"]
                    and "gate" not in node):
                w = node["up"]["w"]
                prepared = ([prep_one(wg) for wg in w] if w.ndim == 3
                            else prep_one(w))
                return {**node, "up": {**node["up"], "dslot": prepared}}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return node

    return walk(params)
