"""Mixture-of-Experts layer: top-k router + capacity-based dispatch (port of
``repro.models.moe``).

Dispatch is scatter/gather based: each (token, choice) gets the slot
``expert * C + rank``, where ``rank`` is the token's arrival order within
the expert and ``C`` the per-expert capacity.  A choice past the capacity is
dropped for that expert (GShard/Switch semantics): its combine weight is
zero, so the residual path carries the token, and its scatter adds exact
zeros into the expert's last slot.  The expert FFN is one batched product
over (E, C, D), so expert flops scale with the active tokens only.

Dispatch is computed per data shard, as the reference does: with a mesh
installed (``models/pspec.py``) the tokens split into ``G = fsdp_size()``
groups when that divides the batch, each with its own capacity and arrival
ranks, so which choices drop depends on ``G``.  Without a mesh ``G = 1``
and dispatch is global.  Expert parallelism (``repro_torch.distributed.
expert_parallel``) reuses ``moe_block``'s dispatch and combine with the
expert FFN swapped for an exchange over the mesh.

Ties in the router's top-k go to the lower expert index, as
``jax.lax.top_k`` breaks them: the choice is a stable descending sort.  The
expert products accumulate in f32 (the entry points run under
``repro_torch.device.full_f32``) with outputs in the activation dtype, the
reference's ``preferred_element_type``.

Inside ``pspec.model_shard`` each expert's ``d_ff`` is split over the model
ranks (``up``/``gate`` column-parallel on the dispatched slots through "f",
``down`` row-parallel with "g"); the router, dispatch and combine stay
whole on every rank.
"""

from __future__ import annotations

import torch

from . import pspec
from .layers import Params, _matmul, matmul_f32, normal
from .mlp import _ACTS
from .pspec import fsdp_size, shard_mean

TOKEN_BLOCK = 4096      # tokens per dispatch block of a long prefill


def init_moe(cfg, gen, device) -> Params:
    dt = getattr(torch, cfg.dtype)
    E, D, F = cfg.n_experts, cfg.d_model, cfg.d_ff
    s = D ** -0.5
    p = {"router": normal(gen, (D, E), s, device, torch.float32),
         "up": normal(gen, (E, D, F), s, device, dt),
         "down": normal(gen, (E, F, D), F ** -0.5, device, dt)}
    if cfg.glu:
        p["gate"] = normal(gen, (E, D, F), s, device, dt)
    return p


def moe_capacity(cfg, n_tokens: int) -> int:
    per = n_tokens * cfg.top_k / cfg.n_experts
    cap = int(per * cfg.capacity_factor) + 1
    cap = max(cap, cfg.top_k)
    return -(-cap // 128) * 128   # 128-aligned, as the reference shards it


def apply_moe(p: Params, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux_loss), aux the Switch load-balancing loss.

    Decode steps (S == 1) use capacity T*K: dropless by construction.  A
    prefill of more than ``TOKEN_BLOCK`` tokens per data shard that divides
    into whole blocks streams through the experts block by block (dispatch
    buffers scale with the block, not the sequence); its aux is the mean
    over the blocks."""
    B, S, D = x.shape
    G = fsdp_size() if B % max(fsdp_size(), 1) == 0 else 1
    Tl = B * S // G
    flat = x.reshape(G, Tl, D)
    tb = min(Tl, TOKEN_BLOCK)
    nb = Tl // tb
    if nb > 1 and Tl % tb == 0 and S > 1:
        C = moe_capacity(cfg, tb)
        ys, auxs = zip(*[moe_block(p, flat[:, i * tb:(i + 1) * tb], cfg, C,
                                   mean=shard_mean) for i in range(nb)])
        return torch.cat(ys, dim=1).reshape(B, S, D), torch.stack(auxs).mean()
    C = Tl * cfg.top_k if S == 1 else moe_capacity(cfg, Tl)
    y, aux = moe_block(p, flat, cfg, C, mean=shard_mean)
    return y.reshape(B, S, D), aux


def route(p: Params, flat: torch.Tensor, cfg, C: int):
    """The router's dispatch plan for one block.  flat: (G, Tl, D).

    Returns (probs (G, Tl, E) f32, gate_vals (G, Tl, K) f32 renormalized,
    expert_idx (G, Tl, K) int64, keep (G, Tl, K) bool, slot (G, Tl, K)
    int64)."""
    G, Tl, D = flat.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = torch.matmul(flat.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)
    # top-k with ties to the lower index (jax.lax.top_k's order)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :K], expert_idx[..., :K]
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    # arrival order within each expert, over (token, choice) in row order;
    # the scan runs along the contiguous last axis: along the outer token
    # axis of (G, Tl*K, E), with only E columns, CUDA scans it serially
    choice = torch.nn.functional.one_hot(expert_idx, E).reshape(
        G, Tl * K, E).transpose(1, 2).contiguous()            # (G, E, Tl*K)
    ranks = torch.cumsum(choice, dim=-1) - choice
    rank = (ranks * choice).sum(dim=1).reshape(G, Tl, K)
    keep = rank < C
    slot = expert_idx * C + torch.clamp_max(rank, C - 1)
    return probs, gate_vals, expert_idx, keep, slot


def expert_ffn(p: Params, xb: torch.Tensor, cfg) -> torch.Tensor:
    """Every expert's FFN on its capacity slots: (G, E, C, D) -> same."""
    act = _ACTS[cfg.act]
    split = pspec.active_splits(cfg).moe
    if split:
        xb = pspec.copy_to_model(xb)
    up = _matmul(xb, p["up"], xb.dtype)
    h = act(_matmul(xb, p["gate"], xb.dtype)) * up if cfg.glu else act(up)
    if split:
        return pspec.reduce_from_model(matmul_f32(h, p["down"]), h.dtype)
    return _matmul(h, p["down"], h.dtype)


def moe_block(p: Params, flat: torch.Tensor, cfg, C: int, ffn=expert_ffn,
              mean=lambda t: t) -> tuple[torch.Tensor, torch.Tensor]:
    """One token block through the experts at capacity ``C``.  flat: (G,
    Tl, D).  ``ffn(p, xb (G, E, C, D), cfg) -> (G, E, C, D)`` is the expert
    FFN; ``mean`` turns the router's statistics averaged over these tokens
    into their average over every token of the batch (the identity when
    ``flat`` is the batch)."""
    G, Tl, D = flat.shape
    E, K = cfg.n_experts, cfg.top_k
    probs, gate_vals, expert_idx, keep, slot = route(p, flat, cfg, C)

    # load-balancing auxiliary loss (Switch eq. 4), global means
    me = mean(probs.mean(dim=(0, 1)))                             # (E,)
    onehot = torch.nn.functional.one_hot(expert_idx, E).to(torch.float32)
    ce = mean(onehot.sum(dim=2).mean(dim=(0, 1)))
    aux = E * (me * ce).sum() / K

    # dispatch: scatter-add into (G, E*C, D); dropped choices add zeros
    contrib = keep.to(flat.dtype)[..., None]
    src = (flat[:, :, None, :] * contrib).reshape(G, Tl * K, D)
    buf = torch.zeros((G, E * C, D), dtype=flat.dtype, device=flat.device)
    flat_slot = slot.reshape(G, Tl * K)
    for g in range(G):
        buf[g].index_add_(0, flat_slot[g], src[g])

    # expert FFN, batched over shards and experts
    yb = ffn(p, buf.reshape(G, E, C, D), cfg).reshape(G, E * C, D)

    # combine: gather each choice's expert output, weight by its gate
    gathered = torch.gather(
        yb, 1, flat_slot[..., None].expand(G, Tl * K, D)
    ).reshape(G, Tl, K, D)
    w = (gate_vals * keep).to(gathered.dtype)
    y = (gathered.to(torch.float32) * w.to(torch.float32)[..., None]
         ).sum(dim=2).to(gathered.dtype)
    return y, aux.to(torch.float32)
