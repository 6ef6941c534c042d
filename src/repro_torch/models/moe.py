"""Mixture-of-Experts layer: top-k router + capacity-based dispatch (port of
``repro.models.moe``).

Dispatch is scatter/gather based: each (token, choice) gets the slot
``expert * C + rank``, where ``rank`` is the token's arrival order within
the expert and ``C`` the per-expert capacity.  A choice past the capacity is
dropped for that expert (GShard/Switch semantics): its combine weight is
zero, so the residual path carries the token, and its scatter adds exact
zeros into the expert's last slot.  The expert FFN is one batched product
over (E, C, D), so expert flops scale with the active tokens only.

The reference computes dispatch per data shard of its mesh (``G =
fsdp_size()`` shards, ``pspec.constrain`` placing each buffer).  The port
has no mesh yet: ``constrain`` is a no-op and ``fsdp_size()`` is 1, so
``G = 1`` here and dispatch is global, which is the reference's semantics
without a mesh.  Expert parallelism comes with the mesh slice.

Ties in the router's top-k go to the lower expert index, as
``jax.lax.top_k`` breaks them: the choice is a stable descending sort.  The
expert products accumulate in f32 (the entry points run under
``repro_torch.device.full_f32``) with outputs in the activation dtype, the
reference's ``preferred_element_type``.
"""

from __future__ import annotations

import torch

from .layers import Params, _matmul, normal
from .mlp import _ACTS

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
    prefill of more than ``TOKEN_BLOCK`` tokens that divides into whole
    blocks streams through the experts block by block (dispatch buffers
    scale with the block, not the sequence); its aux is the mean over the
    blocks."""
    B, S, D = x.shape
    T = B * S
    flat = x.reshape(1, T, D)              # G = 1: no mesh (module doc)
    tb = min(T, TOKEN_BLOCK)
    nb = T // tb
    if nb > 1 and T % tb == 0 and S > 1:
        ys, auxs = zip(*[_moe_block(p, flat[:, i * tb:(i + 1) * tb], cfg, S)
                         for i in range(nb)])
        return torch.cat(ys, dim=1).reshape(B, S, D), torch.stack(auxs).mean()
    y, aux = _moe_block(p, flat, cfg, S)
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


def _moe_block(p: Params, flat: torch.Tensor, cfg, S: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One token block through the experts.  flat: (G, Tl, D)."""
    G, Tl, D = flat.shape
    E, K = cfg.n_experts, cfg.top_k
    act = _ACTS[cfg.act]
    C = Tl * K if S == 1 else moe_capacity(cfg, Tl)
    probs, gate_vals, expert_idx, keep, slot = route(p, flat, cfg, C)

    # load-balancing auxiliary loss (Switch eq. 4), global means
    me = probs.mean(dim=(0, 1))                                   # (E,)
    onehot = torch.nn.functional.one_hot(expert_idx, E).to(torch.float32)
    ce = onehot.sum(dim=2).mean(dim=(0, 1))
    aux = E * (me * ce).sum() / K

    # dispatch: scatter-add into (G, E*C, D); dropped choices add zeros
    contrib = keep.to(flat.dtype)[..., None]
    src = (flat[:, :, None, :] * contrib).reshape(G, Tl * K, D)
    buf = torch.zeros((G, E * C, D), dtype=flat.dtype, device=flat.device)
    flat_slot = slot.reshape(G, Tl * K)
    for g in range(G):
        buf[g].index_add_(0, flat_slot[g], src[g])
    xb = buf.reshape(G, E, C, D)

    # expert FFN, batched over shards and experts
    up = _matmul(xb, p["up"], xb.dtype)
    h = act(_matmul(xb, p["gate"], xb.dtype)) * up if cfg.glu else act(up)
    yb = _matmul(h, p["down"], h.dtype).reshape(G, E * C, D)

    # combine: gather each choice's expert output, weight by its gate
    gathered = torch.gather(
        yb, 1, flat_slot[..., None].expand(G, Tl * K, D)
    ).reshape(G, Tl, K, D)
    w = (gate_vals * keep).to(gathered.dtype)
    y = (gathered.to(torch.float32) * w.to(torch.float32)[..., None]
         ).sum(dim=2).to(gathered.dtype)
    return y, aux.to(torch.float32)
