"""Expert-parallel MoE dispatch with ``all_to_all`` (port of
``repro.distributed.expert_parallel``).

Each of the ``ep`` ranks of the mesh axis holds ``E / ep`` experts; tokens
are routed with two exchanges:

    tokens -> [all_to_all] -> expert-local FFN -> [all_to_all back] -> combine

which trades the expert weights' all-gather for activation-sized traffic.

The tokens a rank is given are replicated across the expert axis (every
rank of ``axis`` holds the same tokens) and are its shard along the batch
axes ("pod", "data").  Routing, capacity ranks, the (E, C, D) dispatch
buffer and the combine are ``models.moe.moe_block``'s on the rank's own
tokens; only the expert FFN changes: the buffer's expert axis is exchanged
with ``all_to_all_single`` over the axis's group, so each rank holds its
experts' slots from every source rank, runs its experts, and the inverse
exchange returns the outputs.  The load-balancing loss averages its router
statistics over the batch axes.

The capacity rule is the reference's ``apply_moe_ep``'s, not its
``apply_moe``'s: one capacity ``moe_capacity(cfg, B * S)`` over all of the
rank's tokens, at a decode step (S == 1) too, and no token blocks.  So
``apply_moe_ep`` equals ``apply_moe`` where neither drops a choice, or
where both set the same capacity (a prefill of at most ``moe.TOKEN_BLOCK``
tokens per batch shard); a decode step can drop here where ``apply_moe`` is
dropless, and a longer prefill drops by one capacity where ``apply_moe``
gives each block its own.

Per-expert plane budgets (``expert_planes``): each expert's input
activations are truncated to that expert's most significant
``expert_planes[e]`` digit planes (MSDF order) before its FFN runs.  Each
rank truncates only its own experts, after the first exchange.  Budgets
``>= n_bits`` are exact no-ops.
"""

from __future__ import annotations

import torch

from repro_torch.distributed import (all_reduce_mean, all_to_all,
                                     axis_rank, axis_size)
from repro_torch.models import moe

__all__ = ["apply_moe_ep"]


def _truncate_planes(xb: torch.Tensor, planes: torch.Tensor, n_bits: int
                     ) -> torch.Tensor:
    """Keep each local expert's top ``planes[e]`` MSDF digit planes of its
    (C, D) input slice.  ``planes >= n_bits`` rows pass through untouched
    (bit-exact): the selection below takes the raw input, so quantization
    round-off never reaches full-budget experts."""
    qmax = float(2 ** (n_bits - 1) - 1)
    amax = torch.clamp_min(xb.abs().amax(dim=(1, 2)), 1e-12)     # (E/ep,)
    step = (amax / qmax)[:, None, None]
    q = torch.clamp(torch.round(xb / step), -qmax, qmax).to(torch.int32)
    shift = torch.clamp(n_bits - planes.to(torch.int32), 0, n_bits)
    shift = shift[:, None, None]
    kept = (q.abs() >> shift) << shift
    xq = (torch.sign(q) * kept).to(xb.dtype) * step
    return torch.where((planes < n_bits)[:, None, None], xq, xb)


def apply_moe_ep(p, x: torch.Tensor, cfg, mesh, axis: str = "model",
                 expert_planes=None, n_bits: int = 8
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE forward on this rank's tokens.

    ``p``: the MoE params with all ``E`` experts (``init_moe``'s layout);
    this rank uses its own ``E / ep`` of them.  ``x``: (B, S, D), this
    rank's batch shard, the same on every rank of ``axis``.  Requires
    ``E % mesh[axis] == 0``.  Returns ``(y, aux)`` like ``apply_moe``.

    ``expert_planes``: optional (E,) per-expert digit-plane budget (module
    docstring); entries ``>= n_bits`` are exact no-ops.
    """
    E = cfg.n_experts
    ep = axis_size(mesh, axis)
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} ranks of "
                         f"mesh axis {axis!r}")
    El = E // ep
    j = axis_rank(mesh, axis)
    own = slice(j * El, (j + 1) * El)
    planes = torch.full((E,), n_bits, dtype=torch.int32, device=x.device) \
        if expert_planes is None else torch.as_tensor(
            expert_planes, dtype=torch.int32, device=x.device)
    if planes.shape != (E,):
        raise ValueError(f"expert_planes must be ({E},), got "
                         f"{tuple(planes.shape)}")
    local = {k: v[own] for k, v in p.items() if k != "router"}
    batch_axes = [a for a in ("pod", "data") if a in mesh.mesh_dim_names]

    def exchanged_ffn(_, xb, cfg):
        # (1, E, C, D) -> (ep, E/ep, C, D): block j goes to rank j, and each
        # rank gets its E/ep experts' slots from every source rank
        _, _, C, D = xb.shape
        xb = all_to_all(xb.reshape(ep, El, C, D), mesh, axis)
        xb = xb.transpose(0, 1).reshape(El, ep * C, D)
        xb = _truncate_planes(xb, planes[own], n_bits)
        yb = moe.expert_ffn(local, xb[None], cfg)[0]
        yb = yb.reshape(El, ep, C, D).transpose(0, 1)
        return all_to_all(yb, mesh, axis).reshape(1, E, C, D)

    def batch_mean(t):
        # router statistics of this rank's tokens -> of the whole batch
        for a in batch_axes:
            t = all_reduce_mean(t, mesh, a)
        return t

    B, S, D = x.shape
    y, aux = moe.moe_block(p, x.reshape(1, B * S, D), cfg,
                           moe.moe_capacity(cfg, B * S), exchanged_ffn,
                           batch_mean)
    return y.reshape(B, S, D), aux
