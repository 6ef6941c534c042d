"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427]
(port of ``repro.models.rglru``).

    r_t = sigmoid(W_a u_t + b_a)          (recurrence gate)
    i_t = sigmoid(W_x u_t + b_x)          (input gate)
    a_t = exp(-c * softplus(Λ) * r_t)     (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t²) · (i_t ⊙ u_t)

The block is Griffin's recurrent temporal-mixing block: linear in, causal
conv1d (k = 4), RG-LRU, times a GeLU gate branch, linear out.

The reference evaluates the linear recurrence with
``jax.lax.associative_scan``.  Here it is a log-depth doubling scan over the
sequence (``linear_scan``): ceil(log2 S) steps of whole-tensor ops, not S
small launches.  Both compose the same pairs, but in another tree, so f32
results differ from the reference's by rounding (about 1e-6 relative).
Decode is the O(1) per-token update.

Inside ``pspec.model_shard``, where the model ranks divide the width W
(``pspec.splits``), each rank computes W/n of it: its columns of
``w_in``, ``w_gate``, ``wa`` and ``wx``, its conv channels and biases,
the scan over its width and ``w_out``'s rows ("g").  The gates' dense
(W, W) products read the whole conv output ``u``, gathered over the ranks
(``pspec.gather_over_model``).  The decode state is the rank's: ``h`` (B,
W/n) and ``conv`` (B, 3, W/n).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import pspec
from .layers import Params, _matmul, matmul_f32, normal
from .mlp import _gelu
from .ssm import _causal_conv, softplus

_C = 8.0


class RGLRUState(NamedTuple):
    conv: torch.Tensor    # (B, k-1, d_rnn)
    h: torch.Tensor       # (B, d_rnn) f32


def _width(cfg) -> int:
    return cfg.rnn_width or cfg.d_model


def init_rglru(cfg, gen, device) -> Params:
    dt = getattr(torch, cfg.dtype)
    d, w = cfg.d_model, _width(cfg)
    s = d ** -0.5

    def f32(value):
        return torch.full((w,), value, dtype=torch.float32, device=device)

    return {
        "w_in": normal(gen, (d, w), s, device, dt),
        "w_gate": normal(gen, (d, w), s, device, dt),
        "conv_w": normal(gen, (4, w), 0.2, device, dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "wa": normal(gen, (w, w), w ** -0.5, device, dt),
        "wx": normal(gen, (w, w), w ** -0.5, device, dt),
        "ba": f32(0.0),
        "bx": f32(0.0),
        "lam": f32(0.5),
        "w_out": normal(gen, (w, d), w ** -0.5, device, dt),
    }


def _gates(p: Params, u: torch.Tensor, u_all: torch.Tensor):
    """(a, b) of the recurrence over ``u``'s width, the gates' products
    reading ``u_all``: ``u`` itself, or every rank's ``u`` under the
    split."""
    uf = u.to(torch.float32)
    ua = u_all.to(torch.float32)
    r = torch.sigmoid(torch.matmul(ua, p["wa"].to(torch.float32)) + p["ba"])
    i = torch.sigmoid(torch.matmul(ua, p["wx"].to(torch.float32)) + p["bx"])
    a = torch.exp(-_C * softplus(p["lam"]) * r)          # (B, S, W)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * uf)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t from h_0 = 0 along axis 1, as a doubling
    (Hillis-Steele) scan: at offset d every position composes the pair d
    steps back, ``(a1, b1) then (a2, b2) = (a1 a2, a2 b1 + b2)``."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def apply_rglru(p: Params, x: torch.Tensor, cfg,
                state: RGLRUState | None = None,
                return_state: bool = False,
                q_valid: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, RGLRUState | None]:
    """x: (B, S, d_model) -> (B, S, d_model).

    ``q_valid`` (B, S) bool marks ragged rows right-padded to S.  Pad
    positions become exact identity elements of the recurrence, ``(a, b) =
    (1, 0)``, so carried state passes through them unchanged.  The gates
    are masked, not ``r`` alone: ``r = 0`` gives ``a = 1`` but ``b =
    sqrt(max(1 - a², 1e-12)) · (i ⊙ u) ≠ 0``.  The conv tail gathers each
    row's last valid inputs.  Pad rows' outputs are garbage.  Inside
    ``pspec.model_shard`` where the ranks divide the width, the rank's
    width (module docstring).
    """
    split = pspec.active_splits(cfg).rglru
    if split:
        x = pspec.copy_to_model(x)
    gate = _gelu(_matmul(x, p["w_gate"], x.dtype))
    u = _matmul(x, p["w_in"], x.dtype)
    lengths = None if q_valid is None \
        else q_valid.to(torch.int32).sum(dim=1)
    u, new_tail = _causal_conv(u, p["conv_w"], p["conv_b"],
                               state.conv if state is not None else None,
                               lengths=lengths)
    a, b = _gates(p, u, pspec.gather_over_model(u, -1) if split else u)
    if q_valid is not None:
        valid = q_valid[..., None]
        a = torch.where(valid, a, 1.0)
        b = torch.where(valid, b, 0.0)

    if x.shape[1] == 1 and state is not None:
        h = a[:, 0] * state.h + b[:, 0]
        hs = h[:, None]
    else:
        if state is not None:
            # fold the initial state into the first step: h_1 = a_1 h_0 + b_1
            b = torch.cat([b[:, :1] + a[:, :1] * state.h[:, None], b[:, 1:]],
                          dim=1)
        hs = linear_scan(a, b)
        h = hs[:, -1]

    y = (hs * gate.to(hs.dtype)).to(x.dtype)
    if split:
        out = pspec.reduce_from_model(matmul_f32(y, p["w_out"]), x.dtype)
    else:
        out = _matmul(y, p["w_out"], x.dtype)
    new_state = RGLRUState(conv=new_tail, h=h) if return_state else None
    return out, new_state
