"""Gradient compression with error feedback (port of
``repro.distributed.compression``).

For a gradient reduction over slow links (across pods in the reference's
mesh):

* ``int8_compress`` — per-tensor symmetric int8 quantization (8x smaller
  payload than f32) with an error-feedback residual, so the quantization
  noise is unbiased over steps.
* ``topk_compress`` — magnitude top-k sparsification (k as a fraction of
  each tensor), the residual accumulating the dropped mass.

Both return ``(payload, state)``; the payloads are linear, so
``all_reduce(payload)`` then decompress approximates ``all_reduce(grads)``.
The arithmetic is the reference's, in f32.  As in the reference, nothing on
the training path calls these functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["EFState", "compressed_ratio", "init_ef_state", "int8_compress",
           "int8_decompress", "topk_compress", "topk_decompress"]


class EFState(NamedTuple):
    """Per-tensor error-feedback residuals (a tree shaped like the
    gradients)."""
    residual: dict


def init_ef_state(grads) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads))


def _unzip(out, n: int) -> list:
    """A tree whose leaves are n-tuples as n trees."""
    return [_pick(out, i) for i in range(n)]


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, i) for v in tree]
    if hasattr(tree, "_fields"):
        return type(tree)(*(_pick(v, i) for v in tree))
    return tree[i]


# ----------------------------------------------------------------- int8

def int8_compress(grads, ef: EFState):
    """-> ((q int8 tree, scale tree), new_ef).  q * scale ~= g + residual."""
    def one(g, r):
        x = g.to(torch.float32) + r
        scale = torch.clamp_min(x.abs().max(), 1e-12) / 127.0
        q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
        err = x - q.to(torch.float32) * scale
        return q, scale, err

    q, scale, err = _unzip(tree_map(one, grads, ef.residual), 3)
    return (q, scale), EFState(residual=err)


def int8_decompress(payload):
    q, scale = payload
    return tree_map(lambda qq, s: qq.to(torch.float32) * s, q, scale)


# ----------------------------------------------------------------- top-k

def topk_compress(grads, ef: EFState, frac: float = 0.01):
    """Keep the top ``frac`` fraction of entries by magnitude (per tensor);
    -> ((values, indices) tree, new_ef)."""
    def one(g, r):
        x = (g.to(torch.float32) + r).reshape(-1)
        k = max(1, int(x.numel() * frac))
        _, idx = torch.topk(x.abs(), k)
        kept = x[idx]
        err = x.clone()
        err[idx] = 0.0
        return kept, idx.to(torch.int32), err.reshape(g.shape)

    vals, idx, err = _unzip(tree_map(one, grads, ef.residual), 3)
    return (vals, idx), EFState(residual=err)


def topk_decompress(payload, like):
    vals, idx = payload

    def one(v, i, g):
        flat = torch.zeros(g.numel(), dtype=torch.float32, device=v.device)
        flat[i.to(torch.int64)] = v
        return flat.reshape(g.shape)

    return tree_map(one, vals, idx, like)


def compressed_ratio(grads, payload) -> float:
    """Payload bytes / raw f32 bytes: the wire saving."""
    raw = sum(g.numel() * 4 for g in leaves(grads))
    comp = sum(x.numel() * x.element_size() for x in leaves(payload))
    return comp / max(raw, 1)
