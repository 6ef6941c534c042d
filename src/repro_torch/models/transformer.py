"""Block assembly: pattern-driven layer stacks (port of
``repro.models.transformer``, for the layer kinds ``attn`` and
``attn_cross``).

A model is a sequence of blocks drawn from the config's ``block_pattern``
(tiled to ``n_layers``): "attn" (self-attention + MLP) and "attn_cross"
(adds cross-attention, the enc-dec decoder).  The kinds "moe", "ssm" and
"rglru" belong to later slices of the port and raise
``NotImplementedError``.

``Stack`` keeps the reference's parameter layout: ``{"groups": [...],
"rest": [...]}``, where ``groups[pos]`` holds the layers at pattern
position ``pos`` of every group stacked on a leading axis, and layer
``g * period + pos`` is group ``g``'s entry.  The reference scans over the
groups; here a Python loop walks them.  Caches are a plain list, one per
layer in layer order (the reference stacks them like the parameters), and
decode writes them in place.  Statistics recorded inside a group come out
stacked over the groups, as the reference's scan emits them, so consumers
that average records weigh groups and rest layers as the reference does.
"""

from __future__ import annotations

from typing import Any

import torch

from . import stats as model_stats
from .attention import (KVCache, attention_forward, check_supported,
                        init_attention, init_kv_cache)
from .layers import Params, apply_norm, init_norm
from .mlp import apply_mlp, init_mlp

KINDS = ("attn", "attn_cross")


def _check_kind(cfg, kind: str) -> None:
    if kind not in KINDS:
        raise NotImplementedError(
            f"{cfg.name}: layer kind {kind!r} is not ported yet (this slice "
            f"of the port has {', '.join(KINDS)}; moe, ssm and rglru come "
            "in later slices)")
    check_supported(cfg)


# ------------------------------------------------------------- single layer

def init_layer(cfg, gen, device, kind: str) -> Params:
    _check_kind(cfg, kind)
    if kind == "attn_cross":
        return {"norm1": init_norm(cfg, device),
                "attn": init_attention(cfg, gen, device),
                "normx": init_norm(cfg, device),
                "cross": init_attention(cfg, gen, device, cross=True),
                "norm2": init_norm(cfg, device),
                "mlp": init_mlp(cfg, gen, device)}
    return {"norm1": init_norm(cfg, device),
            "attn": init_attention(cfg, gen, device),
            "norm2": init_norm(cfg, device),
            "mlp": init_mlp(cfg, gen, device)}


def init_layer_cache(cfg, kind: str, batch: int, seq_len: int, enc_len: int,
                     dtype, device) -> Any:
    _check_kind(cfg, kind)
    self_cache = init_kv_cache(cfg, batch, seq_len, dtype, device)
    if kind == "attn_cross":
        shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim_)
        pos = torch.arange(enc_len, dtype=torch.int32, device=device)
        cross = KVCache(
            k=torch.zeros(shape, dtype=dtype, device=device),
            v=torch.zeros(shape, dtype=dtype, device=device),
            positions=pos[None].expand(batch, enc_len).contiguous())
        return (self_cache, cross)
    return self_cache


def apply_layer(p: Params, x: torch.Tensor, cfg, kind: str, *,
                positions: torch.Tensor, cache: Any = None,
                enc_out: torch.Tensor | None = None, mode: str = "train",
                causal: bool = True, cache_len: int | None = None,
                q_valid: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, Any]:
    """Returns (x, new_cache).  ``mode`` is "train" (a plain forward),
    "prefill" (build the caches) or "decode" (run against ``cache``).
    ``q_valid``: (B, S) bool for ragged batches — pad rows skip the KV-ring
    write (see ``attention_forward``)."""
    _check_kind(cfg, kind)
    return_cache = mode == "prefill"
    use_cache = mode == "decode"

    if kind == "attn_cross":
        self_cache, cross_cache = cache if cache is not None else (None, None)
        h, new_self = attention_forward(
            p["attn"], apply_norm(p["norm1"], x, cfg), cfg,
            positions=positions, cache=self_cache if use_cache else None,
            causal=causal, return_cache=return_cache, cache_len=cache_len,
            q_valid=q_valid)
        x = x + h
        if use_cache:
            h, cross_cache = attention_forward(
                p["cross"], apply_norm(p["normx"], x, cfg), cfg,
                positions=positions, cache=cross_cache, is_cross=True,
                causal=False)
        else:
            h, cross_cache = attention_forward(
                p["cross"], apply_norm(p["normx"], x, cfg), cfg,
                positions=positions, kv_x=enc_out, causal=False,
                return_cache=return_cache)
        x = x + h
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
        return x, (new_self, cross_cache)

    h, new_cache = attention_forward(
        p["attn"], apply_norm(p["norm1"], x, cfg), cfg, positions=positions,
        cache=cache if use_cache else None, causal=causal,
        return_cache=return_cache, cache_len=cache_len, q_valid=q_valid)
    x = x + h
    return x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg), \
        new_cache


# ------------------------------------------------------------- layer stacks

def _index(tree, g: int):
    """Group ``g``'s layer from stacked params: tensors are sliced on their
    leading axis, and a list (prepared DSLOT state, one per layer) is
    indexed."""
    if isinstance(tree, dict):
        return {k: _index(v, g) for k, v in tree.items()}
    if isinstance(tree, (torch.Tensor, list)):
        return tree[g]
    return tree


def _stack(trees: list):
    """Stack layers' params on a new leading axis (the inverse of
    ``_index``)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


class Stack:
    """Pattern-tiled stack of layers, walked group by group."""

    def __init__(self, cfg, pattern: tuple[str, ...], n_layers: int,
                 causal: bool = True):
        self.cfg = cfg
        self.n_layers = n_layers
        self.causal = causal
        # one group covers `scan_unroll` pattern periods, as in the
        # reference, so the parameter layout is the same
        unroll = max(1, cfg.scan_unroll)
        self.pattern = tuple(pattern) * unroll
        self.period = len(self.pattern)
        if cfg.scan_layers and n_layers >= 2 * self.period:
            self.n_groups = n_layers // self.period
            self.n_rest = n_layers % self.period
        else:
            self.n_groups = 0
            self.n_rest = n_layers

    @property
    def kinds(self) -> tuple[str, ...]:
        """Every layer's kind, in layer order."""
        full = self.pattern * (-(-self.n_layers // self.period))
        return full[:self.n_layers]

    @property
    def rest_kinds(self) -> tuple[str, ...]:
        return self.kinds[self.n_groups * self.period:]

    def init(self, gen, device) -> Params:
        p: Params = {"groups": [], "rest": []}
        for pos in range(self.period if self.n_groups else 0):
            kind = self.pattern[pos]
            p["groups"].append(_stack([
                init_layer(self.cfg, gen, device, kind)
                for _ in range(self.n_groups)]))
        for kind in self.rest_kinds:
            p["rest"].append(init_layer(self.cfg, gen, device, kind))
        return p

    def init_cache(self, batch: int, seq_len: int, enc_len: int, dtype,
                   device) -> list:
        """Empty caches, one per layer in layer order."""
        return [init_layer_cache(self.cfg, kind, batch, seq_len, enc_len,
                                 dtype, device) for kind in self.kinds]

    def apply(self, p: Params, x: torch.Tensor, *, positions, caches=None,
              enc_out=None, mode: str = "train", cache_len: int | None = None,
              q_valid: torch.Tensor | None = None):
        """Returns (x, new_caches): for "prefill" and "decode" one cache per
        layer in layer order (decode's are ``caches``, written in place),
        for "train" an empty list."""
        cfg = self.cfg
        new_caches = []
        kw = dict(enc_out=enc_out, mode=mode, causal=self.causal,
                  cache_len=cache_len, q_valid=q_valid)

        def layer(lp, x, kind, i):
            c = None if caches is None else caches[i]
            x, nc = apply_layer(lp, x, cfg, kind, positions=positions,
                                cache=c, **kw)
            if mode != "train":
                new_caches.append(nc)
            return x

        sinks = []
        for g in range(self.n_groups):
            with model_stats.collect() as sink:
                for pos, kind in enumerate(self.pattern):
                    x = layer(_index(p["groups"][pos], g), x, kind,
                              g * self.period + pos)
            sinks.append(sink)
        # one record per (name, call) with a leading group axis — the shape
        # the reference's scan gives its stacked outputs
        for name, vals in (sinks[0].items() if sinks else ()):
            for i in range(len(vals)):
                model_stats.record(name, torch.stack(
                    [s[name][i] for s in sinks]))

        for i, kind in enumerate(self.rest_kinds):
            x = layer(p["rest"][i], x, kind, self.n_groups * self.period + i)
        return x, new_caches
