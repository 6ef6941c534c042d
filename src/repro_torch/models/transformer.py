"""Block assembly: pattern-driven layer stacks (port of
``repro.models.transformer``).

A model is a sequence of blocks drawn from the config's ``block_pattern``
(tiled to ``n_layers``): "attn" (self-attention + MLP), "attn_cross" (adds
cross-attention, the enc-dec decoder), "moe" (attention + MoE FFN), "ssm"
(mamba2 mixer) and "rglru" (RG-LRU mixing + MLP).

``Stack`` keeps the reference's parameter layout: ``{"groups": [...],
"rest": [...]}``, where ``groups[pos]`` holds the layers at pattern
position ``pos`` of every group stacked on a leading axis, and layer
``g * period + pos`` is group ``g``'s entry.  The reference scans over the
groups; here a Python loop walks them.  Caches are a plain list, one per
layer in layer order (the reference stacks them like the parameters).
Decode writes attention rings in place (a multi-token chunk into a
sliding-window ring writes a copy, see ``attention_forward``); recurrent
states (``SSMState``, ``RGLRUState``) come back as new tensors, so a
caller's state changes only where it takes the returned one.  Statistics
recorded inside a group come out stacked over the groups, as the
reference's scan emits them, so consumers that average records weigh
groups and rest layers as the reference does.  Under ``cfg.remat`` a train
forward with grad enabled keeps only each group's input and recomputes the
group in the backward pass (the reference's ``jax.checkpoint`` with
``nothing_saveable``); the rest layers are not recomputed, as there.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from . import stats as model_stats
from .attention import (KVCache, attention_forward, init_attention,
                        init_kv_cache)
from .layers import Params, apply_norm, init_norm
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, init_moe
from .rglru import RGLRUState, apply_rglru, init_rglru
from .ssm import SSMState, _dims, apply_ssm, init_ssm


# ------------------------------------------------------------- single layer

def init_layer(cfg, gen, device, kind: str) -> Params:
    if kind == "ssm":
        return {"norm": init_norm(cfg, device),
                "mixer": init_ssm(cfg, gen, device)}
    if kind == "rglru":
        return {"norm1": init_norm(cfg, device),
                "mixer": init_rglru(cfg, gen, device),
                "norm2": init_norm(cfg, device),
                "mlp": init_mlp(cfg, gen, device)}
    if kind == "moe":
        return {"norm1": init_norm(cfg, device),
                "attn": init_attention(cfg, gen, device),
                "norm2": init_norm(cfg, device),
                "moe": init_moe(cfg, gen, device)}
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
    if kind == "ssm":
        d_inner, H, P, N, G = _dims(cfg)
        conv_ch = d_inner + 2 * G * N
        return SSMState(
            conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_ch), dtype=dtype,
                             device=device),
            ssm=torch.zeros((batch, H, P, N), dtype=torch.float32,
                            device=device))
    if kind == "rglru":
        w = cfg.rnn_width or cfg.d_model
        return RGLRUState(
            conv=torch.zeros((batch, 3, w), dtype=dtype, device=device),
            h=torch.zeros((batch, w), dtype=torch.float32, device=device))
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
                ) -> tuple[torch.Tensor, Any, torch.Tensor]:
    """Returns (x, new_cache, aux_loss).  ``mode`` is "train" (a plain
    forward), "prefill" (build the caches) or "decode" (run against
    ``cache``).  ``aux_loss`` is the MoE load-balancing loss, 0 for the
    other kinds.  ``q_valid``: (B, S) bool for ragged batches — pad rows
    skip the KV-ring write (see ``attention_forward``) and are exact
    identity steps of the recurrent mixers (``apply_ssm``,
    ``apply_rglru``), so carried state only advances past real tokens."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return_cache = mode == "prefill"
    use_cache = mode == "decode"

    if kind == "ssm":
        h, new_state = apply_ssm(p["mixer"], apply_norm(p["norm"], x, cfg),
                                 cfg, state=cache if use_cache else None,
                                 return_state=return_cache or use_cache,
                                 q_valid=q_valid)
        return x + h, new_state, aux

    if kind == "rglru":
        h, new_state = apply_rglru(p["mixer"], apply_norm(p["norm1"], x, cfg),
                                   cfg, state=cache if use_cache else None,
                                   return_state=return_cache or use_cache,
                                   q_valid=q_valid)
        x = x + h
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
        return x, new_state, aux

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
        return x, (new_self, cross_cache), aux

    # attn / moe
    h, new_cache = attention_forward(
        p["attn"], apply_norm(p["norm1"], x, cfg), cfg, positions=positions,
        cache=cache if use_cache else None, causal=causal,
        return_cache=return_cache, cache_len=cache_len, q_valid=q_valid)
    x = x + h
    if kind == "moe":
        h, aux = apply_moe(p["moe"], apply_norm(p["norm2"], x, cfg), cfg)
    else:
        h = apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x + h, new_cache, aux


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
        """Returns (x, new_caches, aux): for "prefill" and "decode" one cache
        per layer in layer order (decode's attention rings are ``caches``'
        own, written in place), for "train" an empty list; ``aux`` is the
        layers' summed MoE loss, group by group as the reference sums its
        scan."""
        cfg = self.cfg
        new_caches = []
        kw = dict(enc_out=enc_out, mode=mode, causal=self.causal,
                  cache_len=cache_len, q_valid=q_valid)

        def layer(lp, x, kind, i):
            c = None if caches is None else caches[i]
            x, nc, aux = apply_layer(lp, x, cfg, kind, positions=positions,
                                     cache=c, **kw)
            if mode != "train":
                new_caches.append(nc)
            return x, aux

        def group_body(x, g):
            aux_g = torch.zeros((), dtype=torch.float32, device=x.device)
            with model_stats.collect() as sink:
                for pos, kind in enumerate(self.pattern):
                    x, aux = layer(_index(p["groups"][pos], g), x, kind,
                                   g * self.period + pos)
                    aux_g = aux_g + aux
            return x, aux_g, sink

        body = group_body
        if cfg.remat and mode == "train" and torch.is_grad_enabled():
            # jax.checkpoint(group_body, nothing_saveable): keep only the
            # group's input and recompute the rest in the backward pass.
            # The recompute records its statistics into a sink of its own,
            # which is dropped, so each group's records and aux count once.
            # The model draws no random numbers, so no RNG state is kept.
            def body(x, g):
                return torch.utils.checkpoint.checkpoint(
                    group_body, x, g, use_reentrant=False,
                    preserve_rng_state=False)

        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        sinks, group_aux = [], []
        for g in range(self.n_groups):
            x, aux_g, sink = body(x, g)
            sinks.append(sink)
            group_aux.append(aux_g)
        if group_aux:
            aux_total = aux_total + torch.stack(group_aux).sum()
        # one record per (name, call) with a leading group axis — the shape
        # the reference's scan gives its stacked outputs
        for name, vals in (sinks[0].items() if sinks else ()):
            for i in range(len(vals)):
                model_stats.record(name, torch.stack(
                    [s[name][i] for s in sinks]))

        for i, kind in enumerate(self.rest_kinds):
            x, aux = layer(p["rest"][i], x, kind,
                           self.n_groups * self.period + i)
            aux_total = aux_total + aux
        return x, new_caches, aux_total
