"""Shared model layers: norms, rotary embeddings, token embedding, heads
(port of ``repro.models.layers``).

Parameters are plain nested dicts of tensors.  Initializers draw from a
``torch.Generator`` on the generator's own device (a CUDA generator draws on
the card) and place the result on ``device``; every layer has a pure
``apply`` function.

Inside ``pspec.model_shard`` (the sharded train step) the embedding and the
head are vocab-parallel where ``pspec.splits`` says the vocab divides: the
rank holds rows ``r * V/n ..`` of the embedding (and those columns of an
untied head), looks up only the tokens in its slice, and produces only its
slice of the logits (``model_zoo.loss_fn`` reduces over the slices).
"""

from __future__ import annotations

import torch

from . import pspec

Params = dict


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: torch.Generator, shape, scale: float, device, dtype
           ) -> torch.Tensor:
    """N(0, scale^2) in f32 from ``gen``, cast to ``dtype`` on ``device``."""
    w = torch.randn(shape, generator=gen, device=gen.device) * scale
    return w.to(device, dtype)


# ---------------------------------------------------------------- norms

def init_norm(cfg, device) -> Params:
    if cfg.norm == "nonparam_ln":
        return {}                       # OLMo: no scale / bias
    ones = torch.ones((cfg.d_model,), dtype=torch.float32, device=device)
    if cfg.norm == "layernorm":
        return {"scale": ones, "bias": torch.zeros_like(ones)}
    return {"scale": ones}


def apply_norm(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Statistics in f32, elementwise normalize in the residual dtype."""
    xf = x.to(torch.float32)
    if cfg.norm == "rmsnorm":
        r = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + 1e-6)
        return x * r.to(x.dtype) * p["scale"].to(x.dtype)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    r = torch.rsqrt(var + 1e-6)
    out = (x - mu.to(x.dtype)) * r.to(x.dtype)
    if cfg.norm == "layernorm":
        out = out * p["scale"].to(x.dtype) + p["bias"].to(x.dtype)
    return out


# ---------------------------------------------------------------- rotary

def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, H, D) with positions (..., S) int32."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs     # (..., S, D/2)
    angles = angles[..., None, :]                               # (..., S, 1, D/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xf1 = x[..., : d // 2].to(torch.float32)
    xf2 = x[..., d // 2:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- embeddings

def init_embedding(cfg, gen, device) -> Params:
    return {"embedding": normal(gen, (cfg.vocab_size, cfg.d_model),
                                cfg.d_model ** -0.5, device, _dtype(cfg))}


def embed_tokens(p: Params, tokens: torch.Tensor, cfg) -> torch.Tensor:
    table = p["embedding"]
    if not pspec.active_splits(cfg).vocab:
        return table[tokens]
    # vocab-parallel: this rank's rows, zeros for tokens outside its slice,
    # then the sum over the ranks (one nonzero term: exact)
    lo = pspec.tp_rank() * table.shape[0]
    local = tokens - lo
    mine = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(mine, local, 0)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                          device=rows.device))
    return pspec.reduce_from_model(rows, table.dtype)


def init_lm_head(cfg, gen, device) -> Params:
    if cfg.tie_embeddings:
        return {}
    return {"w": normal(gen, (cfg.d_model, cfg.vocab_size),
                        cfg.d_model ** -0.5, device, _dtype(cfg))}


def lm_logits(head: Params, embed: Params, x: torch.Tensor, cfg,
              gather: bool = False) -> torch.Tensor:
    """Logits in the residual dtype (f32 accumulation inside the product);
    inside ``pspec.model_shard`` with the vocab split, this rank's slice of
    them (a column-parallel product), or with ``gather`` (serving) every
    rank's slices gathered to the full vocab (exact: no sum), so every rank
    samples the same token."""
    w = embed["embedding"].t() if cfg.tie_embeddings else head["w"]
    if not pspec.active_splits(cfg).vocab:
        return _matmul(x, w, x.dtype)
    logits = _matmul(pspec.copy_to_model(x), w, x.dtype)
    return pspec.model_gather(logits, dim=-1) if gather else logits


# ---------------------------------------------------------------- dense

def init_dense(gen, d_in: int, d_out: int, dtype, device, bias: bool = False
               ) -> Params:
    p = {"w": normal(gen, (d_in, d_out), d_in ** -0.5, device, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def _matmul(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype
            ) -> torch.Tensor:
    """``x @ w`` in the promoted type of both, output in ``out_dtype``: the
    reference's ``preferred_element_type``.  The product accumulates in f32
    where the caller pins it (``Model``'s entry points run under
    ``repro_torch.device.full_f32``), like the reference's."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(ct), w.to(ct)).to(out_dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` with both cast to f32 and the product left in f32: a
    row-parallel product's partial sum, which ``pspec.reduce_from_model``
    adds over the ranks before the one rounding to the value dtype."""
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def row_parallel(p: Params, x: torch.Tensor) -> torch.Tensor:
    """A dense layer whose input features (``p["w"]``'s rows, ``x``'s last
    axis) are split over the ``model_shard`` ranks: the ranks' partial
    products summed ("g") and rounded once to the weight's dtype, then the
    bias, added once."""
    y = pspec.reduce_from_model(matmul_f32(x, p["w"]), p["w"].dtype)
    if "b" in p:
        y = y + p["b"]
    return y


def apply_dense(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Output in the weight's dtype, like the reference."""
    y = _matmul(x, p["w"], p["w"].dtype)
    if "b" in p:
        y = y + p["b"]
    return y
