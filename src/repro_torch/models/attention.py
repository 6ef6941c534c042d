"""Attention: GQA/MQA, full-causal, sliding-window/local and cross,
flash-style (port of ``repro.models.attention``).

Plain PyTorch that follows the reference's arithmetic: f32 scores, bf16
(the value dtype) probabilities into the PV product with f32 accumulation,
and a running-max online softmax over KV chunks, so scores are never
materialized for the whole sequence.  The sliding-window path also chunks
the query axis and slices only the in-window KV span of each chunk.  No
library attention kernel is used, so CPU results keep the reference's
rounding.

Decode uses a ring-buffer KV cache: slot = position % capacity, with an
explicit per-row position array (-1 = empty) for exact masking.  Full
attention uses capacity = seq_len (no wraparound); SWA uses capacity =
window.  Decode writes the ring in place, where the reference returns a new
cache value.  A multi-token chunk into a sliding-window ring is the
exception: it writes a copy (see ``attention_forward``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import Params, apply_dense, apply_rope, init_dense

_NEG_INF = -1e30


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, C, Hkv, D)
    v: torch.Tensor          # (B, C, Hkv, D)
    positions: torch.Tensor  # (B, C) int32 per-row ring positions, -1 = empty


def init_attention(cfg, gen, device, cross: bool = False) -> Params:
    dt = getattr(torch, cfg.dtype)
    hd = cfg.head_dim_
    return {
        "wq": init_dense(gen, cfg.d_model, cfg.n_heads * hd, dt, device,
                         bias=cfg.qkv_bias),
        "wk": init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, device,
                         bias=cfg.qkv_bias),
        "wv": init_dense(gen, cfg.d_model, cfg.n_kv_heads * hd, dt, device,
                         bias=cfg.qkv_bias),
        "wo": init_dense(gen, cfg.n_heads * hd, cfg.d_model, dt, device),
    }


def cache_capacity(cfg, seq_len: int) -> int:
    if cfg.attn_type == "swa" and cfg.window:
        return min(seq_len, cfg.window)
    return seq_len


def init_kv_cache(cfg, batch: int, seq_len: int, dtype, device) -> KVCache:
    C = cache_capacity(cfg, seq_len)
    shape = (batch, C, cfg.n_kv_heads, cfg.head_dim_)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((batch, C), -1, dtype=torch.int32,
                             device=device))


# ------------------------------------------------------------------ softmax core

def _attend_block(q, k, v, mask, m, l, acc):
    """One online-softmax update.  q:(B,Sq,Hkv,G,D) k/v:(B,Ck,Hkv,D)
    mask:(Sq,Ck) or (B,Sq,Ck); m,l:(B,Sq,Hkv,G) acc:(B,Sq,Hkv,G,D)."""
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.to(torch.float32),
                     k.to(torch.float32))
    if mask.ndim == 2:
        mask = mask[None]
    s = torch.where(mask[:, :, None, None, :], s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    # probabilities rounded to the value dtype, products summed in f32 (the
    # reference's bf16 PV product with f32 accumulation)
    pv = torch.einsum("bqhgk,bkhd->bqhgd", p.to(v.dtype).to(torch.float32),
                      v.to(torch.float32))
    return m_new, l_new, acc * corr[..., None] + pv


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int,
                    chunk: int) -> torch.Tensor:
    """Chunked-KV online-softmax attention.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); positions int32 (q_pos: (Sq,)
    or per-row (B, Sq); k_pos: (Sk,) or (B, Sk), -1 = invalid slot).  One
    token per row (Sq == 1) takes the un-chunked decode fast path; longer
    queries walk KV in ``chunk``-sized blocks.  Shared 1-D positions keep a
    (Sq, ck) mask per chunk; per-row positions mask each row against its own
    ring.  GQA folds Hq into (Hkv, G).  Returns (B, Sq, Hq, D) in q.dtype.
    """
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = (q * D ** -0.5).reshape(B, Sq, Hkv, G, D)
    Sk = k.shape[1]
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((B, Sq, Hkv, G), _NEG_INF, **f32)
    l = torch.zeros((B, Sq, Hkv, G), **f32)
    acc = torch.zeros((B, Sq, Hkv, G, D), **f32)

    if Sq == 1:
        qp = q_pos if q_pos.ndim == 2 else q_pos[None]       # (b?, Sq)
        kp = k_pos if k_pos.ndim == 2 else k_pos[None]       # (b?, Sk)
        mask = (kp >= 0)[:, None, :]
        if causal:
            mask = mask & (kp[:, None, :] <= qp[:, :, None])
        if window:
            mask = mask & (kp[:, None, :] > qp[:, :, None] - window)
        if mask.shape[0] == 1:
            mask = mask[0]                                   # shared (Sq, Sk)
        m, l, acc = _attend_block(qg, k, v, mask, m, l, acc)
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        return out.reshape(B, Sq, Hq, D).to(q.dtype)

    shared = q_pos.ndim == 1 and k_pos.ndim == 1
    ck = min(chunk, Sk)
    n_chunks = -(-Sk // ck)
    pad = n_chunks * ck - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-1)
    if not shared:
        q_pos = q_pos if q_pos.ndim == 2 else q_pos[None].expand(B, Sq)
        k_pos = k_pos if k_pos.ndim == 2 \
            else k_pos[None].expand(B, k_pos.shape[-1])

    for c in range(n_chunks):
        sl = slice(c * ck, (c + 1) * ck)
        pb = k_pos[..., sl]
        if shared:
            mask = (pb >= 0)[None, :]
            if causal:
                mask = mask & (pb[None, :] <= q_pos[:, None])
            if window:
                mask = mask & (pb[None, :] > q_pos[:, None] - window)
        else:
            mask = (pb >= 0)[:, None, :]
            if causal:
                mask = mask & (pb[:, None, :] <= q_pos[:, :, None])
            if window:
                mask = mask & (pb[:, None, :] > q_pos[:, :, None] - window)
        m, l, acc = _attend_block(qg, k[:, sl], v[:, sl], mask, m, l, acc)
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def chunked_causal_attention(q, k, v, q_pos, k_pos, *, chunk: int
                             ) -> torch.Tensor:
    """Full causal attention with both axes chunked: a loop over query
    chunks, each a flash pass over KV, so the score working set stays
    (B, cq, H, ck) whatever the sequence length."""
    B, Sq, Hq, D = q.shape
    cq = min(chunk, Sq)
    n_q = -(-Sq // cq)
    pad_q = n_q * cq - Sq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    outs = [flash_attention(q[:, i * cq:(i + 1) * cq], k, v,
                            q_pos[i * cq:(i + 1) * cq], k_pos, causal=True,
                            window=0, chunk=chunk) for i in range(n_q)]
    return torch.cat(outs, dim=1)[:, :Sq]


def swa_attention(q, k, v, q_pos, k_pos, *, window: int, q_chunk: int
                  ) -> torch.Tensor:
    """Sub-quadratic sliding-window attention: a loop over query chunks,
    each attending to the in-window KV span ``min(Sk, window + cq)`` that
    ends at the chunk's end.  Compute O(S * (W + cq)), not O(S^2)."""
    B, Sq, Hq, D = q.shape
    Sk = k.shape[1]
    cq = min(q_chunk, Sq)
    n_q = -(-Sq // cq)
    pad_q = n_q * cq - Sq
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = F.pad(q_pos, (0, pad_q), value=-1)
    span = min(Sk, window + cq)
    outs = []
    for i in range(n_q):
        # the KV span covering (chunk_start - window, chunk_end]
        start = min(max(i * cq + cq - span, 0), Sk - span)
        kv = slice(start, start + span)
        outs.append(flash_attention(
            q[:, i * cq:(i + 1) * cq], k[:, kv], v[:, kv],
            q_pos[i * cq:(i + 1) * cq], k_pos[kv], causal=True,
            window=window, chunk=span))
    return torch.cat(outs, dim=1)[:, :Sq]


# ------------------------------------------------------------------ module API

def _ring_write(cache: KVCache, k, v, pos_b, q_valid, copy: bool = False
                ) -> KVCache:
    """Write a chunk's KV into each row's slots ``pos % C``, in place; rows
    where ``q_valid`` is False write back what the ring already holds.
    Returns ``cache``, or with ``copy`` a written copy (``cache`` stays as
    it was)."""
    if copy:
        cache = KVCache(*(a.clone() for a in cache))
    B = k.shape[0]
    C = cache.k.shape[1]
    slots = pos_b % C                                       # (B, S)
    bidx = torch.arange(B, device=k.device)[:, None]
    if q_valid is not None:
        keep = q_valid[..., None, None]
        k = torch.where(keep, k, cache.k[bidx, slots])
        v = torch.where(keep, v, cache.v[bidx, slots])
        pos_b = torch.where(q_valid, pos_b, cache.positions[bidx, slots])
    cache.k[bidx, slots] = k.to(cache.k.dtype)
    cache.v[bidx, slots] = v.to(cache.v.dtype)
    cache.positions[bidx, slots] = pos_b.to(torch.int32)
    return cache


def _build_ring(k, v, kv_pos, C: int, q_valid) -> KVCache:
    """The decode ring from a prefill pass's KV: each row keeps its last
    min(C, length) valid positions at slots ``pos % C``.

    Without ``q_valid`` every row keeps the pass's last C columns.  With it
    (ragged right-padded rows), slot s of row b holds the largest valid
    position congruent to s mod C, gathered per (row, slot)."""
    B, Skv = k.shape[:2]
    if q_valid is not None:
        lengths = q_valid.to(torch.int32).sum(dim=1)                  # (B,)
        s_idx = torch.arange(C, dtype=torch.int32, device=k.device)[None]
        last = lengths[:, None] - 1                                   # (B, 1)
        owner = last - torch.remainder(last - s_idx, C)               # (B, C)
        valid = (owner >= 0) & (lengths[:, None] > 0)
        col = owner.clamp(0, Skv - 1).long()[..., None, None]
        col = col.expand(B, C, *k.shape[2:])
        keep = valid[..., None, None]
        return KVCache(
            k=torch.where(keep, torch.gather(k, 1, col), 0).to(k.dtype),
            v=torch.where(keep, torch.gather(v, 1, col), 0).to(v.dtype),
            positions=torch.where(valid, owner, -1).to(torch.int32))
    n_keep = min(C, Skv)
    kept_pos = kv_pos[Skv - n_keep:].to(torch.int32)
    slots = (kept_pos % C).long()
    kc = torch.zeros((B, C) + tuple(k.shape[2:]), dtype=k.dtype,
                     device=k.device)
    vc = torch.zeros_like(kc)
    kc[:, slots] = k[:, Skv - n_keep:]
    vc[:, slots] = v[:, Skv - n_keep:]
    pos0 = torch.full((C,), -1, dtype=torch.int32, device=k.device)
    pos0[slots] = kept_pos
    return KVCache(k=kc, v=vc, positions=pos0[None].expand(B, C).contiguous())


def attention_forward(p: Params, x: torch.Tensor, cfg, *,
                      positions: torch.Tensor,
                      cache: KVCache | None = None,
                      kv_x: torch.Tensor | None = None,
                      causal: bool = True,
                      return_cache: bool = False,
                      is_cross: bool = False,
                      cache_len: int | None = None,
                      q_valid: torch.Tensor | None = None
                      ) -> tuple[torch.Tensor, KVCache | None]:
    """Full attention pass (train / prefill / decode / cross).

    x: (B, S, d_model).  positions: (S,) shared or (B, S) per-row int32
    absolute positions.
    cache: with a self-attention cache (decode, or a multi-token extension)
    the new KV are written into each row's ring at its own offsets, in
    place, and attention runs against the whole ring; a multi-token chunk
    into a sliding-window ring writes a copy and attends against the
    pre-write ring beside its own keys.  ``return_cache`` on a pass without
    a cache (prefill) builds the ring, sized for ``cache_len`` (at most the
    window).
    kv_x: encoder output for cross-attention (keys/values from there, no
    causal mask, rope at the encoder positions).  A cross-attention call
    with a cache and no ``kv_x`` attends to that static cache.
    q_valid: optional (B, S) bool for ragged batches: rows where it is False
    are right-padding and write nothing new into the ring.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim_
    cross = is_cross or kv_x is not None
    q = apply_dense(p["wq"], x).reshape(B, S, cfg.n_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)

    if cross and cache is not None and kv_x is None:
        # decode against the static (encoder) cross cache: no writes
        out = flash_attention(q, cache.k, cache.v, positions,
                              cache.positions, causal=False, window=0,
                              chunk=cfg.attn_chunk)
        y = apply_dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
        return y, cache

    src = kv_x if kv_x is not None else x
    Skv = src.shape[1]
    k = apply_dense(p["wk"], src).reshape(B, Skv, cfg.n_kv_heads, hd)
    v = apply_dense(p["wv"], src).reshape(B, Skv, cfg.n_kv_heads, hd)
    if not cross:
        kv_pos = positions
    else:
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=x.device)
    k = apply_rope(k, kv_pos, cfg.rope_theta)

    new_cache = None
    if cache is not None and not cross:
        C = cache.k.shape[1]
        if S > C:
            # consecutive positions are slot-distinct only modulo the ring
            # capacity: a wider chunk would write two rows into one slot
            raise ValueError(
                f"cache extension chunk ({S} tokens) exceeds the KV ring "
                f"capacity ({C}): in-chunk positions would alias ring slots")
        window = cfg.window if cfg.attn_type == "swa" else 0
        pos_b = positions if positions.ndim == 2 \
            else positions[None].expand(B, S)
        carry = S > 1 and window > 0
        # A multi-token chunk into a sliding-window ring writes a copy: its
        # attention reads the pre-write ring, and a forward that raises
        # after this layer must leave that ring as it was for the retry.
        new_cache = _ring_write(cache, k, v, pos_b, q_valid, copy=carry)
        if carry:
            # SWA carry-window extension: the chunk recycles ring slots
            # (capacity = window) that still hold in-window keys its own
            # earliest queries need.  Attend against the pre-write ring
            # (positions o-C..o-1) beside the chunk's own keys (o..o+S-1):
            # the two position sets are disjoint, so the window mask picks
            # exactly the right keys.  Pad rows' chunk keys are masked (-1).
            kp_chunk = pos_b if q_valid is None \
                else torch.where(q_valid, pos_b, -1)
            ka = torch.cat([cache.k, k.to(cache.k.dtype)], dim=1)
            va = torch.cat([cache.v, v.to(cache.v.dtype)], dim=1)
            pa = torch.cat([cache.positions, kp_chunk.to(torch.int32)],
                           dim=1)
        else:
            ka, va, pa = new_cache
        out = flash_attention(q, ka, va, pos_b, pa, causal=causal,
                              window=window, chunk=cfg.attn_chunk)
    else:
        window = cfg.window if (cfg.attn_type == "swa" and not cross) else 0
        if window and S > 1:
            out = swa_attention(q, k, v, positions, kv_pos, window=window,
                                q_chunk=cfg.attn_chunk)
        elif causal and not cross and S > 2 * cfg.attn_chunk:
            out = chunked_causal_attention(q, k, v, positions, kv_pos,
                                           chunk=cfg.attn_chunk)
        else:
            out = flash_attention(q, k, v, positions, kv_pos,
                                  causal=causal and not cross, window=0,
                                  chunk=cfg.attn_chunk)
        if return_cache:
            C = Skv if cross else cache_capacity(cfg, cache_len or Skv)
            new_cache = _build_ring(k, v, kv_pos, C,
                                    None if cross else q_valid)

    y = apply_dense(p["wo"], out.reshape(B, S, cfg.n_heads * hd))
    return y, new_cache
