"""Attention: GQA/MQA, full-causal, sliding-window/local and cross,
flash-style (port of ``repro.models.attention``).

Plain PyTorch that follows the reference's arithmetic: f32 scores, bf16
(the value dtype) probabilities into the PV product with f32 accumulation,
and a running-max online softmax over KV chunks, so scores are never
materialized for the whole sequence.  The sliding-window path also chunks
the query axis and slices only the in-window KV span of each chunk.  No
library attention kernel is used, so CPU results keep the reference's
rounding.

Inside ``pspec.model_shard`` attention is split by heads where
``pspec.splits`` allows: the rank's block of q heads comes from its column
slice of ``wq``; k and v from its kv heads (the "kv" scheme) or, under
"group" and "repeat", from the kv heads its q heads read (cut from the
whole ``wk``/``wv`` in training; a serving rank stores only those,
``train.sharding.model_slice``); ``wo`` is row-parallel.

Serving inside ``model_shard`` also splits a KV ring along its slots where
``pspec.ring_splits`` says the ranks divide its capacity C (context
parallelism, the reference's decode layout): rank r holds a ``KVShard``,
slots ``r * C/tp .. (r + 1) * C/tp - 1`` of every kv head, with its own
positions.  Decode and ``extend`` gather the new tokens' q, k and v heads
over the model axis; each rank writes the tokens whose slots it holds and
attends every head against its own slots, ``pspec.model_combine`` joins
the ranks' online-softmax states (their max, then their rescaled sums),
and the rank keeps its heads' rows for the row-parallel ``wo``.  A prefill builds each rank's block from the
kv heads gathered over the ranks.  A ring the ranks do not divide stays
whole on every rank (every slot of every kv head), and each rank attends
its own q heads against it.

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

from . import pspec
from .layers import Params, apply_dense, apply_rope, init_dense, row_parallel

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


class KVShard(KVCache):
    """One model rank's block of a KV ring split along its slots inside
    ``pspec.model_shard``: slots ``tp_rank * n .. tp_rank * n + n - 1`` (n =
    ``k.shape[1]``) of a ring of ``n * tp_size`` slots, every kv head, and
    the positions those slots hold (-1 = empty)."""
    __slots__ = ()


def ring_block(capacity: int) -> tuple[type, int, int]:
    """This rank's part of a ring of ``capacity`` slots: ``(KVShard, first
    slot, slots)`` where ``pspec.ring_splits``, else ``(KVCache, 0,
    capacity)``."""
    if pspec.ring_splits(capacity):
        n = capacity // pspec.model_split()
        return KVShard, pspec.tp_rank() * n, n
    return KVCache, 0, capacity


def init_kv_cache(cfg, batch: int, seq_len: int, dtype, device) -> KVCache:
    """An empty ring for ``seq_len`` positions (inside ``pspec.model_shard``
    this rank's ``ring_block`` of it)."""
    cls, _, n = ring_block(cache_capacity(cfg, seq_len))
    shape = (batch, n, cfg.n_kv_heads, cfg.head_dim_)
    return cls(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        positions=torch.full((batch, n), -1, dtype=torch.int32,
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
                    chunk: int, partial: bool = False):
    """Chunked-KV online-softmax attention.

    q: (B, Sq, Hq, D); k/v: (B, Sk, Hkv, D); positions int32 (q_pos: (Sq,)
    or per-row (B, Sq); k_pos: (Sk,) or (B, Sk), -1 = invalid slot).  One
    token per row (Sq == 1) takes the un-chunked decode fast path; longer
    queries walk KV in ``chunk``-sized blocks.  Shared 1-D positions keep a
    (Sq, ck) mask per chunk; per-row positions mask each row against its own
    ring.  GQA folds Hq into (Hkv, G).  Returns (B, Sq, Hq, D) in q.dtype;
    with ``partial`` the un-normalised online-softmax state ``(m, l, acc)``
    instead, f32 of shapes (B, Sq, Hkv, G) and (B, Sq, Hkv, G, D): every
    query's largest masked score (-1e30 where it sees no key), the sum of
    its probabilities and their weighted sum of the values
    (``pspec.model_combine`` joins the ranks' states).
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
        if partial:
            return m, l, acc
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
    if partial:
        return m, l, acc
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

def _ring_write(cache: KVCache, k, v, pos_b, q_valid, copy: bool = False,
                lo: int = 0, capacity: int | None = None) -> KVCache:
    """Write a chunk's KV into each row's slots ``pos % C``, in place; rows
    where ``q_valid`` is False write back what the ring already holds.
    ``cache`` may be one block of a larger ring (a ``KVShard``): slots ``lo
    .. lo + n - 1`` of a ring of ``capacity`` slots, where a token whose
    slot lies outside the block writes nothing.  Returns ``cache``, or with
    ``copy`` a written copy (``cache`` stays as it was)."""
    if copy:
        cache = type(cache)(*(a.clone() for a in cache))
    B, S = k.shape[:2]
    n = cache.k.shape[1]
    bidx = torch.arange(B, device=k.device)[:, None]
    if capacity is not None and capacity != n:
        return _block_write(cache, k, v, pos_b, q_valid, lo, capacity, bidx)
    slots = pos_b % n                                       # (B, S)
    if q_valid is not None:
        keep = q_valid[..., None, None]
        k = torch.where(keep, k, cache.k[bidx, slots])
        v = torch.where(keep, v, cache.v[bidx, slots])
        pos_b = torch.where(q_valid, pos_b, cache.positions[bidx, slots])
    cache.k[bidx, slots] = k.to(cache.k.dtype)
    cache.v[bidx, slots] = v.to(cache.v.dtype)
    cache.positions[bidx, slots] = pos_b.to(torch.int32)
    return cache


def _block_write(cache: KVCache, k, v, pos_b, q_valid, lo: int, C: int,
                 bidx) -> KVCache:
    """``_ring_write`` into slots ``lo .. lo + n - 1`` of a ring of ``C``.
    A token that writes nothing repeats its row's first writing token (its
    slot and values); in a row where none writes, every token writes back
    what the block's first slot holds.  So no two writes to one slot
    differ, and no shape depends on the data."""
    n = cache.k.shape[1]
    local = pos_b % C - lo                                  # (B, S)
    own = (local >= 0) & (local < n)
    if q_valid is not None:
        own = own & q_valid
    some = own.any(dim=1, keepdim=True)                     # (B, 1)
    first = torch.argmax(own.to(torch.int32), dim=1, keepdim=True)
    tok = torch.arange(k.shape[1], device=k.device)[None]
    src = torch.where(own, tok, first)
    slots = torch.where(own, local,
                        torch.where(some, local.gather(1, first), 0))
    keep = some[..., None, None]
    cache.k[bidx, slots] = torch.where(keep, k[bidx, src].to(cache.k.dtype),
                                       cache.k[bidx, slots])
    cache.v[bidx, slots] = torch.where(keep, v[bidx, src].to(cache.v.dtype),
                                       cache.v[bidx, slots])
    cache.positions[bidx, slots] = torch.where(
        some, pos_b.gather(1, src).to(torch.int32),
        cache.positions[bidx, slots])
    return cache


def _build_ring(k, v, kv_pos, C: int, q_valid, cls=KVCache, lo: int = 0,
                n: int | None = None) -> KVCache:
    """The decode ring from a prefill pass's KV: each row keeps its last
    min(C, length) valid positions at slots ``pos % C``.

    Without ``q_valid`` every row keeps the pass's last C columns.  With it
    (ragged right-padded rows), slot s of row b holds the largest valid
    position congruent to s mod C, gathered per (row, slot).  ``n`` builds
    only slots ``lo .. lo + n - 1`` (a ``KVShard``, of class ``cls``), by the
    same gather; the pass's positions are then its columns, as a prefill's
    are."""
    B, Skv = k.shape[:2]
    n = C if n is None else n
    if q_valid is not None or n != C:
        lengths = q_valid.to(torch.int32).sum(dim=1) if q_valid is not None \
            else torch.full((B,), Skv, dtype=torch.int32, device=k.device)
        s_idx = torch.arange(lo, lo + n, dtype=torch.int32,
                             device=k.device)[None]
        last = lengths[:, None] - 1                                   # (B, 1)
        owner = last - torch.remainder(last - s_idx, C)               # (B, n)
        valid = (owner >= 0) & (lengths[:, None] > 0)
        col = owner.clamp(0, Skv - 1).long()[..., None, None]
        col = col.expand(B, n, *k.shape[2:])
        keep = valid[..., None, None]
        return cls(
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
    window).  Inside ``pspec.model_shard`` a ring may be a ``KVShard``
    (see the module docstring).
    kv_x: encoder output for cross-attention (keys/values from there, no
    causal mask, rope at the encoder positions).  A cross-attention call
    with a cache and no ``kv_x`` attends to that static cache.
    q_valid: optional (B, S) bool for ragged batches: rows where it is False
    are right-padding and write nothing new into the ring.
    """
    B, S, _ = x.shape
    hd = cfg.head_dim_
    cross = is_cross or kv_x is not None
    sp = pspec.active_splits(cfg)
    tp = pspec.model_split()
    if isinstance(cache, KVShard) and tp == 1:
        raise ValueError("a KV ring split over the model axis (KVShard) is "
                         "read only inside pspec.model_shard")
    hq = cfg.n_heads // tp if sp.heads else cfg.n_heads
    if sp.heads:
        x = pspec.copy_to_model(x)
        if kv_x is not None:
            kv_x = pspec.copy_to_model(kv_x)
    q = apply_dense(p["wq"], x).reshape(B, S, hq, hd)
    q = apply_rope(q, positions, cfg.rope_theta)

    if cross and cache is not None and kv_x is None:
        # decode against the static (encoder) cross cache: no writes
        shard = isinstance(cache, KVShard)
        qa = pspec.model_gather(q, dim=2) if shard and sp.heads else q
        out = _ring_attention(q, qa, cache.k, cache.v, positions,
                              cache.positions, cfg, hq, sp, shard,
                              causal=False, window=0)
        return _out_proj(p, out, sp), cache

    src = kv_x if kv_x is not None else x
    Skv = src.shape[1]
    index = None
    if sp.heads and not sp.kv:
        k, v, index = _kv_read(p, src, cfg, pspec.tp_rank() * hq, hq)
    else:       # every kv head, or under "kv" the rank's (its wk/wv slices)
        hk = cfg.n_kv_heads // (tp if sp.kv else 1)
        k = apply_dense(p["wk"], src).reshape(B, Skv, hk, hd)
        v = apply_dense(p["wv"], src).reshape(B, Skv, hk, hd)
    if not cross:
        kv_pos = positions
    else:
        kv_pos = torch.arange(Skv, dtype=torch.int32, device=x.device)
    k = apply_rope(k, kv_pos, cfg.rope_theta)

    new_cache = None
    if cache is not None and not cross:
        shard = isinstance(cache, KVShard)
        n = cache.k.shape[1]
        C = n * tp if shard else n
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
        qa = q
        if sp.heads:
            # the ring holds every kv head: gather the chunk's heads (and,
            # for a split ring, every q head) from the ranks
            qa, k, v = _gather_heads(q if shard else None, k, v, cfg, hq)
            qa = q if qa is None else qa
        # A multi-token chunk into a sliding-window ring writes a copy: its
        # attention reads the pre-write ring, and a forward that raises
        # after this layer must leave that ring as it was for the retry.
        new_cache = _ring_write(cache, k, v, pos_b, q_valid, copy=carry,
                                lo=pspec.tp_rank() * n if shard else 0,
                                capacity=C)
        if carry and not (shard and pspec.tp_rank() > 0):
            # SWA carry-window extension: the chunk recycles ring slots
            # (capacity = window) that still hold in-window keys its own
            # earliest queries need.  Attend against the pre-write ring
            # (positions o-C..o-1) beside the chunk's own keys (o..o+S-1):
            # the two position sets are disjoint, so the window mask picks
            # exactly the right keys.  Pad rows' chunk keys are masked (-1).
            # Over a split ring the chunk's keys join rank 0's slots only,
            # so they count once in the combine.
            kp_chunk = pos_b if q_valid is None \
                else torch.where(q_valid, pos_b, -1)
            ka = torch.cat([cache.k, k.to(cache.k.dtype)], dim=1)
            va = torch.cat([cache.v, v.to(cache.v.dtype)], dim=1)
            pa = torch.cat([cache.positions, kp_chunk.to(torch.int32)],
                           dim=1)
        elif carry:
            ka, va, pa = cache
        else:
            ka, va, pa = new_cache
        out = _ring_attention(q, qa, ka, va, pos_b, pa, cfg, hq, sp, shard,
                              causal=causal, window=window)
    else:
        ka, va = (k, v) if index is None else (k[:, :, index], v[:, :, index])
        window = cfg.window if (cfg.attn_type == "swa" and not cross) else 0
        if window and S > 1:
            out = swa_attention(q, ka, va, positions, kv_pos, window=window,
                                q_chunk=cfg.attn_chunk)
        elif causal and not cross and S > 2 * cfg.attn_chunk:
            out = chunked_causal_attention(q, ka, va, positions, kv_pos,
                                           chunk=cfg.attn_chunk)
        else:
            out = flash_attention(q, ka, va, positions, kv_pos,
                                  causal=causal and not cross, window=0,
                                  chunk=cfg.attn_chunk)
        if return_cache:
            C = Skv if cross else cache_capacity(cfg, cache_len or Skv)
            if sp.heads:
                _, k, v = _gather_heads(None, k, v, cfg, hq)
            cls, lo, n = ring_block(C)
            new_cache = _build_ring(k, v, kv_pos, C,
                                    None if cross else q_valid, cls, lo, n)
    return _out_proj(p, out, sp), new_cache


def _out_proj(p: Params, out: torch.Tensor, sp) -> torch.Tensor:
    """``wo`` over the heads' outputs (B, S, heads, hd): row-parallel
    where the heads split."""
    out = out.reshape(*out.shape[:2], -1)
    if sp.heads:
        return row_parallel(p["wo"], out)
    return apply_dense(p["wo"], out)


def _ring_attention(q, qa, ka, va, q_pos, k_pos, cfg, hq: int, sp,
                    shard: bool, *, causal: bool, window: int
                    ) -> torch.Tensor:
    """The rank's q heads' attention against a ring.  ``shard``: ``ka`` /
    ``va`` / ``k_pos`` are the rank's slots of every kv head and ``qa``
    every q head; the ranks' partial softmax states are combined and the
    rank's heads kept.  Otherwise the ring is whole and the rank's q heads
    ``q`` attend against the kv heads they read."""
    B, S, _, hd = q.shape
    if shard:
        m, l, acc = flash_attention(qa, ka, va, q_pos, k_pos, causal=causal,
                                    window=window, chunk=cfg.attn_chunk,
                                    partial=True)
        out = pspec.model_combine(m, l, acc, q.dtype).reshape(B, S, -1, hd)
        if sp.heads:
            h0 = pspec.tp_rank() * hq
            out = out[:, :, h0:h0 + hq]
        return out
    if sp.heads:
        lo, hi, index = _kv_heads_read(cfg.n_heads, cfg.n_kv_heads,
                                       pspec.tp_rank() * hq, hq)
        ka, va = ka[:, :, lo:hi], va[:, :, lo:hi]
        if index is not None:
            ka, va = ka[:, :, index], va[:, :, index]
    return flash_attention(q, ka, va, q_pos, k_pos, causal=causal,
                           window=window, chunk=cfg.attn_chunk)


def _gather_heads(q, k, v, cfg, hq: int):
    """Every model rank's heads of a chunk in one ``all_gather``: q (B, S,
    n_heads, hd) in head order (None for a ``q`` of None), and k and v
    (B, S, n_kv_heads, hd), each kv head taken from the first rank whose q
    heads read it (each rank's ``k``/``v`` hold the kv heads its q heads
    ``tp_rank * hq ..`` read, as ``_kv_heads_read`` gives them)."""
    tp = pspec.model_split()
    B, S, _, hd = k.shape
    blocks = [_kv_heads_read(cfg.n_heads, cfg.n_kv_heads, r * hq, hq)[:2]
              for r in range(tp)]
    nk = max(hi - lo for lo, hi in blocks)

    def pad(t):
        return F.pad(t, (0, 0, 0, nk - t.shape[2]))
    parts = ([] if q is None else [q]) + [pad(k), pad(v)]
    every = pspec.model_gather(torch.cat(parts, dim=2)[None], dim=0)
    owner = [next(r for r, (lo, hi) in enumerate(blocks) if lo <= j < hi)
             for j in range(cfg.n_kv_heads)]
    ranks = torch.tensor(owner, device=k.device)
    heads = torch.tensor([j - blocks[r][0] for j, r in enumerate(owner)],
                         device=k.device)
    off = 0 if q is None else hq
    kk = every[ranks, :, :, off + heads].permute(1, 2, 0, 3)
    vv = every[ranks, :, :, off + nk + heads].permute(1, 2, 0, 3)
    qa = None if q is None else every[:, :, :, :hq].permute(
        1, 2, 0, 3, 4).reshape(B, S, tp * hq, hd)
    return qa, kk, vv


def _kv_heads_read(n_heads: int, n_kv: int, h0: int, hl: int
                   ) -> tuple[int, int, list | None]:
    """The kv heads that q heads ``h0 .. h0 + hl - 1`` read (q head h reads
    kv head ``h // (n_heads // n_kv)``): ``(lo, hi, index)``, kv heads
    ``lo .. hi - 1``; ``index`` is None where the q heads fold onto them as
    GQA groups of one size, else each q head's kv head less ``lo`` (the kv
    heads repeated to the q heads)."""
    g = n_heads // n_kv
    idx = [(h0 + i) // g for i in range(hl)]
    lo, hi = idx[0], idx[-1] + 1
    nk = hi - lo
    if hl % nk == 0 and idx == [lo + i // (hl // nk) for i in range(hl)]:
        return lo, hi, None
    return lo, hi, [i - lo for i in idx]


def kv_part(w: torch.Tensor, cfg, h0: int, hl: int) -> torch.Tensor:
    """The PART cut of a whole ``wk`` / ``wv`` leaf (a weight or a bias,
    its columns last): the columns of the kv heads that q heads ``h0 .. h0
    + hl - 1`` read under the "group" and "repeat" schemes
    (``_kv_heads_read``).  The train step's forward cuts it from the
    gathered leaf (``_kv_read``); a serving rank stores only it
    (``train.sharding.model_slice``, read under ``pspec.model_shard(...,
    parts_cut=True)``)."""
    lo, hi, _ = _kv_heads_read(cfg.n_heads, cfg.n_kv_heads, h0, hl)
    return w[..., lo * cfg.head_dim_:hi * cfg.head_dim_]


def _kv_read(p: Params, src: torch.Tensor, cfg, h0: int, hl: int):
    """k and v (B, Skv, hi - lo, hd) of the kv heads ``lo .. hi - 1`` that
    the rank's q heads ``h0 .. h0 + hl - 1`` read under the "group" and
    "repeat" schemes, and the index that repeats them to the q heads (None
    where they fold as GQA groups of one size).  ``wk``/``wv`` are whole
    (the train step gathers them) and cut here, or already cut where
    ``pspec.parts_cut`` (a serving rank's ``model_slice``)."""
    B, Skv, _ = src.shape
    hd = cfg.head_dim_
    lo, hi, index = _kv_heads_read(cfg.n_heads, cfg.n_kv_heads, h0, hl)
    cut = pspec.parts_cut()
    out = []
    for name in ("wk", "wv"):
        part = p[name] if cut else {key: kv_part(w, cfg, h0, hl)
                                    for key, w in p[name].items()}
        width = part["w"].shape[-1]
        if width != (hi - lo) * hd:
            raise ValueError(
                f"{name} holds {width} columns where the kv heads "
                f"{lo}..{hi - 1} take {(hi - lo) * hd} (parts_cut={cut})")
        out.append(apply_dense(part, src).reshape(B, Skv, hi - lo, hd))
    return out[0], out[1], index
