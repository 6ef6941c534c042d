"""Model builder: ModelConfig -> runnable model (forward / prefill / decode)
(port of ``repro.models.model_zoo``).

One ``Model`` class covers every architecture in ``configs/``:

* decoder-only LMs — ``block_pattern`` drives the layer mix (attention,
  MoE, mamba2 SSM and RG-LRU hybrid stacks);
* enc-dec (seamless-m4t): an encoder ``Stack`` (non-causal) + a decoder
  stack with cross-attention;
* [audio]/[vlm] frontends are stubs: precomputed frame/patch embeddings,
  prepended to the token embeddings.

Batch dicts (tensors on the model's device):
    LM       : {"tokens": (B, S) int}
    +frontend: {"frontend": (B, F, d_model)}
    enc-dec  : {"src_embeds": (B, F, d_model), "tokens": (B, S)}
Decode state: {"caches": [one per decoder layer], "pos": (B,) int32}; decode
writes the attention rings in place and returns the recurrent states as new
tensors (see ``transformer``).

``loss_fn`` is the reference's training loss; ``repro_torch.train.step``
differentiates it with ``torch.autograd.grad``.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.device import full_f32, resolve_device

from .layers import (Params, apply_norm, embed_tokens, init_embedding,
                     init_lm_head, init_norm, lm_logits)
from .transformer import Stack


def _last(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Each row's position ``lengths - 1`` of (B, S, D), as (B, 1, D)."""
    idx = torch.clamp(lengths.to(torch.int64) - 1, 0, x.shape[1] - 1)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def _full_f32(method):
    """Run a model entry point with f32 accumulation pinned in every product
    (``full_f32``: no TF32, no half-precision split-K reduction in cuBLAS),
    as the reference accumulates; one scope per call, not per product."""
    @functools.wraps(method)
    def run(*args, **kwargs):
        with full_f32():
            return method(*args, **kwargs)
    return run


class Model:
    def __init__(self, cfg):
        self.cfg = cfg
        if cfg.family == "encdec":
            self.encoder = Stack(cfg, ("attn",), cfg.encoder_layers,
                                 causal=False)
            self.decoder = Stack(cfg, ("attn_cross",), cfg.n_layers,
                                 causal=True)
        else:
            self.encoder = None
            self.decoder = Stack(cfg, cfg.block_pattern, cfg.n_layers,
                                 causal=True)

    # ------------------------------------------------------------- params

    def init(self, generator: torch.Generator, device=None) -> Params:
        """Random parameters drawn from ``generator`` on its own device (a
        CUDA generator draws on the card), placed on ``device`` (default
        ``cuda``)."""
        cfg = self.cfg
        dev = resolve_device(device)
        p: Params = {
            "embed": init_embedding(cfg, generator, dev),
            "decoder": self.decoder.init(generator, dev),
            "final_norm": init_norm(cfg, dev),
            "head": init_lm_head(cfg, generator, dev),
        }
        if self.encoder is not None:
            p["encoder"] = self.encoder.init(generator, dev)
            p["enc_norm"] = init_norm(cfg, dev)
        return p

    def param_count(self, params) -> int:
        """Number of parameters (prepared DSLOT state is not counted)."""
        def count(node):
            if isinstance(node, torch.Tensor):
                return node.numel()
            if isinstance(node, dict):
                return sum(count(v) for k, v in node.items() if k != "dslot")
            if isinstance(node, (list, tuple)):
                return sum(count(v) for v in node)
            return 0
        return count(params)

    def prepare_dslot(self, params) -> Params:
        """One-time DSLOT weight lowering for serving (no-op unless the
        config's digit-serial MLP path applies): attaches prepared
        ``DslotWeights`` to every MLP up-projection."""
        from .mlp import prepare_mlp_dslot
        return prepare_mlp_dslot(params, self.cfg)

    # ------------------------------------------------------------- helpers

    def _embed_inputs(self, params, batch) -> torch.Tensor:
        tok = embed_tokens(params["embed"], batch["tokens"], self.cfg)
        if self.cfg.frontend and "frontend" in batch:
            front = batch["frontend"].to(tok.dtype)
            tok = torch.cat([front, tok], dim=1)
        return tok

    def _encode(self, params, batch) -> torch.Tensor:
        cfg = self.cfg
        src = batch["src_embeds"].to(getattr(torch, cfg.dtype))
        pos = torch.arange(src.shape[1], dtype=torch.int32,
                           device=src.device)
        enc, _, _ = self.encoder.apply(params["encoder"], src,
                                       positions=pos, mode="train")
        return apply_norm(params["enc_norm"], enc, cfg)

    def _full_len(self, batch) -> int:
        S = batch["tokens"].shape[1]
        if self.cfg.frontend and "frontend" in batch:
            S += batch["frontend"].shape[1]
        return S

    # ------------------------------------------------------------- forward

    @_full_f32
    def forward(self, params, batch, mode: str = "train",
                cache_len: int | None = None,
                lengths: torch.Tensor | None = None):
        """Full-sequence pass.  Returns (logits, aux_loss, caches or None),
        ``aux_loss`` the MoE load-balancing loss summed over the layers (0
        without MoE layers).

        ``mode="train"`` is a plain forward with logits at every position;
        ``mode="prefill"`` builds the decode caches (rings sized for
        ``cache_len``) and returns the logits of the last position only.
        ``lengths`` (prefill only): per-row (B,) valid token counts of a
        ragged right-padded batch — pad positions write nothing into the
        KV rings, are identity steps of the recurrent scans, and each row's
        logits come from its last valid position.
        With a frontend, ``lengths`` counts tokens; the frames are valid.
        """
        cfg = self.cfg
        enc_out = self._encode(params, batch) if self.encoder is not None \
            else None
        x = self._embed_inputs(params, batch)
        S = x.shape[1]
        pos = torch.arange(S, dtype=torch.int32, device=x.device)
        q_valid = None
        if lengths is not None and mode == "prefill":
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=x.device)
            F = S - batch["tokens"].shape[1]    # frontend frames, if any
            q_valid = pos[None] < (lengths + F)[:, None]
        x, caches, aux = self.decoder.apply(
            params["decoder"], x, positions=pos, enc_out=enc_out, mode=mode,
            cache_len=cache_len, q_valid=q_valid)
        x = apply_norm(params["final_norm"], x, cfg)
        if cfg.frontend:
            x = x[:, S - batch["tokens"].shape[1]:]
        if mode == "prefill":
            # serving needs only the next-token distribution
            x = x[:, -1:] if lengths is None else _last(x, lengths)
        logits = lm_logits(params["head"], params["embed"], x, cfg)
        return logits, aux, caches if mode == "prefill" else None

    # ------------------------------------------------------------- serving

    def prefill(self, params, batch, max_len: int | None = None,
                lengths: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, dict]:
        """One-shot prompt ingestion: (last-position logits (B, V), decode
        state).  ``lengths``: optional per-row (B,) valid token counts of
        ragged right-padded prompts (see ``forward``)."""
        logits, _, caches = self.forward(params, batch, mode="prefill",
                                         cache_len=max_len, lengths=lengths)
        tokens = batch["tokens"]
        B = tokens.shape[0]
        if lengths is not None:
            F = self._full_len(batch) - tokens.shape[1]
            pos = torch.as_tensor(lengths, dtype=torch.int32,
                                  device=tokens.device) + F
        else:
            pos = torch.full((B,), self._full_len(batch), dtype=torch.int32,
                             device=tokens.device)
        return logits[:, -1], {"caches": caches, "pos": pos}

    @_full_f32
    def decode_step(self, params, state: dict, tokens: torch.Tensor
                    ) -> tuple[torch.Tensor, dict]:
        """One token for every row.  tokens: (B, 1) int.

        ``state["pos"]`` is a per-row (B,) vector (rows may sit at different
        depths); a scalar means every row is at that depth.  The attention
        rings are written in place (the returned state holds ``state``'s
        ring tensors); recurrent states come back as new tensors.
        """
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        pos = state["pos"].to(torch.int32)
        pos2d = pos[:, None] if pos.ndim == 1 else pos[None]
        x, caches, _ = self.decoder.apply(
            params["decoder"], x, positions=pos2d, caches=state["caches"],
            mode="decode")
        x = apply_norm(params["final_norm"], x, cfg)
        logits = lm_logits(params["head"], params["embed"], x, cfg)
        return logits[:, 0], {"caches": caches, "pos": state["pos"] + 1}

    @_full_f32
    def extend(self, params, state: dict, tokens: torch.Tensor,
               lengths: torch.Tensor | None = None
               ) -> tuple[torch.Tensor, dict]:
        """Append multi-token prompt chunks to an existing decode state.

        Runs the decode path with S tokens per row at positions
        ``state["pos"][b] .. state["pos"][b] + S - 1``, writing KV into each
        row's ring at its own offsets.  Returns each row's last position's
        logits and the extended state.  ``lengths``: optional per-row (B,)
        valid token counts of ragged chunks right-padded to S; pad rows
        write nothing, pass through the recurrent scans as identity steps
        and do not advance ``pos``.  Full-attention rings are written in
        place, as in ``decode_step``; sliding-window rings of a multi-token
        chunk and recurrent states come back as new tensors, so a forward
        that raises leaves them as they were.
        """
        cfg = self.cfg
        x = embed_tokens(params["embed"], tokens, cfg)
        B, S = tokens.shape
        pos0 = state["pos"].to(torch.int32)
        pos = pos0[:, None] + torch.arange(S, dtype=torch.int32,
                                           device=x.device)[None]
        q_valid = None
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=x.device)
            q_valid = torch.arange(S, device=x.device)[None] \
                < lengths[:, None]
        x, caches, _ = self.decoder.apply(
            params["decoder"], x, positions=pos, caches=state["caches"],
            mode="decode", q_valid=q_valid)
        x = apply_norm(params["final_norm"], x, cfg)
        if lengths is None:
            last, new_pos = x[:, -1:], pos0 + S
        else:
            last, new_pos = _last(x, lengths), pos0 + lengths
        logits = lm_logits(params["head"], params["embed"], last, cfg)
        return logits[:, 0], {"caches": caches, "pos": new_pos}

    def init_decode_state(self, batch_size: int, seq_len: int,
                          enc_len: int = 0, device=None) -> dict:
        """Empty caches for ``batch_size`` rows of up to ``seq_len``
        positions, on ``device`` (default ``cuda``)."""
        dev = resolve_device(device)
        dtype = getattr(torch, self.cfg.dtype)
        caches = self.decoder.init_cache(batch_size, seq_len, enc_len, dtype,
                                         dev)
        return {"caches": caches,
                "pos": torch.zeros((batch_size,), dtype=torch.int32,
                                   device=dev)}


def build_model(cfg) -> Model:
    return Model(cfg)


def loss_fn(model: Model, params, batch, aux_weight: float = 0.01):
    """The training loss, differentiable under autograd: next-token
    cross-entropy plus ``aux_weight`` times the MoE load-balance aux,
    ``(loss + aux_weight * aux, (loss, aux))``.

    ``batch["labels"]`` (B, S) int, entries < 0 masked out.  As in the
    reference, no f32 (B, S, V) tensor is made: probabilities stay in the
    logits' dtype (max-subtracted) and only the reductions are f32.
    """
    logits, aux, _ = model.forward(params, batch, mode="train")
    labels = batch["labels"].to(torch.int64)
    m = logits.amax(dim=-1, keepdim=True).detach()
    sumexp = torch.exp(logits - m).to(torch.float32).sum(dim=-1)
    lse = torch.log(sumexp) + m[..., 0].to(torch.float32)
    # a masked label indexes like the reference's (negative from the end);
    # its term is multiplied by 0
    idx = torch.where(labels < 0, labels + logits.shape[-1], labels)
    tgt = torch.gather(logits, -1, idx[..., None])[..., 0]
    ll = tgt.to(torch.float32) - lse
    mask = (labels >= 0).to(torch.float32)
    loss = -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return loss + aux_weight * aux, (loss, aux)

