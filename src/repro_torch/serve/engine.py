"""The batch serving API (port of ``repro.serve.engine``): ``generate``
prefills once and decodes N tokens, and returns a
:class:`repro_torch.serve.result.GenerateResult` — the tokens plus the
per-request planes-executed account when the DSLOT path is on.

DSLOT serving mode (``cfg.dslot.enabled`` + ReLU MLPs): ``n_planes`` is a
runtime precision, an int or one budget per request, that reaches every
digit-serial MLP through ``repro_torch.runtime.precision_scope``; each
decode step's termination statistics are collected and averaged into the
per-request account.

The reference's decode ``lax.scan`` is a Python loop here.  Tokens and
statistics stay on the device: the loop never waits for the card.
"""

from __future__ import annotations

import torch

from repro_torch.models import stats as stats_channel
from repro_torch.models.mlp import mlp_uses_dslot
from repro_torch.models.model_zoo import Model
from repro_torch.runtime import precision_scope
from repro_torch.serve.result import GenerateResult

__all__ = ["generate", "greedy_sample", "temperature_sample"]

_ROWKEY = "mlp_up_dslot.row_planes_used"
_BNDKEY = "mlp_up_dslot.planes_bounded_mean"


def greedy_sample(logits: torch.Tensor, generator=None) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def temperature_sample(logits: torch.Tensor, generator: torch.Generator,
                       temp: float = 0.8) -> torch.Tensor:
    """One token per row from softmax(logits / temp), drawn with
    ``generator`` (on the logits' device)."""
    probs = torch.softmax(logits.to(torch.float32) / temp, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0] \
        .to(torch.int32)


def _collapse_rows(sink: dict, batch: int) -> torch.Tensor | None:
    """Average the per-row planes-executed records of every DSLOT MLP call
    into one (B,) vector.  Records may be (B,) (single layers) or carry a
    leading group axis from a stack's groups; that axis is averaged first."""
    vals = []
    for v in sink.get(_ROWKEY, []):
        v = v.to(torch.float32)
        while v.ndim > 1:
            v = v.mean(dim=0)
        if v.shape == (batch,):
            vals.append(v)
    if not vals:
        return None
    return torch.stack(vals).mean(dim=0)


def _collapse_bounded(sink: dict) -> torch.Tensor | None:
    """Mean weight-side never-issued planes per tile across the step's DSLOT
    MLP calls (a scalar: the static MSR bound is request-independent)."""
    vals = [v.to(torch.float32).mean() for v in sink.get(_BNDKEY, [])]
    if not vals:
        return None
    return torch.stack(vals).mean()


def generate(model: Model, params, batch: dict, max_new_tokens: int,
             *, max_len: int | None = None, sample=greedy_sample,
             generator: torch.Generator | None = None, n_planes=None
             ) -> GenerateResult:
    """Prefill + greedy/temperature decode.  Returns a ``GenerateResult``
    (``.tokens`` is (B, max_new_tokens); the DSLOT planes-executed account
    rides along when the digit-serial path is on).

    ``n_planes``: runtime DSLOT precision — int or per-request (B,) int
    vector (ignored unless the model's digit-serial MLP path is enabled).
    ``generator``: passed to ``sample`` (``temperature_sample`` needs one).
    The decode runs ``max_new_tokens`` steps, like the reference's scan:
    the last step's token is not returned.
    """
    tokens = batch["tokens"]
    B, S = tokens.shape
    if model.cfg.frontend and "frontend" in batch:
        S += batch["frontend"].shape[1]
    max_len = max_len or (S + max_new_tokens)
    if n_planes is not None:
        n_planes = torch.as_tensor(n_planes, dtype=torch.int32,
                                   device=tokens.device)
        if n_planes.ndim == 0:
            n_planes = n_planes.expand(B).contiguous()
    want_stats = mlp_uses_dslot(model.cfg)

    def draw(logits):
        return sample(logits) if generator is None \
            else sample(logits, generator)

    toks, rows, bounded = [], [], []
    with precision_scope(n_planes):
        logits, state = model.prefill(params, batch, max_len=max_len)
        tok = draw(logits)
        for _ in range(max_new_tokens):
            toks.append(tok)
            if want_stats:
                with stats_channel.collect() as sink:
                    lg, state = model.decode_step(params, state, tok[:, None])
                r = _collapse_rows(sink, B)
                if r is not None:
                    rows.append(r)
                bnd = _collapse_bounded(sink)
                if bnd is not None:
                    bounded.append(bnd)
            else:
                lg, state = model.decode_step(params, state, tok[:, None])
            tok = draw(lg)
    granted = used = skipped = None
    if rows:
        used = torch.stack(rows).mean(dim=0)                # (B,)
        if n_planes is not None:
            granted = n_planes
            budget = n_planes.to(torch.float32)
        else:
            # no explicit budget: layers ran at their static default
            granted = budget = float(model.cfg.dslot.n_planes
                                     or model.cfg.dslot.n_bits)
        skipped = 1.0 - used / budget
    return GenerateResult(
        tokens=torch.stack(toks, dim=1) if toks else
        torch.zeros((B, 0), dtype=torch.int32, device=tokens.device),
        n_planes=granted, planes_used_mean=used, skipped_frac=skipped,
        planes_bounded_mean=torch.stack(bounded).mean() if bounded else None,
        steps=max_new_tokens, phase="done")
