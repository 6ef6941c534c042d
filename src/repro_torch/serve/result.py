"""Generation result type (port of ``repro.serve.result``).

``generate`` (the batch API) returns a :class:`GenerateResult`; the
slot-pool engine attaches one to every finished request
(``Request.result``).

Conventions:

* ``tokens`` is a ``(B, T)`` tensor on the batch path and a ``list[int]``
  on the engine path (one request = one sequence).
* plane statistics (``planes_used_mean`` / ``skipped_frac``) are ``None``
  unless the model ran the DSLOT digit-serial path; on the batch path they
  are per-request ``(B,)`` tensors, on the engine path python floats.
* ``ttft_steps`` / ``steps`` are in the engine-steps clock and
  ``ttft_steps`` is ``None`` on the batch path (there is no admission
  queue, so there is no TTFT to observe).
"""

from __future__ import annotations

import dataclasses
from typing import Any

__all__ = ["GenerateResult"]


@dataclasses.dataclass
class GenerateResult:
    """What one generation produced, and what it cost.

    tokens: generated tokens — (B, T) tensor (batch path) or list[int]
        (engine path).
    n_planes: the granted DSLOT plane budget the run decoded at (int,
        per-request (B,) tensor, or None when the digit-serial path is off).
    planes_used_mean: effective digit planes executed per output row — the
        paper's energy proxy (None when DSLOT is off).
    skipped_frac: fraction of the granted plane budget not executed —
        activation-side early termination plus the weight-side static MSR
        bound (see planes_bounded_mean for the static share alone).
    planes_bounded_mean: mean digit planes per output tile never issued
        because the prepare-time weight-side MSR bound capped the tile
        (request-independent, a scalar; None when DSLOT is off).
    ttft_steps: engine steps from enqueue to first token (engine path).
    steps: engine steps from enqueue to finish (engine path) or the decode
        length (batch path).
    phase: terminal lifecycle phase — "done" on the batch path; the engine
        also evicts with "cancelled", "timeout" (deadline expired),
        "quarantined" (non-finite logits isolated) or "failed" (admission
        kept raising past the retry budget).
    uid / tier: request identity and QoS tier (engine path only).
    """
    tokens: Any
    n_planes: Any = None
    planes_used_mean: Any = None
    skipped_frac: Any = None
    planes_bounded_mean: Any = None
    ttft_steps: int | None = None
    steps: int | None = None
    phase: str = "done"
    uid: int | None = None
    tier: str | None = None

    @property
    def stats(self) -> dict:
        """The plane statistics as a dict (empty when DSLOT is off)."""
        if self.planes_used_mean is None:
            return {}
        return {"planes_used_mean": self.planes_used_mean,
                "skipped_frac": self.skipped_frac}
