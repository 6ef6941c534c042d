"""Serving-layer configuration (port of ``repro.serve.config``).

``ServeConfig`` is the one construction argument of ``ServeEngine`` beyond
``(model, params)``: pool geometry, the chunked-prefill admission pipeline,
sampling, the precision policy, the SLO control loop and the hardening
knobs.  Model-level execution knobs (DSLOT precision, block geometry) stay
in ``repro_torch.configs.base.DslotConfig``::

    eng = ServeEngine(model, params, ServeConfig(n_slots=4, max_len=512))

One of the reference's fields is not here: ``jit_prefill`` selects between
a compiled and an eager lane forward, while the port runs every forward
eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.serve.slo import SloConfig

__all__ = ["ServeConfig"]


@dataclass(frozen=True)
class ServeConfig:
    """Engine construction knobs.

    n_slots: decode-pool width — concurrently DECODING requests.
    max_len: KV-ring capacity per slot.  ``try_add`` rejects requests with
        ``len(prompt) + max_new > max_len`` (the ring would wrap).
    prefill_chunk: prompt tokens processed per unit of admission work; the
        engine spends at most ``chunks_per_step`` chunks of prefill per
        decode step, which bounds the decode stall an admission can cause.
        Clamped to the KV-ring capacity.  ``0`` disables chunking: each
        claimed admission prefills its whole remaining prompt in the tick's
        one batched forward.
    chunks_per_step: admission-work budget per engine step, spent by the
        hybrid tick.  It is both the lane count — up to ``chunks_per_step``
        PREFILLING requests advance together, one chunk each, in one batched
        ragged-offset forward per step — and the sequential budget: leftover
        budget goes to extra chunks of the head (FIFO) task.  Values below 1
        are clamped to 1.
    max_queue: bound on requests waiting for admission (pending + in-flight
        prefill); ``try_add`` returns False when full.  ``None`` means
        unbounded.
    sample: token sampler ``(logits) -> (B,) int32``; ``None`` means greedy
        argmax.
    precision_policy: a ``repro_torch.runtime`` precision policy consulted
        at enqueue for requests without an explicit ``n_planes`` and fed the
        planes-executed account on finish.  ``None`` disables.
    slo: SLO control-loop config (``repro_torch.serve.slo.SloConfig``);
        ``None`` disables load-driven plane shedding.
    default_deadline_steps: deadline (engine steps from enqueue) for
        requests that set no ``Request.deadline_steps``; an overdue request
        is evicted wherever it is with ``phase == "timeout"``.  ``None``
        disables engine-wide deadlines.
    max_step_retries: bounded retry budget for exceptions inside one
        ``step()``: the admission tick and the pooled decode forward are each
        retried up to this many times before the step gives that phase up
        (admission: the in-flight tasks fail; decode: the pool stalls one
        step).  ``step()`` never raises either way.
    quarantine_nonfinite: quarantine exactly the slot whose logits are
        non-finite after a pooled decode step (``phase == "quarantined"``);
        co-batched survivors keep their token streams.
    faults: a ``repro_torch.serve.faults.FaultPlan`` consulted at the
        engine's fault hook points; ``None`` injects nothing.
    mesh: tensor-parallel mesh (a ``DeviceMesh``, e.g. from
        ``repro_torch.launch.mesh.make_test_mesh``).  The engine installs it
        in ``models/pspec.py``, keeps the rank's model slice of the
        parameters (``train.sharding.model_slice``), prepares the DSLOT
        weights N-sharded over ``mesh[tp_axis]`` and runs every forward
        split over that axis (``pspec.model_shard``: heads over KV rings
        split along their slots, ``d_ff``, the vocab).  Every rank runs the
        same engine on the same traffic; token streams equal
        ``mesh=None``'s.
    tp_axis: the mesh axis the DSLOT N tiles and the forward split over;
        with a mesh it must be "model", the axis the parameters are cut
        over (``train.sharding.mesh_axes``), or the engine raises.
    """
    n_slots: int = 4
    max_len: int = 512
    prefill_chunk: int = 32
    chunks_per_step: int = 1
    max_queue: int | None = None
    sample: Callable | None = None
    precision_policy: Any = None
    slo: SloConfig | None = None
    default_deadline_steps: int | None = None
    max_step_retries: int = 2
    quarantine_nonfinite: bool = True
    faults: Any = None
    mesh: Any = None
    tp_axis: str = "model"
