"""Serving layer (port of ``repro.serve``): slot-pool engine + chunked-prefill
admission pipeline + SLO-driven precision elasticity + a hardened failure
surface.

Public surface, the reference's:

* ``ServeEngine(model, params, cfg: ServeConfig)`` / ``generate`` — the two
  serving paths, both yielding :class:`GenerateResult`.
* ``ServeConfig`` — every engine knob beyond ``(model, params)``.
* ``Request`` — one in-flight generation (QoS ``tier``, per-request
  ``deadline_steps``, streaming ``on_token`` / ``token_steps``, terminal
  ``result``).
* ``SloConfig`` / ``SloController`` / ``TierSpec`` + tier names — the SLO
  plane-shedding control loop (``repro_torch.serve.slo``).
* ``Fault`` / ``FaultPlan`` / ``FaultInjector`` / ``TransientFault`` — the
  deterministic fault-injection plane (``repro_torch.serve.faults``), and
  ``audit_engine`` / ``check_invariants`` / ``InvariantViolation`` — the
  crash-consistency oracle (``repro_torch.serve.health``).
* Lifecycle phases: PENDING -> PREFILLING -> DECODING -> DONE, with the
  terminal evictions CANCELLED / TIMEOUT / QUARANTINED / FAILED.
"""

from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Request, ServeEngine, generate
from repro_torch.serve.faults import (FAULT_KINDS, Fault, FaultInjector,
                                      FaultPlan, TransientFault)
from repro_torch.serve.health import (InvariantViolation, audit_engine,
                                      check_invariants)
from repro_torch.serve.prefill import (CANCELLED, DECODING, DONE, FAILED,
                                       PENDING, PREFILLING, QUARANTINED,
                                       TIMEOUT, PrefillPipeline, PrefillTask)
from repro_torch.serve.result import GenerateResult
from repro_torch.serve.slo import (DEGRADABLE, RESERVED, STANDARD, TIERS,
                                   SloConfig, SloController, SloSignals,
                                   TierSpec, default_tiers)

__all__ = ["ServeConfig", "Request", "ServeEngine", "generate",
           "GenerateResult",
           "PrefillPipeline", "PrefillTask", "PENDING", "PREFILLING",
           "DECODING", "DONE", "CANCELLED", "TIMEOUT", "QUARANTINED",
           "FAILED",
           "Fault", "FaultPlan", "FaultInjector", "TransientFault",
           "FAULT_KINDS",
           "InvariantViolation", "audit_engine", "check_invariants",
           "SloConfig", "SloController", "SloSignals", "TierSpec",
           "default_tiers", "RESERVED", "STANDARD", "DEGRADABLE", "TIERS"]
