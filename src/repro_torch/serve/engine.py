"""Serving engine (port of ``repro.serve.engine``): the batch ``generate``
API and the slot-pool ``ServeEngine``.

``generate`` prefills once and decodes N tokens, and returns a
:class:`repro_torch.serve.result.GenerateResult` — the tokens plus the
per-request planes-executed account when the DSLOT path is on.  The
reference's decode ``lax.scan`` is a Python loop here.  Tokens and
statistics stay on the device: the loop never waits for the card.

``ServeEngine`` is the serving shape: a fixed pool of B slots, one pooled
decode forward per step for every live slot, finished slots free at once.
Construction takes ``(model, params, cfg: ServeConfig)`` (the reference's
older ``n_slots=``/``max_len=``/``sample=``/``precision_policy=``/
``serve_config=`` keywords are mapped onto a config by a warn-once
deprecation shim).  Admission is non-blocking and batched: ``try_add`` only
validates and enqueues, and each step runs one batched admission forward —
up to ``ServeConfig.chunks_per_step`` PREFILLING requests advance by one
``prefill_chunk`` of prompt each (``repro_torch.serve.prefill``) — before
the pooled decode.  A request moves through PENDING -> PREFILLING ->
DECODING -> DONE (``Request.phase``); its slot joins the pooled decode the
step its last prompt chunk lands.

Streaming: every emitted token is pushed through ``Request.on_token`` (when
set) the step it is sampled, and ``Request.token_steps`` records the engine
step of each token; ``ServeEngine.stream(req)`` is a generator over them.

Per-slot position vectors through the model's per-sequence KV rings make
the batch composition dynamic: merging a finished prefill into the pool
never disturbs other slots, and chunked admission gives the tokens of a
solo ``generate`` of the same prompt (in DSLOT mode with a calibrated
``DslotConfig.act_scale``: per-call max quantization is not invariant to
how a prompt is split, so ``try_add`` rejects budgeted multi-chunk
admissions on an uncalibrated model).

Hardening: ``step()`` never raises.  Exceptions from admission or decode
forwards are retried up to ``ServeConfig.max_step_retries`` times and logged
to ``ServeEngine.errors``.  The model writes its full-attention KV rings in
place, and the step stays transactional all the same: ``pos``, the
recurrent states, a chunk's sliding-window rings and the host bookkeeping
move only after a forward succeeds, and a retry writes the same ring rows
with the same values.  Non-finite logit rows quarantine exactly the poisoned
slot; per-request deadlines evict overdue requests wherever they are;
``drain()``/``close()`` shut down; the fault plane in
``repro_torch.serve.faults`` (``ServeConfig.faults``) exercises it all, and
``check_invariants()`` (``repro_torch.serve.health``) audits it.

DSLOT serving mode (``cfg.dslot.enabled`` + ReLU MLPs): the engine prepares
the weight-stationary plane tables once at construction, every request
carries its own digit-plane budget (explicit ``Request.n_planes`` or granted
by a ``repro_torch.runtime`` precision policy at enqueue), prefill chunks and
the pooled decode run each request's rows at its budget (a device tensor
that reaches every DSLOT MLP through ``precision_scope``), and the
per-request planes-executed account is fed back to the policy on finish.
With ``ServeConfig.slo`` set, a ``repro_torch.serve.slo.SloController``
clamps every slot's budget to its QoS tier's current level each step —
shedding planes under a burst, restoring them under slack.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

from repro_torch.kernels.ops import DslotWeights
from repro_torch.models import stats as stats_channel
from repro_torch.models.attention import cache_capacity
from repro_torch.models.mlp import mlp_uses_dslot
from repro_torch.models.model_zoo import Model
from repro_torch.runtime import PolicyFeedback, precision_scope
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.faults import FaultInjector
from repro_torch.serve.prefill import (CANCELLED, DECODING, DONE, FAILED,
                                       PREFILLING, QUARANTINED, TIMEOUT,
                                       PrefillPipeline, _batch_axes)
from repro_torch.serve.result import GenerateResult
from repro_torch.serve.slo import STANDARD, TIERS, SloController, SloSignals
from repro_torch.tree import tree_map

__all__ = ["Request", "ServeEngine", "generate", "greedy_sample",
           "temperature_sample"]

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
             generator: torch.Generator | None = None, n_planes=None,
             return_stats: bool | None = None) -> GenerateResult:
    """Prefill + greedy/temperature decode.  Returns a ``GenerateResult``
    (``.tokens`` is (B, max_new_tokens); the DSLOT planes-executed account
    rides along when the digit-serial path is on).

    ``n_planes``: runtime DSLOT precision — int or per-request (B,) int
    vector (ignored unless the model's digit-serial MLP path is enabled).
    ``generator``: passed to ``sample`` (``temperature_sample`` needs one).
    The decode runs ``max_new_tokens`` steps, like the reference's scan:
    the last step's token is not returned.

    ``return_stats`` is deprecated: ``True`` returns the legacy ``(tokens,
    stats_dict)`` tuple, ``False`` the bare tokens tensor (both warn once).
    Leave it unset for the ``GenerateResult``.
    """
    if return_stats is not None:
        _warn_once(
            "generate.return_stats",
            "generate(return_stats=...) is deprecated; generate() now "
            "returns a GenerateResult — use .tokens / .planes_used_mean / "
            ".skipped_frac")
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
    # statistics are collected exactly when the DSLOT path can produce them,
    # unless the deprecated flag says otherwise
    want_stats = mlp_uses_dslot(model.cfg) if return_stats is None \
        else bool(return_stats)

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
    result = GenerateResult(
        tokens=torch.stack(toks, dim=1) if toks else
        torch.zeros((B, 0), dtype=torch.int32, device=tokens.device),
        n_planes=granted, planes_used_mean=used, skipped_frac=skipped,
        planes_bounded_mean=torch.stack(bounded).mean() if bounded else None,
        steps=max_new_tokens, phase="done")
    if return_stats is True:
        return result.tokens, result.stats
    if return_stats is False:
        return result.tokens
    return result


# one DeprecationWarning per legacy surface per process — enough to nudge a
# migration without drowning a driving loop in repeats
_LEGACY_WARNED: set[str] = set()


def _warn_once(key: str, msg: str) -> None:
    if key in _LEGACY_WARNED:
        return
    _LEGACY_WARNED.add(key)
    warnings.warn(msg, DeprecationWarning, stacklevel=3)


@dataclass
class Request:
    uid: int
    prompt: np.ndarray                 # (S,) integer token ids
    max_new: int
    n_planes: int | None = None        # per-request DSLOT precision (None =
                                       # policy-assigned or full n_bits)
    tier: str = STANDARD               # QoS tier (repro_torch.serve.slo)
    deadline_steps: int | None = None  # engine steps from enqueue before
                                       # timeout eviction (None = engine's
                                       # ServeConfig.default_deadline_steps)
    on_token: Callable | None = None   # streaming: called (req, token, step)
                                       # the step each token is emitted
    out: list = field(default_factory=list)
    token_steps: list = field(default_factory=list)  # engine step per token
    done: bool = False
    dslot_stats: dict | None = None    # set on finish in DSLOT mode
    result: GenerateResult | None = None  # set on finish / eviction
    phase: str = "new"                 # pending|prefilling|decoding|done|...
    enqueue_step: int | None = None    # engine step count at try_add
    first_token_step: int | None = None  # step that emitted out[0]

    @property
    def ttft_steps(self) -> int | None:
        """Engine steps from enqueue to first emitted token."""
        if self.enqueue_step is None or self.first_token_step is None:
            return None
        return self.first_token_step - self.enqueue_step


def _dslot_calibrated(params) -> bool:
    """True iff every prepared ``DslotWeights`` in the tree carries a
    calibrated activation scale (False when none are found)."""
    found, ok = False, True

    def walk(node):
        nonlocal found, ok
        if isinstance(node, DslotWeights):
            found = True
            ok = ok and node.x_scale is not None
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(params)
    return found and ok


def _params_device(params) -> torch.device:
    """The device of the first tensor in a params tree: the engine keeps its
    decode state beside the weights."""
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            return node.device
        if isinstance(node, dict):
            stack.extend(reversed(list(node.values())))
        elif isinstance(node, (list, tuple)):
            stack.extend(reversed(node))
    raise ValueError("params hold no tensor")


class ServeEngine:
    """Slot-pool continuous batching with one pooled decode forward per
    step, chunked-prefill admission interleaved into the step loop, and an
    optional SLO plane-shedding control loop."""

    def __init__(self, model: Model, params,
                 cfg: ServeConfig | None = None, *,
                 n_slots: int | None = None, max_len: int | None = None,
                 sample: Callable | None = None,
                 precision_policy=None,
                 serve_config: ServeConfig | None = None):
        legacy = {k: v for k, v in (("n_slots", n_slots),
                                    ("max_len", max_len),
                                    ("sample", sample),
                                    ("precision_policy", precision_policy))
                  if v is not None}
        if serve_config is not None or legacy:
            # deprecation shim: fold the accreted keywords onto a ServeConfig
            if cfg is not None:
                raise TypeError(
                    "pass either cfg=ServeConfig(...) or the legacy "
                    "keywords, not both")
            _warn_once(
                "ServeEngine.kwargs",
                "ServeEngine(model, params, n_slots=..., max_len=..., "
                "serve_config=...) is deprecated; pass a single "
                "ServeConfig: ServeEngine(model, params, ServeConfig("
                "n_slots=..., max_len=..., ...))")
            cfg = dataclasses.replace(serve_config or ServeConfig(), **legacy)
        self.cfg = cfg or ServeConfig()
        self.model = model
        self.dslot = mlp_uses_dslot(model.cfg)
        # one-time weight-stationary lowering: every decode step executes
        # against the prepared digit-plane tables (no per-call re-encode)
        self.params = model.prepare_dslot(params) if self.dslot else params
        self.device = _params_device(self.params)
        self.n_slots = self.cfg.n_slots
        self.max_len = self.cfg.max_len
        self.sample = self.cfg.sample or greedy_sample
        self.policy = self.cfg.precision_policy
        self.n_bits = model.cfg.dslot.n_bits
        self.calibrated = (not self.dslot) or _dslot_calibrated(self.params)
        self.slo: SloController | None = None if self.cfg.slo is None \
            else SloController(self.n_bits, self.cfg.slo)
        self.state = model.init_decode_state(self.n_slots, self.max_len,
                                             device=self.device)
        self.slot_req: list[Request | None] = [None] * self.n_slots
        self.next_tok = np.zeros(self.n_slots, np.int32)
        self.last_budget: np.ndarray | None = None  # budgets of last decode
        self._acc_planes = np.zeros(self.n_slots, np.float64)
        self._acc_bounded = np.zeros(self.n_slots, np.float64)
        self._acc_steps = np.zeros(self.n_slots, np.int64)
        self._steps = 0
        self._ttft_obs: list[int] = []     # TTFTs landed since last signal
        self._last_rows_mean: float | None = None
        # hardening state: the fault log (step, site, repr(exc)) of every
        # absorbed exception, the quarantine/timeout eviction records, and
        # the optional deterministic fault-injection plane
        self.errors: list[tuple[int, str, str]] = []
        self.quarantined: list[tuple[int, int]] = []   # (step, uid)
        self.timeouts: list[tuple[int, int]] = []      # (step, uid)
        self.injector: FaultInjector | None = \
            None if self.cfg.faults is None else FaultInjector(self.cfg.faults)
        self._closed = False
        self._state_axes = None            # lazy: KV-corruption fault hook
        self.pipeline = PrefillPipeline(
            model=model, params=self.params, max_len=self.max_len,
            device=self.device, chunk=self.cfg.prefill_chunk,
            chunks_per_step=self.cfg.chunks_per_step,
            max_queue=self.cfg.max_queue,
            dslot=self.dslot, calibrated=self.calibrated,
            injector=self.injector)

    def _decode(self, tokens: torch.Tensor, budgets: torch.Tensor):
        """The pooled decode forward at per-slot budgets, with its DSLOT
        statistics and a per-slot finite-logits flag.  Writes the KV rings
        in place; returns the new ``pos`` in the state, uncommitted."""
        with stats_channel.collect() as sink, precision_scope(budgets):
            lg, st2 = self.model.decode_step(self.params, self.state, tokens)
        rows = _collapse_rows(sink, self.n_slots)
        bnd = _collapse_bounded(sink)
        aux = {} if rows is None else {"rows": rows}
        if bnd is not None:
            aux["bounded"] = bnd
        # per-slot non-finite detection: the quarantine guard reads it
        aux["finite"] = torch.isfinite(lg).all(dim=-1)
        return lg, st2, aux

    @property
    def serve_config(self) -> ServeConfig:
        """Back-compat alias for the engine's config."""
        return self.cfg

    # ------------------------------------------------------------ requests

    def try_add(self, req: Request) -> bool:
        """Enqueue a request for admission — non-blocking.

        No model work happens here: the request joins the FIFO admission
        queue and the step loop prefills it one ``prefill_chunk`` at a time.
        Returns False only when the admission queue is full
        (``ServeConfig.max_queue``) — retry later.

        Requests that can never run are rejected with ``ValueError``: an
        empty, non-1-D or non-integer prompt, token ids outside
        ``[0, vocab_size)``, a non-positive generation budget,
        ``len(prompt) + max_new > max_len`` (the KV ring would wrap), a
        whole-prompt admission (``prefill_chunk == 0``) whose prompt exceeds
        the ring capacity, an unknown QoS tier, or — in DSLOT mode — a
        per-request plane budget whose prompt would be split into several
        chunks on a model with no calibrated activation scale.

        Policy-assigned precision (DSLOT mode) is granted here, at enqueue;
        a per-layer policy is flattened to the budget of the MLP
        up-projection (falling back to the schedule's ``"*"`` default).
        """
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        prompt = np.asarray(req.prompt)
        if prompt.ndim != 1:
            raise ValueError(
                f"request {req.uid}: prompt must be 1-D, got shape "
                f"{prompt.shape}")
        if not np.issubdtype(prompt.dtype, np.integer):
            raise ValueError(
                f"request {req.uid}: prompt dtype {prompt.dtype} is not an "
                f"integer type — token ids must be integers (a float "
                f"prompt would be silently truncated into the shared ring)")
        req.prompt = prompt
        P = int(len(req.prompt))
        if P < 1:
            raise ValueError(f"request {req.uid}: empty prompt")
        vocab = int(self.model.cfg.vocab_size)
        lo, hi = int(prompt.min()), int(prompt.max())
        if lo < 0 or hi >= vocab:
            raise ValueError(
                f"request {req.uid}: token ids must be in [0, {vocab}), "
                f"got range [{lo}, {hi}] — an out-of-vocab id reads "
                f"garbage through the embedding gather and poisons the "
                f"shared decode state")
        if req.max_new < 1:
            raise ValueError(
                f"request {req.uid}: max_new must be >= 1, got {req.max_new}")
        if P + req.max_new > self.max_len:
            raise ValueError(
                f"request {req.uid}: prompt ({P}) + max_new ({req.max_new}) "
                f"= {P + req.max_new} exceeds max_len ({self.max_len}); the "
                f"KV ring would wrap and corrupt the sequence")
        cap = cache_capacity(self.model.cfg, self.max_len)
        if self.pipeline.chunk == 0 and P > cap:
            raise ValueError(
                f"request {req.uid}: whole-prompt admission "
                f"(prefill_chunk=0) cannot ingest a {P}-token prompt into "
                f"a KV ring of capacity {cap} (sliding window "
                f"{self.model.cfg.window}); the ring would wrap.  Use "
                f"chunked admission (prefill_chunk > 0)")
        known_tiers = self.slo.tiers if self.slo is not None else TIERS
        if req.tier not in known_tiers:
            raise ValueError(
                f"request {req.uid}: unknown QoS tier {req.tier!r} "
                f"(known: {sorted(known_tiers)})")
        wants_budget = req.n_planes is not None or (
            self.dslot and self.policy is not None)
        if (self.dslot and not self.calibrated and wants_budget
                and 0 < self.pipeline.chunk < P):
            raise ValueError(
                f"request {req.uid}: a per-request DSLOT plane budget with "
                f"a chunked prompt ({P} tokens > prefill_chunk="
                f"{self.pipeline.chunk}) requires a calibrated activation "
                "scale — per-call max quantization is not invariant to how "
                "the prompt is split into chunks.  Set DslotConfig.act_scale"
                " (or DslotWeights.with_scale), or use prefill_chunk=0")
        if not self.pipeline.enqueue(req):
            return False        # queue full: the policy is NOT consulted, so
                                # a later retry gets a fresh grant
        if self.dslot and req.n_planes is None and self.policy is not None:
            nxt = self.policy.next_precision()
            if isinstance(nxt, dict):
                nxt = nxt.get("mlp_up_dslot", nxt.get("*", self.n_bits))
            req.n_planes = int(nxt)
        req.enqueue_step = self._steps
        return True

    def cancel(self, uid: int) -> bool:
        """Abandon a request wherever it is in its lifecycle.

        Pending: removed from the queue.  Mid-prefill: the private lane work
        is dropped and the reserved slot released.  Decoding: the slot is
        freed; its stale rows are invisible to other slots (per-sequence
        rings) and are overwritten by the next admission's merge.

        Cancellation is terminal: ``req.done`` is set (with
        ``phase == "cancelled"``) and ``req.result`` carries whatever was
        produced.  A cancelled request is never returned from ``step()``.
        """
        return self._evict(uid, CANCELLED) is not None

    def _evict(self, uid: int, phase: str) -> Request | None:
        """Terminate a request wherever it lives (queue, prefill lane, or
        decode slot) with the given terminal phase, freeing its slot and
        lane, and attach its ``GenerateResult``."""
        found = next((r for r in list(self.pipeline.queue)
                      + [t.req for t in self.pipeline.active]
                      if r.uid == uid), None)
        if self.pipeline.cancel(uid):
            if found is not None:
                found.phase = phase
                found.result = self._result_of(found)
            return found
        for i, req in enumerate(self.slot_req):
            if req is not None and req.uid == uid:
                req.phase = phase
                req.done = True
                req.result = self._result_of(req)
                self.slot_req[i] = None
                return req
        return None

    def stream(self, req: Request) -> Iterator[int]:
        """Generator handle over a request's token stream.

        Admits ``req`` if it is new (raising ``RuntimeError`` on a full
        queue), then drives ``step()`` and yields each generated token as
        it lands.  A consumer that stops iterating cancels the request, so
        an abandoned stream frees its slot and lane.
        """
        if req.phase == "new" and not self.try_add(req):
            raise RuntimeError(
                f"request {req.uid}: admission queue full")
        sent = 0
        try:
            while True:
                while sent < len(req.out):
                    yield req.out[sent]
                    sent += 1
                if req.done:
                    return
                self.step()
        finally:
            if not req.done:
                self.cancel(req.uid)

    @property
    def queue_depth(self) -> int:
        """Admitted-but-not-yet-decodable requests (pending + prefilling)."""
        return len(self.pipeline)

    @property
    def steps(self) -> int:
        """Engine steps taken so far (the clock ``ttft_steps`` is in)."""
        return self._steps

    def slot_phases(self) -> list[str]:
        """Phase of each pool slot: 'free' | PREFILLING | DECODING."""
        held = {t.slot for t in self.pipeline.active}
        return [PREFILLING if i in held
                else (DECODING if r is not None else "free")
                for i, r in enumerate(self.slot_req)]

    def _free_slot(self, exclude: set = frozenset()) -> int | None:
        held = {t.slot for t in self.pipeline.active}
        for i, r in enumerate(self.slot_req):
            if r is None and i not in held and i not in exclude:
                return i
        return None

    def _budget_vector(self) -> list[int]:
        npl = []
        for r in self.slot_req:
            base = self.n_bits if r is None or r.n_planes is None \
                else r.n_planes
            if self.slo is not None and r is not None:
                base = self.slo.budget_for(r.tier, base)
            npl.append(int(base))
        return npl

    # ------------------------------------------------------------ stepping

    def _admission_tick(self) -> None:
        """One step's worth of admission work; completed prefills are
        copied into their slots' rows and decode from this step on."""
        for task in self.pipeline.tick(self._free_slot):
            i = task.slot
            _merge_slot(self.state, task.state, i)
            self.slot_req[i] = task.req
            task.req.phase = DECODING
            self._acc_planes[i] = 0.0
            self._acc_bounded[i] = 0.0
            self._acc_steps[i] = 0
            # first token through the engine's sample fn (greedy by default),
            # as ``generate`` does with its prefill logits
            self.next_tok[i] = int(self.sample(task.logits)[0])

    def _evict_timeouts(self) -> int:
        """Deadline sweep: evict every request past its deadline — queued,
        mid-prefill, or decoding — with ``phase == "timeout"``.  Runs before
        the admission tick so an overdue queued request never claims a
        lane.  Returns the eviction count (SLO pressure)."""
        default = self.cfg.default_deadline_steps
        expired = []
        for req in (list(self.pipeline.queue)
                    + [t.req for t in self.pipeline.active]
                    + [r for r in self.slot_req if r is not None]):
            dl = req.deadline_steps if req.deadline_steps is not None \
                else default
            if dl is None or req.enqueue_step is None:
                continue
            if self._steps - req.enqueue_step > dl:
                expired.append(req.uid)
        n = 0
        for uid in expired:
            if self._evict(uid, TIMEOUT) is not None:
                self.timeouts.append((self._steps, uid))
                n += 1
        return n

    def _fault_slot(self, fault) -> int | None:
        """Resolve a fault's target to a pool slot.  ``uid`` targets wait
        (return None, keeping the fault pending) until the request is
        decoding; ``slot`` targets fire as planned."""
        if fault.uid is not None:
            for i, r in enumerate(self.slot_req):
                if r is not None and r.uid == fault.uid:
                    return i
            return None
        if fault.slot is not None and 0 <= fault.slot < self.n_slots:
            return fault.slot
        return None

    def _corrupt_slot(self, slot: int) -> None:
        """Write NaN over one slot's floating-point rows of the decode state
        (the KV rings), in place — the ``kv_corrupt`` fault hook.  Integer
        tensors (ring positions, ``pos``) are left intact, so the corruption
        is a bad value, not broken indexing; the quarantine guard catches
        the NaN logits on the next decode step."""
        if self._state_axes is None:
            self._state_axes = _batch_axes(self.model, self.max_len)

        def scribble(leaf, ax):
            if ax >= 0 and leaf.is_floating_point():
                leaf.narrow(ax, slot, 1).fill_(float("nan"))

        tree_map(scribble, self.state, self._state_axes)

    def step(self) -> list[Request]:
        """One engine step: deadline sweep, admission chunk(s), SLO
        control, then advance all live slots by one token.  Returns
        finished requests.

        Never raises (a closed engine excepted): exceptions from admission
        or decode work are retried up to ``ServeConfig.max_step_retries``
        times within the step and logged to ``self.errors``.  Admission that
        fails every retry evicts its in-flight tasks with
        ``phase == "failed"``; a decode that fails every retry stalls the
        pool one step, with ``pos`` and every request as they were — ring
        rows a failed attempt wrote sit at positions the next decode writes
        again before it reads them.
        """
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        self._steps += 1
        inj = self.injector
        if inj is not None:
            inj.begin_step(self._steps)
            for f in inj.slow_steps():            # artificial latency
                time.sleep(f.value or 0.0)
            for uid in inj.cancels():             # replayable cancel storms
                self.cancel(uid)
        timed_out = self._evict_timeouts()
        f0 = self.pipeline.forwards
        for _ in range(self.cfg.max_step_retries + 1):
            try:
                if inj is not None:
                    inj.raise_if("admission_tick")
                self._admission_tick()
                break
            except Exception as e:  # noqa: BLE001 — absorb, log, retry
                self.errors.append((self._steps, "admission", repr(e)))
        else:
            # every retry failed: fail the in-flight admissions so the lanes
            # recover next step (the queue is untouched)
            for task in list(self.pipeline.active):
                self._evict(task.req.uid, FAILED)
        if self.slo is not None:
            # load signals: queue after this step's admissions, the TTFTs
            # that landed since the last update, and last decode's planes
            self.slo.update(SloSignals(
                queue_depth=self.queue_depth,
                ttft_steps=self._ttft_obs,
                decode_stalled=self.pipeline.forwards > f0,
                planes_used_mean=self._last_rows_mean,
                timed_out=timed_out))
            self._ttft_obs = []
        if all(r is None for r in self.slot_req):
            return []
        toks = torch.from_numpy(self.next_tok[:, None].copy()).to(self.device)
        budget_list = self._budget_vector()
        budgets = torch.tensor(budget_list, dtype=torch.int32,
                               device=self.device)
        decoded = None
        for _ in range(self.cfg.max_step_retries + 1):
            try:
                if inj is not None:
                    inj.raise_if("decode_forward")
                decoded = self._decode(toks, budgets)
                break
            except Exception as e:  # noqa: BLE001
                self.errors.append((self._steps, "decode", repr(e)))
        if decoded is None:
            # decode failed every retry: pos, tokens and accounting are
            # untouched, the pool stalls this step and retries next step
            return []
        logits, state2, aux = decoded
        self.last_budget = np.asarray(budget_list, np.int32)
        poisoned = False
        if inj is not None:
            logits, poisoned = inj.poison_logits(logits, self._fault_slot)
        self.state = state2
        if inj is not None:
            for slot in inj.kv_corruptions(self._fault_slot):
                self._corrupt_slot(slot)
        # the step's host reads — sampled tokens, the finite flags, the
        # per-slot planes and the bounded planes — in one device-to-host copy
        parts = [self.sample(logits).to(torch.float64)]
        if self.cfg.quarantine_nonfinite:
            fin = torch.isfinite(logits).all(dim=-1) if poisoned \
                else aux["finite"]
            parts.append(fin.to(torch.float64))
        if "rows" in aux:
            parts.append(aux["rows"].to(torch.float64))
        if "bounded" in aux:
            parts.append(aux["bounded"].to(torch.float64).reshape(1))
        host = torch.cat(parts).cpu().numpy()
        B = self.n_slots
        nxt = host[:B].astype(np.int32)
        at = B
        fin = None
        if self.cfg.quarantine_nonfinite:
            fin = host[at:at + B] != 0
            at += B
        rows = None
        if "rows" in aux:
            rows = host[at:at + B]
            at += B
        bounded = float(host[at]) if "bounded" in aux else None
        self._last_rows_mean = None if rows is None \
            else float(rows.astype(np.float32).mean())
        finished = []
        for i, req in enumerate(self.slot_req):
            if req is None:
                continue
            if fin is not None and not fin[i]:
                # quarantine before emitting: the poisoned logits never
                # reach the stream.  Only this slot is touched — rows are
                # computationally independent (per-sequence rings, row-wise
                # MLP/norm), so survivors' tokens are unchanged.
                self.quarantined.append((self._steps, req.uid))
                req.phase = QUARANTINED
                req.done = True
                req.result = self._result_of(req)
                self.slot_req[i] = None
                continue
            tok = int(self.next_tok[i])
            req.out.append(tok)
            req.token_steps.append(self._steps)
            if req.first_token_step is None:
                req.first_token_step = self._steps
                if req.ttft_steps is not None:
                    self._ttft_obs.append(req.ttft_steps)
            if req.on_token is not None:
                req.on_token(req, tok, self._steps)
            self.next_tok[i] = nxt[i]
            if rows is not None:
                self._acc_planes[i] += float(rows[i])
                if bounded is not None:
                    self._acc_bounded[i] += bounded
                self._acc_steps[i] += 1
            if len(req.out) >= req.max_new:
                req.done = True
                req.phase = DONE
                self._finish_stats(i, req)
                finished.append(req)
                self.slot_req[i] = None
        return finished

    # -------------------------------------------------------- shutdown

    @property
    def closed(self) -> bool:
        """True once :meth:`close` has sealed the engine."""
        return self._closed

    def live_requests(self) -> list[Request]:
        """Every request the engine still owes work: queued, mid-prefill,
        and decoding."""
        return (list(self.pipeline.queue)
                + [t.req for t in self.pipeline.active]
                + [r for r in self.slot_req if r is not None])

    def drain(self, max_steps: int | None = None) -> list[Request]:
        """Graceful shutdown, phase 1: step until every admitted request
        reaches a terminal state, admitting nothing new.  Returns the
        requests that finished naturally during the drain.

        ``max_steps`` bounds the drain; ``None`` derives a worst-case
        sequential bound from the live work (every prompt's chunks plus its
        generation budget) — exceeding it means the engine lost liveness,
        which raises ``RuntimeError``.
        """
        if self._closed:
            return []
        if max_steps is None:
            chunk = self.pipeline.chunk or self.max_len
            max_steps = 16 + sum(
                -(-len(r.prompt) // max(1, chunk)) + r.max_new
                for r in self.live_requests())
        finished: list[Request] = []
        for _ in range(max_steps):
            if not self.live_requests():
                return finished
            finished.extend(self.step())
        if self.live_requests():
            raise RuntimeError(
                f"drain did not converge in {max_steps} steps; still live: "
                f"{[r.uid for r in self.live_requests()]}")
        return finished

    def close(self) -> list[Request]:
        """Graceful shutdown, phase 2 (or immediate shutdown on its own):
        cancel everything still in flight, attaching each request's
        ``GenerateResult``, then seal the engine: ``try_add`` and ``step``
        raise ``RuntimeError`` afterwards.  Idempotent.  Returns the
        requests cancelled by this call."""
        if self._closed:
            return []
        cancelled = []
        for req in self.live_requests():
            if self._evict(req.uid, CANCELLED) is not None:
                cancelled.append(req)
        self._closed = True
        return cancelled

    def check_invariants(self) -> None:
        """Audit slot/queue/lane/ring accounting; raises
        ``repro_torch.serve.health.InvariantViolation`` on corruption."""
        from repro_torch.serve.health import check_invariants
        check_invariants(self)

    def _result_of(self, req: Request, granted=None, used=None,
                   skipped=None, bounded=None) -> GenerateResult:
        return GenerateResult(
            tokens=list(req.out), n_planes=granted,
            planes_used_mean=used, skipped_frac=skipped,
            planes_bounded_mean=bounded,
            ttft_steps=req.ttft_steps,
            steps=None if req.enqueue_step is None
            else self._steps - req.enqueue_step,
            phase=req.phase, uid=req.uid, tier=req.tier)

    def _finish_stats(self, i: int, req: Request) -> None:
        granted = used = skipped = bounded = None
        if self.dslot and self._acc_steps[i] > 0:
            granted = req.n_planes if req.n_planes is not None \
                else self.n_bits
            if self.slo is not None:
                # a tier floor may have raised the effective budget above
                # the granted one (reserved pins full precision)
                granted = max(int(granted), self.slo.floor(req.tier))
            used = self._acc_planes[i] / self._acc_steps[i]
            # skipped_frac counts every granted-but-not-executed plane:
            # activation-side early termination and the weight-side static
            # MSR bound; planes_bounded_mean is the static share alone
            skipped = 1.0 - float(used) / float(granted)
            bounded = self._acc_bounded[i] / self._acc_steps[i]
            fb = PolicyFeedback(n_planes=int(granted),
                                planes_used_mean=float(used),
                                skipped_frac=skipped, tier=req.tier)
            req.dslot_stats = {"n_planes": fb.n_planes,
                               "planes_used_mean": fb.planes_used_mean,
                               "skipped_frac": fb.skipped_frac,
                               "planes_bounded_mean": float(bounded)}
            if self.policy is not None:
                self.policy.observe(fb)
            if self.slo is not None:
                self.slo.observe(fb)
        req.result = self._result_of(req, granted=granted, used=used,
                                     skipped=skipped, bounded=bounded)


def _merge_slot(pool_state: dict, one_state: dict, slot: int) -> None:
    """Copy a one-row prefill state into row ``slot`` of the pooled state,
    in place.

    The batch axis of each tensor is wherever its shape differs from the
    pooled tensor's; only that row of the pool is written, so live slots
    keep decoding undisturbed.
    """
    def merge(pool, one):
        if pool.shape == one.shape:
            if pool.shape and pool.shape[0] == 1:
                pool.copy_(one)                  # 1-slot pool: full replace
            return                               # unbatched: shared
        diff = [a for a, (ps, os) in enumerate(zip(pool.shape, one.shape))
                if ps != os]
        if len(diff) == 1 and one.shape[diff[0]] == 1:
            pool.narrow(diff[0], slot, 1).copy_(one)

    tree_map(merge, pool_state, one_state)
