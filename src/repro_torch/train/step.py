"""Train step: gradient accumulation over microbatches + AdamW (port of
``repro.train.step``, one device).

Batch layout is ``(M, mb, ...)``: microbatch axis first.  The step loops
over the M microbatches, takes one ``torch.autograd.grad`` of ``loss_fn``
for each, sums the gradients into f32 and scales them by ``1/M``, then
runs ``adamw_update``.  Forward, backward and update all run inside
``full_f32()``: the backward pass of a product or convolution accumulates
in f32 as the reference does (no TF32, no half-precision split-K).

The reference jits the step with the old state donated.  Here the step
updates the state's parameter and moment tensors in place and returns a
state that holds them: the old state must not be used again, and a caller
that steps twice from one state clones it first.

``make_sharded_train_step`` is the step over a mesh (the reference's
``make_train_step`` jitted with FSDP x TP shardings): the state is stored
sharded by ``train.sharding.make_state_shardings``.  Each rank computes
the gradients of its slice of the batch with the compute split over
``model`` as the reference's ``constrain`` asks (Megatron's column- and
row-parallel attention, MLP and expert FFN, a vocab-parallel embedding,
head and cross-entropy) and by the Mamba2 mixer's heads and the RG-LRU's
width (``models/pspec.py`` ``model_shard``).  As GSPMD does inside the
reference's scan, the layer stacks' parameters are gathered layer by layer
at use (and again in the remat recompute), and their gradients are
reduce-scattered into the rank's f32 slices as each group's backward
finishes, once per microbatch (``pspec.layer_gather``); the few leaves
outside the stacks are gathered once and averaged after the last
microbatch.  Each rank then updates its own slices.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from repro_torch.device import full_f32, resolve_device
from repro_torch.distributed import all_reduce_sum_, axis_size
from repro_torch.models import pspec
from repro_torch.models.model_zoo import Model, loss_fn
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     init_opt_state)
from repro_torch.train.sharding import (PART, _axis_sizes, _coords,
                                        _spec_axes, buckets, gather_specs,
                                        gather_tree, local_slice, mesh_axes,
                                        model_reads, stack_plan)
from repro_torch.tree import leaves, tree_map

__all__ = ["CollectiveClock", "TrainState", "init_train_state",
           "make_sharded_train_step", "make_train_step", "microbatch_grads"]


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    step: torch.Tensor           # 0-d int32


def init_train_state(model: Model, generator: torch.Generator,
                     device=None) -> TrainState:
    """Parameters from ``generator`` (``Model.init``), zero moments and step
    0, on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    params = model.init(generator, device=dev)
    return TrainState(params=params, opt=init_opt_state(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def microbatch_grads(model: Model, params, batch):
    """``(grads, loss, aux)`` of one batch of ``(M, mb, ...)`` tensors: the
    gradients of ``loss_fn`` summed over the M microbatches in f32 and
    scaled by ``1/M`` (a tree shaped like ``params``, each leaf full size),
    and the mean loss and aux.  Runs in ``full_f32()``.  The one-device
    step's; the sharded step differentiates only the leaves outside the
    layer stacks this way (``_summed_grads``)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    acc, loss, aux, M = _summed_grads(model, live, leaves(live), batch)
    inv = 1.0 / M
    torch._foreach_mul_(acc, inv)
    it = iter(acc)
    return tree_map(lambda _: next(it), params), loss * inv, aux * inv


def _summed_grads(model: Model, live, wrt: list, batch):
    """``(acc, loss, aux, M)``: the gradients of ``loss_fn(model, live,
    microbatch)`` with respect to the tensors ``wrt``, summed over the M
    microbatches of ``batch`` in f32 (zeros for an unused tensor), and the
    summed loss and aux.  Runs in ``full_f32()``."""
    M = leaves(batch)[0].shape[0]
    acc = loss = aux = None
    with full_f32():
        for i in range(M):
            mb = tree_map(lambda a: a[i], batch)
            with torch.enable_grad():
                tot, (ce, ax) = loss_fn(model, live, mb)
                grads = torch.autograd.grad(tot, wrt, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(wrt, grads)]
            if acc is None:
                acc = [g.to(torch.float32) for g in grads]
                loss, aux = ce.detach(), ax.detach()
            else:
                torch._foreach_add_(acc, grads)
                loss, aux = loss + ce.detach(), aux + ax.detach()
            del grads, tot
    return acc, loss, aux, M


def make_train_step(model: Model, opt_cfg: AdamWConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    batch: a tree of ``(M, mb, ...)`` tensors (tokens / labels / frontend /
    src_embeds).  metrics: ``loss`` and ``aux`` (means over the
    microbatches), ``grad_norm`` (before clipping) and ``lr``, as 0-d f32
    tensors on the state's device.
    """

    def train_step(state: TrainState, batch):
        with full_f32():
            grads, loss, aux = microbatch_grads(model, state.params, batch)
            params, opt, om = adamw_update(state.params, grads, state.opt,
                                           opt_cfg)
            del grads
        metrics = {"loss": loss, "aux": aux, **om}
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return train_step


def _reduce_(tensors: list, mesh, axes: tuple, mean: bool) -> list:
    """Each f32 tensor of ``tensors`` replaced in place by its sum (or,
    with ``mean``, its mean) over the ranks of ``axes`` (their product):
    one ``all_reduce`` per ``sharding.buckets`` run, over each axis in
    turn (then, for the mean, a scale).  Every rank gets the same bits."""
    axes = tuple(a for a in axes if axis_size(mesh, a) > 1)
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    if n == 1:
        return tensors
    for run in buckets(tensors):
        part = [tensors[i] for i in run]
        flat = torch.cat([t.reshape(-1) for t in part])
        for a in axes:
            all_reduce_sum_(flat, mesh, a)
        if mean:
            flat.mul_(1.0 / n)
        off = 0
        for t in part:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        del flat
    return tensors


class CollectiveClock:
    """Host seconds spent in a step's collectives (the card synchronized
    before and after each), by kind: ``gather`` (parameters over the batch
    axes, and PART and WHOLE leaves over ``model``: a layer stack's leaves
    at each use, in the forward and the remat recompute, the other leaves
    once a step), ``reduce`` (gradients over the batch axes: a stack
    leaf's reduce-scatter, with its PART sum over ``model``, as each
    group's backward finishes; the other leaves', loss and aux after the
    last microbatch; the norm's sum over the batch axes) and ``model`` (the
    split compute's collectives over the model axis in the forward and
    backward, the model-axis sums of the other leaves' PART gradients and
    of the gradient norm).  Pass one to ``make_sharded_train_step`` to time
    a step's collectives inside its own wall; ``None`` times nothing and
    adds no synchronization.  A kind it has not seen (a split serving
    forward's ``model_gather`` and ``model_combine``) gets its own
    entry."""

    def __init__(self):
        self.seconds = {"gather": 0.0, "reduce": 0.0, "model": 0.0}

    @contextlib.contextmanager
    def __call__(self, kind: str, device):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            self.seconds[kind] = self.seconds.get(kind, 0.0) \
                + time.perf_counter() - t0


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, shardings,
                            clock: CollectiveClock | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` over the
    mesh of ``shardings`` (``train.sharding.Shardings`` of the state).

    ``state`` holds this rank's slices (``shard_tree`` of a full state by
    ``shardings.specs``); ``batch`` is this rank's slice of the global
    batch (``data.pipeline.make_global_batch``).  Every leaf is gathered by
    ``sharding.gather_specs``: a leaf that the split compute reads only as
    the rank's ``model`` slice (``sharding.model_reads`` SPLIT) over the
    batch axes alone, every other leaf over every axis.  One step:

    * the leaves outside the layer stacks (embedding, head, final and
      encoder norms) gathered once (``gather_tree``);
    * the M microbatches' forward and backward on the batch slice under
      ``pspec.data_shard`` (MoE dispatch takes the slice as one group, the
      router's load statistics are averaged over the data shards),
      ``pspec.model_shard`` (heads, ``d_ff``, the vocab and the recurrent
      mixers split over ``model``) and ``pspec.layer_gather``: each Stack
      group's leaves, and each rest layer's, gathered just before the
      layer runs (again in the remat recompute), their gradients summed
      over the batch axes in f32 -- a reduce-scatter to the rank's slice
      -- as each group's backward finishes and added to the step's f32
      slices (the gather's backward writes them there, not through
      autograd, which would round the sum to the slice's dtype): no
      full-size gradient of a stack leaf outside its group's backward.  A
      PART leaf's gradient (``wk``/``wv`` under "group" and "repeat", the
      Mamba2 mixer's ``w_in``, conv and per-head leaves) is summed over
      ``model`` too; a WHOLE leaf's, alike on every model rank, cut to the
      rank's block;
    * the other leaves' gradients summed over the microbatches in f32
      (full size), PART ones summed over ``model``, all averaged over the
      batch axes with loss and aux in bucketed ``all_reduce``s and cut to
      the rank's slice; the stack slices scaled to the same mean;
    * ``grad_norm`` over the stored slices (``_slice_norm``); then
      ``adamw_update`` of this rank's slices.

    All in ``full_f32()``; the metrics are equal on every rank.  The state
    is updated in place, as ``make_train_step``'s is.  Over a model axis of
    one rank nothing splits and the step is the batch-parallel one.
    """
    mesh, specs = shardings
    fsdp, tp = mesh_axes(mesh)
    quiet = contextlib.nullcontext()
    splits = tp is not None and axis_size(mesh, tp) > 1
    n_batch = 1
    for a in fsdp:
        n_batch *= axis_size(mesh, a)
    plan = {}      # the first step's reads, gather specs and stack plan

    def timed(kind, dev):
        return clock(kind, dev) if clock is not None else quiet

    def train_step(state: TrainState, batch):
        flat = leaves(state.params)
        dev = flat[0].device
        if not plan:
            reads = model_reads(mesh, model.cfg, state.params) \
                if splits else None
            gspecs = specs.params if reads is None \
                else gather_specs(specs.params, reads, mesh)
            plan.update(kinds=None if reads is None else leaves(reads),
                        specs=_flat_specs(state.params, gspecs),
                        stored=_flat_specs(state.params, specs.params),
                        stack=_flat_specs(state.params, stack_plan(
                            mesh, specs.params, reads, state.params)))
        kinds, pspecs, stack = plan["kinds"], plan["specs"], plan["stack"]
        inside = [i for i, sp in enumerate(stack) if sp is not None]
        outside = [i for i, sp in enumerate(stack) if sp is None]
        timer = None if clock is None else (lambda kind: clock(kind, dev))
        with full_f32():
            sinks = {i: torch.zeros(flat[i].shape, dtype=torch.float32,
                                    device=dev) for i in inside}
            with timed("gather", dev):
                full = gather_tree([flat[i] for i in outside],
                                   [pspecs[i] for i in outside], mesh)
            wrt = [t.detach().requires_grad_() for t in full]
            token = torch.empty(0, device=dev, requires_grad=True)
            live = list(flat)
            for i, t in zip(outside, wrt):
                live[i] = t
            it = iter(live)
            live = tree_map(lambda _: next(it), state.params)
            table = {id(flat[i]): (stack[i], sinks[i]) for i in inside}
            split = quiet if kinds is None else pspec.model_shard(mesh, tp,
                                                                   timer)
            with pspec.data_shard(mesh, fsdp), split, \
                    pspec.layer_gather(mesh, table, token, timer):
                acc, loss, aux, M = _summed_grads(model, live,
                                                  wrt + [token], batch)
            del full, wrt, live, table, acc[-1]
            inv = 1.0 / M
            torch._foreach_mul_(acc, inv)
            if kinds is not None:
                with timed("model", dev):
                    _reduce_([g for g, i in zip(acc, outside)
                              if kinds[i] == PART], mesh, (tp,), mean=False)
            stats = torch.stack([loss * inv, aux * inv]).to(torch.float32)
            with timed("reduce", dev):
                _reduce_(acc + [stats], mesh, fsdp, mean=True)
            mine = [None] * len(flat)
            for i, g in zip(outside, acc):
                mine[i] = local_slice(g, pspecs[i], mesh).clone()
            del acc
            for i in inside:
                mine[i] = sinks[i]
            del sinks
            torch._foreach_mul_([mine[i] for i in inside], inv / n_batch)
            gnorm = _slice_norm(mine, plan["stored"], mesh, tp,
                                lambda kind: timed(kind, dev))
            it = iter(mine)
            grads = tree_map(lambda _: next(it), state.params)
            del mine
            params, opt, om = adamw_update(state.params, grads, state.opt,
                                           opt_cfg, gnorm=gnorm)
            del grads
        metrics = {"loss": stats[0], "aux": stats[1], **om}
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return train_step


def _flat_specs(params, specs) -> list:
    """The entries of ``specs`` (a tree shaped like ``params`` whose leaves
    may be tuples) in ``leaves(params)`` order."""
    out = []
    tree_map(lambda _, s: out.append(s), params, specs)
    return out


def _slice_norm(slices: list, stored: list, mesh, tp, timed
                ) -> torch.Tensor:
    """The global norm of a gradient held as this rank's stored slices
    (``stored``: each slice's storage spec): each slice's squares summed
    here, a leaf counted on one rank of every axis its spec does not split
    (its copies there are alike), then the sum over every axis of the mesh
    (``timed(kind)``: ``model`` for ``tp``, ``reduce`` for the others);
    f32, equal on every rank."""
    sizes, coords = _axis_sizes(mesh), _coords(mesh)
    axes = [a for a in sizes if sizes[a] > 1]
    mine = torch.zeros(1, dtype=torch.float32, device=slices[0].device)
    for g, spec in zip(slices, stored):
        split = {a for e in spec for a in _spec_axes(e)}
        if all(coords[a] == 0 for a in axes if a not in split):
            mine += torch.sum(torch.square(g.to(torch.float32)))
    for a in axes:
        with timed("model" if a == tp else "reduce"):
            all_reduce_sum_(mine, mesh, a)
    return torch.sqrt(mine[0])
