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
sharded by ``train.sharding.make_state_shardings``, each rank gathers the
parameters over the batch axes, computes the gradients of its slice of the
batch with the compute split over ``model`` as the reference's
``constrain`` asks (Megatron's column- and row-parallel attention, MLP and
expert FFN, a vocab-parallel embedding, head and cross-entropy) and by the
Mamba2 mixer's heads and the RG-LRU's width (``models/pspec.py``
``model_shard``), and the gradients are averaged over the batch axes
before each rank updates its own slices.
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
                                     global_norm, init_opt_state)
from repro_torch.train.sharding import (PART, SPLIT, buckets, gather_specs,
                                        gather_tree, local_slice, mesh_axes,
                                        model_reads)
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
    scaled by ``1/M`` (a tree shaped like ``params``), and the mean loss
    and aux.  Runs in ``full_f32()``."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = leaves(live)
    M = leaves(batch)[0].shape[0]
    acc = loss = aux = None
    with full_f32():
        for i in range(M):
            mb = tree_map(lambda a: a[i], batch)
            with torch.enable_grad():
                tot, (ce, ax) = loss_fn(model, live, mb)
                grads = torch.autograd.grad(tot, flat, allow_unused=True)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(flat, grads)]
            if acc is None:
                acc = [g.to(torch.float32) for g in grads]
                loss, aux = ce.detach(), ax.detach()
            else:
                torch._foreach_add_(acc, grads)
                loss, aux = loss + ce.detach(), aux + ax.detach()
            del grads, tot
    inv = 1.0 / M
    torch._foreach_mul_(acc, inv)
    it = iter(acc)
    return tree_map(lambda _: next(it), params), loss * inv, aux * inv


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
    axes), ``reduce`` (gradients, loss and aux over the batch axes) and
    ``model`` (the split compute's collectives over the model axis in the
    forward and backward, and the model-axis sums of gradients and of the
    gradient norm).  Pass one to ``make_sharded_train_step`` to time a
    step's collectives inside its own wall; ``None`` times nothing and adds
    no synchronization.  A kind it has not seen (a split serving forward's
    ``model_gather`` and ``model_combine``) gets its own entry."""

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
    batch (``data.pipeline.make_global_batch``).  One step:

    * gather the parameters by ``sharding.gather_specs``: a leaf that the
      split compute reads only as the rank's ``model`` slice
      (``sharding.model_reads`` SPLIT) over the batch axes alone, every
      other leaf over every axis;
    * ``microbatch_grads`` on the batch slice under ``pspec.data_shard``
      (MoE dispatch takes the slice as one group, the router's load
      statistics are averaged over the data shards) and
      ``pspec.model_shard`` (heads, ``d_ff``, the vocab and the recurrent
      mixers split over ``model``);
    * the gradients of leaves gathered whole but read in part (PART:
      ``wk``/``wv`` under "group" and "repeat", the Mamba2 mixer's
      ``w_in``, conv and per-head leaves) summed over ``model``; every
      gradient, the loss and aux averaged over the batch axes (``pod``,
      ``data``) in bucketed ``all_reduce``s;
    * ``grad_norm`` of the whole gradient: the squares of SPLIT leaves
      summed over ``model``, the other leaves (alike on every model rank)
      counted once; then ``adamw_update`` of this rank's slices.

    All in ``full_f32()``; the metrics are equal on every rank.  The state
    is updated in place, as ``make_train_step``'s is.  Over a model axis of
    one rank nothing splits and the step is the batch-parallel one.
    """
    mesh, specs = shardings
    fsdp, tp = mesh_axes(mesh)
    quiet = contextlib.nullcontext()
    splits = tp is not None and axis_size(mesh, tp) > 1
    plan = {}      # the first step's reads and gather specs

    def timed(kind, dev):
        return clock(kind, dev) if clock is not None else quiet

    def train_step(state: TrainState, batch):
        dev = leaves(state.params)[0].device
        if not plan:
            reads = model_reads(mesh, model.cfg, state.params) \
                if splits else None
            plan.update(reads=reads, specs=specs.params if reads is None
                        else gather_specs(specs.params, reads, mesh))
        reads, pspecs = plan["reads"], plan["specs"]
        with full_f32():
            with timed("gather", dev):
                full = gather_tree(state.params, pspecs, mesh)
            split = quiet if reads is None else pspec.model_shard(
                mesh, tp, None if clock is None
                else (lambda kind: clock(kind, dev)))
            with pspec.data_shard(mesh, fsdp), split:
                grads, loss, aux = microbatch_grads(model, full, batch)
            del full
            flat = leaves(grads)
            if reads is not None:
                kinds = leaves(reads)
                with timed("model", dev):
                    _reduce_([g for g, k in zip(flat, kinds) if k == PART],
                             mesh, (tp,), mean=False)
            stats = torch.stack([loss, aux]).to(torch.float32)
            with timed("reduce", dev):
                _reduce_(flat + [stats], mesh, fsdp, mean=True)
            if reads is None:
                gnorm = global_norm(flat)
            else:
                gnorm = _split_norm(flat, kinds, mesh, tp,
                                    lambda: timed("model", dev))
            mine = tree_map(lambda g, s: local_slice(g, s, mesh).clone(),
                            grads, pspecs)
            del grads, flat
            params, opt, om = adamw_update(state.params, mine, state.opt,
                                           opt_cfg, gnorm=gnorm)
            del mine
        metrics = {"loss": stats[0], "aux": stats[1], **om}
        return TrainState(params=params, opt=opt, step=state.step + 1), \
            metrics

    return train_step


def _split_norm(flat: list, kinds: list, mesh, tp: str, timed
                ) -> torch.Tensor:
    """The global norm of a gradient whose SPLIT leaves are this rank's
    model slices: their squares summed here and over ``tp``, the other
    leaves' (alike on every model rank) added once; f32."""
    def sq(ts):
        return sum((torch.sum(torch.square(t.to(torch.float32))) for t in ts),
                   torch.zeros((), dtype=torch.float32,
                               device=flat[0].device))

    mine = sq(g for g, k in zip(flat, kinds) if k == SPLIT).reshape(1)
    with timed():
        all_reduce_sum_(mine, mesh, tp)
    return torch.sqrt(mine[0] + sq(g for g, k in zip(flat, kinds)
                                   if k != SPLIT))
