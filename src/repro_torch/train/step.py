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
parameters, computes the gradients of its slice of the batch, and the
gradients are averaged over the batch axes before each rank updates its
own slices.  GSPMD also splits the reference's compute over ``model``;
here the model axis shards storage only, and every rank of a model group
computes the whole forward.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import torch

from repro_torch.device import full_f32, resolve_device
from repro_torch.models import pspec
from repro_torch.models.model_zoo import Model, loss_fn
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     global_norm, init_opt_state)
from repro_torch.train.sharding import (buckets, gather_tree, local_slice,
                                        mesh_axes)
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


def _reduce_mean_(tensors: list, mesh, axes: tuple) -> list:
    """Each f32 tensor of ``tensors`` replaced in place by its mean over
    the ranks of ``axes`` (their product): one ``all_reduce`` per
    ``sharding.buckets`` run, over each axis in turn, then a scale.  Every
    rank gets the same bits."""
    from repro_torch.distributed import all_reduce_sum_, axis_size

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
        flat.mul_(1.0 / n)
        off = 0
        for t in part:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()
        del flat
    return tensors


class CollectiveClock:
    """Host seconds spent in a step's collectives (the card synchronized
    before and after each), by kind: ``gather`` (parameters) and
    ``reduce`` (gradients, loss and aux).  Pass one to
    ``make_sharded_train_step`` to time a step's collectives inside its
    own wall; ``None`` times nothing and adds no synchronization."""

    def __init__(self):
        self.seconds = {"gather": 0.0, "reduce": 0.0}

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
            self.seconds[kind] += time.perf_counter() - t0


def make_sharded_train_step(model: Model, opt_cfg: AdamWConfig, shardings,
                            clock: CollectiveClock | None = None):
    """Returns ``train_step(state, batch) -> (state, metrics)`` over the
    mesh of ``shardings`` (``train.sharding.Shardings`` of the state).

    ``state`` holds this rank's slices (``shard_tree`` of a full state by
    ``shardings.specs``); ``batch`` is this rank's slice of the global
    batch (``data.pipeline.make_global_batch``).  One step: gather the
    parameters; ``microbatch_grads`` on the batch slice (under
    ``pspec.data_shard``: MoE dispatch takes the slice as one group, and
    the router's load statistics are averaged over the data shards); the
    gradients, loss and aux averaged over the batch axes (``pod``,
    ``data``) in bucketed ``all_reduce``s; ``grad_norm`` and the clip scale
    from the whole averaged gradient; then ``adamw_update`` of this rank's
    slices.  All in ``full_f32()``; the metrics are equal on every rank.
    The state is updated in place, as ``make_train_step``'s is.
    """
    mesh, specs = shardings
    fsdp, _ = mesh_axes(mesh)
    pspecs = specs.params
    quiet = contextlib.nullcontext()

    def timed(kind, dev):
        return clock(kind, dev) if clock is not None else quiet

    def train_step(state: TrainState, batch):
        dev = leaves(state.params)[0].device
        with full_f32():
            with timed("gather", dev):
                full = gather_tree(state.params, pspecs, mesh)
            with pspec.data_shard(mesh, fsdp):
                grads, loss, aux = microbatch_grads(model, full, batch)
            del full
            flat = leaves(grads)
            stats = torch.stack([loss, aux]).to(torch.float32)
            with timed("reduce", dev):
                _reduce_mean_(flat + [stats], mesh, fsdp)
            gnorm = global_norm(flat)
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

