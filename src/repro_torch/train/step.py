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
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.device import full_f32, resolve_device
from repro_torch.models.model_zoo import Model, loss_fn
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_update,
                                     init_opt_state)
from repro_torch.tree import leaves, tree_map

__all__ = ["TrainState", "init_train_state", "make_train_step",
           "microbatch_grads"]


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
