"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule (port of ``repro.optim.adamw``).

The arithmetic is the reference's, in f32: clip by the global norm, bias
correction by ``1 - b^count``, ``mh / (sqrt(vh) + eps)``, decay only on
parameters with ``ndim >= 2`` (not on norms or biases), the update cast
back to the parameter's dtype.  ``torch.optim.AdamW`` is not the same
function: it decays every parameter and orders the update otherwise.

``adamw_update`` writes the parameters and the moments in place (the
counterpart of the reference's donated buffers: no second copy of the
optimizer state is made); a caller that needs the old values clones them
first.  Everything stays on the parameters' device: the step count, the
learning rate and the clip scale are 0-d tensors, so a step never waits on
the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_update", "global_norm",
           "init_opt_state", "schedule"]


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    m: dict
    v: dict
    count: torch.Tensor          # 0-d int32: updates taken


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate after ``step`` updates: linear warmup to ``peak_lr``,
    then a cosine down to ``min_lr_frac * peak_lr`` at ``decay_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.decay_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params) -> OptState:
    """f32 zero moments shaped like ``params``, on their devices."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    first = leaves(params)[0]
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=first.device))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, opt: OptState, cfg: AdamWConfig,
                 gnorm: torch.Tensor | None = None):
    """One AdamW step.  Returns ``(params, opt, metrics)``: the same
    parameter and moment tensors, updated in place, a new ``count``, and
    ``{"grad_norm", "lr"}`` as 0-d f32 tensors.  ``grads`` is read only.
    ``gnorm``: the global gradient norm where ``params``, ``grads`` and the
    moments are one rank's slices (the sharded step); by default the norm
    of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                            1.0)
    count = opt.count + 1
    lr = schedule(cfg, count)
    cf = count.to(torch.float32)
    b1c = 1 - torch.pow(cfg.b1, cf)
    b2c = 1 - torch.pow(cfg.b2, cf)

    for p, g, m, v in zip(leaves(params), leaves(grads), leaves(opt.m),
                          leaves(opt.v)):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        step = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and p.ndim >= 2:     # no decay on norms/biases
            step = step + cfg.weight_decay * p.to(torch.float32)
        p.copy_((p.to(torch.float32) - lr * step).to(p.dtype))
    return params, OptState(m=opt.m, v=opt.v, count=count), \
        {"grad_norm": gnorm, "lr": lr}
