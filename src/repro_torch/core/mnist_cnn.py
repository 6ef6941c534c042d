"""The paper's evaluation network (Fig. 6): bias-free MNIST CNN (port of
``repro.core.mnist_cnn``).

conv 5x5 (no bias) -> ReLU -> 2x2 maxpool -> dense -> softmax.  ``forward``
is the float network, trained by ``train_cnn`` (SGD with momentum on
autograd, in full f32); inference on the DSLOT engine goes through the layer
API with a prepare/execute split: ``prepare_cnn`` lowers the weights once,
``calibrate_cnn`` fixes the activation scales, and ``forward_dslot``
executes at a runtime precision, reporting per-layer ``planes_used``.  On
CUDA tensors both layers launch the CUDA kernel: two launches per
``forward_dslot``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.dslot_mnist import MnistCNNConfig
from repro_torch.device import full_f32, resolve_device
from repro_torch.layers import DslotConv2d, DslotDense

__all__ = ["CNNParams", "DslotForwardResult", "PreparedCNN", "calibrate_cnn",
           "fit_cnn", "forward", "forward_dslot", "init_cnn", "prepare_cnn",
           "train_cnn"]


class CNNParams(NamedTuple):
    conv: torch.Tensor    # (M, k, k)
    dense: torch.Tensor   # (M*12*12, 10)


class PreparedCNN(NamedTuple):
    """Prepared (weight-stationary) DSLOT state of the MNIST CNN: layer
    configs + params with attached ``DslotWeights``."""
    conv_layer: DslotConv2d
    head_layer: DslotDense
    conv_params: dict
    head_params: dict


class DslotForwardResult(NamedTuple):
    logits: torch.Tensor                 # (B, n_classes)
    layer_stats: dict                    # name -> DslotLayerStats


def init_cnn(cfg: MnistCNNConfig, generator: torch.Generator,
             device=None) -> CNNParams:
    """Random weights from ``generator`` (a seeded CPU ``torch.Generator``),
    placed on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    side = (cfg.image_size - cfg.kernel_size + 1) // cfg.pool
    conv = torch.randn((cfg.conv_channels, cfg.kernel_size, cfg.kernel_size),
                       generator=generator) * 0.2
    dense = torch.randn((cfg.conv_channels * side * side, cfg.n_classes),
                        generator=generator) * 0.05
    return CNNParams(conv=conv.to(dev), dense=dense.to(dev))


def forward(params: CNNParams, images: torch.Tensor, cfg: MnistCNNConfig
            ) -> torch.Tensor:
    """images: (B, 28, 28) in [0,1] (NCHW after the channel axis) ->
    logits (B, 10).  Bias-free, full f32.  The ReLU is ``torch.maximum``
    against zero, whose gradient at ``x == 0`` is split 0.5 / 0.5 as the
    reference's ``jnp.maximum``'s is."""
    with full_f32():
        x = F.conv2d(images[:, None], params.conv[:, None])  # (B, M, 24, 24)
        x = F.max_pool2d(torch.maximum(x, x.new_zeros(())), cfg.pool)
        return x.reshape(x.shape[0], -1) @ params.dense


def prepare_cnn(params: CNNParams, cfg: MnistCNNConfig, *,
                block_k: int | None = None, block_m: int = 128,
                block_n: int = 8) -> PreparedCNN:
    """One-time DSLOT lowering of the CNN (weight-stationary).

    The fused conv+ReLU gets per-tile early termination; the logits head
    (no ReLU) runs all planes.  ``block_n`` defaults small because the CNN
    has few output channels and classes.
    """
    k, m = cfg.kernel_size, cfg.conv_channels
    side = (cfg.image_size - k + 1) // cfg.pool
    conv = DslotConv2d(
        in_channels=1, out_channels=m, kernel_size=k, name="conv1",
        n_bits=cfg.n_bits, relu=True,
        block_m=block_m, block_n=min(block_n, m), block_k=block_k)
    head = DslotDense(
        d_in=m * side * side, d_out=cfg.n_classes, name="dense1",
        n_bits=cfg.n_bits, relu=False, signed=False,
        block_m=block_m, block_n=min(block_n, cfg.n_classes),
        block_k=block_k)
    # conv weights (M, k, k) -> layer layout (k, k, 1, M)
    wc = params.conv.permute(1, 2, 0)[:, :, None, :]
    return PreparedCNN(conv_layer=conv, head_layer=head,
                       conv_params=conv.prepare({"w": wc}),
                       head_params=head.prepare({"w": params.dense}))


def _pool_flatten(x: torch.Tensor, cfg: MnistCNNConfig) -> torch.Tensor:
    """Maxpool + layout shuffle between the two DSLOT layers: the float
    forward flattens (M, H, W), the DSLOT path is NHWC."""
    B, Ho, Wo, m = x.shape
    Hp, Wp = Ho // cfg.pool, Wo // cfg.pool
    x = x[:, :Hp * cfg.pool, :Wp * cfg.pool, :]
    x = x.reshape(B, Hp, cfg.pool, Wp, cfg.pool, m).amax(dim=(2, 4))
    return x.permute(0, 3, 1, 2).reshape(B, -1)


def calibrate_cnn(prep: PreparedCNN, images: torch.Tensor,
                  cfg: MnistCNNConfig) -> PreparedCNN:
    """Fix both layers' activation-quantization scales from a sample batch,
    removing the data-dependent max from the execute path."""
    conv_params = prep.conv_layer.calibrate(prep.conv_params,
                                            images[..., None])
    x, _ = prep.conv_layer.apply(conv_params, images[..., None])
    head_params = prep.head_layer.calibrate(prep.head_params,
                                            _pool_flatten(x, cfg))
    return prep._replace(conv_params=conv_params, head_params=head_params)


def forward_dslot(params: CNNParams | PreparedCNN, images: torch.Tensor,
                  cfg: MnistCNNConfig, *, n_planes=None,
                  block_k: int | None = None, block_m: int = 128,
                  block_n: int = 8) -> DslotForwardResult:
    """Inference through the digit-plane engine via the layer API.

    Pass a ``PreparedCNN`` for the amortized weight-stationary path; raw
    ``CNNParams`` are prepared on the fly (block_* apply only then).
    ``n_planes`` is a runtime precision: int, i32 scalar tensor, or
    per-image (B,) vector; a new value re-executes but never re-prepares.
    """
    if not isinstance(params, PreparedCNN):
        params = prepare_cnn(params, cfg, block_k=block_k, block_m=block_m,
                             block_n=block_n)
    x, conv_stats = params.conv_layer.apply(
        params.conv_params, images[..., None], n_planes=n_planes)
    flat = _pool_flatten(x, cfg)
    logits, head_stats = params.head_layer.apply(
        params.head_params, flat, n_planes=n_planes)
    return DslotForwardResult(
        logits=logits,
        layer_stats={"conv1": conv_stats, "dense1": head_stats})


def fit_cnn(cfg: MnistCNNConfig, params: CNNParams, images: np.ndarray,
            labels: np.ndarray, *, epochs: int = 20, batch: int = 64,
            lr: float = 2e-2, seed: int = 0) -> tuple[CNNParams, float]:
    """Plain SGD with momentum 0.9 from the initial ``params``, on their
    device; returns (trained params, accuracy on ``images``).

    The reference's loop: batches in the order of
    ``np.random.default_rng(seed).permutation`` per epoch (a last partial
    batch is dropped), loss ``-mean(log_softmax(logits)[label])``, then
    ``m = 0.9 * m + g`` and ``p = p - lr * m``, each a separate rounding.
    Forward and backward run in full f32 (cuDNN would take TF32).
    """
    dev = params.conv.device
    p = [t.detach().clone().requires_grad_(True) for t in params]
    mom = [torch.zeros_like(t) for t in p]
    x_all = torch.as_tensor(images).to(dev, torch.float32)
    y_all = torch.as_tensor(labels).to(dev, torch.int64)
    n = len(images)
    rng = np.random.default_rng(seed)
    with full_f32():
        for _ in range(epochs):
            order = torch.as_tensor(rng.permutation(n), device=dev)
            for i in range(0, n - batch + 1, batch):
                idx = order[i:i + batch]
                logits = forward(CNNParams(*p), x_all[idx], cfg)
                logp = torch.log_softmax(logits, dim=-1)
                loss = -logp.gather(1, y_all[idx][:, None]).mean()
                grads = torch.autograd.grad(loss, p)
                with torch.no_grad():
                    for t, m, g in zip(p, mom, grads):
                        m.mul_(0.9).add_(g)
                        t.sub_(lr * m)
        trained = CNNParams(*(t.detach() for t in p))
        logits = forward(trained, x_all, cfg)
    acc = float((logits.argmax(-1) == y_all).to(torch.float32).mean())
    return trained, acc


def train_cnn(cfg: MnistCNNConfig, images: np.ndarray, labels: np.ndarray,
              *, epochs: int = 20, batch: int = 64, lr: float = 2e-2,
              seed: int = 0, device=None) -> tuple[CNNParams, float]:
    """Train from ``init_cnn`` with a CPU generator seeded with ``seed``, on
    ``device`` (default ``cuda``); returns (params, final accuracy).  The
    same seed gives the same initial weights on every device."""
    params = init_cnn(cfg, torch.Generator().manual_seed(seed), device=device)
    return fit_cnn(cfg, params, images, labels, epochs=epochs, batch=batch,
                   lr=lr, seed=seed)
