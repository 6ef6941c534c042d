"""Carry parameters made by the JAX reference package over to the port.

Inputs are array-likes (numpy arrays, or anything ``numpy.asarray``
accepts); nothing here imports the reference.  Layouts are the same in both
packages, so conversion is a copy onto the device plus shape checks:

* ``cnn_params``: the MNIST CNN's ``(conv (M, k, k), dense (M*S*S, C))``;
* ``layer_params``: a layer's ``{"w": ...}`` — a dense ``(K, N)`` weight or
  a conv ``(k, k, C, M)`` weight;
* ``model_params``: a ``Model.init`` tree — nested dicts and lists, stacked
  groups kept stacked (layer ``g * period + pos`` is entry ``g`` of
  ``groups[pos]`` in both packages);
* ``train_state``: a ``TrainState`` (params, AdamW moments and counts), so
  both packages can train on from the same state.

The reference's prepared state (``"dslot"``) is dropped: the port prepares
its own.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.mnist_cnn import CNNParams
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptState
from repro_torch.train.step import TrainState

__all__ = ["cnn_params", "layer_params", "model_params", "to_tensor",
           "train_state"]


def to_tensor(a, device=None) -> torch.Tensor:
    """One array onto ``device`` (default ``cuda``); bfloat16 stays
    bfloat16 (numpy has no such type, so it travels as float32)."""
    arr = np.asarray(a)
    bf16 = arr.dtype.name == "bfloat16"
    t = torch.from_numpy(np.array(arr, dtype=np.float32 if bf16 else None))
    return t.to(resolve_device(device), torch.bfloat16 if bf16 else t.dtype)


def cnn_params(params, device=None) -> CNNParams:
    """``CNNParams`` from the reference's ``(conv, dense)`` pair."""
    conv, dense = params
    conv, dense = to_tensor(conv, device), to_tensor(dense, device)
    if conv.ndim != 3 or conv.shape[1] != conv.shape[2]:
        raise ValueError(f"conv weight must be (M, k, k), got {conv.shape}")
    if dense.ndim != 2:
        raise ValueError(f"dense weight must be 2-D, got {dense.shape}")
    return CNNParams(conv=conv, dense=dense)


def layer_params(params: dict, device=None) -> dict:
    """A ``DslotDense``/``DslotConv2d`` params dict, weights only."""
    w = to_tensor(params["w"], device)
    if w.ndim not in (2, 4):
        raise ValueError(f"weight must be (K, N) or (k, k, C, M), got "
                         f"{tuple(w.shape)}")
    return {"w": w}


def model_params(tree, device=None):
    """The port's params tree from the reference's ``Model.init`` tree:
    every leaf onto ``device`` (default ``cuda``), bf16 kept bf16, lists and
    tuples kept, prepared ``"dslot"`` entries dropped."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items() if k != "dslot"}
        if isinstance(node, list):
            return [walk(v) for v in node]
        if isinstance(node, tuple):
            return tuple(walk(v) for v in node)
        return to_tensor(node, dev)

    return walk(tree)


def train_state(ref_state, device=None) -> TrainState:
    """The port's ``TrainState`` from the reference's (``params``, ``opt``
    with ``m``, ``v``, ``count``, and ``step``; leaves as numpy arrays):
    every leaf onto ``device`` (default ``cuda``) in its own dtype."""
    dev = resolve_device(device)
    opt = ref_state.opt
    return TrainState(
        params=model_params(ref_state.params, dev),
        opt=OptState(m=model_params(opt.m, dev), v=model_params(opt.v, dev),
                     count=to_tensor(opt.count, dev)),
        step=to_tensor(ref_state.step, dev))
