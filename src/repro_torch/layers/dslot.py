"""DSLOT layer API: ``DslotDense`` and ``DslotConv2d`` (port of
``repro.layers.dslot``).

Both layers sit on the prepare/execute split of ``kernels.ops``:

* ``init`` returns params with the prepared state attached — the weight
  lowering (column sort, padding, block geometry, termination tables) runs
  once per layer;
* ``prepare(params)`` attaches it to weights made elsewhere;
* ``calibrate(params, x_sample)`` stores a fixed activation scale;
* ``apply(params, x, n_planes=...)`` executes at a runtime precision: an
  explicit argument, the active ``repro_torch.runtime`` precision scope, or
  the layer's static default, in that order.  A new precision never
  re-prepares and never rebuilds anything.

The device of the tensors picks the execution: CUDA tensors launch the CUDA
kernel, CPU tensors run its plain version.  ``mesh``/``tp_axis`` prepare the
layer tensor-parallel: each rank keeps its own output columns and execution
gathers the rest (``kernels/ops.py``).  Per-call statistics come back
as ``DslotLayerStats`` and through the ``repro_torch.models.stats`` side
channel (``{name}.skipped_frac``, ``{name}.planes_used_mean``,
``{name}.row_planes_used``, ``{name}.planes_bounded_mean``).

``DslotConv2d`` lowers a convolution through ``core.conv.im2col`` (valid or
same padding), so conv layers run on the same kernel as dense ones.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.conv import im2col
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (DslotStats, DslotWeights, calibrate_scale,
                                     dslot_execute, dslot_prepare)
from repro_torch.models import stats as stats_channel
from repro_torch.runtime import current_precision

__all__ = ["DslotDense", "DslotConv2d", "DslotLayerStats"]


class DslotLayerStats(NamedTuple):
    name: str
    planes_used: torch.Tensor     # (Mt, Nt) int32 — digit planes per tile
    n_planes: int
    skipped_frac: torch.Tensor    # scalar f32 — fraction of planes skipped
    row_planes_used: torch.Tensor | None = None  # (rows,) f32
    planes_bounded: torch.Tensor | None = None   # (Mt, Nt) int32

    @classmethod
    def of(cls, name: str, st: DslotStats) -> "DslotLayerStats":
        return cls(name=name, planes_used=st.planes_used,
                   n_planes=st.n_planes, skipped_frac=st.skipped_frac,
                   row_planes_used=st.row_planes_used,
                   planes_bounded=st.planes_bounded)


def _record(name: str, st: DslotStats) -> None:
    stats_channel.record(f"{name}.skipped_frac", st.skipped_frac)
    stats_channel.record(f"{name}.planes_used_mean",
                         st.planes_used.to(torch.float32).mean())
    if st.row_planes_used is not None:
        stats_channel.record(f"{name}.row_planes_used", st.row_planes_used)
    if st.planes_bounded is not None:
        stats_channel.record(f"{name}.planes_bounded_mean",
                             st.planes_bounded.to(torch.float32).mean())


def _resolve_precision(name: str, explicit, static_default):
    """explicit arg > active runtime precision scope > layer static field."""
    if explicit is not None:
        return explicit
    scoped = current_precision(name, None)
    if scoped is not None:
        return scoped
    return static_default


def _rows_precision(n_planes, lead: tuple, rows: int):
    """Broadcast a per-request (B,) budget to the (B*S,) flattened rows."""
    if n_planes is None or not hasattr(n_planes, "ndim"):
        return n_planes
    n_planes = torch.as_tensor(n_planes)
    if n_planes.ndim == 1 and lead and n_planes.shape[0] != rows \
            and rows % n_planes.shape[0] == 0:
        n_planes = n_planes.repeat_interleave(rows // n_planes.shape[0])
    return n_planes


@dataclasses.dataclass(frozen=True)
class DslotDense:
    """Dense layer on the digit-plane DSLOT engine.

    ``relu=True`` fuses the activation into the kernel and enables per-tile
    early termination (the paper's Algorithm 1); ``relu=False`` (a logits
    head) runs all planes.
    """
    d_in: int
    d_out: int
    name: str = "dslot_dense"
    n_bits: int = 8
    n_planes: int | None = None      # default precision (<= n_bits)
    relu: bool = True
    signed: bool = False             # activation quantization range
    sort_columns: bool = False
    block_m: int = 128
    block_n: int = 128
    block_k: int | None = None       # None = the reference's auto choice
    mesh: object | None = None       # tensor-parallel mesh (N-axis shards)
    tp_axis: str = "model"

    # ------------------------------------------------------------ lifecycle

    def init(self, generator: torch.Generator, device=None,
             dtype=torch.float32) -> dict:
        """Random weights from ``generator`` (a CPU generator), on
        ``device`` (default ``cuda``)."""
        w = torch.randn((self.d_in, self.d_out), generator=generator) \
            * self.d_in ** -0.5
        return self.prepare({"w": w.to(resolve_device(device), dtype)})

    def prepare(self, params: dict) -> dict:
        """Attach the one-time prepared state (weight-stationary lowering)."""
        prepared = dslot_prepare(
            params["w"].to(torch.float32), n_bits=self.n_bits,
            relu=self.relu, signed=self.signed,
            sort_columns=self.sort_columns, block_m=self.block_m,
            block_n=self.block_n, block_k=self.block_k, mesh=self.mesh,
            tp_axis=self.tp_axis)
        return {**params, "dslot": prepared}

    def calibrate(self, params: dict, x_sample: torch.Tensor) -> dict:
        """Store a fixed activation scale from a calibration batch."""
        prep: DslotWeights = params.get("dslot") or \
            self.prepare(params)["dslot"]
        scale = calibrate_scale(x_sample.reshape(-1, self.d_in),
                                n_bits=self.n_bits, signed=self.signed)
        return {**params, "dslot": prep.with_scale(scale)}

    # ------------------------------------------------------------ execution

    def apply(self, params: dict, x: torch.Tensor, *, n_planes=None
              ) -> tuple[torch.Tensor, DslotLayerStats]:
        """x: (..., d_in) -> (..., d_out), plus per-tile plane statistics.

        ``n_planes``: runtime precision — int, i32 scalar tensor, or
        per-request (B,) vector (broadcast over the sequence axis); defaults
        to the active precision scope, then the layer's static field.
        """
        lead = x.shape[:-1]
        flat = x.reshape(-1, self.d_in).to(torch.float32)
        prep = params.get("dslot")
        if prep is None:                      # unprepared params
            prep = self.prepare(params)["dslot"]
        npl = _resolve_precision(self.name, n_planes, self.n_planes)
        npl = _rows_precision(npl, lead, flat.shape[0])
        y, st = dslot_execute(prep, flat, n_planes=npl)
        _record(self.name, st)
        return (y.to(x.dtype).reshape(*lead, self.d_out),
                DslotLayerStats.of(self.name, st))


@dataclasses.dataclass(frozen=True)
class DslotConv2d:
    """2-D convolution lowered to the DSLOT kernel via im2col.

    Input (B, H, W, C) (NHWC), weights (k, k, C, M), valid or same padding.
    A tile is a block of spatial output positions x output channels, so
    early termination kills provably-ReLU-dead spatial regions per channel
    block.
    """
    in_channels: int
    out_channels: int
    kernel_size: int
    stride: int = 1
    padding: str = "valid"           # "valid" | "same"
    name: str = "dslot_conv2d"
    n_bits: int = 8
    n_planes: int | None = None
    relu: bool = True
    signed: bool = False
    sort_columns: bool = False
    block_m: int = 128
    block_n: int = 128
    block_k: int | None = None
    mesh: object | None = None       # tensor-parallel mesh (N-axis shards)
    tp_axis: str = "model"

    # ------------------------------------------------------------ lifecycle

    def init(self, generator: torch.Generator, device=None,
             dtype=torch.float32) -> dict:
        k, c, m = self.kernel_size, self.in_channels, self.out_channels
        w = torch.randn((k, k, c, m), generator=generator) \
            * (k * k * c) ** -0.5
        return self.prepare({"w": w.to(resolve_device(device), dtype)})

    def _kkc(self) -> int:
        return self.kernel_size ** 2 * self.in_channels

    def prepare(self, params: dict) -> dict:
        prepared = dslot_prepare(
            params["w"].to(torch.float32).reshape(self._kkc(),
                                                  self.out_channels),
            n_bits=self.n_bits, relu=self.relu, signed=self.signed,
            sort_columns=self.sort_columns, block_m=self.block_m,
            block_n=self.block_n, block_k=self.block_k, mesh=self.mesh,
            tp_axis=self.tp_axis)
        return {**params, "dslot": prepared}

    def calibrate(self, params: dict, x_sample: torch.Tensor) -> dict:
        """Calibrate on sample feature maps (B, H, W, C)."""
        prep: DslotWeights = params.get("dslot") or \
            self.prepare(params)["dslot"]
        cols = im2col(x_sample.to(torch.float32), self.kernel_size,
                      self.stride, self.padding)
        scale = calibrate_scale(cols, n_bits=self.n_bits, signed=self.signed)
        return {**params, "dslot": prep.with_scale(scale)}

    # ------------------------------------------------------------ execution

    def apply(self, params: dict, x: torch.Tensor, *, n_planes=None
              ) -> tuple[torch.Tensor, DslotLayerStats]:
        """x: (B, H, W, C) -> (B, Ho, Wo, M), plus plane statistics.

        A per-request (B,) ``n_planes`` vector is broadcast over each
        image's Ho*Wo output rows.
        """
        B = x.shape[0]
        k, c, m = self.kernel_size, self.in_channels, self.out_channels
        assert x.shape[-1] == c, (x.shape, c)
        cols = im2col(x.to(torch.float32), k, self.stride, self.padding)
        _, Ho, Wo, kkc = cols.shape
        prep = params.get("dslot")
        if prep is None:
            prep = self.prepare(params)["dslot"]
        npl = _resolve_precision(self.name, n_planes, self.n_planes)
        npl = _rows_precision(npl, (B,), B * Ho * Wo)
        y, st = dslot_execute(prep, cols.reshape(B * Ho * Wo, kkc),
                              n_planes=npl)
        _record(self.name, st)
        return (y.to(x.dtype).reshape(B, Ho, Wo, m),
                DslotLayerStats.of(self.name, st))
