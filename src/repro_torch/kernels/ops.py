"""Framework-facing ops for the digit-plane DSLOT engine (port of
``repro.kernels.ops``).

The engine is a **prepare/execute** pair, the software analogue of the
paper's weight-stationary dataflow:

* ``dslot_prepare(w, ...) -> DslotWeights`` — everything that depends only
  on the weights, computed once per layer: column-sort permutation (+
  inverse), block geometry (``block_k``), N/K padding, the |W| column-sum
  termination tables, the weight-side MSR plane bound and, for layers whose
  kernel tiles stream W, W's bf16 parts (one part where bf16 holds every
  weight, else three).
* ``dslot_execute(prepared, x, n_planes=...)`` — the per-request path:
  quantize activations (against a calibrated fixed scale when one is
  stored), run the digit-serial matmul, dequantize.  ``n_planes`` is a
  runtime value (int, scalar tensor or per-row vector) that travels to the
  kernel in device memory: a new precision needs no host sync and no
  rebuild.
* ``calibrate_scale(x_sample, ...)`` — one-shot activation-range
  calibration; store it with ``DslotWeights.with_scale``.

``dslot_matmul`` is the fused one-shot prepare + execute.

Backend rule: the device of the tensors decides.  CUDA tensors launch the
CUDA kernel (``kernels/csrc/dslot_matmul.cu``); CPU tensors run its plain
version (``dslot_matmul._replay``).  There is no backend option and nothing
falls back from one to the other.

``sort_columns=True`` reorders output columns by their weight column sum (a
static, offline permutation) so ReLU-dead neurons cluster into whole tiles;
the inverse permutation is applied to the output, so results are unchanged.

Tensor parallelism (``dslot_prepare(mesh=..., tp_axis=...)``): the prepared
state splits along the output (N) axis at tile granularity over the ranks
of the mesh's ``tp_axis``.  Termination is decided per N tile from per-
column tables and per-tile plane bounds, so each rank runs the same kernel
on its own columns with its own tables and no coordination.  Prepare sorts
and pads over all of N, pads the tile count to a multiple of the shard
count with all-zero tiles of plane bound 0 (exact no-ops: they issue no
plane and emit zeros), and each rank keeps only its own columns of ``w``
and the colsum tables and its own bounds, about 1/shards of the bytes.
Execute quantizes the replicated activations, runs the kernel (or its
plain version) on the rank's slice, ``all_gather``s the output and the
per-tile ``planes_used`` and bounds over the axis, slices the pad off, and
only then applies the inverse column permutation and the statistics, as
the unsharded path does.  Results and every ``DslotStats`` field equal the
unsharded path's bit for bit where the backend computes a column the same
way whatever the others: the plane path of the kernel (ReLU layers), and
the plain version run on one thread (a multithreaded CPU BLAS may split K
across threads by the product's width).  The kernel's product path
(layers without ReLU) picks its K split from the launch's tile count, so a
shard may sum K in another order there.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core.msr import tile_plane_bound
from repro_torch.distributed import all_gather, axis_rank, axis_size

from . import dslot_matmul as dm
from .dslot_matmul import _pad_to, colsum_tables, q_storage_dtype, select_block_k

__all__ = ["DslotStats", "DslotWeights", "dslot_matmul", "dslot_prepare",
           "dslot_execute", "calibrate_scale", "prepare_call_count",
           "quantize_activations"]

_PREPARE_CALLS = 0


def prepare_call_count() -> int:
    """Number of ``dslot_prepare`` calls since process start — tests assert
    prepare-once behaviour."""
    return _PREPARE_CALLS


class DslotStats(NamedTuple):
    planes_used: torch.Tensor     # (Mt, Nt) int32 — planes per output tile
    n_planes: int                 # static plane depth of the call
    skipped_frac: torch.Tensor    # scalar — fraction of plane passes skipped
    row_planes_used: torch.Tensor | None = None  # (M,) f32 effective planes
    planes_bounded: torch.Tensor | None = None   # (Mt, Nt) int32 — planes
                                  # never issued because the weight-side MSR
                                  # bound capped the tile below its budget


@dataclasses.dataclass(frozen=True)
class DslotWeights:
    """Prepared (weight-stationary) state of one DSLOT layer.

    With a mesh, ``w``, the colsum tables and ``msr_bound`` hold this rank's
    columns and tiles only (``Np / shards`` columns of the tile-padded
    layout); ``inv_perm``, ``d_in`` and ``d_out`` describe the whole layer.
    """
    w: torch.Tensor                    # (Kp, Np) padded (+sorted) weights
    suffix_colsum: torch.Tensor        # (Kt, Np) f32 — unseen-chunk table
    total_colsum: torch.Tensor         # (1, Np) f32 — all-of-K table
    inv_perm: torch.Tensor | None      # (N,) undo of the column sort
    x_scale: torch.Tensor | None       # () f32 calibrated activation step,
                                       # or None = per-call max
    msr_bound: torch.Tensor | None = None  # (Nt,) i32 static plane bound
    parts: torch.Tensor | None = None  # (P, Kp, Nt, PN) bf16 parts of w
                                       # (dm.split_parts), or None
    n_bits: int = 8
    relu: bool = True
    signed: bool = False
    block_m: int = 128
    block_n: int = 128
    block_k: int = 0                   # resolved chunk size
    d_in: int = 0                      # K before padding
    d_out: int = 0                     # N before padding
    mesh: object | None = None         # tensor-parallel DeviceMesh, or None
    tp_axis: str = "model"             # mesh axis the N tiles shard over

    def with_scale(self, x_scale) -> "DslotWeights":
        """Attach a calibrated activation scale (see ``calibrate_scale``)."""
        return dataclasses.replace(self, x_scale=torch.as_tensor(
            x_scale, dtype=torch.float32, device=self.w.device))


def _qmax(n_bits: int, signed: bool) -> float:
    return float(2 ** n_bits - 1 if not signed else 2 ** (n_bits - 1) - 1)


def quantize_activations(x: torch.Tensor, n_bits: int = 8,
                         signed: bool = False, scale=None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric activation quantization -> (q int32, step float32).

    ``scale=None`` derives the step from this batch's max; a calibrated
    ``scale`` skips the reduction and clips outliers instead.
    ``torch.round`` rounds half to even, like the reference.
    """
    qmax = _qmax(n_bits, signed)
    if scale is None:
        amax = torch.clamp_min(x.abs().max() if signed else x.max(), 1e-12)
        step = amax / qmax
    else:
        step = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    lo = -qmax if signed else 0.0
    q = torch.clamp(torch.round(x / step), lo, qmax).to(torch.int32)
    return q, step


def calibrate_scale(x_sample: torch.Tensor, n_bits: int = 8,
                    signed: bool = False) -> torch.Tensor:
    """Fixed activation quantization step from a calibration batch."""
    amax = x_sample.abs().max() if signed else x_sample.max()
    return (torch.clamp_min(amax, 1e-12) / _qmax(n_bits, signed)
            ).to(torch.float32)


def dslot_prepare(w: torch.Tensor, *, n_bits: int = 8, relu: bool = True,
                  signed: bool = False, sort_columns: bool = False,
                  block_m: int = 128, block_n: int = 128,
                  block_k: int | None = None, x_scale=None,
                  msr_bound: bool = True, mesh=None,
                  tp_axis: str = "model") -> DslotWeights:
    """One-time weight lowering: sort, pad, pick ``block_k``, build the
    termination tables and the weight-side MSR plane bound.

    ``w``: (K, N) float32/bfloat16 on the device the layer will run on.
    ``msr_bound=True`` stores a static per-N-tile plane bound
    (``core.msr.tile_plane_bound``): tiles proven output-inert from the
    weights alone get bound 0 and are never issued; results are identical
    to ``msr_bound=False``.

    W's bf16 parts (``dm.split_parts``, the kernel's streamed layout) are
    built here once, after the rank's columns are cut, for every layer on
    the card whose tiles take the kernel's plane path and are wider than 8
    columns (those tiles all stream W; tiles of 8 columns may stay resident
    and stage W themselves, and a streamed one builds its parts per call).
    The part count is decided once over the whole layer: 1 where bf16 holds
    every weight, else 3.  Every call passes them; none rebuilds them.  A
    layer on the CPU stores none: the plain version never reads them.

    ``mesh``/``tp_axis`` (a ``DeviceMesh`` and one of its axis names) make
    every ``dslot_execute`` of the result tensor-parallel over that axis;
    each rank keeps its own columns (module docstring).  Every rank of the
    axis calls this with the same ``w``.
    """
    global _PREPARE_CALLS
    _PREPARE_CALLS += 1
    if mesh is not None and tp_axis not in mesh.mesh_dim_names:
        raise ValueError(f"tp_axis {tp_axis!r} not in mesh axes "
                         f"{mesh.mesh_dim_names}")
    K, N = w.shape

    inv_perm = None
    if sort_columns:
        # stable, like jnp.argsort: tied column sums permute identically
        perm = torch.argsort(w.sum(dim=0), stable=True)
        w = w[:, perm]
        inv_perm = torch.argsort(perm, stable=True)

    bk = block_k or select_block_k(K, block_m, block_n, w.element_size(),
                                   q_storage_dtype(n_bits, signed).itemsize)
    w_p = _pad_to(w, block_n, axis=1)
    w_p = _pad_to(w_p, bk, axis=0).contiguous()

    suffix_colsum, total_colsum = colsum_tables(w_p, bk)
    bound = tile_plane_bound(w_p, block_n, n_bits=n_bits, relu=relu,
                             signed=signed) if msr_bound else None
    if x_scale is not None:
        x_scale = torch.as_tensor(x_scale, dtype=torch.float32,
                                  device=w.device)
    n_parts = dm.part_count(w_p) \
        if _on_card(w_p) and _reads_parts(relu, n_bits, block_n) else 0
    if mesh is not None:
        w_p, suffix_colsum, total_colsum, bound = _shard_columns(
            mesh, tp_axis, block_n, n_bits, w_p, suffix_colsum,
            total_colsum, bound)
    parts = dm.split_parts(w_p, block_n, n_parts) if n_parts else None
    return DslotWeights(
        w=w_p, suffix_colsum=suffix_colsum, total_colsum=total_colsum,
        inv_perm=inv_perm, x_scale=x_scale, msr_bound=bound, parts=parts,
        n_bits=n_bits, relu=relu, signed=signed, block_m=block_m,
        block_n=block_n, block_k=bk, d_in=K, d_out=N, mesh=mesh,
        tp_axis=tp_axis)


def _on_card(w: torch.Tensor) -> bool:
    """Whether ``w`` lies where the kernel runs (the CPU runs the plain
    version, which reads no parts)."""
    return w.is_cuda


def _reads_parts(relu: bool, n_bits: int, block_n: int) -> bool:
    """Whether a layer gets prepared parts: its tiles take the kernel's
    plane path (ReLU, or more than 24 bits) and are wider than 8 columns."""
    return (relu or n_bits > 24) and block_n > 8


def _shard_columns(mesh, axis, block_n, n_bits, w_p, suffix, total, bound):
    """This rank's columns and tiles of the prepared arrays.  The tile
    count is padded to a multiple of the shard count with all-zero tiles of
    plane bound 0; without an MSR bound the real tiles get ``n_bits``, which
    execute clamps to the call's depth, as it does for no bound at all."""
    shards, idx = axis_size(mesh, axis), axis_rank(mesh, axis)
    Nt = w_p.shape[1] // block_n
    per = -(-Nt // shards)
    if bound is None:
        bound = torch.full((Nt,), n_bits, dtype=torch.int32,
                           device=w_p.device)
    lo, hi = idx * per, (idx + 1) * per

    def cols(t):             # zero-padded to shards * per tiles, then sliced
        t = _pad_to(t, shards * per * block_n, axis=1)
        return t[:, lo * block_n:hi * block_n].contiguous()

    bound = _pad_to(bound.to(torch.int32), shards * per, axis=0)
    return cols(w_p), cols(suffix), cols(total), bound[lo:hi].contiguous()


# ------------------------------------------------------------- execution

def _execute_core(prepared: DslotWeights, x: torch.Tensor, npl: torch.Tensor,
                  static_planes: int | None = None
                  ) -> tuple[torch.Tensor, DslotStats]:
    """Shared execute path.  ``npl`` is an i32 tensor, scalar or per-row (M,).

    ``static_planes`` (fused one-shot path only) shrinks the static plane
    depth; the split path keeps it at ``n_bits`` and lets the runtime
    precision stop the plane loop.  Everything stays on the device: no
    host sync.
    """
    cfg = prepared
    M, K = x.shape
    assert K == cfg.d_in, (x.shape, cfg.d_in)

    q, step = quantize_activations(x, n_bits=cfg.n_bits, signed=cfg.signed,
                                   scale=cfg.x_scale)
    D = min(static_planes or cfg.n_bits, cfg.n_bits)

    if npl.ndim == 1:
        row_budget = torch.clamp(npl, 1, D)
        npl_scalar = row_budget.max()
        budget_f = row_budget.to(torch.float32)
    else:
        row_budget = None
        npl_scalar = torch.clamp(npl, 1, D)
        budget_f = npl_scalar.to(torch.float32)

    q_p = _pad_to(q.to(q_storage_dtype(cfg.n_bits, cfg.signed)),
                  cfg.block_m, axis=0)
    q_p = _pad_to(q_p, cfg.w.shape[0], axis=1)   # match prepared K padding
    # pad rows: zero budget (all-zero digits); a scalar budget covers all rows
    bud_p = None if row_budget is None else \
        _pad_to(row_budget.to(torch.int32), cfg.block_m, axis=0)

    Nt = cfg.w.shape[1] // cfg.block_n          # this rank's, when sharded
    bnd = torch.full((Nt,), D, dtype=torch.int32, device=x.device) \
        if cfg.msr_bound is None \
        else torch.clamp_max(cfg.msr_bound.to(torch.int32), D)

    out_p, used = dm.run(q_p, cfg.w, cfg.n_bits, D, cfg.relu, cfg.block_m,
                         cfg.block_n, cfg.block_k, cfg.suffix_colsum,
                         cfg.total_colsum[0], npl_scalar, bud_p, bnd,
                         cfg.parts, M)
    used = torch.minimum(used, npl_scalar.to(torch.int32))
    if cfg.mesh is not None:
        out_p, used, bnd = _gather_shards(cfg, out_p, used, bnd)

    out = out_p[:M, :cfg.d_out] * step
    if cfg.inv_perm is not None:
        out = out[:, cfg.inv_perm]

    # per-row effective planes: tile usage spread over its rows, clipped to
    # each row's own budget — the per-request account for serving
    rows_used = used.to(torch.float32).mean(dim=1) \
        .repeat_interleave(cfg.block_m)[:M]
    if row_budget is not None:
        rows_used = torch.minimum(rows_used, budget_f)
        skipped = 1.0 - rows_used.mean() / torch.clamp_min(budget_f.mean(),
                                                           1.0)
    else:
        skipped = 1.0 - used.to(torch.float32).mean() / budget_f
    # planes the static weight-side bound kept from being issued
    bounded = torch.clamp_min(npl_scalar.to(torch.int32) - bnd, 0)[None, :] \
        .expand(used.shape)
    return out, DslotStats(planes_used=used, n_planes=D,
                           skipped_frac=skipped, row_planes_used=rows_used,
                           planes_bounded=bounded)


def _gather_shards(cfg: DslotWeights, out_p: torch.Tensor,
                   used: torch.Tensor, bnd: torch.Tensor):
    """The whole layer's padded output, ``planes_used`` and plane bounds
    from every rank's slice (two ``all_gather``s over the tp axis), with
    the pad tiles of the shard layout sliced off the tile tables."""
    Nt = -(-cfg.d_out // cfg.block_n)
    out_p = all_gather(out_p, cfg.mesh, cfg.tp_axis, dim=1)
    tiles = all_gather(torch.cat([used, bnd[None]]), cfg.mesh, cfg.tp_axis,
                       dim=1)[:, :Nt]
    return out_p, tiles[:-1], tiles[-1]


def dslot_execute(prepared: DslotWeights, x: torch.Tensor, *,
                  n_planes=None) -> tuple[torch.Tensor, DslotStats]:
    """Per-request execution against prepared weights: ``[relu](x @ w)``.

    ``x``: (M, d_in) float activations.  ``n_planes``: None (all
    ``n_bits``), an int or i32 scalar tensor, or a per-row (M,) vector.
    """
    if n_planes is None:
        n_planes = prepared.n_bits
    npl = torch.as_tensor(n_planes, dtype=torch.int32, device=x.device)
    return _execute_core(prepared, x, npl)


def dslot_matmul(x: torch.Tensor, w: torch.Tensor, *, n_bits: int = 8,
                 n_planes: int | None = None, relu: bool = True,
                 block_m: int = 128, block_n: int = 128,
                 block_k: int | None = None, sort_columns: bool = False,
                 signed: bool = False) -> tuple[torch.Tensor, DslotStats]:
    """Fused one-shot digit-serial matmul: prepare + execute.

    ``n_planes`` here is static.  When every column of ``w`` is output-inert
    from the weight side (all zero, or under unsigned+ReLU all <= 0) the
    static plane depth itself shrinks to one plane; planes beyond a tile's
    bound are exact no-ops.  That check reads ``w`` on the host, which this
    one-shot path accepts and ``dslot_execute`` never does.
    """
    D = min(n_planes or n_bits, n_bits)
    inert = (w == 0.0).all(dim=0)
    if relu and not signed:
        inert = inert | (w <= 0.0).all(dim=0)
    if bool(inert.all()):
        D = 1
    prepared = dslot_prepare(
        w, n_bits=n_bits, relu=relu, signed=signed,
        sort_columns=sort_columns, block_m=block_m, block_n=block_n,
        block_k=block_k)
    return _execute_core(prepared, x,
                         torch.tensor(D, dtype=torch.int32, device=x.device),
                         static_planes=D)
