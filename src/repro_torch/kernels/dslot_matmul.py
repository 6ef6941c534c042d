"""Digit-serial MSDF matmul: the CUDA kernel's wrapper and its plain version
(port of ``repro.kernels.dslot_matmul``).

    C = [relu](sum_d 2^(n-1-d) * (P_d @ W)),   P_d in {-1,0,1}^(M x K), MSDF

The kernel input is the quantized activation block ``q`` itself; plane ``d``
is derived from it on the fly (bit ``n_bits-1-d`` of ``|q|`` times
``sign(q)``), never stored.  After each (plane ``d``, K chunk ``c``) step a
ReLU tile checks whether the remaining work can still lift any of its
outputs to zero,

    R[d, c][n] = 2^(n-1-d) * S_c[n] + (2^(n-1-d) - 2^(n-npl)) * T[n],

with ``S_c`` the |W| column sum over the K chunks not yet seen in this plane
and ``T`` the one over all of K (``colsum_tables``).  A tile with
``acc + R < 0`` everywhere is provably zero after ReLU: it stops and emits
zeros.  ``planes_used`` counts the planes each tile entered.

Two executions of that one definition live here:

* ``csrc/dslot_matmul.cu`` — the CUDA C++ kernel for Hopper.  A layer
  without ReLU (and ``n_bits <= 24``) cannot terminate, so it runs as one
  product of the truncated ``q`` with ``W``, split over K across a
  thread-block cluster when its tiles are fewer than the SMs.  A ReLU layer
  runs the (d, c) loop inside a thread block, the digit planes on the
  tensor cores (bf16, f32 weights as three bf16 parts) and a vote for the
  early exit: at the serving shapes (8-bit signed q, ``block_n`` 128, or
  256 over a 2-block cluster), the launchers' narrow tiles (``block_n``
  16, 32 or 64, ``block_k`` 16, 32 or whole 64-row sub-chunks) and
  ``block_n`` 24, 40, 48 or 56 (whole sub-chunks; a block holds the whole
  column tiles that fit in 128 columns, and each 8-column half of a warp
  votes for its own) one block per band of up to 128 rows and 128
  columns, its vote tiles (a row tile by a column tile) voting each on
  its own, on ``wgmma``; elsewhere one block per output tile on
  ``mma.sync``, or, for a tile too large for one block (1024 x 136,
  ``block_m`` 2048 at 8 columns), one thread-block
  cluster of up to 16 blocks whose votes join through distributed shared
  memory.  ``dslot_matmul_cuda`` launches it for CUDA tensors; ``route``
  names the kernel a launch takes.
* ``split_parts`` — W's bf16 parts in the layout the kernel streams
  (``split_parts_plain`` is its plain version).  ``ops.dslot_prepare``
  builds them once per layer and passes them on every call; a call on raw
  weights builds them inside the launch.
* ``_replay`` — the plain PyTorch version: the vectorized replay of the
  reference's ``ops._jnp_path``.  It computes every plane and derives the
  per-tile ``planes_used`` the kernel reports by replaying the bound check in
  the kernel's (plane outer, K chunk inner) order.  ``dslot_matmul_cuda``
  runs it for CPU tensors; ``dslot_matmul_plain`` runs it on any device, so
  the kernel can be held against it on the card.

``block_k`` is a semantic parameter: it places the termination check and
defines ``S_c``.  ``select_block_k`` keeps the reference's choice (a 12 MiB
working-set budget of TPU VMEM, K-chunks aligned to 128), so ``block_k=None``
gives the reference's geometry and ``planes_used``; the kernel stages each
logical chunk through shared memory in fixed sub-tiles whatever its size.
"""

from __future__ import annotations

import ctypes
import struct
from typing import NamedTuple

import torch

from repro_torch.device import full_f32

from . import _build

__all__ = ["DslotMatmulOut", "colsum_tables", "dslot_matmul_cuda",
           "dslot_matmul_cuda_batched", "dslot_matmul_plain", "part_count",
           "q_storage_dtype", "route", "select_block_k", "split_parts",
           "split_parts_plain"]

_CHUNK_BUDGET_BYTES = 12 * 1024 * 1024  # the reference's block_k policy
_LANE = 128                             # the reference's K-chunk alignment

_Q_CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3,
            torch.int32: 4}
_W_CODES = {torch.float32: 0, torch.bfloat16: 1}


class DslotMatmulOut(NamedTuple):
    out: torch.Tensor            # (M, N) f32 — [relu](A_D @ W)
    planes_used: torch.Tensor    # (M/bm, N/bn) int32 — digit planes entered


def q_storage_dtype(n_bits: int, signed: bool = False) -> torch.dtype:
    """Narrowest integer dtype holding the quantized-activation range:
    unsigned ``n_bits`` spans [0, 2^n - 1], signed ±(2^(n-1) - 1)."""
    qmax = 2 ** (n_bits - 1) - 1 if signed else 2 ** n_bits - 1
    if signed:
        if qmax <= 127:
            return torch.int8
        if qmax <= 32767:
            return torch.int16
        return torch.int32
    if qmax <= 255:
        return torch.uint8
    if qmax <= 65535:
        return torch.uint16
    return torch.int32


def select_block_k(K: int, block_m: int, block_n: int, w_itemsize: int,
                   act_itemsize: int = 1,
                   budget: int = _CHUNK_BUDGET_BYTES) -> int:
    """The reference's K-chunk choice: the largest chunk whose TPU working
    set (q chunk, W chunk, accumulator + output tile, two colsum rows) fits
    ``budget``; K itself when the whole reduction fits, else a multiple of
    128.  Kept unchanged so ``block_k=None`` matches the reference's
    termination checkpoints exactly."""
    fixed = 2 * block_m * block_n * 4 + 2 * block_n * 4
    per_k = block_m * act_itemsize + block_n * w_itemsize
    avail = budget - fixed
    if avail < per_k * _LANE:
        raise ValueError(
            f"block_m={block_m} x block_n={block_n} alone exceeds the chunk "
            f"budget ({budget} B); shrink the output tile")
    bk = avail // per_k
    if bk >= K:
        return K
    return max(_LANE, (bk // _LANE) * _LANE)


def colsum_tables(w: torch.Tensor, block_k: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """|W| column-sum termination tables over the ``block_k``-chunked K axis
    of padded ``w`` (Kp, N): ``(suffix_colsum (Kt, N), total_colsum (1, N))``.
    """
    Kp, N = w.shape
    assert Kp % block_k == 0, (Kp, block_k)
    absw = w.to(torch.float32).abs()
    chunk_colsum = absw.reshape(Kp // block_k, block_k, N).sum(dim=1)
    total_colsum = chunk_colsum.sum(dim=0, keepdim=True)
    return total_colsum - torch.cumsum(chunk_colsum, dim=0), total_colsum


def _pad_to(x: torch.Tensor, m: int, axis: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to the next multiple of ``m`` (any dtype)."""
    r = (-x.shape[axis]) % m
    if r == 0:
        return x
    shape = list(x.shape)
    shape[axis] += r
    out = x.new_zeros(shape)
    out.narrow(axis, 0, x.shape[axis]).copy_(x)
    return out


# ------------------------------------------------------------ W's parts

def part_count(w: torch.Tensor) -> int:
    """bf16 parts the kernel needs for ``w``: 1 where bf16 holds every
    weight exactly (a bf16 model's weights, widened to f32), else 3 (hi,
    mid and lo: 24 bits of significand)."""
    if w.dtype == torch.bfloat16:
        return 1
    return 1 if torch.equal(w, w.to(torch.bfloat16).to(w.dtype)) else 3


def split_parts_plain(w: torch.Tensor, block_n: int, n_parts: int
                      ) -> torch.Tensor:
    """Plain version of ``split_parts``: (n_parts, K, N / block_n, PN) bf16,
    PN = block_n rounded up to 8 with zero pad columns; hi = bf16(w), mid =
    bf16(w - hi), lo = bf16(w - hi - mid), each difference exact in f32."""
    K, N = w.shape
    Nt = N // block_n
    pn = -(-block_n // 8) * 8
    x = w.to(torch.float32).reshape(K, Nt, block_n)
    hi = x.to(torch.bfloat16)
    parts = [hi]
    if n_parts == 3:
        r1 = x - hi.to(torch.float32)
        mid = r1.to(torch.bfloat16)
        parts += [mid, (r1 - mid.to(torch.float32)).to(torch.bfloat16)]
    return _pad_to(torch.stack(parts), pn, axis=3)


def split_parts(w: torch.Tensor, block_n: int, n_parts: int) -> torch.Tensor:
    """W's bf16 parts in the layout the kernel streams (``split_parts_plain``
    gives the shape): a CUDA tensor launches ``dslot_split_parts``, one
    kernel that reads f32 or bf16 ``w`` as it is stored
    (``split_parts.launches`` counts the launches), a CPU tensor runs the
    plain version.  ``n_parts`` 1 asks for bf16(w), exact only where
    ``part_count(w)`` is 1."""
    K, N = w.shape
    if N % block_n or n_parts not in (1, 3):
        raise ValueError(f"w{tuple(w.shape)} does not tile by {block_n}, or "
                         f"{n_parts} parts")
    if not w.is_cuda:
        return split_parts_plain(w, block_n, n_parts)
    # copied only where the kernel cannot read it: strided, or another type
    src = _dense(w, w.dtype if w.dtype in _W_CODES else torch.float32)
    pn = -(-block_n // 8) * 8
    out = torch.empty((n_parts, K, N // block_n, pn), dtype=torch.bfloat16,
                      device=w.device)
    lib = _library()
    dev = w.get_device()
    args = (src.data_ptr(), _W_CODES[src.dtype], n_parts, out.data_ptr(), K,
            N, block_n, torch.cuda.current_stream(dev).cuda_stream)
    if dev == torch.cuda.current_device():
        err = lib.dslot_split_parts(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.dslot_split_parts(*args)
    if err != 0:
        raise RuntimeError("dslot_split_parts kernel launch failed: "
                           + lib.dslot_error_string(err).decode())
    split_parts.launches += 1
    return out


split_parts.launches = 0


# ------------------------------------------------------------ the replay

def _replay(q: torch.Tensor, w: torch.Tensor, n_bits: int, n_planes: int,
            relu: bool, block_m: int, block_n: int, bk: int,
            suffix: torch.Tensor, total: torch.Tensor, npl: torch.Tensor,
            row_budget: torch.Tensor | None, tile_bound: torch.Tensor,
            parts: torch.Tensor | None = None, rows: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: every plane computed, ``planes_used``
    replayed (port of the reference's ``ops._jnp_path``).

    q (M, Kp) integer, pre-padded; w (Kp, N); suffix (Kt, N) and total (N,)
    the |W| column-sum tables; ``npl`` the runtime precision (i32 scalar
    tensor); ``row_budget`` (M,) i32 or None (every row at ``npl``);
    ``tile_bound`` (Nt,) i32 the weight-side plane bound; ``n_planes`` the
    static plane depth D; ``parts`` and ``rows`` (the kernel's prepared
    parts and unpadded row count) change nothing here.  Digits of rows past
    their budget and columns of tiles past their bound contribute nothing; check results at steps the
    kernel never enters are removed by the final clamps to ``tile_bound``
    and ``npl``, as in the reference.
    """
    M, K = q.shape
    D = n_planes
    N = w.shape[1]
    Kt = K // bk
    Mt, Nt = M // block_m, N // block_n
    wf = w.to(torch.float32)
    qi = q.to(torch.int32)
    sign, mag = torch.sign(qi), qi.abs()
    tail = torch.exp2(n_bits - npl.to(torch.float32))
    budget = npl.expand(M) if row_budget is None else row_budget
    bound_cols = tile_bound.to(torch.int32).repeat_interleave(block_n)
    acc = torch.zeros((M, N), dtype=torch.float32, device=w.device)
    dead = []
    with full_f32():
        for d in range(D):
            scale = 2.0 ** (n_bits - 1 - d)
            live = (budget > d).to(torch.float32)[:, None]
            col_live = (bound_cols > d).to(torch.float32)[None, :]
            for c in range(Kt):
                ks = slice(c * bk, (c + 1) * bk)
                bit = (mag[:, ks] >> (n_bits - 1 - d)) & 1
                digit = (bit * sign[:, ks]).to(torch.float32) * live
                acc = acc + scale * (digit @ wf[ks]) * col_live
                rem = scale * suffix[c] + (scale - tail) * total
                bound = acc + rem[None, :]
                dead.append((bound.reshape(Mt, block_m, Nt, block_n) < 0.0)
                            .all(dim=3).all(dim=1))
    out = torch.clamp_min(acc, 0.0) if relu else acc
    if relu:
        dead_after = torch.stack(dead).to(torch.int32)       # (D*Kt, Mt, Nt)
        ever = dead_after.any(dim=0)
        first = torch.argmax(dead_after, dim=0)              # first True step
        used = torch.where(ever, first // Kt + 1, D).to(torch.int32)
    else:
        used = torch.full((Mt, Nt), D, dtype=torch.int32, device=w.device)
    used = torch.minimum(used, tile_bound.to(torch.int32)[None, :])
    return out, torch.minimum(used, npl.to(torch.int32))


# ------------------------------------------------------------ the kernel

def _launch(q: torch.Tensor, w: torch.Tensor, n_bits: int, n_planes: int,
            relu: bool, block_m: int, block_n: int, bk: int,
            suffix: torch.Tensor, total: torch.Tensor, npl: torch.Tensor,
            row_budget: torch.Tensor | None, tile_bound: torch.Tensor,
            parts: torch.Tensor | None = None, rows: int | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch ``csrc/dslot_matmul.cu`` on the current stream (same
    arguments and results as ``_replay``).  ``parts`` are W's prepared bf16
    parts (``split_parts``), read in place of a per-call split; ``rows``
    the real rows of ``q`` before the caller padded it to ``block_m`` (the
    kernel skips the products of pad rows past them).  One call is one
    launch for the counter, also where it takes two grids (W's bf16 parts
    written before tiles that stream W, when no parts are passed).  The host work per call is kept small: an H100
    runs the CNN head's kernel in about 11 us, so there the wrapper's own
    time is what an eager caller waits for."""
    M, K = q.shape
    N = w.shape[1]
    q_code = _Q_CODES.get(q.dtype)
    w_code = _W_CODES.get(w.dtype)
    if q_code is None:
        raise TypeError(f"q dtype {q.dtype} not supported by the kernel")
    if w_code is None:
        raise TypeError(f"w dtype {w.dtype} not supported by the kernel")
    if w.shape[0] != K or M % block_m or N % block_n or K % bk:
        raise ValueError(f"shapes q{tuple(q.shape)} w{tuple(w.shape)} do not "
                         f"tile by ({block_m}, {block_n}, {bk})")
    dev = q.get_device()
    for name, t in (("w", w), ("suffix", suffix), ("total", total),
                    ("npl", npl), ("tile_bound", tile_bound),
                    ("row_budget", row_budget), ("parts", parts)):
        if t is not None and t.get_device() != dev:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    q, w = _dense(q, q.dtype), _dense(w, w.dtype)
    suffix = _dense(suffix, torch.float32)
    total = _dense(total, torch.float32)
    npl = _dense(npl, torch.int32)
    tile_bound = _dense(tile_bound, torch.int32)
    if row_budget is not None:
        row_budget = _dense(row_budget, torch.int32)
    if suffix.shape != (K // bk, N) or total.numel() != N \
            or npl.numel() != 1 or tile_bound.shape != (N // block_n,) \
            or (row_budget is not None and row_budget.shape != (M,)):
        raise ValueError("termination tables, runtime precision, plane bound "
                         "or row budget do not match the tiled shapes")
    n_parts = 0
    if parts is not None:
        n_parts = parts.shape[0]
        if parts.dtype != torch.bfloat16 or not parts.is_contiguous() \
                or parts.shape != (n_parts, K, N // block_n,
                                   -(-block_n // 8) * 8) \
                or n_parts not in (1, 3) \
                or (n_parts == 3 and w.dtype != torch.float32):
            raise ValueError(f"parts {tuple(parts.shape)} {parts.dtype} are "
                             f"not split_parts of w{tuple(w.shape)}")
    lib = _library()
    ws_bytes = 0
    if parts is None:
        key = (K, N, block_m, block_n, bk, n_bits, bool(relu), q_code, w_code)
        ws_bytes = _WORKSPACE.get(key)
        if ws_bytes is None:
            ws_bytes = _WORKSPACE[key] = max(0, lib.dslot_matmul_workspace(
                K, N, block_m, block_n, bk, n_bits, int(relu), q_code,
                w_code))
    out = torch.empty((M, N), dtype=torch.float32, device=q.device)
    used = torch.empty((M // block_m, N // block_n), dtype=torch.int32,
                       device=q.device)
    ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=q.device) \
        if ws_bytes else None
    args = _ARGS.pack(
        q.data_ptr(), q_code, w.data_ptr(), w_code, suffix.data_ptr(),
        total.data_ptr(), npl.data_ptr(), tile_bound.data_ptr(),
        0 if row_budget is None else row_budget.data_ptr(), out.data_ptr(),
        used.data_ptr(), 0 if ws is None else ws.data_ptr(), M, K, N, n_bits,
        n_planes, block_m, block_n, bk, int(relu),
        torch.cuda.current_stream(dev).cuda_stream,
        0 if parts is None else parts.data_ptr(), n_parts,
        M if rows is None else rows)
    if dev == torch.cuda.current_device():
        err = lib.dslot_matmul_launch(args)
    else:
        with torch.cuda.device(dev):
            err = lib.dslot_matmul_launch(args)
    if err != 0:
        raise RuntimeError("dslot_matmul kernel launch failed: "
                           + lib.dslot_error_string(err).decode())
    dslot_matmul_cuda.launches += 1
    return out, used


def _dense(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` as a contiguous tensor of ``dtype`` (itself when it is one)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


# The C entry point's argument record (struct DslotArgs): 25 int64 fields.
_ARGS = struct.Struct("=25q")
_WORKSPACE: dict[tuple, int] = {}   # workspace bytes by launch shape


def _library() -> ctypes.CDLL:
    lib = _build.load("dslot_matmul")
    if lib.dslot_matmul_launch.argtypes is None:
        i = ctypes.c_int
        lib.dslot_matmul_launch.argtypes = [ctypes.c_char_p]
        lib.dslot_matmul_launch.restype = i
        lib.dslot_matmul_workspace.argtypes = [i] * 9
        lib.dslot_matmul_workspace.restype = ctypes.c_longlong
        lib.dslot_error_string.argtypes = [i]
        lib.dslot_error_string.restype = ctypes.c_char_p
        p = ctypes.c_void_p
        lib.dslot_split_parts.argtypes = [p, i, i, p, i, i, i, p]
        lib.dslot_split_parts.restype = i
        lib.dslot_matmul_route.argtypes = [i] * 10
        lib.dslot_matmul_route.restype = i
    return lib


_ROUTES = ("product_kernel", "plane_kernel", "band_kernel", "cluster_kernel",
           "walk_kernel")


def route(M: int, K: int, N: int, block_m: int, block_n: int, bk: int,
          n_bits: int, relu: bool, q_dtype: torch.dtype,
          w_dtype: torch.dtype) -> str:
    """The CUDA kernel a launch on padded (M, K) @ (K, N) takes: one of
    ``product_kernel``, ``plane_kernel``, ``band_kernel``,
    ``cluster_kernel`` or ``walk_kernel``.  Asks the card (a cluster's
    fit); raises for a shape the kernel does not take."""
    code = _library().dslot_matmul_route(
        M, K, N, block_m, block_n, bk, n_bits, int(relu), _Q_CODES[q_dtype],
        _W_CODES[w_dtype])
    if code < 0:
        raise ValueError(f"the kernel takes no ({M}, {K}) @ ({K}, {N}) "
                         f"launch at ({block_m}, {block_n}, {bk})")
    return _ROUTES[code]


def run(q: torch.Tensor, w: torch.Tensor, n_bits: int, n_planes: int,
        relu: bool, block_m: int, block_n: int, bk: int,
        suffix: torch.Tensor, total: torch.Tensor, npl: torch.Tensor,
        row_budget: torch.Tensor | None, tile_bound: torch.Tensor,
        parts: torch.Tensor | None = None, rows: int | None = None
        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The backend rule on pre-padded inputs: a CUDA tensor launches the
    kernel, a CPU tensor runs the plain version.  Nothing falls back.

    The kernel has no backward pass: on the card, an input that autograd
    tracks raises rather than losing its gradient, as the reference's Pallas
    path fails under ``jax.grad``.  The plain version is differentiable."""
    if q.is_cuda and torch.is_grad_enabled() and (q.requires_grad
                                                  or w.requires_grad):
        raise RuntimeError(
            "the DSLOT CUDA kernel has no backward pass; differentiate the "
            "digit-serial MLP on CPU tensors (the plain version) or under "
            "torch.no_grad()")
    fn = _launch if q.is_cuda else _replay
    args = (q, w, n_bits, n_planes, relu, block_m, block_n, bk, suffix,
            total, npl, row_budget, tile_bound, parts, rows)
    if _COST_HOOK is not None:   # an active launch.op_cost.OpCost
        return _COST_HOOK(fn, args)
    return fn(*args)


# launch.op_cost.OpCost while one is active: it takes each call of ``run``
# as one opaque op (dispatch never sees the ctypes launch)
_COST_HOOK = None


# ------------------------------------------------------------ entry points

def _normalize(q, w, *, n_bits, n_planes, block_m, block_n, block_k,
               n_planes_rt, row_budget, suffix_colsum, total_colsum,
               plane_bound):
    """The reference wrapper's argument handling: plane depth, chunk size,
    K padding, default tables, runtime precision and plane bound."""
    M, K = q.shape
    K2, N = w.shape
    assert K == K2, (q.shape, w.shape)
    assert M % block_m == 0 and N % block_n == 0, (M, N, block_m, block_n)
    if n_planes is not None and n_planes < 1:
        raise ValueError(f"n_planes must be >= 1, got {n_planes}")
    D = min(n_planes or n_bits, n_bits)
    bk = block_k or select_block_k(K, block_m, block_n, w.element_size(),
                                   q.element_size())
    q = _pad_to(q, bk, axis=1)
    w = _pad_to(w, bk, axis=0)
    Kt = w.shape[0] // bk
    if suffix_colsum is None or total_colsum is None:
        suffix_colsum, total_colsum = colsum_tables(w, bk)
    assert suffix_colsum.shape == (Kt, N), (suffix_colsum.shape, Kt, N)
    assert total_colsum.shape == (1, N), (total_colsum.shape, N)
    dev = q.device
    if n_planes_rt is None:
        n_planes_rt = D
    npl = torch.as_tensor(n_planes_rt, dtype=torch.int32, device=dev)
    if plane_bound is None:
        bnd = torch.full((N // block_n,), D, dtype=torch.int32, device=dev)
    else:
        assert plane_bound.shape == (N // block_n,), \
            (plane_bound.shape, N, block_n)
        bnd = plane_bound.to(torch.int32)
    if row_budget is not None:
        assert row_budget.shape == (M,), (row_budget.shape, M)
        row_budget = row_budget.to(torch.int32)
    return (q, w, D, bk, suffix_colsum, total_colsum[0], npl, row_budget,
            bnd)


def _call(fn, q, w, *, n_bits, n_planes, relu, block_m, block_n, block_k,
          n_planes_rt, row_budget, suffix_colsum, total_colsum, plane_bound,
          parts=None, rows=None):
    q, w, D, bk, sfx, tot, npl, bud, bnd = _normalize(
        q, w, n_bits=n_bits, n_planes=n_planes, block_m=block_m,
        block_n=block_n, block_k=block_k, n_planes_rt=n_planes_rt,
        row_budget=row_budget, suffix_colsum=suffix_colsum,
        total_colsum=total_colsum, plane_bound=plane_bound)
    out, used = fn(q, w, n_bits, D, relu, block_m, block_n, bk, sfx, tot,
                   npl, bud, bnd, parts, rows)
    return DslotMatmulOut(out=out, planes_used=used)


def dslot_matmul_cuda(q: torch.Tensor, w: torch.Tensor, *, n_bits: int = 8,
                      n_planes: int | None = None, relu: bool = True,
                      block_m: int = 128, block_n: int = 128,
                      block_k: int | None = None,
                      n_planes_rt=None,
                      row_budget: torch.Tensor | None = None,
                      suffix_colsum: torch.Tensor | None = None,
                      total_colsum: torch.Tensor | None = None,
                      plane_bound: torch.Tensor | None = None,
                      parts: torch.Tensor | None = None,
                      rows: int | None = None
                      ) -> DslotMatmulOut:
    """Run the digit-serial matmul (counterpart of ``dslot_matmul_pallas``).

    q: (M, K) integer quantized activations, |q| < 2^n_bits, any integer
       dtype the kernel reads (u8/i8/u16/i16/i32).
    w: (K, N) float32/bfloat16 weights.
    n_planes: static plane depth D (default ``n_bits``).
    block_k: logical K chunk (None = the reference's auto choice); K is
       zero-padded to a multiple.
    n_planes_rt: runtime precision, an int or an i32 device tensor (<= D).
    row_budget: (M,) i32 per-row precision, or None.
    suffix_colsum / total_colsum: prepared |W| column-sum tables ((Kt, N) /
       (1, N)), or None to compute them here.
    plane_bound: (N/block_n,) i32 weight-side plane bound per N tile.
    parts: W's prepared bf16 parts (``split_parts`` of the K-padded ``w``),
       or None to build them inside the launch where a tile reads them.
    rows: the rows of ``q`` before the caller padded M to ``block_m`` (None:
       all of them); the kernel may skip the pad rows' products.
    M % block_m == 0 and N % block_n == 0 (callers pad).

    CUDA tensors launch the kernel (``dslot_matmul_cuda.launches`` counts
    the launches); CPU tensors run the plain version.
    """
    return _call(run, q, w, n_bits=n_bits, n_planes=n_planes, relu=relu,
                 block_m=block_m, block_n=block_n, block_k=block_k,
                 n_planes_rt=n_planes_rt, row_budget=row_budget,
                 suffix_colsum=suffix_colsum, total_colsum=total_colsum,
                 plane_bound=plane_bound, parts=parts, rows=rows)


dslot_matmul_cuda.launches = 0


def dslot_matmul_plain(q: torch.Tensor, w: torch.Tensor, *, n_bits: int = 8,
                       n_planes: int | None = None, relu: bool = True,
                       block_m: int = 128, block_n: int = 128,
                       block_k: int | None = None,
                       n_planes_rt=None,
                       row_budget: torch.Tensor | None = None,
                       suffix_colsum: torch.Tensor | None = None,
                       total_colsum: torch.Tensor | None = None,
                       plane_bound: torch.Tensor | None = None,
                       parts: torch.Tensor | None = None,
                       rows: int | None = None
                       ) -> DslotMatmulOut:
    """The plain PyTorch version of ``dslot_matmul_cuda`` on any device
    (same signature, same ``(out, planes_used)``)."""
    return _call(_replay, q, w, n_bits=n_bits, n_planes=n_planes, relu=relu,
                 block_m=block_m, block_n=block_n, block_k=block_k,
                 n_planes_rt=n_planes_rt, row_budget=row_budget,
                 suffix_colsum=suffix_colsum, total_colsum=total_colsum,
                 plane_bound=plane_bound, parts=parts, rows=rows)


def dslot_matmul_cuda_batched(q: torch.Tensor, w: torch.Tensor, *,
                              n_bits: int = 8, n_planes: int | None = None,
                              relu: bool = True, block_m: int = 128,
                              block_n: int = 128, block_k: int | None = None,
                              n_planes_rt=None,
                              row_budget: torch.Tensor | None = None,
                              suffix_colsum: torch.Tensor | None = None,
                              total_colsum: torch.Tensor | None = None,
                              plane_bound: torch.Tensor | None = None
                              ) -> DslotMatmulOut:
    """Batched entry: q (B, M, K) sharing one weight matrix.

    The batch axis folds into M; with ``M % block_m == 0`` every output tile
    lies inside one batch element, so results and per-tile termination equal
    B separate calls.  ``row_budget`` may be (B,) per request or (B, M) per
    row.  Returns out (B, M, N) and planes_used (B, M/bm, N/bn).
    """
    B, M, K = q.shape
    assert M % block_m == 0, (M, block_m)
    if row_budget is not None:
        row_budget = torch.as_tensor(row_budget, dtype=torch.int32,
                                     device=q.device)
        if row_budget.shape == (B,):
            row_budget = row_budget.repeat_interleave(M)
        else:
            assert row_budget.shape == (B, M), (row_budget.shape, B, M)
            row_budget = row_budget.reshape(B * M)
    r = dslot_matmul_cuda(q.reshape(B * M, K), w, n_bits=n_bits,
                          n_planes=n_planes, relu=relu, block_m=block_m,
                          block_n=block_n, block_k=block_k,
                          n_planes_rt=n_planes_rt, row_budget=row_budget,
                          suffix_colsum=suffix_colsum,
                          total_colsum=total_colsum, plane_bound=plane_bound)
    N = r.out.shape[-1]
    return DslotMatmulOut(out=r.out.reshape(B, M, N),
                          planes_used=r.planes_used.reshape(B, M // block_m, -1))
