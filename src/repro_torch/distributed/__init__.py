"""Collectives over one axis of a mesh (``torch.distributed``), for the
port's tensor- and expert-parallel paths.

The port runs SPMD: every rank runs the same program on its own tensors, and
a mesh (``repro_torch.launch.mesh``) names the ranks' axes.  What the
reference's ``shard_map`` bodies express with ``all_gather`` /
``all_to_all`` / ``ppermute`` over an axis name, the port does with these
helpers over the axis's process group.

A collective that fails (a peer's timeout, a closed connection, a rank that
posted another collective) raises ``torch.distributed.DistError``: ranks
that disagree cannot be repaired by a retry on one of them, so callers that
absorb other errors (the serving engine's step retry) let it through.
Under ``gloo`` every collective here takes CUDA tensors as they are; only the
point-to-point ring of ``overlap.py`` copies through the host.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_to_all", "all_reduce_mean",
           "all_reduce_mean_grad", "all_reduce_sum_", "axis_rank",
           "axis_size", "mesh_barrier"]


def axis_size(mesh, axis: str) -> int:
    """Ranks along mesh axis ``axis``."""
    return int(mesh.size(list(mesh.mesh_dim_names).index(axis)))


def axis_rank(mesh, axis: str) -> int:
    """This rank's index along ``axis``: its slot in ``all_gather``'s and
    ``all_to_all``'s results (its rank in the axis group)."""
    return dist.get_rank(group=mesh.get_group(axis))


def _failed(what: str, axis: str, err: RuntimeError):
    return dist.DistError(f"{what} over mesh axis {axis!r} failed on rank "
                          f"{dist.get_rank()}: {err}")


def all_gather(t: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Every rank's ``t`` along ``axis``, concatenated along ``dim`` in axis
    order."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(n)]
    try:
        dist.all_gather(parts, t, group=mesh.get_group(axis))
    except RuntimeError as e:
        raise _failed("all_gather", axis, e) from e
    return torch.cat(parts, dim=dim)


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` (n, ...) split along dim 0: block ``j`` goes to rank ``j`` of
    ``axis``; returns (n, ...) whose block ``j`` came from rank ``j``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    try:
        dist.all_to_all_single(out, t, group=mesh.get_group(axis))
    except RuntimeError as e:
        raise _failed("all_to_all_single", axis, e) from e
    return out


def all_reduce_mean(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``axis``."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t
    t = t.clone()
    try:
        dist.all_reduce(t, group=mesh.get_group(axis))
    except RuntimeError as e:
        raise _failed("all_reduce", axis, e) from e
    return t / n


def all_reduce_mean_grad(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The mean of ``t`` over the ranks of ``axis``, differentiable: its
    backward sums the ranks' gradients (``torch.distributed.nn``), so every
    rank's autograd sees what a mean over the whole batch would give it."""
    from torch.distributed.nn.functional import all_reduce

    n = axis_size(mesh, axis)
    if n == 1:
        return t
    try:
        return all_reduce(t, group=mesh.get_group(axis)) / n
    except RuntimeError as e:
        raise _failed("all_reduce", axis, e) from e


def all_reduce_sum_(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``t`` replaced in place by its sum over the ranks of ``axis``;
    returns ``t``.  Every rank of the axis gets the same bits."""
    if axis_size(mesh, axis) == 1:
        return t
    try:
        dist.all_reduce(t, group=mesh.get_group(axis))
    except RuntimeError as e:
        raise _failed("all_reduce", axis, e) from e
    return t


def mesh_barrier(mesh) -> None:
    """Wait for every rank of ``mesh``: a one-element ``all_reduce`` over
    each axis in turn (after the last, each rank has met every rank whose
    earlier rounds it depends on, which is all of them)."""
    one = torch.zeros(1)
    if dist.get_backend() == "nccl":
        one = one.cuda()
    for axis in mesh.mesh_dim_names:
        all_reduce_sum_(one, mesh, axis)
