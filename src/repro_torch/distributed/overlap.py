"""Collective matmul: a ring of point-to-point exchanges overlapped with the
products of a tensor-parallel all-gather matmul (port of
``repro.distributed.overlap``).

The plain lowering of a column-parallel matmul with a sequence-sharded
activation is ``all_gather(x) ; x @ w``, with the gather on the critical
path.  The collective-matmul schedule (Wang et al., ASPLOS'23) splits it
into ``n`` rounds over the ``n`` ranks of the axis:

    round r on rank d:  y[rows of slice (d + r) % n] = cur @ w_d
                        cur <- the slice rank d + 1 held   (its exchange is
                               posted before the product, so it runs while
                               the product does)

The reference's ``ppermute`` ring becomes ``dist.batch_isend_irecv``: one
``P2POp`` sending ``cur`` to rank ``d - 1`` and one receiving from rank
``d + 1``, posted before each round's product.  The product runs on the
current stream: the exchange proceeds beside it without a stream of its
own (on gloo's transport threads, or on NCCL's internal stream), and the
product is only enqueued, so one more stream would add no overlap.
``gloo`` moves point-to-point messages between host buffers only, so
under ``gloo`` the ring carries host copies: the rank's own slice goes to
the host once, every slice that arrives is copied to the card for its
product and sent on from the host; other backends send the tensor as it
is.

Layouts (per rank): ``x`` (S/n, K) this rank's rows; ``w`` (K, N/n) this
rank's columns; ``y`` (S, N/n) every row, this rank's columns.  Products
accumulate in f32 under ``device.full_f32()``, like the reference's f32
einsums.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.device import full_f32
from repro_torch.distributed import (_failed, all_gather, axis_rank,
                                     axis_size)

__all__ = ["collective_matmul_ag", "plain_matmul_ag"]


def _product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    with full_f32():
        return torch.matmul(a.to(torch.float32), w.to(torch.float32))


def collective_matmul_ag(x: torch.Tensor, w: torch.Tensor, mesh,
                         axis: str = "model") -> torch.Tensor:
    """Pipelined all-gather matmul (see the module docstring)."""
    n = axis_size(mesh, axis)
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    idx = axis_rank(mesh, axis)
    s_local = x.shape[0]
    y = torch.empty((s_local * n, w.shape[1]), dtype=torch.float32,
                    device=x.device)
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    cur = x.contiguous()
    msg = cur.cpu() if host else cur            # what the ring sends
    for r in range(n):
        reqs = []
        if r < n - 1:
            nxt = torch.empty_like(msg)
            try:
                reqs = dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, msg, ranks[(idx - 1) % n], group),
                    dist.P2POp(dist.irecv, nxt, ranks[(idx + 1) % n], group)])
            except RuntimeError as e:
                raise _failed("batch_isend_irecv", axis, e) from e
        src = (idx + r) % n
        rows = slice(src * s_local, (src + 1) * s_local)
        y[rows] = _product(cur, w)
        try:
            for req in reqs:
                req.wait()
        except RuntimeError as e:
            raise _failed("batch_isend_irecv", axis, e) from e
        if r < n - 1:
            msg = nxt
            cur = nxt.to(x.device) if host else nxt
    return y


def plain_matmul_ag(x: torch.Tensor, w: torch.Tensor, mesh,
                    axis: str = "model") -> torch.Tensor:
    """Reference: the unpipelined lowering (all-gather, then one product)."""
    return _product(all_gather(x, mesh, axis, dim=0), w)
