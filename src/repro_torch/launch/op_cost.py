"""Op-level cost counter: the counterpart of ``repro.launch.hlo_cost``.

The reference compiles a step with XLA and walks the optimized HLO, whose
``cost_analysis()`` counts each while-loop body once; ``hlo_cost`` multiplies
by the loops' trip counts.  The port has no HLO to parse: it runs eagerly,
and every op of every loop iteration goes through PyTorch's dispatcher.
So this module is named for what it counts, ops, and counts them as they
run, under a ``TorchDispatchMode`` that composes with ``FakeTensorMode``
(the dry run's shapes without data) as well as with real tensors on the
CPU or the card.  There are no trip counts to correct.  It accumulates
the keys ``analyze_hlo`` returns:

* ``dot_flops``       -- 2 * M * N * K of every product and convolution,
                         forward and backward (``torch.utils.flop_counter``'s
                         formulas: ``mm``, ``addmm``, ``bmm``, ``baddbmm``,
                         ``convolution``, ``convolution_backward``, ...);
* ``vector_flops``    -- the output numel of pointwise arithmetic;
* ``hbm_bytes``       -- compulsory traffic by the reference's rule: the
                         operands and outputs of products and convolutions,
                         collectives, index / gather / scatter / index_put,
                         and reductions.  Elementwise ops are excluded: a
                         fused program keeps them out of device memory;
* ``hbm_bytes_upper`` -- every op that is not a view reads its operands and
                         writes its outputs once; the true traffic of an
                         eager program lies near this bound;
* ``coll_bytes`` / ``coll_counts`` per kind (the reference's kind names,
                         output sizes) and ``coll_total_bytes``: the
                         collectives the port issues (``c10d`` ops from
                         ``repro_torch.distributed`` and
                         ``train.sharding.gather_tree``).

The DSLOT kernel is a ``ctypes`` launch that dispatch never sees
(``kernels/dslot_matmul.run``), and on the CPU its plain version runs in
its place.  While a counter is active, ``run`` hands each call to the
counter, which records it as one opaque op, as ``analyze_hlo`` records a
Pallas ``custom-call``: its operand and output bytes in both byte counts,
no dot FLOPs, one launch in ``dslot_launches``; the ops of the plain
version inside it are not counted.  With no counter active ``run`` pays one
``None`` check.

    with OpCost() as cost:
        step(state, batch)
    cost.totals()          # the keys of analyze_hlo, plus dslot_launches
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["COLLECTIVES", "OpCost"]

aten = torch.ops.aten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# c10d ops by the reference's collective kinds; each op's outputs are its
# first argument
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# compulsory traffic besides products, collectives and reductions: the
# counterparts of gather, scatter and dynamic-update-slice
_INDEX_OPS = {
    aten.index, aten.index_put, aten.index_put_, aten._index_put_impl_,
    aten.index_select, aten.gather, aten.scatter, aten.scatter_,
    aten.scatter_add, aten.scatter_add_, aten.scatter_reduce,
    aten.scatter_reduce_, aten.index_add, aten.index_add_, aten.index_copy,
    aten.index_copy_, aten.embedding, aten.embedding_dense_backward,
    aten.slice_scatter, aten.select_scatter, aten.masked_scatter,
}

# pointwise-tagged ops that move data without arithmetic
_NOT_ARITHMETIC = {
    aten.copy_, aten._to_copy, aten.clone, aten.fill_, aten.zero_,
    aten.lift_fresh_copy, aten.detach, aten.alias,
}

# ops that allocate or describe and move no bytes
_NO_TRAFFIC = {
    aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
    aten.new_empty_strided, aten.detach, aten.alias, aten.lift_fresh,
    aten.sym_size, aten.sym_stride, aten.sym_numel, aten.sym_storage_offset,
    aten.is_same_size, aten._local_scalar_dense,
}

def _tensors(tree) -> list:
    """The tensors of ``tree`` (nested lists, tuples and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _numel(tree) -> int:
    return sum(t.numel() for t in _tensors(tree))


class OpCost(TorchDispatchMode):
    """Counts the ops dispatched inside it (see the module docstring).

    Enter it inside ``FakeTensorMode`` to count a program without running
    it.  ``totals()`` returns the reference's keys."""

    def __init__(self):
        super().__init__()
        self.dot_flops = 0
        self.vector_flops = 0
        self.hbm_bytes = 0
        self.hbm_bytes_upper = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_counts = {k: 0 for k in COLLECTIVES}
        self.dslot_launches = 0
        self._paused = 0
        self._outer_hook = None

    def __enter__(self):
        from repro_torch.kernels import dslot_matmul as dm

        self._outer_hook, dm._COST_HOOK = dm._COST_HOOK, self._dslot
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels import dslot_matmul as dm

        dm._COST_HOOK = self._outer_hook
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        packet = func._overloadpacket
        ns = func.namespace
        if ns == "c10d":
            kind = _C10D.get(packet.__name__)
            if kind is not None:
                moved = _nbytes(args[0])
                self.coll_bytes[kind] += moved
                self.coll_counts[kind] += 1
                self.hbm_bytes += moved
                self.hbm_bytes_upper += moved
            return
        if ns != "aten" or func.is_view or packet in _NO_TRAFFIC:
            return
        traffic = _nbytes((args, kwargs)) + _nbytes(out)
        self.hbm_bytes_upper += traffic
        if packet in flop_registry:
            self.dot_flops += int(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
            self.hbm_bytes += traffic
        elif packet in _INDEX_OPS or torch.Tag.reduction in func.tags:
            self.hbm_bytes += traffic
        elif torch.Tag.pointwise in func.tags \
                and packet not in _NOT_ARITHMETIC:
            self.vector_flops += _numel(out)
        elif packet.__name__.startswith("_foreach_") \
                and not packet.__name__.startswith("_foreach_copy"):
            self.vector_flops += _numel(args[0])

    @contextlib.contextmanager
    def paused(self):
        """Nothing dispatched inside is counted."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def _dslot(self, fn, args):
        """One DSLOT kernel call (``dslot_matmul.run``'s arguments) as an
        opaque op: the kernel on the card, the plain version on CPU
        tensors, empty outputs on fake ones (a dry run needs only their
        shapes)."""
        from torch._subclasses.fake_tensor import is_fake

        q, w, _, _, _, block_m, block_n = args[:7]
        with self.paused():
            if is_fake(q):
                M, N = q.shape[0], w.shape[1]
                out = (torch.empty((M, N), dtype=torch.float32,
                                   device=q.device),
                       torch.empty((M // block_m, N // block_n),
                                   dtype=torch.int32, device=q.device))
            else:
                out = fn(*args)
        moved = _nbytes(list(args)) + _nbytes(out)
        self.hbm_bytes += moved
        self.hbm_bytes_upper += moved
        self.dslot_launches += 1
        return out

    def totals(self) -> dict:
        """``analyze_hlo``'s keys (``unknown_trip_whiles`` is always 0:
        every iteration is dispatched) and ``dslot_launches``."""
        return {"dot_flops": self.dot_flops,
                "vector_flops": self.vector_flops,
                "hbm_bytes": self.hbm_bytes,
                "hbm_bytes_upper": self.hbm_bytes_upper,
                "coll_bytes": dict(self.coll_bytes),
                "coll_counts": dict(self.coll_counts),
                "unknown_trip_whiles": 0,
                "coll_total_bytes": sum(self.coll_bytes.values()),
                "dslot_launches": self.dslot_launches}

