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

``gather_for_use`` is the sharded train step's ZeRO-3 gather of one stored
parameter slice at its use (``models/pspec.py`` ``layer_gather``): an
``all_gather`` over each axis the slice is split on, whose backward
reduce-scatters the gradient back to the slice in f32 and adds it to an
f32 accumulator of the step's (a sink) instead of handing it to autograd.

``copy_to_model`` and ``reduce_from_model`` are Megatron's "f" and "g", the
autograd operators around a column- and row-parallel pair of products over
the model axis (the sharded train step's split, ``models/pspec.py``
``model_shard``); ``all_reduce_max`` is the vocab-parallel cross-entropy's
max.  The split recurrent mixers add two more: ``sum_over_model``, a sum
whose backward sums as well (Mamba2's gated RMSNorm, whose statistic runs
over every rank's channels and is read by every rank's channels), and
``gather_over_model``, an ``all_gather`` whose backward is a
reduce-scatter (the RG-LRU's gate input, whose whole width every rank's
gate columns read).  Serving under the split adds ``gather_from_model`` (the new tokens'
heads, a prefill's kv heads, vocab-parallel logits) and
``combine_softmax``, which joins the ranks' partial attention over a KV
ring split along its slots (context parallelism): ``all_reduce_max`` of
their running maxima, then one sum of their rescaled softmax sums.  Their
``timer`` is an optional ``timer(kind)`` context manager around each
collective
(``train.step.CollectiveClock``): kind ``model`` for "f", "g", the
cross-entropy's max and the mixers' two, ``model_gather`` for the gathers, ``model_combine``
for the split attention's max and sum.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

__all__ = ["all_gather", "all_to_all", "all_reduce_max", "all_reduce_mean",
           "all_reduce_mean_grad", "all_reduce_sum_", "axis_rank",
           "axis_size", "combine_softmax", "copy_to_model",
           "gather_for_use", "gather_from_model", "gather_over_model",
           "mesh_barrier", "reduce_from_model", "reduce_scatter",
           "sum_over_model"]


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


def reduce_scatter(t: torch.Tensor, mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``axis``, taken in f32 and cut
    along ``dim`` into as many blocks as the axis has ranks: this rank's
    block (its slot in ``all_gather``'s result), f32."""
    n = axis_size(mesh, axis)
    if n == 1:
        return t.to(torch.float32)
    src = t.movedim(dim, 0).to(torch.float32,
                               memory_format=torch.contiguous_format)
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    try:
        scatter(out, src, group=mesh.get_group(axis))
    except RuntimeError as e:
        raise _failed("reduce_scatter", axis, e) from e
    return out.movedim(0, dim)


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


def _timed(timer, kind: str):
    """``timer(kind)``, or no context without a timer."""
    return timer(kind) if timer is not None else contextlib.nullcontext()


def _sum_f32(t: torch.Tensor, mesh, axis: str, dtype, timer
             ) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis``, taken in f32 and rounded
    once to ``dtype``; a new tensor.  ``timer(kind)``, when given, is a
    context manager around the collective."""
    flat = t.to(torch.float32, copy=True).contiguous()
    with _timed(timer, "model"):
        all_reduce_sum_(flat, mesh, axis)
    return flat.to(dtype)


class _CopyToModel(torch.autograd.Function):
    """Megatron's "f": the identity forward; the backward sums the ranks'
    gradients over the axis."""

    @staticmethod
    def forward(ctx, x, mesh, axis, timer):
        ctx.mesh, ctx.axis, ctx.timer = mesh, axis, timer
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.mesh, ctx.axis, g.dtype, ctx.timer), None, \
            None, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's "g": the forward sums the ranks' partial values over the
    axis; the identity backward (in the partials' dtype).  Not
    ``torch.distributed.nn.functional.all_reduce``, whose backward
    all-reduces again and would multiply every gradient by the axis size."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dtype, timer):
        ctx.dtype = x.dtype
        return _sum_f32(x, mesh, axis, dtype, timer)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None, None, None


def copy_to_model(x: torch.Tensor, mesh, axis: str = "model",
                  timer=None) -> torch.Tensor:
    """``x``, replicated on every rank of ``axis``, entering a
    column-parallel product: the identity, whose backward all-reduces the
    sum of the ranks' gradients (each rank's holds its columns' share).
    The sum runs in f32 and is rounded once to the gradient's dtype."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyToModel.apply(x, mesh, axis, timer)


def reduce_from_model(x: torch.Tensor, mesh, dtype, axis: str = "model",
                      timer=None) -> torch.Tensor:
    """The sum over the ranks of ``axis`` of each rank's partial ``x`` (a
    row-parallel product's output, best in f32), rounded once to ``dtype``:
    one device and the split differ only in the order of the sum.  The
    backward passes the gradient to every rank's partial unchanged."""
    if axis_size(mesh, axis) == 1:
        return x.to(dtype)
    return _ReduceFromModel.apply(x, mesh, axis, dtype, timer)


class _SumOverModel(torch.autograd.Function):
    """A sum over the axis whose backward sums the ranks' gradients too:
    every rank reads the summed value, so each one's gradient of it holds
    only its own readers' share."""

    @staticmethod
    def forward(ctx, x, mesh, axis, timer):
        ctx.mesh, ctx.axis, ctx.timer = mesh, axis, timer
        return _sum_f32(x, mesh, axis, x.dtype, timer)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.mesh, ctx.axis, g.dtype, ctx.timer), None, \
            None, None


class _GatherOverModel(torch.autograd.Function):
    """``all_gather`` along a dim over the axis; the backward sums the
    ranks' gradients of the gathered tensor and hands each rank its own
    block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, dim, axis, timer):
        ctx.mesh, ctx.dim, ctx.axis, ctx.timer = mesh, dim, axis, timer
        ctx.size = x.shape[dim]
        with _timed(timer, "model"):
            return all_gather(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        whole = _sum_f32(g, ctx.mesh, ctx.axis, g.dtype, ctx.timer)
        lo = axis_rank(ctx.mesh, ctx.axis) * ctx.size
        return whole.narrow(ctx.dim, lo, ctx.size).contiguous(), None, \
            None, None, None


class _GatherForUse(torch.autograd.Function):
    """A stored parameter slice gathered for use: ``all_gather`` over each
    ``(axis, dim)`` of ``gathers``, innermost first.  The backward takes
    the gradient of the gathered leaf (in its dtype) back to the slice in
    f32 -- over each gathered axis in reverse, a reduce-scatter where the
    axis is in ``sums`` and the rank's block otherwise; then a sum over
    each axis of ``sums`` the slice is not split on -- and adds it to
    ``sink``.  Nothing reaches the slice through autograd, which would
    round the f32 sum to the slice's dtype; ``token`` (an empty tensor
    that requires grad) is the input that puts the gather on autograd's
    path.  No gathered tensor is saved."""

    @staticmethod
    def forward(ctx, x, token, mesh, gathers, sums, sink, timer):
        ctx.mesh, ctx.gathers, ctx.sums = mesh, gathers, sums
        ctx.sink, ctx.timer = sink, timer
        with _timed(timer, "gather"):
            for axis, dim in gathers:
                x = all_gather(x, mesh, axis, dim)
        return x if gathers else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, split = ctx.mesh, {a for a, _ in ctx.gathers}
        with _timed(ctx.timer, "reduce"):
            for axis, dim in reversed(ctx.gathers):
                if axis in ctx.sums:
                    g = reduce_scatter(g, mesh, axis, dim)
                else:              # alike on every rank: its own block
                    n = g.shape[dim] // axis_size(mesh, axis)
                    g = g.narrow(dim, axis_rank(mesh, axis) * n, n)
            rest = [a for a in ctx.sums if a not in split]
            if rest:
                g = g.to(torch.float32, memory_format=torch.contiguous_format,
                         copy=True)
                for axis in rest:
                    all_reduce_sum_(g, mesh, axis)
        ctx.sink.add_(g)
        return None, None, None, None, None, None, None


def gather_for_use(x: torch.Tensor, token: torch.Tensor, mesh,
                   gathers: tuple, sums: tuple, sink: torch.Tensor,
                   timer=None) -> torch.Tensor:
    """``x``, a stored parameter slice, gathered whole over the ``(axis,
    dim)`` pairs of ``gathers`` (innermost axis first) inside
    ``timer("gather")``.  Its backward adds to ``sink`` (f32, shaped like
    ``x``) the gradient of the gathered leaf summed in f32 over the axes of
    ``sums`` and cut to ``x``'s block -- a reduce-scatter over each
    gathered axis of ``sums``, the rank's block of the others, an
    ``all_reduce`` over the axes of ``sums`` ``x`` is not split on --
    inside ``timer("reduce")``; autograd sees no gradient of ``x``.  The
    output requires grad through ``token``."""
    return _GatherForUse.apply(x, token, mesh, tuple(gathers), tuple(sums),
                               sink, timer)


def sum_over_model(x: torch.Tensor, mesh, axis: str = "model",
                   timer=None) -> torch.Tensor:
    """The sum of the ranks' partial ``x`` over ``axis``, taken in f32 and
    rounded once to ``x``'s dtype, where every rank reads the sum: the
    backward sums the ranks' gradients of it as well (unlike "g", whose
    readers after it compute alike on every rank)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _SumOverModel.apply(x, mesh, axis, timer)


def gather_over_model(x: torch.Tensor, mesh, dim: int, axis: str = "model",
                      timer=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in axis order, where
    each rank reads the whole in its own way: the backward sums the ranks'
    gradients of the whole in f32 and keeps this rank's block (a
    reduce-scatter; ``gather_from_model`` has no backward)."""
    if axis_size(mesh, axis) == 1:
        return x
    return _GatherOverModel.apply(x, mesh, dim, axis, timer)


def all_reduce_max(t: torch.Tensor, mesh, axis: str = "model",
                   timer=None, kind: str = "model") -> torch.Tensor:
    """The elementwise max of ``t`` over the ranks of ``axis``, detached
    (no gradient flows through it); a new tensor."""
    if axis_size(mesh, axis) == 1:
        return t.detach().clone()
    out = t.detach().to(torch.float32, copy=True).contiguous()   # exact
    try:
        with _timed(timer, kind):
            dist.all_reduce(out, op=dist.ReduceOp.MAX,
                            group=mesh.get_group(axis))
    except RuntimeError as e:
        raise _failed("all_reduce", axis, e) from e
    return out.to(t.dtype)


def gather_from_model(t: torch.Tensor, mesh, dim: int, axis: str = "model",
                      timer=None) -> torch.Tensor:
    """``all_gather`` of ``t`` over ``axis`` along ``dim`` (every rank's
    block in axis order), inside ``timer("model_gather")``; no autograd."""
    with _timed(timer, "model_gather"):
        return all_gather(t, mesh, axis, dim)


def combine_softmax(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor,
                    mesh, dtype, axis: str = "model", timer=None
                    ) -> torch.Tensor:
    """Attention over keys split among the ranks of ``axis``, from each
    rank's online-softmax state over its own keys: ``m`` its largest score
    (``(...,)``, f32; -1e30 where it sees no key), ``l`` the sum of its
    probabilities exp(s - m) and ``acc`` their weighted sum of the values
    (``(..., D)``, f32).  The ranks' largest ``m`` (``all_reduce_max``)
    rescales each rank's ``l`` and ``acc`` by exp(m - max); both are summed
    over the ranks in f32 (one collective), then ``acc / l`` is rounded
    once to ``dtype``.  One device differs in the order of those sums and
    in rounding each probability against the rank's own max."""
    if axis_size(mesh, axis) > 1:
        scale = torch.exp(m - all_reduce_max(m, mesh, axis, timer,
                                             "model_combine"))
        flat = torch.cat([(l * scale).reshape(-1),
                          (acc * scale[..., None]).reshape(-1)])
        with _timed(timer, "model_combine"):
            all_reduce_sum_(flat, mesh, axis)
        l, acc = flat[:l.numel()].view(l.shape), \
            flat[l.numel():].view(acc.shape)
    return (acc / torch.clamp_min(l[..., None], 1e-30)).to(dtype)


def mesh_barrier(mesh) -> None:
    """Wait for every rank of ``mesh``: a one-element ``all_reduce`` over
    each axis in turn (after the last, each rank has met every rank whose
    earlier rounds it depends on, which is all of them)."""
    one = torch.zeros(1)
    if dist.get_backend() == "nccl":
        one = one.cuda()
    for axis in mesh.mesh_dim_names:
        all_reduce_sum_(one, mesh, axis)
