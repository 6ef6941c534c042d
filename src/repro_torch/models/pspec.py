"""The installed mesh and its logical axes (port of ``repro.models.pspec``).

Launchers and the serving engine register the mesh here (``set_mesh``);
model code reads its sizes:

    b   -> the batch axes ("pod", "data")
    tp  -> the tensor-parallel axis ("model")
    None-> replicated

``head_scheme`` picks how attention would shard across tp given the GQA
geometry, as the reference does:
    "kv"     — tp | n_kv_heads: shard the kv-head axis (canonical Megatron)
    "group"  — tp | q-groups:   shard q's group axis, replicate kv
    "repeat" — otherwise:       repeat kv to n_heads and shard q-heads

The registry is process state, as in the reference: one mesh per process.

``model_shard`` is where the model axis splits compute: inside it (the
sharded train step's forward and backward, and serving with
``ServeConfig.mesh`` or the dry run's serving cells) ``tp_size`` and
``tp_rank`` report its model axis, ``splits`` says which products split,
and the model code runs Megatron's column- and row-parallel products on
the rank's slices of the parameters (``train.sharding.model_slice`` cuts
them for serving), with ``copy_to_model`` / ``reduce_from_model`` ("f" /
"g") around them.  Serving splits its KV rings along their slots as well
(context parallelism, ``ring_splits``): each rank attends every head
against its own slots and ``model_combine`` joins the ranks' online-softmax
states.  Outside ``model_shard`` nothing splits, whatever mesh is
installed, but a DSLOT MLP prepared with one (``dslot_prepare(mesh=...)``).

``layer_gather`` is where a layer ``Stack`` reads stored parameter slices:
inside it (the sharded train step's forward and backward) ``Stack.apply``
gathers each layer's leaves just before the layer runs (``gather_leaf``),
and their gradients go back to f32 slices of the step's; outside it a
Stack reads its parameters as they are.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

from repro_torch import distributed
from repro_torch.distributed import axis_size

__all__ = ["Splits", "active_splits", "constrain", "copy_to_model",
           "data_shard", "fsdp_size", "gather_leaf", "gather_over_model",
           "head_scheme", "layer_gather",
           "model_combine", "model_gather", "model_max", "model_shard",
           "model_split", "parts_cut", "reduce_from_model", "ring_splits",
           "set_mesh", "shard_mean", "splits", "sum_over_model", "tp_rank",
           "tp_size"]

_MESH = None
_FSDP: tuple = ()
_TP: str | None = None
_SHARD = None        # (mesh, batch axes) inside ``data_shard``
_SPLIT = None        # (mesh, model axis, timer, parts_cut) in ``model_shard``
_GATHER = None       # (mesh, {id: (plan, sink)}, token, timer) in layer_gather


def set_mesh(mesh) -> None:
    """Install ``mesh`` (a ``DeviceMesh`` with named axes), or None."""
    global _MESH, _FSDP, _TP
    _MESH = mesh
    if mesh is None:
        _FSDP, _TP = (), None
        return
    names = mesh.mesh_dim_names
    _FSDP = tuple(a for a in ("pod", "data") if a in names)
    _TP = "model" if "model" in names else None


def tp_size() -> int:
    """Ranks on the model axis: the ``model_shard`` axis inside it, else
    the installed mesh's ``model`` axis (1 without one)."""
    if _SPLIT is not None:
        return axis_size(_SPLIT[0], _SPLIT[1])
    if _MESH is None or _TP is None:
        return 1
    return axis_size(_MESH, _TP)


def tp_rank() -> int:
    """This rank's index on the ``model_shard`` axis (0 outside it)."""
    if _SPLIT is None:
        return 0
    return distributed.axis_rank(_SPLIT[0], _SPLIT[1])


def model_split() -> int:
    """Ranks the model code splits its products over: ``tp_size()`` inside
    ``model_shard``, 1 elsewhere."""
    return tp_size() if _SPLIT is not None else 1


def fsdp_size() -> int:
    if _MESH is None or _SHARD is not None:
        return 1
    n = 1
    for a in _FSDP:
        n *= axis_size(_MESH, a)
    return n


@contextlib.contextmanager
def data_shard(mesh, axes: tuple):
    """Code inside runs on the rows of one data shard of ``mesh`` (the
    sharded train step's forward on a rank's batch slice), the shards split
    over the mesh axes ``axes``.  There ``fsdp_size()`` is 1, so MoE
    dispatch takes the rank's rows as one group, the group the reference's
    GSPMD forward gives that shard; and ``shard_mean`` averages a batch
    statistic over the shards, as the reference's means over the whole
    batch do."""
    global _SHARD
    prev, _SHARD = _SHARD, (mesh, tuple(axes))
    try:
        yield
    finally:
        _SHARD = prev


@contextlib.contextmanager
def model_shard(mesh, axis: str = "model", timer=None,
                parts_cut: bool = False):
    """Code inside splits its compute over mesh axis ``axis`` (the sharded
    train step's forward and backward; serving's prefill, extend and
    decode): attention heads, MLP and expert ``d_ff`` columns, the vocab,
    the Mamba2 mixer's heads and the RG-LRU's width, where ``splits`` says
    they divide, and serving's KV rings where
    ``ring_splits`` does.  The parameters it reads are the rank's ``model``
    slices of those leaves (``train.sharding.model_reads``).  A PART leaf
    (``wk``/``wv`` under "group" and "repeat"; the Mamba2 mixer's ``w_in``,
    conv and per-head leaves) is whole, as the train step gathers it, or
    with ``parts_cut`` already cut to what the rank reads, as a serving
    rank stores it (``train.sharding.model_slice``).
    ``timer(kind)``: an optional context manager around every model-axis
    collective (``repro_torch.distributed``'s kinds)."""
    global _SPLIT
    prev, _SPLIT = _SPLIT, (mesh, axis, timer, parts_cut)
    try:
        yield
    finally:
        _SPLIT = prev


@contextlib.contextmanager
def layer_gather(mesh, table: dict, token, timer=None):
    """Code inside reads every layer ``Stack`` leaf as a stored slice to be
    gathered at use (the sharded train step): ``table`` maps the ``id`` of
    each stored leaf to its ``train.sharding.LeafGather`` and an f32 sink
    shaped like it, where the gather's backward adds the leaf's gradient
    slice; ``token``, an empty tensor that requires grad, puts every gather
    on autograd's path; ``timer(kind)``, an optional context manager around
    each gather and reduction (kinds ``gather`` and ``reduce``)."""
    global _GATHER
    prev, _GATHER = _GATHER, (mesh, table, token, timer)
    try:
        yield
    finally:
        _GATHER = prev


def gather_leaf(t, g: int | None = None):
    """Stack leaf ``t`` for use by one layer: group ``g``'s entry of a
    stacked leaf (``g`` None: a rest layer's leaf as it is), inside
    ``layer_gather`` gathered whole from the stored slice
    (``distributed.gather_for_use``)."""
    if _GATHER is None:
        return t if g is None else t[g]
    mesh, table, token, timer = _GATHER
    plan, sink = table[id(t)]
    if g is not None:
        t, sink = t[g], sink[g]
    return distributed.gather_for_use(t, token, mesh, plan.gathers,
                                      plan.sums, sink, timer)


def parts_cut() -> bool:
    """Whether the PART leaves read inside ``model_shard`` are stored cut
    to what the rank reads (its ``parts_cut``)."""
    return _SPLIT is not None and _SPLIT[3]


class Splits(NamedTuple):
    """What the model code splits over ``n`` model ranks.  heads: q heads,
    ``wo``'s rows, the attention products; kv: ``wk``/``wv`` by kv head
    (``head_scheme``'s "kv"; under "group" and "repeat" each rank reads the
    kv heads its q heads read);
    mlp / moe: the dense MLP's and the experts' ``d_ff`` columns (not a
    DSLOT MLP); vocab: embedding rows, head columns and the logits; ssm:
    the Mamba2 mixer's heads (its z/x/dt columns, conv channels, SSD heads
    and ``w_out``'s rows; B and C stay whole); rglru: the RG-LRU's width
    (every mixer leaf, the scan and ``w_out``'s rows)."""
    heads: bool
    kv: bool
    mlp: bool
    moe: bool
    vocab: bool
    ssm: bool
    rglru: bool


def splits(cfg, n: int) -> Splits:
    """The split of ``cfg``'s products over ``n`` model ranks: each axis
    only where ``n`` divides it, where ``train.sharding.sanitize_spec``
    stores it split (the heads, whose columns divide whenever they do; the
    SSD heads, whose ``d_inner`` channels do)."""
    from .mlp import mlp_uses_dslot

    if n <= 1:
        return Splits(*(False,) * len(Splits._fields))
    heads = cfg.n_heads > 0 and cfg.n_heads % n == 0
    ff = cfg.d_ff > 0 and cfg.d_ff % n == 0
    kinds = set(cfg.block_pattern)
    ssd_heads = cfg.ssm_expand * cfg.d_model // cfg.ssm_headdim
    return Splits(heads=heads, kv=heads and cfg.n_kv_heads % n == 0,
                  mlp=ff and not mlp_uses_dslot(cfg),
                  moe=ff and cfg.n_experts > 0,
                  vocab=cfg.vocab_size % n == 0,
                  ssm="ssm" in kinds and ssd_heads % n == 0,
                  rglru="rglru" in kinds
                  and (cfg.rnn_width or cfg.d_model) % n == 0)


def active_splits(cfg) -> Splits:
    """``splits`` of ``cfg`` over ``model_split()`` ranks: nothing splits
    outside ``model_shard``."""
    return splits(cfg, model_split())


def ring_splits(capacity: int) -> bool:
    """Whether a KV ring of ``capacity`` slots splits its slots over the
    model ranks (context parallelism): inside ``model_shard`` over more
    than one rank, where the ranks divide it -- the reference's
    divisibility rule for the cache's sequence axis (``spec_for`` in its
    ``decode_state_shardings``).  A ring that does not split stays whole on
    every rank."""
    n = model_split()
    return n > 1 and capacity % n == 0


def copy_to_model(x):
    """Megatron's "f" over the ``model_shard`` axis."""
    mesh, axis, timer, _ = _SPLIT
    return distributed.copy_to_model(x, mesh, axis, timer)


def reduce_from_model(x, dtype):
    """Megatron's "g" over the ``model_shard`` axis: the ranks' partial
    ``x`` summed in f32, rounded once to ``dtype``."""
    mesh, axis, timer, _ = _SPLIT
    return distributed.reduce_from_model(x, mesh, dtype, axis, timer)


def sum_over_model(x):
    """The ranks' partial ``x`` summed over the ``model_shard`` axis, read
    by every rank: the backward sums as well
    (``distributed.sum_over_model``)."""
    mesh, axis, timer, _ = _SPLIT
    return distributed.sum_over_model(x, mesh, axis, timer)


def gather_over_model(x, dim: int):
    """Every model rank's ``x`` along ``dim`` in rank order, read whole by
    each rank: the backward is a reduce-scatter
    (``distributed.gather_over_model``)."""
    mesh, axis, timer, _ = _SPLIT
    return distributed.gather_over_model(x, mesh, dim, axis, timer)


def model_max(x):
    """The max of ``x`` over the ``model_shard`` axis, detached."""
    mesh, axis, timer, _ = _SPLIT
    return distributed.all_reduce_max(x, mesh, axis, timer)


def model_gather(x, dim: int):
    """Every model rank's ``x`` concatenated along ``dim`` in rank order
    (no autograd: serving)."""
    mesh, axis, timer, _ = _SPLIT
    return distributed.gather_from_model(x, mesh, dim, axis, timer)


def model_combine(m, l, acc, dtype):
    """Attention from the model ranks' online-softmax states over their
    own keys (``distributed.combine_softmax``)."""
    mesh, axis, timer, _ = _SPLIT
    return distributed.combine_softmax(m, l, acc, mesh, dtype, axis, timer)


def shard_mean(t):
    """``t``, a mean over this rank's rows, as the mean over every data
    shard's rows inside ``data_shard`` (a differentiable ``all_reduce``);
    ``t`` itself elsewhere."""
    if _SHARD is None:
        return t
    mesh, axes = _SHARD
    for a in axes:
        t = distributed.all_reduce_mean_grad(t, mesh, a)
    return t


def constrain(x, *axes):
    """The reference's GSPMD layout hint; here ``x`` itself.

    In the reference, ``constrain`` tells XLA's partitioner how to lay out
    an activation across the mesh.  The port runs eager SPMD: only code
    written against the mesh splits work and calls a collective: the
    model code inside ``model_shard`` (heads, ``d_ff`` columns and the vocab
    over ``model``, where the reference's ``constrain`` puts "tp"; the
    recurrent mixers by head and width, where its parameter rules and
    decode-state layout put ``model``), the sharded DSLOT execute, expert
    parallelism and the collective matmul.
    There is no layout to hint, so the activation comes back unchanged."""
    return x


def head_scheme(n_kv: int, n_heads: int) -> str:
    t = tp_size()
    if t == 1:
        return "kv"
    if n_kv % t == 0:
        return "kv"
    if (n_heads // n_kv) % t == 0:
        return "group"
    return "repeat"
