"""Sharding rules: FSDP x TP over a device mesh (port of
``repro.train.sharding``).

Two logical parallel dimensions, as in the reference:

* ``tp``   — the "model" mesh axis: Megatron-style column- and row-parallel
  layouts of the projections, the vocab-sharded embedding and head.
* ``fsdp`` — the "data" axis (and "pod" when present): ZeRO-3 storage
  sharding of the non-TP weight dimension.

A spec is the reference's ``PartitionSpec`` as plain data: a tuple with one
entry per leading dimension, each ``None`` (replicated), an axis name, or a
tuple of axis names (the dimension split over their product, the first
axis outermost).  A one-name tuple is written as the name, as
``PartitionSpec`` itself normalises it, so ``tuple(P(...))`` of the
reference equals the spec here.  Rules match the flattened parameter path
(``repro_torch.tree.flatten_with_path``: the reference's paths); a leaf of
the stacked layers (a path through ``groups``) has its spec shifted right
by one ``None``.

GSPMD places shards and inserts the collectives for the reference; here
``shard_tree`` keeps each rank's slice of every leaf and ``gather_tree``
rebuilds full leaves with ``all_gather`` over each sharded axis, a few
bucketed collectives for a whole tree (the checkpointer's snapshot, and the
sharded train step's leaves outside the layer stacks).  ``stack_plan`` is
the sharded train step's per-leaf plan of the layer stacks' leaves, which
it gathers layer by layer at use (``models/pspec.py`` ``layer_gather``),
as GSPMD gathers them inside the reference's scan.  ``model_reads`` is the
table of how the sharded train step's split compute (``models/pspec.py``
``model_shard``) reads each leaf: a leaf it reads only as the rank's
``model`` slice is gathered over the batch axes alone (``gather_specs``),
and a serving rank stores only what it reads (``model_slice``).
The rule functions take any mesh with the reference's surface
(``axis_names`` and ``shape`` by axis name) or a ``DeviceMesh``
(``mesh_dim_names``), so the rules need no world.
"""

from __future__ import annotations

import re
from typing import NamedTuple

import torch

from repro_torch.tree import flatten_with_path, map_with_path, tree_map

__all__ = ["LeafGather", "PART", "SPLIT", "Shardings", "WHOLE", "batch_pspec",
           "buckets", "gather_specs", "gather_tree", "local_slice",
           "make_batch_shardings", "make_param_shardings",
           "make_state_shardings", "mesh_axes", "model_reads", "model_slice",
           "param_pspec", "replicated", "sanitize_spec", "shard_tree",
           "stack_plan"]

BUCKET_BYTES = 256 << 20     # one collective moves at most this much a rank


def P(*entries) -> tuple:
    """A spec: one-name tuples become the name, as in ``PartitionSpec``."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def _axis_sizes(mesh) -> dict:
    """``{axis name: size}`` in the mesh's axis order."""
    if hasattr(mesh, "mesh_dim_names"):               # a DeviceMesh
        return {n: int(mesh.size(i))
                for i, n in enumerate(mesh.mesh_dim_names)}
    return {n: int(mesh.shape[n]) for n in mesh.axis_names}


def mesh_axes(mesh) -> tuple:
    """(fsdp_axes, tp_axis) for the given mesh."""
    names = tuple(_axis_sizes(mesh))
    fsdp = tuple(a for a in ("pod", "data") if a in names)
    tp = "model" if "model" in names else None
    return fsdp, tp


# (regex over the flattened path, spec rule given (fsdp, tp)): the
# reference's table
_RULES: list[tuple[str, object]] = [
    (r"embed/embedding$",        lambda f, t: P(t, f)),
    (r"head/w$",                 lambda f, t: P(f, t)),
    (r"(wq|wk|wv)/w$",           lambda f, t: P(f, t)),
    (r"(wq|wk|wv)/b$",           lambda f, t: P(t)),
    (r"wo/w$",                   lambda f, t: P(t, f)),
    (r"wo/b$",                   lambda f, t: P(None)),
    (r"mlp/(up|gate)/w$",        lambda f, t: P(f, t)),
    (r"mlp/down/w$",             lambda f, t: P(t, f)),
    (r"moe/router$",             lambda f, t: P(f, None)),
    (r"moe/(up|gate)$",          lambda f, t: P(None, f, t)),
    (r"moe/down$",               lambda f, t: P(None, t, f)),
    (r"mixer/w_in$",             lambda f, t: P(f, t)),
    (r"mixer/w_gate$",           lambda f, t: P(f, t)),
    (r"mixer/(wa|wx)$",          lambda f, t: P(f, t)),
    (r"mixer/conv_w$",           lambda f, t: P(None, t)),
    (r"mixer/(conv_b|norm_scale|ba|bx|lam)$", lambda f, t: P(t)),
    (r"mixer/w_out$",            lambda f, t: P(t, f)),
    (r"mixer/(A_log|D_skip|dt_bias)$", lambda f, t: P(None)),
    (r"(norm\d?|normx|final_norm|enc_norm)/(scale|bias)$",
     lambda f, t: P(None)),
]


# How the split compute reads a leaf (``model_reads``): SPLIT, only the
# rank's model slice; PART, gathered whole and read in part (its gradient
# is summed over the model axis); WHOLE, gathered whole and read whole by
# every model rank alike.
SPLIT, PART, WHOLE = "split", "part", "whole"

# (regex over the flattened path, the ``pspec.Splits`` field that splits
# it, what the split reads of it); a mixer's leaves are matched by its kind
_READS: list[tuple[str, str, str]] = [
    (r"(embed/embedding|head/w)$", "vocab", SPLIT),
    (r"(wq/(w|b)|wo/w)$",          "heads", SPLIT),
    (r"(wk|wv)/(w|b)$",            "kv", SPLIT),
    (r"mlp/(up|gate|down)/w$",     "mlp", SPLIT),
    (r"moe/(up|gate|down)$",       "moe", SPLIT),
    (r"ssm/(w_in|conv_w|conv_b|A_log|D_skip|dt_bias)$", "ssm", PART),
    (r"ssm/(norm_scale|w_out)$",   "ssm", SPLIT),
    (r"rglru/\w+$",                "rglru", SPLIT),
]


def _mixer_path(path: str, ssm_mixers: set) -> str:
    """``path`` with a mixer leaf's ``mixer`` named by its kind (``ssm``
    where the mixer holds ``A_log``, else ``rglru``)."""
    head, sep, name = path.rpartition("mixer/")
    if not sep or "/" in name:
        return path
    return f"{head}{'ssm' if head in ssm_mixers else 'rglru'}/{name}"


def model_reads(mesh, cfg, params):
    """A tree shaped like ``params`` of SPLIT / PART / WHOLE: how the
    compute inside ``pspec.model_shard`` over ``mesh``'s model axis reads
    each leaf (``pspec.splits``).  SPLIT: embedding and head where the
    vocab divides, ``wq`` and ``wo`` where the heads do, ``wk``/``wv`` under
    the "kv" scheme, MLP and expert ``d_ff`` products, the Mamba2 mixer's
    ``norm_scale`` and ``w_out`` where its heads divide, every RG-LRU
    mixer leaf where its width does.  PART: ``wk``/``wv`` under "group"
    and "repeat" (each rank reads the kv heads its q heads read), and the
    Mamba2 mixer's ``w_in``, conv and per-head leaves (its z/x/B/C/dt
    segments do not line up with the storage's blocks; ``ssm.ssm_part``).
    WHOLE: the rest -- a vocab, head count or mixer width that does not
    divide, norms, the router, ``wo``'s bias."""
    from repro_torch.models.pspec import splits

    _, tp = mesh_axes(mesh)
    sp = splits(cfg, _axis_sizes(mesh)[tp] if tp else 1)
    ssm_mixers = {path[:-len("mixer/A_log")] for path, _ in
                  flatten_with_path(params) if path.endswith("mixer/A_log")}

    def one(path, leaf):
        path = _mixer_path(path, ssm_mixers)
        for pat, field, read in _READS:
            if re.search(pat, path):
                if getattr(sp, field):
                    return read
                return PART if field == "kv" and sp.heads else WHOLE
        return WHOLE

    return map_with_path(one, params)


def gather_specs(specs, reads, mesh):
    """The specs the sharded train step gathers the parameters by
    (``gather_tree`` and ``stack_plan``): each SPLIT leaf's spec without
    the model axis (it stays the rank's slice), the others' as they
    are."""
    _, tp = mesh_axes(mesh)
    return tree_map(
        lambda r, s: P(*(None if e == tp else e for e in s))
        if r == SPLIT else s, reads, specs)


class LeafGather(NamedTuple):
    """How the sharded train step gathers one layer-stack leaf at its use
    (``distributed.gather_for_use``): ``gathers``, the ``(axis, dim)``
    ``all_gather``s of one layer's slice, innermost axis first (a stacked
    leaf's dims counted after ``_index`` took its group); ``sums``, the
    axes its gradient is summed over (every batch axis, and the model axis
    for a PART leaf); ``stacked``, whether the leaf holds a Stack's groups
    on its leading dimension."""
    gathers: tuple
    sums: tuple
    stacked: bool


def stack_plan(mesh, specs, reads, params):
    """A tree shaped like ``params``: for each leaf of a layer ``Stack``
    its ``LeafGather`` -- gathered by ``gather_specs`` (``specs`` as they
    are where ``reads`` is None), the stacked leaf's leading ``None``
    dropped -- and None for the leaves outside every Stack (embedding,
    head, final and encoder norms), which ``gather_tree`` gathers."""
    fsdp, tp = mesh_axes(mesh)
    sizes = _axis_sizes(mesh)
    gspecs = specs if reads is None else gather_specs(specs, reads, mesh)
    batch = tuple(a for a in fsdp if sizes[a] > 1)
    part_sum = (tp,) if tp is not None and sizes[tp] > 1 else ()

    def one(path, spec, read):
        parts = path.split("/")
        if "groups" not in parts and "rest" not in parts:
            return None
        stacked = "groups" in parts
        spec = spec[1:] if stacked else spec
        gathers = tuple((axis, dim) for axis in reversed(list(sizes))
                        if sizes[axis] > 1
                        for dim, e in enumerate(spec)
                        if axis in _spec_axes(e))
        return LeafGather(gathers, batch + (part_sum if read == PART else ()),
                          stacked)

    paths = map_with_path(lambda path, _: path, params)
    return tree_map(one, paths, gspecs,
                    reads if reads is not None else paths)


def model_slice(mesh, cfg, params):
    """A serving rank's parameters: what the split compute inside
    ``pspec.model_shard`` over ``mesh``'s model axis reads of each leaf of
    a whole ``params`` tree (``model_reads``), each a copy of its own.  A
    SPLIT leaf is cut to the rank's ``model`` slice, a PART leaf to what
    the rank reads (``wk``/``wv`` under "group" and "repeat": the columns
    of the kv heads its q heads read, ``attention.kv_part``; a Mamba2
    mixer leaf: its heads' columns and the whole B/C, ``ssm.ssm_part``),
    read under ``pspec.model_shard(..., parts_cut=True)``; a WHOLE leaf is
    kept as it is.  Nothing is split over the batch axes: every rank of a
    model slice holds it whole, so a forward gathers no parameter."""
    from repro_torch.models.attention import kv_part
    from repro_torch.models.ssm import _dims, ssm_part

    _, tp = mesh_axes(mesh)
    if tp is None or _axis_sizes(mesh)[tp] == 1:
        return params
    n, r = _axis_sizes(mesh)[tp], _coords(mesh)[tp]
    hq = cfg.n_heads // n                     # a PART leaf's rank's q heads
    hs = _dims(cfg)[1] // n                   # or its SSD heads
    reads = model_reads(mesh, cfg, params)
    specs = make_param_shardings(mesh, params)

    def one(leaf, read, spec, path):
        if read == SPLIT:
            only = P(*(tp if e == tp else None for e in spec))
            assert tp in only, (spec, leaf.shape)
            return local_slice(leaf, only, mesh).clone()
        if read == PART:
            head, _, name = path.rpartition("/")
            if head.endswith("mixer"):
                return ssm_part(name, leaf, cfg, r * hs, hs).clone()
            return kv_part(leaf, cfg, r * hq, hq).clone()
        return leaf

    paths = map_with_path(lambda path, _: path, params)
    return tree_map(one, params, reads, specs, paths)


def _path_str(path) -> str:
    """A path string as is, or the reference's key sequence joined by
    ``/`` (``.key`` / ``.idx`` entries, or plain values)."""
    if isinstance(path, str):
        return path
    parts = []
    for k in path:
        if hasattr(k, "key"):
            parts.append(str(k.key))
        elif hasattr(k, "idx"):
            parts.append(str(k.idx))
        else:
            parts.append(str(k))
    return "/".join(parts)


def param_pspec(path, leaf):
    """The spec rule ``(fsdp, tp) -> spec`` of the leaf at ``path``:
    shifted for a stacked leaf, trimmed to the leaf's rank; ``()``
    (replicated) for a path no rule matches."""
    s = _path_str(path)
    stacked = "groups" in s.split("/")
    for pat, rule in _RULES:
        if re.search(pat, s):
            def build(f, t, rule=rule):
                spec = rule(f, t)
                if stacked:
                    spec = P(None, *spec)
                return spec[:leaf.ndim]
            return build
    return lambda f, t: ()


def _axis_size(sizes: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def sanitize_spec(mesh, spec: tuple, shape) -> tuple:
    """Drop (replicate) any axis that does not divide its dimension (e.g.
    granite's vocab 49155 over 16)."""
    sizes = _axis_sizes(mesh)
    out = []
    for i, axis in enumerate(spec):
        if axis is None or i >= len(shape):
            out.append(None)
            continue
        out.append(axis if shape[i] % _axis_size(sizes, axis) == 0 else None)
    return P(*out)


def make_param_shardings(mesh, params):
    """Specs for a parameter tree (any leaves with ``ndim`` and
    ``shape``), a tree of the same structure."""
    fsdp, tp = mesh_axes(mesh)
    f = fsdp if fsdp else None

    def one(path, leaf):
        return sanitize_spec(mesh, param_pspec(path, leaf)(f, tp),
                             tuple(leaf.shape))

    return map_with_path(one, params)


def batch_pspec(mesh, global_batch: int) -> tuple:
    """Shard the batch dim over (pod, data) when divisible, else
    replicate."""
    fsdp, _ = mesh_axes(mesh)
    n = _axis_size(_axis_sizes(mesh), fsdp)
    if fsdp and global_batch % n == 0:
        return P(fsdp)
    return ()


def make_batch_shardings(mesh, batch, global_batch: int,
                         batch_axis: int = 0):
    """A spec for every array of the batch tree: its ``batch_axis``
    dimension sharded as ``batch_pspec`` says (``batch_axis=1`` for the
    grad-accumulation layout (M, mb, ...))."""
    axes = batch_pspec(mesh, global_batch)[:1]

    def one(leaf):
        if getattr(leaf, "ndim", 0) <= batch_axis or not axes:
            return ()
        return P(*((None,) * batch_axis), axes[0])

    return tree_map(one, batch)


def replicated(mesh) -> tuple:
    return ()


# ------------------------------------------------------------ placement

def _spec_axes(entry) -> tuple:
    """The axis names of one spec entry, outermost first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _coords(mesh) -> dict:
    """This rank's index along every axis of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _index(shape, spec: tuple, sizes: dict, coords: dict) -> tuple:
    """The index of this rank's block of an array of ``shape``."""
    idx = []
    for dim, entry in enumerate(spec):
        k, n = 0, 1
        for a in _spec_axes(entry):           # row-major over the axes
            k, n = k * sizes[a] + coords[a], n * sizes[a]
        size = shape[dim] // n
        idx.append(slice(k * size, (k + 1) * size))
    return tuple(idx)


def local_slice(x, spec: tuple, mesh):
    """This rank's block of ``x`` (a tensor or a numpy array) under
    ``spec``: a view."""
    return x[_index(x.shape, spec, _axis_sizes(mesh), _coords(mesh))]


def shard_tree(tree, specs, mesh):
    """This rank's slice of every leaf of ``tree`` (each a copy of its
    own), by the matching spec of ``specs``."""
    sizes, coords = _axis_sizes(mesh), _coords(mesh)
    return tree_map(
        lambda t, s: t[_index(t.shape, s, sizes, coords)].clone(), tree,
        specs)


class Shardings(NamedTuple):
    """Where a tree lives: a mesh and a tree of specs shaped like it (the
    counterpart of the reference's tree of ``NamedSharding``s)."""
    mesh: object
    specs: object


def make_state_shardings(mesh, state) -> Shardings:
    """A train state's placement: parameters and both AdamW moments by
    ``make_param_shardings``, ``count`` and ``step`` replicated (the
    reference launcher's state shardings)."""
    psh = make_param_shardings(mesh, state.params)
    specs = type(state)(
        params=psh,
        opt=type(state.opt)(m=make_param_shardings(mesh, state.opt.m),
                            v=make_param_shardings(mesh, state.opt.v),
                            count=()),
        step=())
    return Shardings(mesh, specs)


def gather_tree(tree, specs, mesh):
    """Full leaves from every rank's slices: for each mesh axis, innermost
    first, one ``all_gather`` per ``buckets`` run of the leaves sharded over
    it, each leaf reassembled along its dimension.  A failed collective
    raises ``DistError``."""
    from repro_torch.distributed import all_gather

    flat, flat_specs = [], []
    tree_map(lambda t, s: (flat.append(t), flat_specs.append(s)), tree,
             specs)
    sizes = _axis_sizes(mesh)
    for axis in reversed(list(sizes)):
        n = sizes[axis]
        if n == 1:
            continue
        todo = [(i, dim) for i, spec in enumerate(flat_specs)
                for dim, e in enumerate(spec) if axis in _spec_axes(e)]
        for run in buckets([flat[i] for i, _ in todo]):
            bucket = [todo[j] for j in run]
            local = torch.cat([flat[i].reshape(-1) for i, _ in bucket])
            every = all_gather(local, mesh, axis, dim=0).view(n, -1)
            off = 0
            for i, dim in bucket:
                t = flat[i]
                parts = [every[r, off:off + t.numel()].view(t.shape)
                         for r in range(n)]
                flat[i] = torch.cat(parts, dim=dim)
                off += t.numel()
            del every, local
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def buckets(tensors: list):
    """The indices of ``tensors`` in order, split into runs of one dtype of
    at most ``BUCKET_BYTES`` (a tensor larger than that goes alone): the
    tensors one collective moves."""
    run, size, dtype = [], 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if run and (t.dtype != dtype or size + nbytes > BUCKET_BYTES):
            yield run
            run, size = [], 0
        run.append(i)
        size += nbytes
        dtype = t.dtype
    if run:
        yield run
