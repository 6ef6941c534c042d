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
"""

from __future__ import annotations

import contextlib

from repro_torch.distributed import axis_size

__all__ = ["constrain", "data_shard", "fsdp_size", "head_scheme",
           "set_mesh", "shard_mean", "tp_size"]

_MESH = None
_FSDP: tuple = ()
_TP: str | None = None
_SHARD = None        # (mesh, batch axes) inside ``data_shard``


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
    if _MESH is None or _TP is None:
        return 1
    return axis_size(_MESH, _TP)


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


def shard_mean(t):
    """``t``, a mean over this rank's rows, as the mean over every data
    shard's rows inside ``data_shard`` (a differentiable ``all_reduce``);
    ``t`` itself elsewhere."""
    if _SHARD is None:
        return t
    from repro_torch.distributed import all_reduce_mean_grad
    mesh, axes = _SHARD
    for a in axes:
        t = all_reduce_mean_grad(t, mesh, a)
    return t


def constrain(x, *axes):
    """The reference's GSPMD layout hint; here ``x`` itself.

    In the reference, ``constrain`` tells XLA's partitioner how to lay out
    an activation across the mesh.  The port runs eager SPMD: every rank
    holds the whole activation (replicated), and only code written against
    the mesh (the sharded DSLOT execute, expert parallelism, the collective
    matmul) splits work and calls a collective.  There is no layout to
    hint, so the activation comes back unchanged."""
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
