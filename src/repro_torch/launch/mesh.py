"""Meshes over a ``torch.distributed`` world (port of ``repro.launch.mesh``).

JAX runs one process over many devices and names their axes with a
``Mesh``; the port runs one process per rank (SPMD) and names the ranks'
axes with a ``torch.distributed.device_mesh.DeviceMesh`` whose dimension
names are the reference's axis names.  Building a mesh needs an initialised
world; ``run_world`` starts one of ``n`` local ranks, which JAX does not
need.  Every process group of a mesh carries the world's timeout, so a rank
that posts a collective its peers never post fails after that timeout
instead of waiting forever.  Nothing here touches ``torch.distributed`` at
import time.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["make_mesh", "make_production_mesh", "make_test_mesh",
           "run_world"]


def make_production_mesh(*, multi_pod: bool = False):
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model).
    The world must have exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = _world_size()
    if n != int(torch.tensor(shape).prod()):
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{int(torch.tensor(shape).prod())} ranks, have {n}")
    return _mesh(shape, axes)


def make_test_mesh(n_devices: int | None = None, model: int = 2):
    """Small (data, model) mesh of shape ``(n // model, model)`` over the
    first ranks of the world, ``n`` = ``n_devices`` or the world's size (1
    without a world).

    Raises ``ValueError`` instead of building a zero-extent mesh when fewer
    than ``model`` ranks are available, and when ``n_devices`` exceeds the
    world.
    """
    world = _world_size()
    n = n_devices or world
    if model < 1 or n // model < 1:
        raise ValueError(
            f"make_test_mesh needs at least model={model} devices, have "
            f"{n}; start a world of N ranks (repro_torch.launch.mesh."
            f"run_world) or lower `model`")
    if n > world:
        raise ValueError(f"make_test_mesh(n_devices={n}) exceeds the world "
                         f"of {world} ranks")
    return _mesh((n // model, model), ("data", "model"))


def make_mesh(shape: tuple, axes: tuple):
    """A mesh of ``shape`` with axis names ``axes`` over the first ranks of
    the world (the counterpart of ``jax.make_mesh``).  Every rank of the
    world takes part in building it; a rank outside it gets a mesh whose
    ``get_coordinate()`` is None."""
    n = int(torch.tensor(shape).prod())
    if len(shape) != len(axes) or n > _world_size():
        raise ValueError(f"a mesh {tuple(shape)} over axes {tuple(axes)} "
                         f"needs {n} ranks and one name an axis; the world "
                         f"has {_world_size()}")
    return _mesh(tuple(shape), tuple(axes))


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape, axes):
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("a mesh needs a torch.distributed world: start "
                           "one with repro_torch.launch.mesh.run_world or "
                           "torch.distributed.init_process_group")
    ranks = torch.arange(int(torch.tensor(shape).prod())).reshape(shape)
    # the mesh's device type is where the world's backend moves its
    # buffers: the card for NCCL, the host for gloo (which also takes card
    # tensors, copying them); the axis groups get the world's backend and
    # options, its timeout among them (new groups would otherwise wait the
    # backend's default, 30 minutes for gloo)
    backend = dist.get_backend()
    device_type = "cuda" if backend == "nccl" else "cpu"
    world = dist.group.WORLD._get_backend(torch.device(device_type))
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes,
                      backend_override=((backend, world.options),)
                      * len(shape))


# ------------------------------------------------------------ local worlds

def run_world(fn, n: int, *, backend: str, device: str,
              timeout: float, deadline: float, args: tuple = ()) -> list:
    """Run ``fn(rank, *args)`` on ``n`` spawned local ranks of one
    ``torch.distributed`` world and return their results in rank order.

    ``backend`` (``gloo`` or ``nccl``) is the caller's choice; nothing here
    picks another.  ``device``: ``cpu``, ``cuda:i`` (every rank on card
    ``i``, which NCCL refuses and ``gloo`` allows) or ``cuda`` (rank ``r``
    on card ``r``).  ``timeout`` (seconds)
    bounds every collective; ``deadline`` (seconds) the whole run.  Each
    rank runs ``torch.set_num_threads(1)``, so ranks beside other processes
    do not oversubscribe the cores.  ``fn`` and ``args`` are pickled: ``fn``
    must be importable by name.  If a rank raises, dies or outlives the
    deadline, every rank is stopped and this raises ``RuntimeError`` with
    the rank's traceback.
    """
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"run_world runs its ranks on 'cpu', one card "
                         f"'cuda:i' or a card each 'cuda', not {device!r}")
    ctx = multiprocessing.get_context("spawn")
    store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                          wait_for_workers=False,
                          timeout=datetime.timedelta(seconds=timeout))
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, n, store.port, backend, device, timeout, args, results))
        for r in range(n)]
    for p in procs:
        p.start()
    out: dict[int, object] = {}
    end = time.monotonic() + deadline
    try:
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                # a rank that returned exits 0 after its result is queued
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} before "
                                       f"returning") from None
                if time.monotonic() > end:
                    raise RuntimeError(f"the world of {n} ranks ran past "
                                       f"its deadline of {deadline} s; "
                                       f"ranks done: {sorted(out)}") from None
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, end - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[r] for r in range(n)]


def _rank_main(fn, rank, n, port, backend, device, timeout, args, results):
    """One spawned rank: join the world, run ``fn``, report to the parent."""
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev if dev.index is not None else rank)
        span = datetime.timedelta(seconds=timeout)
        store = dist.TCPStore("127.0.0.1", port, n, is_master=False,
                              timeout=span)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=n, timeout=span)
        try:
            value = fn(rank, *args)
            dist.barrier()          # no rank leaves while a peer still reads
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
