"""Async, integrity-checked checkpointing (port of
``repro.checkpoint.checkpointer``, one device).

Layout (one directory per step), the reference's, so either package reads
the other's checkpoints:
    step_000123/
      manifest.json     — leaf paths, shapes, dtypes, crc32 per leaf
      shard_0.npz       — leaf arrays
      _COMMITTED        — written last; a directory without it is ignored

* **atomicity** — writes go to ``<dir>.tmp`` and are renamed after the
  commit marker; a crash mid-save never corrupts the latest checkpoint.
* **async** — ``save_async`` snapshots every tensor to host memory (a copy,
  so a train step that then updates the state in place does not reach the
  snapshot) and writes on a background thread.
* **integrity** — crc32 per leaf, verified on restore.

Leaf paths are the reference's ``jax.tree_util`` paths
(``repro_torch.tree.flatten_with_path``): a ``TrainState`` gives
``.params/<keys>``, ``.opt/.m/...``, ``.opt/.count``, ``.step``.  numpy has
no bfloat16, so a bf16 tensor is stored, as the reference stores it, as its
uint16 bit pattern under the dtype name ``"bfloat16"``.

* **elastic restore** — ``restore(step, target, shardings)`` with a
  ``train.sharding.Shardings`` (a mesh and a spec tree) gives each rank
  only its own block of every leaf on the target mesh, which may differ
  from the mesh that saved it.  Each rank reads the full leaf and checks its
  crc.

Tensors carry no placement here (the reference's arrays do), so a sharded
state is saved by passing its ``Shardings`` to ``save`` / ``save_async``:
every leaf is gathered (``all_gather``, a few leaves at a time), the mesh's
first rank alone writes the one-file layout above, and the other ranks go
on; ``wait`` then holds every rank of the mesh until the write is
committed.  So the reference, the single-device port and another mesh all
read the same checkpoint.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, map_with_path, tree_map

__all__ = ["Checkpointer"]

# dtypes numpy's npz handles natively (the reference stores any other as a
# same-width unsigned-int bit pattern; here only bfloat16 has one)
_NATIVE_DTYPES = {str(np.dtype(t)) for t in
                  ("f2", "f4", "f8", "i1", "i2", "i4", "i8",
                   "u1", "u2", "u4", "u8", "b1", "c8", "c16")}


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _snapshot(tree) -> list[tuple[str, str, np.ndarray]]:
    """``[(path, dtype name, stored array)]``: every leaf copied to host
    memory (bf16 as its uint16 bits)."""
    out = []
    for key, leaf in flatten_with_path(tree):
        t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            out.append((key, "bfloat16",
                        t.view(torch.int16).numpy().view(np.uint16)))
        else:
            arr = t.numpy()
            out.append((key, str(arr.dtype), arr))
    return out


def _from_stored(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if dtype_name not in _NATIVE_DTYPES:
        raise TypeError(f"checkpoint leaf of dtype {dtype_name} has no "
                        f"torch counterpart here")
    return torch.from_numpy(arr)


def _specs_by_leaf(tree, specs) -> dict:
    """``{id(leaf): spec}`` for the leaves of ``tree`` and the matching
    specs of ``specs``."""
    out = {}
    tree_map(lambda t, sp: out.__setitem__(id(t), sp), tree, specs)
    return out


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._barrier = None     # the mesh of the last sharded save

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, shardings=None) -> str | None:
        """Write ``tree`` as step ``step``; returns the step's directory
        (None on a rank of a sharded save that does not write)."""
        flat = self._host(tree, shardings)
        out = self._write(step, flat) if flat is not None else None
        if shardings is not None:
            from repro_torch.distributed import mesh_barrier
            mesh_barrier(shardings.mesh)
        return out

    def save_async(self, step: int, tree, shardings=None) -> None:
        """Snapshot ``tree`` to host memory now (gathered first when
        ``shardings`` is given) and write it on a thread (after any write
        still in flight)."""
        self.wait()
        flat = self._host(tree, shardings)
        self._barrier = shardings.mesh if shardings is not None else None
        if flat is not None:
            self._thread = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; after a sharded save, every rank of its
        mesh waits here until the writer is done."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier is not None:
            from repro_torch.distributed import mesh_barrier
            mesh, self._barrier = self._barrier, None
            mesh_barrier(mesh)

    @staticmethod
    def _host(tree, shardings):
        """The host snapshot to write: the whole tree, or for a sharded
        tree the gathered leaves on the mesh's first rank and None on the
        others (gathered one ``sharding.buckets`` run of shards at a time,
        so the card holds at most one run of full leaves beside the
        shards)."""
        if shardings is None:
            return _snapshot(tree)
        from repro_torch.train.sharding import buckets, gather_tree
        mesh = shardings.mesh
        writer = not any(mesh.get_coordinate())
        pairs = flatten_with_path(tree)
        by_id = _specs_by_leaf(tree, shardings.specs)
        specs = [by_id[id(t)] for _, t in pairs]
        out = []
        for run in buckets([t for _, t in pairs]):
            full = gather_tree([pairs[j][1] for j in run],
                               [specs[j] for j in run], mesh)
            if writer:
                out += _snapshot({pairs[j][0]: f for j, f in zip(run, full)})
            del full
        return out if writer else None

    def _write(self, step: int, flat) -> str:
        name = f"step_{step:08d}"
        final = os.path.join(self.dir, name)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)

        manifest = {"step": step, "leaves": {}}
        arrays = {}
        for i, (key, dtype_name, stored) in enumerate(flat):
            arrays[f"a{i}"] = stored
            manifest["leaves"][key] = {
                "idx": i, "shape": list(stored.shape), "dtype": dtype_name,
                "crc32": _crc(stored),
            }
        np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
            f.write("ok")
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore

    def all_steps(self) -> list[int]:
        out = []
        for d in sorted(os.listdir(self.dir)):
            if d.startswith("step_") and not d.endswith(".tmp") and \
                    os.path.exists(os.path.join(self.dir, d, "_COMMITTED")):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """Restore into the structure of ``target_tree``: every leaf onto
        the target leaf's device and dtype.  With ``shardings`` (a
        ``train.sharding.Shardings`` shaped like the tree) each rank keeps
        only its block of every leaf on that mesh.  Raises ``IOError`` on a
        crc mismatch and ``KeyError`` for a leaf the checkpoint lacks."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        if shardings is not None:
            from repro_torch.train.sharding import local_slice
            by_id = _specs_by_leaf(target_tree, shardings.specs)

        leaves = manifest["leaves"]
        with np.load(os.path.join(d, "shard_0.npz")) as data:
            def read(key):
                arr = data[f"a{leaves[key]['idx']}"]
                if _crc(arr) != leaves[key]["crc32"]:
                    raise IOError(f"checkpoint corruption at leaf {key}")
                return arr

            def load(key, tgt):
                if key not in leaves:
                    raise KeyError(f"missing leaf {key} in checkpoint")
                t = _from_stored(read(key), leaves[key]["dtype"])
                if shardings is not None:
                    t = local_slice(t, by_id[id(tgt)], shardings.mesh)
                return t.to(device=tgt.device, dtype=tgt.dtype, copy=True)

            out = map_with_path(load, target_tree)
            # every leaf is checked, as the reference checks them, also
            # those the target does not take
            wanted = {k for k, _ in flatten_with_path(target_tree)}
            for key in leaves.keys() - wanted:
                read(key)
        return out
