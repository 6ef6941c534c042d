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

Re-laying leaves onto a device mesh (the reference's ``shardings``) belongs
to the port's multi-device slice.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, map_with_path

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


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree) -> str:
        """Write ``tree`` as step ``step``; returns the step's directory."""
        return self._write(step, _snapshot(tree))

    def save_async(self, step: int, tree) -> None:
        """Snapshot ``tree`` to host memory now and write it on a thread
        (after any write still in flight)."""
        self.wait()
        flat = _snapshot(tree)
        self._thread = threading.Thread(
            target=self._write, args=(step, flat), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

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

    def restore(self, step: int, target_tree):
        """Restore into the structure of ``target_tree``: every leaf onto
        the target leaf's device and dtype.  Raises ``IOError`` on a crc
        mismatch and ``KeyError`` for a leaf the checkpoint lacks."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)

        with np.load(os.path.join(d, "shard_0.npz")) as data:
            by_key = {}
            for key, meta in manifest["leaves"].items():
                arr = data[f"a{meta['idx']}"]
                if _crc(arr) != meta["crc32"]:
                    raise IOError(f"checkpoint corruption at leaf {key}")
                by_key[key] = (arr, meta["dtype"])

        def load(key, tgt):
            if key not in by_key:
                raise KeyError(f"missing leaf {key} in checkpoint")
            return _from_stored(*by_key[key]).to(
                device=tgt.device, dtype=tgt.dtype, copy=True)

        return map_with_path(load, target_tree)
