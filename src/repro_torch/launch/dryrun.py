"""Multi-pod dry run: trace rank 0's program of every (arch x shape x mesh)
cell on shapes alone (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 placeholder TPU
devices and reads XLA's memory and cost analyses.  The port runs one
process per rank, so a cell here is rank 0's program: a fake
``torch.distributed`` world of 256 (single pod, 16 x 16) or 512 (multi-pod,
2 x 16 x 16) ranks carries the production mesh
(``launch.mesh.make_production_mesh``), and the program runs under
``FakeTensorMode`` on ``device="cpu"``, shapes without data: the zoo's
programs branch on the device only at the DSLOT kernel, which
``launch.op_cost`` takes at its boundary.  For each cell this shows,
without a card,

  * that the port's program runs on the production mesh (every collective
    of ``repro_torch.distributed`` and ``train.sharding`` accepted),
  * a rank's memory: the live storages tracked op by op, each rounded up to
    the 512 bytes the CUDA caching allocator rounds a block to, against the
    80 GB of an H100 (``launch.summarize``),
  * the roofline inputs: ``op_cost``'s FLOPs, bytes and collectives
    (``launch.roofline``).

Rank 0's program, by shape kind: train -- ``init_train_state``, its
``shard_tree`` slice, one ``make_sharded_train_step`` step at
``microbatches_for``'s depth, whose compute is split over ``model``
(heads, ``d_ff``, the vocab, the Mamba2 mixer's heads and the RG-LRU's
width, with parameters gathered over the batch axes only where the split
reads the rank's slice; the layer stacks' parameters gathered group by
group at use, their gradients reduce-scattered into f32 slices; the
record's ``peak_breakdown`` divides a rank's peak into its stored state,
the largest group's gathered parameters, the gathered leaves outside the
stacks and their f32 gradient sum, the stacks' f32 gradient slices, the
largest gathered leaf's gradient on its way to a slice, and the rest,
activations most of it); prefill --
``Model.prefill`` on rank 0's batch slice (``batch_pspec``); decode --
``init_decode_state`` and ``decode_step`` on that slice.  Both run on rank
0's model slice of the parameters (``train.sharding.model_slice``) inside
``pspec.model_shard``, as a serving engine over the mesh does: heads,
``d_ff``, the vocab and the recurrent mixers split over ``model``, the KV
rings along their slots and the recurrent states by head or width where
``model`` divides them.  The record lists the state leaves the port
splits over ``model`` and those the reference's layout
(``decode_state_shardings``) splits that the port keeps whole (a mixer
the axis does not divide), each with its bytes, and apart from both the
bytes of the Mamba2 conv tails' B/C channels, which every rank of a split
mixer holds whole.

Usage:
    python -m repro_torch.launch.dryrun --arch deepseek-67b --shape train_4k \\
        [--multi-pod] [--out build/dryrun]
    python -m repro_torch.launch.dryrun --all [--multi-pod]   # every live cell

``trace_cell`` stands where the reference's ``lower_cell`` and compile
stood: it takes any ``ShapeConfig`` and any mesh (None: one device), so a
measured step can be held against it; ``run_cell`` wraps it for a
registry cell on the production mesh.  One JSON record per cell, with the
reference's keys; ``launch.sweep`` runs each cell in its own process, and
the CLI keeps its fake world to its own process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback
import weakref
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.registry import (cell_is_live, get_arch, get_shape,
                                          live_cells)
from repro_torch.train.sharding import P, _axis_sizes, batch_pspec, mesh_axes
from repro_torch.tree import (flatten_with_path, leaves, map_with_path,
                               tree_map)

__all__ = ["LiveBytes", "TensorSpec", "decode_state_shardings",
           "input_specs", "microbatches_for", "run_cell", "start_world",
           "trace_cell"]

BLOCK = 512                  # the CUDA caching allocator's block rounding


class TensorSpec(NamedTuple):
    """A model input's shape and dtype (the reference's
    ``ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def _fsdp_size(mesh) -> int:
    fsdp, _ = mesh_axes(mesh)
    sizes = _axis_sizes(mesh)
    n = 1
    for a in fsdp:
        n *= sizes[a]
    return n


def microbatches_for(arch: ModelConfig, shape: ShapeConfig, mesh) -> int:
    """Grad-accumulation depth: a per-rank microbatch of about one sample
    bounds the saved activations of the big models (the reference's rule).
    ``mesh`` None is one device."""
    if shape.kind != "train":
        return 1
    n = 1 if mesh is None else _fsdp_size(mesh)
    return max(1, min(shape.global_batch // n, shape.microbatches * 2))


def input_specs(arch: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """Shape and dtype of every model input of this cell (global batch)."""
    S, B = shape.seq_len, shape.global_batch
    F = arch.frontend_len if arch.frontend else 0
    enc_len = arch.frontend_len if arch.family == "encdec" else 0
    d = torch.bfloat16 if arch.dtype == "bfloat16" else torch.float32

    if shape.kind == "train":
        M = microbatches_for(arch, shape, mesh)
        mb = B // M
        batch = {"tokens": TensorSpec((M, mb, S - F), torch.int32),
                 "labels": TensorSpec((M, mb, S - F), torch.int32)}
        if arch.frontend:
            batch["frontend"] = TensorSpec((M, mb, F, arch.d_model), d)
        if arch.family == "encdec":
            batch["src_embeds"] = TensorSpec((M, mb, enc_len, arch.d_model), d)
        return batch

    if shape.kind == "prefill":
        batch = {"tokens": TensorSpec((B, S - F), torch.int32)}
        if arch.frontend:
            batch["frontend"] = TensorSpec((B, F, arch.d_model), d)
        if arch.family == "encdec":
            batch["src_embeds"] = TensorSpec((B, enc_len, arch.d_model), d)
        return batch

    # decode: one new token against a seq_len-deep cache
    return {"tokens": TensorSpec((B, 1), torch.int32)}


def decode_state_shardings(mesh, state):
    """The reference's decode-state layout as plain-data specs: KV caches
    shard the batch over (pod, data) when divisible and the cache sequence
    axis over ``model`` (context parallelism); recurrent states shard their
    feature axis over ``model``.  Leading stack dimensions replicate, and
    every axis must divide its dimension."""
    fsdp, tp = mesh_axes(mesh)
    n_fsdp = _fsdp_size(mesh)
    tp_n = _axis_sizes(mesh)[tp] if tp else 1

    def one(path, leaf):
        field = path.rsplit("/", 1)[-1].lstrip(".")
        nd = leaf.ndim
        if field == "positions" or nd == 0:
            return ()

        def spec_for(core: tuple) -> tuple:
            lead = nd - len(core)
            if lead < 0:
                core = core[-nd:]
                lead = 0
            full = (None,) * lead + core
            out = []
            for i, a in enumerate(full):
                if a is None:
                    out.append(None)
                    continue
                n = n_fsdp if a == fsdp else tp_n
                out.append(a if leaf.shape[i] % n == 0 else None)
            return P(*out)

        b = fsdp if fsdp else None
        if field in ("k", "v"):          # KV cache (B, C, Hkv, hd)
            return spec_for((b, tp, None, None))
        if field == "ssm":               # (B, H, P, N): heads over model
            return spec_for((b, tp, None, None))
        if field == "conv":              # (B, k-1, C): channels over model
            return spec_for((b, None, tp))
        if field == "h":                 # rglru state (B, W)
            return spec_for((b, tp))
        return ()

    return map_with_path(one, state)


# ------------------------------------------------------------ memory

class LiveBytes(TorchDispatchMode):
    """The bytes of live storages, op by op, and their peak: each storage
    an op's outputs hold is counted once, rounded up to ``BLOCK`` bytes,
    from the op until the storage is freed (a finalizer on the storage,
    which outlives its tensors while autograd saves it).  ``add`` counts
    tensors made before the mode was entered."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._held: dict[int, int] = {}

    def add(self, tree) -> None:
        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        key = id(s)
        if key in self._held:
            return
        nbytes = -(-s.nbytes() // BLOCK) * BLOCK
        self._held[key] = nbytes
        self.live += nbytes
        self.peak = max(self.peak, self.live)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._held.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in leaves(out) if isinstance(out, (list, tuple)) else [out]:
            if isinstance(t, torch.Tensor):
                self._hold(t)
        return out


# ------------------------------------------------------------ the program

def _rank_rows(mesh, global_batch: int) -> int:
    """Rows of a batch of ``global_batch`` that one rank holds."""
    if mesh is None or not batch_pspec(mesh, global_batch):
        return global_batch
    return global_batch // _fsdp_size(mesh)


def _model_split(mesh, arch, state) -> dict:
    """The decode-state leaves this rank holds split over ``model`` (those
    of a ``KVShard``, and the recurrent states of a mixer ``pspec.splits``
    splits), and the leaves the reference's layout
    (``decode_state_shardings``) splits over ``model`` that the port keeps
    whole, each list with its bytes on this rank; the B/C channels of a
    split Mamba2 mixer's conv tail, whole on every rank, count in
    ``state_bc_tail_bytes`` and not in the split bytes."""
    from repro_torch.models.attention import KVShard
    from repro_torch.models.pspec import splits
    from repro_torch.models.rglru import RGLRUState
    from repro_torch.models.ssm import SSMState

    out = {"state_split_over_model": [], "state_split_over_model_bytes": 0,
           "state_whole_over_model": [], "state_whole_over_model_bytes": 0,
           "state_bc_tail_bytes": 0}
    if mesh is None:
        return out
    sp = splits(arch, _axis_sizes(mesh).get("model", 1))
    split: set = set()
    bc = 2 * arch.ssm_state                  # a conv tail's B/C channels

    def walk(node):
        if isinstance(node, KVShard) or (isinstance(node, SSMState)
                                         and sp.ssm) or \
                (isinstance(node, RGLRUState) and sp.rglru):
            split.update(id(t) for t in node)
            if isinstance(node, SSMState):
                c = node.conv
                out["state_bc_tail_bytes"] += \
                    math.prod(c.shape[:-1]) * bc * c.element_size()
        elif isinstance(node, dict):
            for v in node.values():
                walk(v)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)

    walk(state)
    specs = []
    tree_map(lambda t, s: specs.append(s), state,
             decode_state_shardings(mesh, state))
    for (path, leaf), spec in zip(flatten_with_path(state), specs):
        key = "state_split_over_model" if id(leaf) in split else \
            "state_whole_over_model" if "model" in spec else None
        if key is not None:
            out[key].append(path)
            out[key + "_bytes"] += leaf.numel() * leaf.element_size()
    out["state_split_over_model_bytes"] -= out["state_bc_tail_bytes"]
    return out


def _batch(specs: dict, lead: tuple) -> dict:
    """Zero tensors of ``specs`` with their leading dimensions ``lead``."""
    return {k: torch.zeros(lead + s.shape[len(lead):], dtype=s.dtype)
            for k, s in specs.items()}


def _batch_bytes(specs: dict, lead: tuple) -> int:
    """The bytes ``LiveBytes`` holds for ``_batch(specs, lead)``."""
    total = 0
    for s in specs.values():
        n = math.prod(lead + s.shape[len(lead):]) * s.dtype.itemsize
        total += -(-n // BLOCK) * BLOCK
    return total


def _train_run(model, mesh, specs: dict, rows: int, M: int) -> dict:
    """One train step of rank 0 at ``M`` microbatches of its ``rows //
    M_cell`` rows each, counted: argument bytes, peak bytes and op_cost
    totals."""
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.sharding import (Shardings, make_state_shardings,
                                            shard_tree)
    from repro_torch.train.step import (init_train_state,
                                        make_sharded_train_step,
                                        make_train_step)

    per = rows // specs["tokens"].shape[0]
    gen = torch.Generator().manual_seed(0)
    mem, cost = LiveBytes(), OpCost()
    if mesh is not None and any(n > 1 for n in _axis_sizes(mesh).values()):
        # the rank's slices: storage the whole state never takes on a rank
        state = init_train_state(model, gen, device="cpu")
        shardings = make_state_shardings(mesh, state)
        state = shard_tree(state, shardings.specs, mesh)
        step = make_sharded_train_step(model, AdamWConfig(),
                                       Shardings(mesh, shardings.specs))
        batch = _batch(specs, (M, per))
        mem.add((state, batch))
        with mem:
            argument = mem.live
            with cost:
                step(state, batch)
        parts = _gathered_bytes(model.cfg, mesh, state.params,
                                shardings.specs.params)
        parts["activations_and_rest"] = mem.peak - argument - sum(
            parts.values())
        parts["stored_state"] = sum(t.numel() * t.element_size()
                                    for t in leaves(state))
        return {"argument": argument, "peak": mem.peak,
                "totals": cost.totals(), "breakdown": parts}
    else:
        # one device: its peak counts init's temporaries too, as a card's
        # peak memory after init_train_state does
        with mem:
            state = init_train_state(model, gen, device="cpu")
            batch = _batch(specs, (M, per))
            argument = mem.live
            step = make_train_step(model, AdamWConfig())
            with cost:
                step(state, batch)
    return {"argument": argument, "peak": mem.peak, "totals": cost.totals()}


def _gathered_bytes(cfg, mesh, params, specs) -> dict:
    """A train step's largest buffers on a rank besides its state and
    activations, bytes each, by the parameters' gather plan
    (``sharding.gather_specs``: a SPLIT leaf of ``sharding.model_reads``
    stays the rank's model slice): ``group_gathered``, the largest layer
    group's leaves gathered at use (one group of a Stack's ``groups``, or
    one rest layer); ``outside_gathered`` and ``outside_grad_f32``, the
    leaves outside the stacks, gathered once, and their gradients' f32 sum;
    ``grad_slices_f32``, the stacks' f32 gradient slices; ``leaf_grad``,
    the largest gathered stack leaf's gradient in its dtype beside its f32
    copy (a group's backward hands each leaf's gradient to its
    reduce-scatter as it is made)."""
    from repro_torch.train.sharding import (gather_specs, model_reads,
                                            stack_plan)

    sizes = _axis_sizes(mesh)
    reads = model_reads(mesh, cfg, params)
    flat = []
    tree_map(lambda *a: flat.append(a), params,
             map_with_path(lambda path, _: path, params),
             stack_plan(mesh, specs, reads, params),
             gather_specs(specs, reads, mesh))
    out = dict.fromkeys(("group_gathered", "outside_gathered",
                         "outside_grad_f32", "grad_slices_f32",
                         "leaf_grad"), 0)
    groups: dict = {}
    for t, path, plan, spec in flat:
        n = t.numel()
        for e in spec:
            for a in (e if isinstance(e, tuple) else (e,)):
                n *= sizes[a] if a is not None else 1
        if plan is None:
            out["outside_gathered"] += n * t.element_size()
            out["outside_grad_f32"] += n * 4
            continue
        out["grad_slices_f32"] += t.numel() * 4
        if plan.stacked:
            n //= t.shape[0]
            group = path.split("/groups/")[0]
        else:
            group = "/".join(path.split("/")[:path.split("/").index(
                "rest") + 2])
        groups[group] = groups.get(group, 0) + n * t.element_size()
        out["leaf_grad"] = max(out["leaf_grad"], n * (t.element_size() + 4))
    out["group_gathered"] = max(groups.values(), default=0)
    return out


def _extrapolate(one: dict, two: dict, M: int) -> dict:
    """Totals at ``M`` microbatches from the counts at 1 and 2: every
    microbatch runs the same ops on the same shapes."""
    out = {}
    for k, a in one.items():
        if isinstance(a, dict):
            out[k] = {j: a[j] + (M - 1) * (two[k][j] - a[j]) for j in a}
        else:
            out[k] = a + (M - 1) * (two[k] - a)
    return out


def trace_cell(arch: ModelConfig, shape: ShapeConfig, mesh=None, *,
               fake: bool = True) -> dict:
    """Rank 0's program of one cell on ``mesh`` (any size; None is the
    one-device program, ``make_train_step`` for training), under
    ``op_cost.OpCost`` and ``LiveBytes``.  ``fake=False`` runs it on real
    CPU tensors instead (a check that the fake trace counts what a run
    does).  A train step of more than 2 microbatches is traced at 1 and 2
    microbatches of the same shape and its counts extrapolated (every
    microbatch runs the same ops; the peak, reached in the second, holds
    from there on).  Returns the record's ``memory``, ``collectives``,
    ``corrected``, ``microbatches`` and timing entries."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import pspec
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.sharding import model_slice

    model = build_model(arch)
    specs = input_specs(arch, shape, mesh)
    rows = _rank_rows(mesh, shape.global_batch)
    extra: dict = {}
    t0 = time.perf_counter()
    with FakeTensorMode() if fake else contextlib.nullcontext():
        if shape.kind == "train":
            M = specs["tokens"].shape[0]
            extra["microbatches"] = M
            if M > 2:
                one, two = (_train_run(model, mesh, specs, rows, m)
                            for m in (1, 2))
                extra["microbatches_traced"] = [1, 2]
                totals = _extrapolate(one["totals"], two["totals"], M)
                per = rows // M
                more = _batch_bytes(specs, (M, per)) \
                    - _batch_bytes(specs, (2, per))
                argument = two["argument"] + more
                peak = two["peak"] + more
                run = two
            else:
                run = _train_run(model, mesh, specs, rows, M)
                totals, argument, peak = (run["totals"], run["argument"],
                                          run["peak"])
            if "breakdown" in run:
                extra["peak_breakdown"] = run["breakdown"]
        else:
            enc_len = arch.frontend_len if arch.family == "encdec" else 0
            params = model.init(torch.Generator().manual_seed(0),
                                device="cpu")
            split = contextlib.nullcontext()
            if mesh is not None and _axis_sizes(mesh).get("model", 1) > 1:
                params = model_slice(mesh, arch, params)
                split = pspec.model_shard(mesh, parts_cut=True)
            batch = _batch(specs, (rows,))
            mem, cost = LiveBytes(), OpCost()
            with split:
                if shape.kind == "decode":
                    state = model.init_decode_state(rows, shape.seq_len,
                                                    enc_len, device="cpu")
                    mem.add((params, batch, state))
                    with mem, cost:
                        argument = mem.live
                        _, state = model.decode_step(params, state,
                                                     batch["tokens"])
                else:
                    mem.add((params, batch))
                    with mem, cost:
                        argument = mem.live
                        _, state = model.prefill(params, batch,
                                                 max_len=shape.seq_len)
            totals, peak = cost.totals(), mem.peak
            extra.update(_model_split(mesh, arch, state))
    seconds = round(time.perf_counter() - t0, 2)
    return {**extra, "lower_s": seconds, "compile_s": seconds,
            "memory": {"argument_size_in_bytes": argument,
                       "temp_size_in_bytes": peak - argument},
            "collectives": {"bytes": totals["coll_bytes"],
                            "counts": totals["coll_counts"],
                            "total_bytes": totals["coll_total_bytes"]},
            "corrected": totals}


# ------------------------------------------------------------ the world

def start_world(n: int) -> None:
    """A fake ``torch.distributed`` world of ``n`` ranks in this process,
    rank 0 (``torch.testing``'s fake process group: collectives keep their
    shapes and move nothing)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             out_dir: str, tag: str = "") -> dict:
    """Trace one registry cell on the production mesh over a fake world of
    256 (512 with ``multi_pod``) ranks and write its record."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import pspec

    arch = get_arch(arch_name)
    shape = get_shape(shape_name)
    ok, why = cell_is_live(arch, shape)
    if not ok:
        raise SystemExit(f"cell skipped by assignment rule: {why}")
    start_world(512 if multi_pod else 256)
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        pspec.set_mesh(mesh)
        try:
            traced = trace_cell(arch, shape, mesh)
        finally:
            pspec.set_mesh(None)
        axes = _axis_sizes(mesh)
    finally:
        dist.destroy_process_group()
    rec = {"arch": arch_name, "shape": shape_name, "multi_pod": multi_pod,
           "mesh": axes, "tag": tag, **traced}
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch_name}__{shape_name}__{'multi' if multi_pod else 'single'}"
    if tag:
        fname += f"__{tag}"
    with open(os.path.join(out_dir, fname + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/dryrun")
    args = ap.parse_args(argv)

    cells = live_cells() if args.all else [(args.arch, args.shape)]
    for arch_name, shape_name in cells:
        try:
            rec = run_cell(arch_name, shape_name, multi_pod=args.multi_pod,
                           out_dir=args.out)
            peak = (rec["memory"]["argument_size_in_bytes"]
                    + rec["memory"]["temp_size_in_bytes"])
            print(f"OK  {arch_name} {shape_name} multi_pod={args.multi_pod} "
                  f"trace={rec['lower_s'] + rec['compile_s']:.1f}s "
                  f"flops={rec['corrected']['dot_flops']:.3e} "
                  f"coll={rec['collectives']['total_bytes'] / 2 ** 20:.1f}"
                  f"MiB peak={peak / 1e9:.2f}GB", flush=True)
            print("  memory:", rec["memory"], flush=True)
        except SystemExit as e:
            print(f"SKIP {arch_name} {shape_name}: {e}")
        except Exception:  # noqa: BLE001 -- reported, the next cell runs
            print(f"FAIL {arch_name} {shape_name}")
            traceback.print_exc()


if __name__ == "__main__":
    main()
