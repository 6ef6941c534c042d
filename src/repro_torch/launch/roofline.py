"""Roofline analysis over the dry-run records (port of
``repro.launch.roofline``).

Per (arch x shape) cell, from rank 0's traced program (``launch.dryrun``):

    compute    = dot_FLOPs / PEAK_FLOPS       (989 TFLOP/s dense bf16)
    memory     = HBM_bytes / HBM_BW           (3.35 TB/s)
    collective = collective_bytes / LINK_BW   (450 GB/s NVLink 4, one way)

All three numerators are a rank's, counted op by op (``launch.op_cost``).
The constants are an NVIDIA H100 SXM 80GB HBM3's data-sheet figures at its
700 W limit; NVLink 4 moves 900 GB/s a card in all, 450 GB/s in each
direction, and a collective's output bytes arrive over one direction.  The
dominant term is the modeled bottleneck; the roofline fraction is
``(MODEL_FLOPS / chips / peak) / dominant``, the share of the peak tensor
rate the step would sustain if it ran exactly at the modeled bottleneck.
MODEL_FLOPS = 6·N·D for training (2·N·D prefill, 2·N·B decode), N_active
for MoE.

    python -m repro_torch.launch.roofline [--dir build/dryrun] [--md out.md]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

PEAK_FLOPS = 989e12          # bf16 dense tensor cores, H100 SXM, 700 W
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s each way, NVLink 4 (900e9 both ways)

_PARAM_CACHE: dict[str, tuple[float, float]] = {}


def param_counts(arch_name: str) -> tuple[float, float]:
    """(N_total, N_active): the parameters ``Model.init`` builds, shapes
    only (under ``FakeTensorMode``); active discounts the experts a token
    is not routed to (``top_k / n_experts`` of every MoE up, gate and down
    leaf), as the reference does."""
    if arch_name in _PARAM_CACHE:
        return _PARAM_CACHE[arch_name]
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model_zoo import build_model
    from repro_torch.tree import flatten_with_path

    cfg = get_arch(arch_name)
    with FakeTensorMode():
        params = build_model(cfg).init(torch.Generator(), device="cpu")
    total = active = 0.0
    for path, leaf in flatten_with_path(params):
        n = float(leaf.numel())
        total += n
        if cfg.n_experts and "moe/" in path and any(
                path.endswith(x) for x in ("up", "gate", "down")):
            active += n * cfg.top_k / cfg.n_experts
        else:
            active += n
    _PARAM_CACHE[arch_name] = (total, active)
    return total, active


def model_flops_per_device(arch_name: str, shape_name: str, chips: int
                           ) -> float:
    from repro_torch.configs.registry import get_shape
    shape = get_shape(shape_name)
    _, n_active = param_counts(arch_name)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / chips
    # decode: one token per sequence per step
    return 2.0 * n_active * shape.global_batch / chips


def analyze_cell(rec: dict, *, peak_flops: float = PEAK_FLOPS,
                 hbm_bw: float = HBM_BW, link_bw: float = LINK_BW,
                 model_flops: float | None = None) -> dict:
    """The three roofline terms of one dry-run record and its bottleneck.
    ``model_flops`` (a rank's useful FLOPs) defaults to
    ``model_flops_per_device`` of the record's registry cell."""
    c = rec["corrected"]
    chips = 1
    for v in rec["mesh"].values():
        chips *= v
    compute_s = c["dot_flops"] / peak_flops
    # compulsory traffic (product operands with per-iteration weight
    # streaming, collectives, scatters); hbm_bytes_upper counts every op's
    # operands and outputs (op_cost.py docstring)
    memory_s = c["hbm_bytes"] / hbm_bw
    coll_s = c["coll_total_bytes"] / link_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops if model_flops is not None else \
        model_flops_per_device(rec["arch"], rec["shape"], chips)
    useful_s = mf / peak_flops
    frac = useful_s / max(terms[dominant], 1e-30)
    peak_gib = (rec["memory"].get("temp_size_in_bytes", 0)
                + rec["memory"].get("argument_size_in_bytes", 0)) / 2 ** 30
    return {
        "arch": rec["arch"], "shape": rec["shape"], "chips": chips,
        "compute_s": compute_s, "memory_s": memory_s,
        "memory_upper_s": c.get("hbm_bytes_upper", 0) / hbm_bw,
        "collective_s": coll_s, "dominant": dominant,
        "model_flops_dev": mf, "hlo_flops_dev": c["dot_flops"],
        "useful_ratio": mf / max(c["dot_flops"], 1e-30),
        "roofline_frac": frac, "peak_gib": peak_gib,
        "tag": rec.get("tag", ""),
    }


def predict_tp_scaling(m: int, k: int, n: int, shards: int, *,
                       n_planes: int = 8, bytes_per_el: int = 4,
                       peak_flops: float = PEAK_FLOPS,
                       hbm_bw: float = HBM_BW,
                       link_bw: float = LINK_BW) -> dict:
    """Roofline-model prediction for one N-sharded digit-serial matmul.

    The DSLOT tensor-parallel layout (``kernels/ops.py``) splits the N axis
    ``shards`` ways: compute and weight traffic divide by ``shards``; the
    activations are replicated, and the collective is the gather of each
    shard's (M, N/s) output slice: each rank receives ``(s-1)/s`` of the
    (M, N) result over the link.  Returns the per-term seconds and the
    predicted speedup against 1 shard (``t1 / ts`` with the same model).
    A model, not a measurement."""
    def terms(s: int) -> float:
        flops = 2.0 * m * k * n * n_planes / 8.0 / s   # plane passes ~ D/8
        compute_s = flops / peak_flops
        mem = (k * n / s + m * k) * bytes_per_el
        memory_s = mem / hbm_bw
        # ring all-gather of the (M, N) output: (s-1) hops of M*N/s bytes
        coll_s = (s - 1) * m * (n / s) * bytes_per_el / link_bw
        return compute_s + memory_s + coll_s
    t1, ts = terms(1), terms(shards)
    return {"shards": shards, "t_model_s": ts,
            "predicted_speedup": t1 / max(ts, 1e-30)}


def suggestion(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_ratio"] < 0.5:
            return ("compute-bound with <50% useful FLOPs: cut remat/causal "
                    "waste (a smarter checkpoint policy, causal blocks "
                    "skipped)")
        return "compute-bound near useful peak: quantize (DSLOT int8 planes)"
    if d == "memory":
        return ("memory-bound: fuse/stream weights (bigger microbatch, "
                "int8 weights, DSLOT planes) to raise arithmetic intensity")
    return ("collective-bound: overlap the gathers with compute (collective "
            "matmul), compress cross-pod gradients, or reshard the dominant "
            "tensor")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="build/dryrun")
    ap.add_argument("--md", default="build/roofline.md")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)

    rows = []
    for f in sorted(glob.glob(os.path.join(args.dir,
                                           f"*__{args.mesh}.json"))):
        with open(f) as fh:
            rec = json.load(fh)
        if rec.get("tag"):
            continue
        rows.append(analyze_cell(rec))
    rows.sort(key=lambda r: (r["arch"], r["shape"]))

    lines = ["| arch | shape | compute s | memory s (upper) | collective s |"
             " bottleneck | MODEL/op | roofline frac | peak GiB |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['compute_s']:.3e} | "
            f"{r['memory_s']:.3e} ({r['memory_upper_s']:.1e}) | "
            f"{r['collective_s']:.3e} | "
            f"**{r['dominant']}** | {r['useful_ratio']:.2f} | "
            f"{r['roofline_frac']:.1%} | {r['peak_gib']:.1f} |")
    out = "\n".join(lines)
    print(out)
    notes = ["", "Per-cell bottleneck notes:"]
    for r in rows:
        notes.append(f"- {r['arch']} x {r['shape']}: {suggestion(r)}")
    out = out + "\n" + "\n".join(notes) + "\n"
    if args.md:
        os.makedirs(os.path.dirname(args.md) or ".", exist_ok=True)
        with open(args.md, "w") as fh:
            fh.write(out)
        print(f"\nwritten to {args.md}")


if __name__ == "__main__":
    main()
