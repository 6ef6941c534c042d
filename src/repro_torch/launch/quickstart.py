"""Quickstart: the DSLOT-NN core in five minutes (port of
``examples/quickstart.py``).

1. multiply two numbers digit-serially (MSDF) and watch the digits converge;
2. run a sum-of-products through a PE with Algorithm-1 early termination;
3. run the GPU adaptation: a digit-plane matmul that skips plane passes on
   provably-negative output tiles.

    python -m repro_torch.launch.quickstart [--device cpu]

Everything runs on ``--device`` (default ``cuda``: the matmul is the CUDA
kernel; ``cpu`` runs its plain version).  Returns the printed numbers as a
dict.
"""

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.core import (early_termination, fixed_to_sd,
                                  online_mult_sp, pe_schedule, pe_sop_digits,
                                  sd_prefix_values)
    from repro_torch.device import resolve_device
    from repro_torch.kernels.ops import dslot_matmul

    dev = resolve_device(args.device)

    # ---- 1. online (MSDF) multiplication: digits arrive MSD first
    xq, wq = 113, -97                               # 8-bit operands
    x_digits = fixed_to_sd(torch.tensor([xq], device=dev), 8)
    z = online_mult_sp(x_digits, torch.tensor(wq / 256.0, device=dev),
                       n_out=16)
    prefixes = (sd_prefix_values(z)[:, 0] * 2.0 ** 16).tolist()
    print("true product:", xq * wq)
    for j in (1, 2, 4, 8, 16):
        print(f"  after {j:2d} digits the prefix is {prefixes[j - 1]:9.1f} "
              f"(sign known: {'yes' if prefixes[j - 1] < 0 else 'not yet'})")

    # ---- 2. a 5x5 PE with early termination (paper Algorithm 1)
    sch = pe_schedule(k=5, p_mult=16)
    print(f"\nPE schedule (paper eq.6): {sch.total_cycles} cycles, "
          f"p_out={sch.p_out}")
    rng = np.random.default_rng(0)
    window = rng.integers(0, 128, size=(25, 4))         # 4 conv windows
    kernel = rng.integers(-127, -16, size=(25,))        # negative-leaning
    sop = pe_sop_digits(
        fixed_to_sd(torch.as_tensor(window, device=dev), 8),
        torch.as_tensor(kernel / 256.0, dtype=torch.float32,
                        device=dev)[:, None], sch)
    rep = early_termination(sop, sch)
    cycles = rep.cycles_used.cpu().numpy()
    savings = rep.savings_frac.cpu().numpy()
    print("cycles used per window:", cycles, f"(full = {rep.cycles_full})")
    print("cycle savings:", [f"{s:.0%}" for s in savings])

    # ---- 3. GPU adaptation: digit-plane matmul with tile termination
    x = torch.as_tensor(np.maximum(rng.normal(0.3, 0.4, (128, 64)), 0),
                        dtype=torch.float32, device=dev)
    w = rng.normal(0, 0.05, (64, 128)).astype(np.float32)
    w[:, ::2] -= 0.08                                   # half the neurons dead
    w = torch.as_tensor(w, device=dev)
    out, stats = dslot_matmul(x, w, sort_columns=True, block_m=32,
                              block_n=32)
    skipped = float(stats.skipped_frac)
    print(f"\ndigit-plane matmul: {skipped:.0%} of digit-plane passes "
          f"skipped (D={stats.n_planes} planes), result == relu(x@w)")
    err = float((out - torch.clamp_min(x @ w, 0)).abs().max())
    print("max err vs dense:", err)
    return dict(prefixes=prefixes, total_cycles=sch.total_cycles,
                p_out=sch.p_out, cycles_used=cycles.tolist(),
                cycles_full=rep.cycles_full, savings=savings.tolist(),
                skipped_frac=skipped, n_planes=stats.n_planes, max_err=err)


if __name__ == "__main__":
    main()
