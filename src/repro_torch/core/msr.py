"""Weight-side Most-Significant-Run (MSR) analysis (port of
``repro.core.msr``).

``tile_plane_bound`` is the exact static per-N-tile plane bound that
``kernels.ops.dslot_prepare`` stores in ``DslotWeights.msr_bound``: 0 for
tiles whose output is provably inert from the weights alone (exactly-zero
columns in every mode; all-non-positive columns under ReLU with unsigned
activations), ``n_bits`` otherwise.  ``msr_depths``/``msr_histogram`` are
profiling only.
"""

from __future__ import annotations

import torch

__all__ = ["msr_depths", "msr_histogram", "quantize_weights",
           "tile_plane_bound"]


def quantize_weights(w: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Symmetric signed ``n_bits`` quantization (profiling only): maps
    ``max|w|`` to ``2^(n_bits-1) - 1``.  Returns int32."""
    qmax = float(2 ** (n_bits - 1) - 1)
    wf = w.to(torch.float32)
    amax = torch.clamp_min(wf.abs().max(), 1e-12)
    return torch.clamp(torch.round(wf / (amax / qmax)),
                       -qmax, qmax).to(torch.int32)


def msr_depths(w_q: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    """Per-weight MSR depth ``n_bits - bitlength(|w_q|)`` (int32)."""
    m = torch.as_tensor(w_q).to(torch.int32).abs()
    shifts = torch.arange(n_bits, dtype=torch.int32, device=m.device)
    shifts = shifts.reshape(shifts.shape + (1,) * m.ndim)
    bitlen = ((m[None] >> shifts) > 0).sum(dim=0, dtype=torch.int32)
    return n_bits - bitlen


def msr_histogram(w: torch.Tensor, n_bits: int = 8) -> dict:
    """MSR depth distribution: ``{"n_bits", "depth_counts", "msr_ge"}``."""
    depths = msr_depths(quantize_weights(w, n_bits), n_bits)
    counts = torch.bincount(depths.reshape(-1).to(torch.int64),
                            minlength=n_bits + 1)
    counts = [int(c) for c in counts.cpu()]
    total = max(1, sum(counts))
    return {
        "n_bits": n_bits,
        "depth_counts": counts,
        "msr_ge": {str(nn): sum(counts[nn:]) / total
                   for nn in (3, 4, 5, 6) if nn <= n_bits},
    }


def tile_plane_bound(w_p: torch.Tensor, block_n: int, *, n_bits: int,
                     relu: bool, signed: bool) -> torch.Tensor:
    """Exact static plane upper bound per N-tile of padded/sorted weights
    ``w_p`` (Kp, Np), ``Np % block_n == 0``.  Returns (Nt,) int32."""
    Kp, Np = w_p.shape
    assert Np % block_n == 0, (Np, block_n)
    tiles = w_p.to(torch.float32).reshape(Kp, Np // block_n, block_n)
    inert = (tiles == 0.0).all(dim=2).all(dim=0)
    if relu and not signed:
        # unsigned activation digits are {0, 1}: an all-non-positive tile
        # accumulates <= 0 and ReLU zeroes it, so bound 0 is output-exact
        inert = inert | (tiles <= 0.0).all(dim=2).all(dim=0)
    return torch.where(inert, 0, n_bits).to(torch.int32)
