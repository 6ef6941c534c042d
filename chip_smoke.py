#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, hold its CUDA kernel
against the kernel's plain PyTorch version, and train a model at full
width.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases (any failure exits non-zero and prints no result line):

1. Device and build: the card's name and power limit, then ``nvcc`` builds
   ``src/repro_torch/kernels/csrc/dslot_matmul.cu`` for ``sm_90a``.
2. Kernel vs plain version: the digit-serial matmul at the paper CNN's two
   GEMM shapes (B = 1024 images) and at the DSLOT MLP up-projection of
   seamless-m4t-medium (d_model 1024 -> d_ff 4096, 2048 tokens, block 128,
   sorted columns, block_k auto and 256), with f32 and bf16 weights,
   n_planes 8 and 3, a per-row budget, ReLU on and off, and an all-inert
   weight; the head with row budgets and one N tile of plane bound 0 (the
   split-K product path crosses both); the head at B = 16384 (more tiles
   than SMs, no split); f32 weights of magnitudes 2^-20 to 1 under ReLU
   (which two bf16 parts would not hold); block_n 5 and 24 at the MLP's
   K = 1024; block 256 x 32 at K = 1024 (q rows too long to stage once, so
   they ride with each sub-chunk).  Every case runs the kernel twice and
   the two results must be equal bit for bit.  Dyadic weights (multiples
   of 2^-6) make every sum exact, so there the outputs and ``planes_used``
   must be equal.  On normal weights the outputs must agree within
   ``rtol = 1e-5`` plus ``1e-5 * max|out|``,
   and a tile whose ``planes_used`` differs must have a termination margin
   (max of acc + R at the deciding step, replayed in float64) below
   ``1e-5 * 2^n_bits * max(tot)`` of the tile; such tiles are listed.
3. Main path: ``init_cnn`` (seeded generator) -> ``prepare_cnn`` ->
   ``calibrate_cnn`` -> ``forward_dslot`` on 1024 synthetic MNIST images at
   n_planes 8, 6, 4 and 2.  Each forward must launch the kernel exactly
   twice, the logits must be finite, argmax agreement with the float
   ``forward`` must be >= 0.95 at 8 planes, and 16 images run through the
   kernel must match the plain version on the same prepared state.
4. Times (CUDA events, warm-up excluded): kernel, plain version and
   ``torch.matmul`` of the dequantized product at every phase-2 shape and at
   the two launches of one ``forward_dslot`` (whose exact arguments are also
   held against the plain version), beside the kernel's bound:
   the larger of bytes / 3.35 TB/s and the needed bf16 tensor-core
   products / 989 TFLOP/s, both H100 SXM data-sheet peaks at 700 W.  A
   product with f32 weights needs 3 bf16 products (hi, mid and lo parts of
   each weight: f32 accuracy without TF32), one whose weights are all bf16
   values (a bf16 model's, widened to f32) needs 1.
   Bytes and products count the unpadded shape (not the pad rows of a
   tile): ``planes_used`` products per tile under ReLU
   (the early exit reads every plane's partial sum), one product of the
   truncated q without it.  The earlier yardstick, needed f32 flops / 67
   TFLOP/s on the CUDA cores, is printed beside it.  Times are eager
   (back-to-back calls between CUDA events, so a call that the host issues
   slower than the device runs it is timed at the host's rate); kernel and
   ``torch.matmul`` are also timed from a CUDA graph of 20 calls (device
   time alone) and by their host issue time.  ``forward_dslot`` is timed in
   7 repeats (median, min, max) and traced once with ``torch.profiler``
   for its device time per call.
5. LM serving path: full-width seamless-m4t-medium (12 encoder + 12
   decoder layers, d_model 1024, d_ff 4096, vocab 256206, bf16) with the
   config's own ``DslotConfig(enabled=True)`` (8 bits, block 128 x 128,
   sorted columns, ``block_k`` auto), weights from a seeded generator on the
   card, ``prepare_dslot``, and the launcher's batch: 4 prompts of 16 tokens,
   ``frontend`` (4, 1024, 1024) and ``src_embeds`` (4, 8, 1024).
   ``generate`` of 16 new tokens at ``n_planes`` 8 and per request
   [8, 8, 4, 2] must each launch the kernel exactly 216 times (24 MLPs at
   prefill, 12 per decode step), give tokens in [0, vocab), and the 2-plane
   request must report ``planes_used_mean <= 2``.  One launch of each shape
   (encoder, decoder prefill, decode step) is held against the plain
   version as in phase 2 and timed as in phase 4; a prefill with ``run``
   swapped for the plain version must give logits within ``LM_LOGIT_RTOL``
   of the largest (the reason is at its definition), and the token
   agreement of a whole plain ``generate`` is printed, as is the agreement
   with the dense MLP and the plane statistics per request (random weights:
   not gated).  Times: ``generate`` (median of 5 after a warm-up, tokens/s,
   with the dense MLP beside it), prefill and decode step (median of 5),
   one of each traced with ``torch.profiler`` (device time, idle share, top
   kernels), and peak memory.
6. Serving engine: full-width olmo-1b with a ReLU, non-GLU MLP (16 layers,
   d_model 2048, d_ff 8192, vocab 50304, bf16; random weights from a seeded
   generator on the card) on ``DslotConfig(block_m=16, block_n=128,
   block_k=None)`` with an ``act_scale`` calibrated from one seeded prefill,
   through ``ServeEngine`` with ``ServeConfig(n_slots=16, max_len=512,
   prefill_chunk=64, chunks_per_step=2)`` and the SLO loop (thresholds at
   ``ENGINE_SLO``).  Traffic: 32 requests from a numpy seed (prompts of
   16-256 tokens, 16-32 new tokens, tiers reserved : standard : degradable
   = 1 : 2 : 1), 16 at step 0 and 16 as one burst once those are admitted,
   then ``drain()`` and idle steps until every tier is restored.  Gates:
   every request ``done``; ``audit_engine`` empty after every step; no
   errors, quarantines or timeouts; kernel launches = 16 x (decode forwards
   + admission lane forwards); the kernel equal to its plain version at
   both engine shapes (decode (16, 2048) and admission (128, 2048) @ (2048,
   8192)) with mixed per-row budgets, as in phase 2; at least one shed
   event after the burst; every reserved slot decoded at 8 planes at every
   step; every tier back at its ceiling; the degradable tier's mean
   ``planes_used_mean`` at most the reserved tier's; and every token of a
   reserved stream within ``LM_LOGIT_RTOL`` of the best logit of a forward
   of that stream (reason at ``hold_reserved``), its token agreement with
   solo ``generate`` printed.  Printed: tokens/s, step and forward wall
   medians, device time and idle share of one traced forward of each kind
   (from a warm-up run on 6 of the requests), TTFT per tier, plane
   statistics per tier, SLO events, kernel times as in phase 4, peak memory,
   and the same traffic on the dense MLP (same weights) for its tokens/s.

7. The paper's experiment (``repro_torch.launch.mnist_dslot`` at its full
   setting): ``train_cnn`` on 300 synthetic images (38 a class, 80 held
   out), 20 epochs at lr 2e-2, on the card (timed after a one-epoch
   warm-up) and again on the CPU from the same seeded weights; the trained
   parameters must agree within ``TRAIN_RTOL`` of their largest (reason at
   its definition).  ``dslot_conv2d_stats`` per class on the held-out
   images on the card and on the CPU with the card's weights:
   ``is_negative``, ``term_digit`` and ``cycles_used`` must be equal; the
   per-class negative rate and cycles saved (Figs. 8/9) and the
   simulator's time are printed.  DSLOT against ``sip_conv2d`` on 16
   images: max |diff| must be 0.  ``table1_model()`` is printed, labelled
   as modeled FPGA figures.  Then ``prepare_cnn(block_m=32)`` once,
   ``calibrate_cnn`` on 16 held-out images and ``forward_dslot`` on the 80
   at n_planes 8, 6, 4 and 2 (two launches each, no re-prepare, argmax
   agreement with the float ``forward`` >= 0.95 at 8), and once at
   B = 1024 and 8 planes; every one of these launches is held against the
   plain version as in phase 2 (from its own arguments and results, no
   launch again).  Printed: per-layer ``planes_used_mean``, ``skipped_frac``
   and accuracy, the conv tiles that terminated at B = 1024, the times of
   the conv and head launches at B = 80 and B = 1024 as in phase 4, and the
   B = 1024 forward's median and device time.
8. The rest of the model zoo, each at full published width and depth, bf16,
   seeded weights on the card, one after another with memory freed:
   ``generate`` of 16 new tokens on h2o-danube-3-4b (B = 4 prompts of
   4608, so the prefill ring of its 4096 window wraps), granite-moe-1b-
   a400m (4 x 2048: a prefill of 8192 tokens through two MoE token blocks;
   the share of (token, choice) pairs dropped at prefill is printed and
   none may drop at decode), mamba2-780m (4 x 2048: 8 SSD chunks; one
   layer's ``ssd_chunked`` held against ``ssd_sequential`` on its own
   inputs within ``SSD_RTOL``) and recurrentgemma-2b (4 x 2560: its 2048
   local-attention ring wraps).  Gate (a): every decode step's logits, and
   the prefill's, within ``ZOO_RTOL`` of a train-mode forward of prompt +
   generated tokens at the same position, and within ``ZOO_F32_RTOL`` with
   the weights widened to f32 (MoE at a dropless capacity; reasons at
   ``ZOO_RTOL``).  Gate (b): the model's first 2 layers at full width,
   weights widened to f32, give the same greedy tokens on the card and on
   the CPU (or part only at near-ties, see ``gate_card_vs_cpu``) and
   prefill logits within ``CARD_RTOL``.  Printed per run: tokens/s (median
   of 3), prefill and decode-step ms with one ``torch.profiler`` trace each
   (device time, idle share, top kernels), peak memory.  Then
   recurrentgemma-2b with ReLU, non-GLU MLPs on the kernel through the
   ``ServeEngine`` as phase 6 (``ServeConfig(n_slots=16, max_len=4096,
   prefill_chunk=128, chunks_per_step=2)``, 24 seeded requests with prompts
   of 16-3000 tokens, at least 4 longer than the window, 12 at step 0 and a
   burst of 12 once those are admitted and the tiers have restored, since
   the first wave's long prompts hold them at their floors until then)
   under phase 6's gates, the kernel held against its plain
   version at its decode (16, 2560) and admission (256, 2560) @ (2560,
   7680) shapes and timed as in phase 4.

9. Training (``repro_torch.train``, ``optim``, ``checkpoint``,
   ``data.pipeline``): olmo-1b at full published width and depth (16
   layers, d_model 2048, d_ff 8192, vocab 50304, bf16, remat per group of 2
   layers, ``attn_chunk`` 1024) on ``TokenPipeline`` batches at seq 2048,
   global batch 8, M = 2 (16384 tokens a step), with ``launch/train.py``'s
   AdamW wiring at peak lr 3e-4 for 8 steps: 1 untimed, 6 timed, 1 traced.
   Gates (a)-(c) first, on the model's first 2 layers at full width in f32
   (one remat group a layer), from one seeded state copied to both devices
   by ``convert.train_state``: (a) one step on the card and on the CPU, loss
   and grad_norm within ``TRAIN_LOSS_RTOL``, gradients within
   ``TRAIN_GRAD_REL`` of each leaf's largest, parameters within 1e-3 * lr
   where the CPU's |g| exceeds ``TRAIN_FIRM`` of its leaf's largest and 2 *
   lr everywhere; (b) remat on vs off, gradients within
   ``TRAIN_REMAT_REL``; (c) M = 1 vs M = 4, loss within 1e-4 and parameters
   within 5e-3 (the reference's ``test_train.py`` bounds).  Gate (d): every
   loss and grad_norm finite, every lr equal to ``schedule`` of its count,
   the last timed loss below the first.  Gate (e): ``save_async`` after
   step 3 writes while step 4 runs; after the run, ``restore`` into a fresh
   state (crc checked) gives every leaf bit-equal to the state saved, and
   one step from it gives step 4's loss within ``TRAIN_CKPT_RTOL``; the
   checkpoint directory is deleted.  Printed: loss, grad_norm and lr per
   step, step wall (median, min, max over the 6 timed steps, CUDA events
   beside), tokens/s, the model-FLOPs share (6 N T over the wall x 989
   TFLOP/s, the H100 SXM bf16 dense spec figure), peak memory, the traced
   step's device time, idle share, top kernels and time by kind of kernel,
   and the checkpoint's snapshot ms, write and restore seconds and GB.  The
   training path runs no DSLOT layer, so the kernel record below does not
   change.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel record, and the card's name and power limit are
printed just before that.  The record's ``launches`` counts the kernel
launches of the driven paths (phase 3's CNN, phase 5's two ``generate``
runs, phase 6's timed engine run, phase 7's calibrate, sweep and B = 1024
forward, and phase 8's hybrid engine run); its times and bound are sums
over the thirteen main-path launches timed in phases 4-8 (CNN conv and
head; LM encoder, prefill and decode; engine decode and admission; trained
conv and head at B = 80 and B = 1024; hybrid decode and admission).
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM HBM3, data sheet, 700 W
PEAK_BF16_FLOPS = 989e12     # H100 SXM bf16 tensor cores, dense, data sheet, 700 W
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside tensor cores, data sheet, 700 W
OUT_RTOL = 1e-5
MARGIN_RTOL = 1e-5
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/dslot_matmul.cu"
REPLACES = "src/repro/kernels/dslot_matmul.py:169"


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ------------------------------------------------------------ phase 2

@dataclasses.dataclass(frozen=True)
class Case:
    name: str
    M: int
    K: int
    N: int
    block_m: int
    block_n: int
    block_k: int | None
    relu: bool
    signed: bool
    weights: str            # "dyadic" | "normal" | "inert" | "wide"
    wdtype: torch.dtype = torch.float32
    precision: object = 8   # int or "rows"
    sort: bool = False
    zero_tile: int | None = None    # N tile given plane bound 0


def phase2_cases() -> list[Case]:
    B = 1024
    conv = dict(M=B * 576, K=25, N=8, block_m=128, block_n=8, block_k=None,
                relu=True, signed=False)
    head = dict(M=B, K=1152, N=10, block_m=128, block_n=8, block_k=None,
                relu=False, signed=False)
    mlp = dict(M=2048, K=1024, N=4096, block_m=128, block_n=128,
               relu=True, signed=True, sort=True)
    return [
        Case("conv f32 dyadic n8", weights="dyadic", **conv),
        Case("conv f32 normal n8", weights="normal", **conv),
        Case("conv bf16 normal n3", weights="normal",
             wdtype=torch.bfloat16, precision=3, **conv),
        Case("conv f32 normal rows", weights="normal", precision="rows",
             **conv),
        Case("conv f32 inert n8", weights="inert", **conv),
        Case("head f32 dyadic n8", weights="dyadic", **head),
        Case("head f32 normal n8", weights="normal", **head),
        Case("head bf16 normal n3", weights="normal", wdtype=torch.bfloat16,
             precision=3, **head),
        Case("head f32 normal rows", weights="normal", precision="rows",
             **head),
        Case("mlp bk=auto f32 dyadic n8", weights="dyadic", block_k=None,
             **mlp),
        Case("mlp bk=auto f32 normal n8", weights="normal", block_k=None,
             **mlp),
        Case("mlp bk=auto bf16 normal n3", weights="normal", block_k=None,
             wdtype=torch.bfloat16, precision=3, **mlp),
        Case("mlp bk=256 f32 dyadic n8", weights="dyadic", block_k=256,
             **mlp),
        Case("mlp bk=256 f32 normal n8", weights="normal", block_k=256,
             **mlp),
        Case("mlp bk=256 f32 normal rows", weights="normal", block_k=256,
             precision="rows", **mlp),
        Case("mlp bk=256 f32 normal n8 no-relu", weights="normal",
             block_k=256, **{**mlp, "relu": False}),
        Case("head f32 normal rows bound0", weights="normal",
             precision="rows", zero_tile=1, **head),
        Case("head f32 dyadic rows bound0", weights="dyadic",
             precision="rows", zero_tile=0, **head),
        Case("head B=16384 f32 normal n8", weights="normal",
             **{**head, "M": 16384}),
        Case("conv f32 wide n8", weights="wide", **conv),
        Case("mlp bk=256 f32 wide n8", weights="wide", block_k=256, **mlp),
        Case("mlp bn=5 f32 normal n8", weights="normal",
             **{**mlp, "M": 512, "N": 120, "block_m": 16, "block_n": 5,
                "block_k": None, "sort": False}),
        Case("mlp bn=24 f32 dyadic rows", weights="dyadic",
             precision="rows",
             **{**mlp, "M": 512, "N": 96, "block_m": 32, "block_n": 24,
                "block_k": None, "sort": False}),
        Case("mlp bn=24 bf16 normal n8 bk=256", weights="normal",
             wdtype=torch.bfloat16,
             **{**mlp, "M": 512, "N": 96, "block_m": 32, "block_n": 24,
                "block_k": 256, "sort": False}),
        Case("mlp bm=256 bn=32 f32 dyadic rows", weights="dyadic",
             precision="rows",
             **{**mlp, "M": 512, "N": 128, "block_m": 256, "block_n": 32,
                "block_k": 256, "sort": False}),
    ]


def make_inputs(case: Case, seed: int):
    """Quantized activations and weights for one case, from a seed.

    Unsigned q is uniform over [0, 255]; signed q is a rounded N(20, 40)
    clipped to +-127.  Weights are N(0, K^-1/2) with column n shifted down
    so that its pre-ReLU output sits z_n standard deviations below zero:
    z = 3.3 on every column of a narrow layer (one N tile, so a tile dies
    only when all its columns do) and a ramp from 0 to 6 across a wide
    one, so that some tiles are provably negative under ReLU and the early
    exit fires.  "dyadic" rounds the weights to multiples of 2^-6 in
    [-1, 1]; "inert" makes every weight <= 0 (weight-side plane bound 0);
    "wide" gives each weight a random sign and a magnitude 2^u, u uniform
    in [-20, 0], unshifted.
    """
    g = torch.Generator().manual_seed(seed)
    if case.signed:
        q = (torch.randn((case.M, case.K), generator=g) * 40 + 20).round()
        q = q.clamp(-127, 127).to(torch.int8)
        mean, rms = 20.0, 44.7
    else:
        q = torch.randint(0, 256, (case.M, case.K), generator=g,
                          dtype=torch.uint8)
        mean, rms = 127.5, 147.2
    w = torch.randn((case.K, case.N), generator=g) * case.K ** -0.5
    z = torch.full((case.N,), 3.3) if case.N <= 16 \
        else torch.linspace(0.0, 6.0, case.N)
    if case.weights == "wide":
        u = torch.rand((case.K, case.N), generator=g) * -20.0
        w = torch.sign(w) * torch.exp2(u)
    else:
        w = w - z * rms / (case.K * mean)
    if case.weights == "dyadic":
        w = (w * 64).round().clamp(-64, 64) / 64
    elif case.weights == "inert":
        w = -w.abs()
    return q, w.to(case.wdtype)


def run_case(case: Case, seed: int, dev: torch.device):
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.kernels.ops import dslot_prepare

    q, w = make_inputs(case, seed)
    prep = dslot_prepare(w.to(dev), relu=case.relu, signed=case.signed,
                         sort_columns=case.sort, block_m=case.block_m,
                         block_n=case.block_n, block_k=case.block_k)
    q = dm._pad_to(q.to(dev), prep.block_k, axis=1)
    g = torch.Generator().manual_seed(seed + 1)
    if case.precision == "rows":
        budget = torch.randint(1, 9, (case.M,), generator=g,
                               dtype=torch.int32).to(dev)
        npl = budget.max()
    else:
        budget = None
        npl = torch.tensor(case.precision, dtype=torch.int32, device=dev)
    bound = prep.msr_bound
    if case.zero_tile is not None:
        bound = bound.clone()
        bound[case.zero_tile] = 0
    kw = dict(n_bits=8, relu=case.relu, block_m=case.block_m,
              block_n=case.block_n, block_k=prep.block_k, n_planes_rt=npl,
              row_budget=budget, suffix_colsum=prep.suffix_colsum,
              total_colsum=prep.total_colsum, plane_bound=bound)
    return q, prep, kw


def tile_margin(q, w, sfx, tot, budget, npl, n_bits, bm, bn, bk, i, j,
                plane):
    """Smallest |max_tile(acc + R)| over the chunks of ``plane``, replayed
    in float64 for output tile (i, j): how close the termination decision
    at that plane was to zero."""
    rows = slice(i * bm, (i + 1) * bm)
    cols = slice(j * bn, (j + 1) * bn)
    qi = q[rows].to(torch.int64)
    wf = w[:, cols].to(torch.float64)
    live = torch.full((bm,), float(npl), dtype=torch.float64,
                      device=q.device) if budget is None \
        else budget[rows].to(torch.float64)
    acc = torch.zeros((bm, bn), dtype=torch.float64, device=q.device)
    tail = 2.0 ** (n_bits - int(npl))
    margins = []
    for d in range(plane + 1):
        scale = 2.0 ** (n_bits - 1 - d)
        digit = ((qi.abs() >> (n_bits - 1 - d)) & 1) * torch.sign(qi)
        digit = digit.to(torch.float64) * (live > d).to(torch.float64)[:, None]
        for c in range(q.shape[1] // bk):
            ks = slice(c * bk, (c + 1) * bk)
            acc = acc + scale * (digit[:, ks] @ wf[ks])
            if d == plane:
                rem = scale * sfx[c, cols].double() \
                    + (scale - tail) * tot[cols].double()
                margins.append(float((acc + rem).max()))
    return min((abs(m) for m in margins), default=float("inf"))


def compare(name, a, b, exact, q, w, kw):
    """Hold kernel result ``a`` against plain result ``b``; returns the
    max abs error.  Raises on any disagreement outside the rule."""
    err = float((a.out - b.out).abs().max())
    scale = float(b.out.abs().max())
    if exact:
        if not (torch.equal(a.out, b.out)
                and torch.equal(a.planes_used, b.planes_used)):
            raise AssertionError(f"{name}: dyadic weights must agree "
                                 f"exactly (max err {err})")
        return err
    tol = OUT_RTOL * b.out.abs() + OUT_RTOL * scale
    if not bool(((a.out - b.out).abs() <= tol).all()):
        raise AssertionError(f"{name}: outputs disagree, max err {err}, "
                             f"max |out| {scale}")
    diff = (a.planes_used != b.planes_used).nonzero().tolist()
    tot = kw["total_colsum"][0]
    for i, j in diff[:20]:
        plane = min(int(a.planes_used[i, j]), int(b.planes_used[i, j])) - 1
        bn = kw["block_n"]
        limit = MARGIN_RTOL * 2 ** kw["n_bits"] * float(
            tot[j * bn:(j + 1) * bn].max())
        margin = tile_margin(q, w, kw["suffix_colsum"], tot,
                             kw["row_budget"], kw["n_planes_rt"],
                             kw["n_bits"], kw["block_m"], bn, kw["block_k"],
                             i, j, plane)
        log(f"    tile ({i},{j}): kernel {int(a.planes_used[i, j])} plain "
            f"{int(b.planes_used[i, j])} planes, margin {margin:.3g} "
            f"(limit {limit:.3g})")
        if margin > limit:
            raise AssertionError(f"{name}: tile ({i},{j}) planes_used "
                                 f"differs with margin {margin}")
    if len(diff) > 20:
        raise AssertionError(f"{name}: {len(diff)} tiles differ")
    return err


def kernel_kw(args) -> dict:
    """``compare``'s and ``time_call``'s keywords from ``dm.run``'s
    positional arguments."""
    return dict(n_bits=args[2], relu=args[4], block_m=args[5],
                block_n=args[6], block_k=args[7], suffix_colsum=args[8],
                total_colsum=args[9][None], n_planes_rt=args[10],
                row_budget=args[11], plane_bound=args[12])


class Captured:
    """Stands in for ``dm.run``: runs it and keeps every call's arguments
    and results, so each launch of a driven path can be held against the
    plain version afterwards without launching again."""

    def __init__(self, dm):
        self.dm, self.run, self.calls = dm, dm.run, []

    def __enter__(self):
        self.dm.run = self
        return self

    def __exit__(self, *exc):
        self.dm.run = self.run

    def __call__(self, *args):
        out = self.run(*args)
        self.calls.append((args, out))
        return out


def bound_ms(q, w, kw, used, dims) -> tuple[float, str, float, float]:
    """Least time for the call on an H100 SXM at 700 W: bytes moved once
    over 3.35 TB/s against the bf16 tensor-core flops this run's data needs
    over 989 TFLOP/s (``bf16_parts``: 3 bf16 products per product with
    f32 weights, 1 with weights that bf16 holds exactly).  Returns (bound
    ms, what bounds it, bytes, f32 flops).

    ``dims`` is the unpadded (M, K, N), and both terms count only real
    rows, columns and K: bytes are q (M, K), W (K, N), the f32 out (M, N),
    the termination tables, ``planes_used`` per tile and the M row budgets,
    not the pad rows and columns the wrapper adds for its tiles.  A ReLU
    tile needs its partial sum after every plane it entered (the
    termination check reads it), so it costs ``planes_used`` products of
    its rows and columns; a tile without ReLU needs one product of the
    truncated q, and none when it entered no plane.
    """
    M, K, N = dims
    nbytes = (M * K * q.element_size() + K * N * w.element_size()
              + kw["suffix_colsum"].numel() * 4 + kw["total_colsum"].numel()
              * 4 + M * N * 4 + used.numel() * 4 + 4)
    if kw["plane_bound"] is not None:
        nbytes += kw["plane_bound"].numel() * 4
    if kw["row_budget"] is not None:
        nbytes += M * 4
    bm, bn = kw["block_m"], kw["block_n"]
    Mt, Nt = used.shape
    rows = (M - bm * torch.arange(Mt, dtype=torch.float64)).clamp(0, bm)
    cols = (N - bn * torch.arange(Nt, dtype=torch.float64)).clamp(0, bn)
    per_tile = used.cpu().to(torch.float64)
    if not kw["relu"]:
        per_tile = (per_tile > 0).to(torch.float64)
    flops = 2.0 * K * float((per_tile * rows[:, None] * cols[None, :]).sum())
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = bf16_parts(w) * flops / PEAK_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, flops


def bf16_parts(w) -> int:
    """bf16 tensor-core products this run's weights need per product: 3 for
    f32 weights (hi, mid and lo bf16 parts), 1 where every weight is a bf16
    value (a bf16 model's weights widened to f32), since the digit planes
    are exact in bf16."""
    if w.dtype == torch.float32 and not torch.equal(
            w, w.to(torch.bfloat16).to(torch.float32)):
        return 3
    return 1


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` replayed from a CUDA graph of ``reps``
    calls: the kernel's own time, without the host's launch overhead."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return cuda_ms(graph.replay, reps=5, warm=1) / reps


def host_us(fn, reps: int = 50) -> float:
    """Host time to issue one call of ``fn`` (no synchronization), in us."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e6


def time_call(label, q, w, kw, dims, launch, replay, card):
    """Kernel, plain and torch.matmul times for one call; returns a dict.

    ``ms``, ``plain_ms`` and ``library_ms`` are eager: back-to-back calls
    between two CUDA events, the wrapper's host work included where the
    device outruns it.  ``graph_ms`` and ``library_graph_ms`` replay the
    same calls from a CUDA graph: device time alone, inputs warm in L2."""
    from repro_torch.device import full_f32

    _, used = launch()
    torch.cuda.synchronize()
    k_ms = cuda_ms(launch)
    k_graph = graph_ms(launch)
    p_ms = cuda_ms(replay, reps=3, warm=1)
    qf = q.to(torch.float32)
    wf = w.to(torch.float32)

    def mm():
        return torch.matmul(qf, wf)

    with full_f32():
        lib_ms = cuda_ms(mm)
        lib_graph = graph_ms(mm)
        lib_host = host_us(mm)
    k_host = host_us(launch)
    b_ms, b_by, nbytes, flops = bound_ms(q, w, kw, used, dims)
    parts = bf16_parts(w)
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    old_ms = max(t_bytes, flops / PEAK_F32_FLOPS * 1e3)
    log(f"  {label}: kernel {k_ms:.4f} ms (graph {k_graph:.4f}, host issue "
        f"{k_host:.1f} us), plain {p_ms:.4f} ms, torch.matmul {lib_ms:.4f} "
        f"ms (graph {lib_graph:.4f}, host issue {lib_host:.1f} us), bound "
        f"{b_ms:.4g} ms ({b_by}; {nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} "
        f"GFLOP needed, x{parts} bf16), share of bound "
        f"{b_ms / k_ms:.3g} (graph {b_ms / k_graph:.3g}); f32 CUDA-core "
        f"bound {old_ms:.4g} ms, share {old_ms / k_ms:.3g}; "
        f"kernel/torch.matmul {k_ms / lib_ms:.3g} (graph "
        f"{k_graph / lib_graph:.3g}) [{card}]")
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
            "graph_ms": k_graph, "library_graph_ms": lib_graph,
            "bound_ms": b_ms, "t_bytes": t_bytes,
            "t_ops": parts * flops / PEAK_BF16_FLOPS * 1e3}


def forward_profile(fn, calls: int = 5) -> tuple[float, list] | None:
    """Device kernel time per call of ``fn`` and the kernels that take it,
    from one ``torch.profiler`` trace of ``calls`` calls; None when the
    trace holds no device time."""
    fn()
    torch.cuda.synchronize()
    return traced(lambda: [fn() for _ in range(calls)], calls)[1]


def traced(fn, calls: int = 1):
    """``fn()`` under one ``torch.profiler`` trace: (its result, (device
    kernel time per call, [(ms per call, launches per call, kernel)]) or
    None when the trace holds no device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:    # host ops: not device time
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us / calls / 1e3, e.count // calls, e.key))
    if not rows:
        return out, None
    rows.sort(reverse=True)
    return out, (sum(r[0] for r in rows), rows)


# ------------------------------------------------------------ phase 5

LM_ARCH = "seamless-m4t-medium"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 16, 16
# Prefill logits of the kernel's generate against the plain version's: both
# run the same bf16 model and differ only where the kernel's f32 sums (in
# another order) round an MLP output to another bf16 value, or move a later
# layer's 8-bit activation across a rounding edge; each such flip is one
# bf16 ulp (2^-8 to 2^-7 relative) or one quantization step.  Flips stay
# sparse, so the logits must agree within 2^-4 of their largest magnitude,
# 8 to 16 bf16 ulps there; a wrong tile moves logits by their own size.
LM_LOGIT_RTOL = 2.0 ** -4


def lm_setup(dev):
    """Full-width seamless-m4t-medium with the config's own DSLOT defaults,
    seeded weights drawn on the card, prepared once; the launcher's batch."""
    from repro_torch.configs.base import DslotConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model_zoo import build_model

    cfg = dataclasses.replace(get_arch(LM_ARCH),
                              dslot=DslotConfig(enabled=True))
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    prepared = model.prepare_dslot(params)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {model.param_count(params) / 1e9:.4f} B parameters "
        f"({cfg.dtype}), {cfg.encoder_layers} encoder + {cfg.n_layers} "
        f"decoder layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}; init {t1 - t0:.2f} s, prepare_dslot "
        f"{time.perf_counter() - t1:.2f} s; {cfg.dslot}")
    g = torch.Generator(dev).manual_seed(1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_PROMPT),
                                generator=g, device=dev),
        "frontend": torch.randn((LM_BATCH, cfg.frontend_len, cfg.d_model),
                                generator=g, device=dev) * 0.02,
        "src_embeds": torch.randn((LM_BATCH, 8, cfg.d_model), generator=g,
                                  device=dev) * 0.02}
    dense = build_model(dataclasses.replace(cfg,
                                            dslot=DslotConfig(enabled=False)))
    return cfg, model, params, prepared, dense, batch


def median_ms(fn, reps: int = 5) -> tuple[float, list]:
    """Median wall time of ``fn`` (ending in a synchronize) after one
    warm-up call, with all the times."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2], times


def phase5(card, dev):
    """The LM serving path: ``generate`` on full-width seamless-m4t-medium.
    Returns (kernel launches in the driven runs, max abs error, the three
    kernel shapes' times)."""
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.runtime import precision_scope
    from repro_torch.serve.engine import generate

    cfg, model, params, prep, dense, batch = lm_setup(dev)
    n_layers = cfg.encoder_layers + cfg.n_layers
    expected = n_layers + cfg.n_layers * LM_NEW
    budgets = {"n_planes=8": 8,
               "n_planes=[8,8,4,2]": torch.tensor([8, 8, 4, 2], device=dev)}
    launches = 0
    results = {}
    torch.cuda.reset_peak_memory_stats()
    for label, npl in budgets.items():
        dm.dslot_matmul_cuda.launches = 0
        res = generate(model, prep, batch, LM_NEW, n_planes=npl)
        torch.cuda.synchronize()
        n = dm.dslot_matmul_cuda.launches
        launches += n
        results[label] = res
        if n != expected:
            raise AssertionError(f"generate ({label}) launched the kernel {n} "
                                 f"times, expected {expected}")
        toks = res.tokens
        if toks.shape != (LM_BATCH, LM_NEW) or not bool(
                ((toks >= 0) & (toks < cfg.vocab_size)).all()):
            raise AssertionError(f"{label}: tokens {tuple(toks.shape)} out of "
                                 f"[0, {cfg.vocab_size})")
        log(f"  generate {label}: {n} kernel launches; planes_used_mean "
            f"{[round(float(v), 4) for v in res.planes_used_mean]}, "
            f"skipped_frac {[round(float(v), 4) for v in res.skipped_frac]}, "
            f"planes_bounded_mean {float(res.planes_bounded_mean):.4f}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    low = float(results["n_planes=[8,8,4,2]"].planes_used_mean[3])
    if low > 2.0:
        raise AssertionError(f"the 2-plane request used {low} planes")
    ref = generate(dense, params, batch, LM_NEW)
    for label, res in results.items():
        agree = float((res.tokens == ref.tokens).float().mean())
        log(f"  token agreement {label} vs the dense MLP: {agree:.4f} "
            f"(random weights: not gated)")

    # one launch of each shape, held against the plain version
    calls = []
    orig_run = dm.run
    dm.run = lambda *args: calls.append(args) or orig_run(*args)
    try:
        generate(model, prep, batch, 1, n_planes=8)
    finally:
        dm.run = orig_run
    shapes = (("LM encoder launch", calls[0], LM_BATCH * 8),
              ("LM prefill launch", calls[cfg.encoder_layers],
               LM_BATCH * (cfg.frontend_len + LM_PROMPT)),
              ("LM decode launch", calls[n_layers], LM_BATCH))
    max_err, times = 0.0, []
    for label, args, rows in shapes:
        q, w = args[0], args[1]
        kw = kernel_kw(args)
        a = dm.DslotMatmulOut(*dm._launch(*args))
        b = dm.DslotMatmulOut(*dm._replay(*args))
        torch.cuda.synchronize()
        err = compare(label, a, b, False, q, w, kw)
        max_err = max(max_err, err)
        log(f"  {label}: q {tuple(q.shape)} ({rows} rows), max err "
            f"{err:.3g}, planes_used mean "
            f"{float(a.planes_used.float().mean()):.3f}")
        times.append(time_call(
            label, q, w, kw, (rows, cfg.d_model, cfg.d_ff),
            lambda a=args: dm._launch(*a), lambda a=args: dm._replay(*a),
            card))
    del calls

    # the whole generate on the plain version
    def prefill(m, p):
        with precision_scope(torch.full((LM_BATCH,), 8, dtype=torch.int32,
                                        device=dev)):
            return m.prefill(p, batch)[0]

    kernel_logits = prefill(model, prep)
    dm.run = dm._replay
    try:
        plain_logits = prefill(model, prep)
        plain = generate(model, prep, batch, LM_NEW, n_planes=8)
    finally:
        dm.run = orig_run
    for lg in (kernel_logits, plain_logits):
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError("prefill logits are not finite")
    diff = float((kernel_logits.float() - plain_logits.float()).abs().max())
    scale = float(plain_logits.float().abs().max())
    agree = float((plain.tokens == results["n_planes=8"].tokens)
                  .float().mean())
    log(f"  prefill logits, kernel vs plain version: max |diff| {diff:.4g}, "
        f"max |logit| {scale:.4g} (limit {LM_LOGIT_RTOL * scale:.4g}); "
        f"token streams agree {agree:.4f}")
    if diff > LM_LOGIT_RTOL * scale:
        raise AssertionError(f"prefill logits differ by {diff}")

    # times
    log(f"  times [{card}]")
    npl8 = torch.full((LM_BATCH,), 8, dtype=torch.int32, device=dev)
    gen_ms, gen_all = median_ms(
        lambda: generate(model, prep, batch, LM_NEW, n_planes=npl8))
    dense_ms, _ = median_ms(lambda: generate(dense, params, batch, LM_NEW))
    log(f"  generate B={LM_BATCH} prompt {LM_PROMPT} + {cfg.frontend_len} "
        f"frames, {LM_NEW} new tokens, n_planes 8: median {gen_ms:.2f} ms "
        f"({LM_BATCH * LM_NEW / gen_ms * 1e3:.1f} tokens/s) of "
        f"{[round(t, 2) for t in gen_all]}; dense MLP {dense_ms:.2f} ms "
        f"({LM_BATCH * LM_NEW / dense_ms * 1e3:.1f} tokens/s)")

    def run_prefill():
        with precision_scope(npl8):
            return model.prefill(prep, batch)

    _, state = run_prefill()
    tok = torch.zeros((LM_BATCH, 1), dtype=torch.int32, device=dev)

    def run_decode():
        with precision_scope(npl8):
            return model.decode_step(prep, state, tok)

    pre_ms, _ = median_ms(run_prefill)
    dec_ms, _ = median_ms(run_decode)
    log(f"  prefill {pre_ms:.2f} ms, decode step {dec_ms:.3f} ms "
        f"(median of 5 each)")
    for label, fn, wall in (("prefill", run_prefill, pre_ms),
                            ("decode step", run_decode, dec_ms)):
        prof = forward_profile(fn, calls=1)
        if prof is None:
            log(f"  {label} device time: not measured (the profiler trace "
                f"holds no device time)")
            continue
        dev_ms, rows = prof
        kern = sum(r[0] for r in rows if any(
            k in r[2] for k in ("plane_kernel", "product_kernel",
                                "split_parts_kernel")))
        log(f"  {label} device time (torch.profiler): {dev_ms:.3f} ms, idle "
            f"share {1 - dev_ms / wall:.3f} of the median "
            f"{wall:.3f} ms; dslot kernels {kern:.3f} ms; top kernels:")
        for ms, count, key in rows[:8]:
            log(f"    {ms:.4f} ms x{count} {key[:90]}")
    log(f"  peak memory in the generate runs: {peak_gb:.2f} GB [{card}]")
    return launches, max_err, times


# ------------------------------------------------------------ phase 6

ENGINE_ARCH = "olmo-1b"
ENGINE_SLOTS, ENGINE_MAX_LEN = 16, 512
ENGINE_CHUNK, ENGINE_LANES = 64, 2
ENGINE_REQUESTS = 32            # 16 at step 0, then a burst of 16
# The SLO loop's thresholds (the reference's defaults, stated here): a queue
# deeper than 4 requests, or a rolling p95 TTFT above 8 engine steps, is
# pressure; 2 such steps in a row shed one plane, 4 slack steps in a row
# restore one.  The 16 requests of step 0 and the burst of 16 each queue 4x
# the high-water mark, so both force shedding.
ENGINE_SLO = dict(queue_high_water=4, target_ttft_steps=8, shed_patience=2,
                  restore_patience=4)
ENGINE_IDLE_MAX = 400           # idle steps allowed for the restore
ENGINE_KERNEL_ROWS = {"engine decode launch": ENGINE_SLOTS,
                      "engine admission launch": ENGINE_LANES * ENGINE_CHUNK}


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def engine_traffic(n: int, vocab: int, seed: int = 6) -> list[dict]:
    """``n`` requests from a numpy seed: prompts of 16-256 tokens, 16-32 new
    tokens each, tiers reserved : standard : degradable = 1 : 2 : 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tiers = rng.permutation(["reserved", "standard", "standard",
                             "degradable"] * (n // 4))
    return [dict(uid=i, tier=str(tiers[i]),
                 prompt=rng.integers(0, vocab, int(rng.integers(16, 257)))
                 .astype(np.int32),
                 max_new=int(rng.integers(16, 33))) for i in range(n)]


def calibrated_act_scale(model, params, vocab: int, dev, n_bits: int = 8
                         ) -> float:
    """The MLP's activation step from one seeded prefill of the dense model
    (4 prompts of 256 tokens): ``calibrate_scale`` of every MLP input,
    the largest over the layers (the signed range of the DSLOT MLP)."""
    from repro_torch.kernels.ops import calibrate_scale
    from repro_torch.models import transformer

    scales = []
    apply_mlp = transformer.apply_mlp

    def record(p, x, cfg):
        scales.append(calibrate_scale(x.reshape(-1, x.shape[-1]).float(),
                                      n_bits=n_bits, signed=True))
        return apply_mlp(p, x, cfg)

    g = torch.Generator(dev).manual_seed(5)
    tokens = torch.randint(0, vocab, (4, 256), generator=g, device=dev)
    transformer.apply_mlp = record
    try:
        model.prefill(params, {"tokens": tokens})
    finally:
        transformer.apply_mlp = apply_mlp
    return float(torch.stack(scales).max())


class Timed:
    """Wraps one engine forward: counts its calls, times each (synchronized
    before and after, so a call's wall time is its host issue plus the
    device finishing it) and traces call ``trace_at`` with the profiler."""

    def __init__(self, fn, dev, trace_at: int | None = None):
        self.fn, self.dev, self.trace_at = fn, dev, trace_at
        self.calls, self.walls, self.trace = 0, [], None

    def __call__(self, *args):
        self.calls += 1
        sync(self.dev)
        if self.calls == self.trace_at:
            out, self.trace = traced(lambda: self.fn(*args))
            return out
        t0 = time.perf_counter()
        out = self.fn(*args)
        sync(self.dev)
        self.walls.append((time.perf_counter() - t0) * 1e3)
        return out


def drive_engine(eng, specs: list[dict], dev, n_first: int,
                 idle_max: int = ENGINE_IDLE_MAX,
                 burst_at_ceiling: bool = False) -> dict:
    """The phase's traffic through ``eng``: ``n_first`` requests at step 0,
    the rest as one burst once those have all been admitted (the queue is
    empty) and, with ``burst_at_ceiling``, once every tier is back at its
    ceiling as well, ``drain()``, then idle steps until every tier is back
    at its ceiling.  After every step ``audit_engine`` must be empty and
    every reserved slot must have decoded at ``n_bits``."""
    from repro_torch.serve import RESERVED, Request, audit_engine

    reqs = [Request(uid=s["uid"], prompt=s["prompt"], max_new=s["max_new"],
                    tier=s["tier"]) for s in specs]
    enqueued, step_end, levels, walls = {}, {}, [], []
    step = eng.step

    def checked_step():
        f0, t = eng.pipeline.forwards, time.perf_counter()
        done = step()
        sync(dev)
        step_end[eng.steps] = time.perf_counter()
        walls.append(((step_end[eng.steps] - t) * 1e3,
                      eng.pipeline.forwards > f0))
        problems = audit_engine(eng)
        if problems:
            raise AssertionError(f"step {eng.steps}: {problems}")
        if eng.last_budget is not None:
            for i, r in enumerate(eng.slot_req):
                if r is not None and r.tier == RESERVED \
                        and int(eng.last_budget[i]) != eng.n_bits:
                    raise AssertionError(
                        f"step {eng.steps}: reserved request {r.uid} in slot "
                        f"{i} decoded at {int(eng.last_budget[i])} planes")
        levels.append(dict(eng.slo.levels))
        return done

    def add(batch):
        for r in batch:
            enqueued[r.uid] = time.perf_counter()
            if not eng.try_add(r):
                raise AssertionError(f"request {r.uid} refused")

    ceiling = {n: t.ceiling for n, t in eng.slo.tiers.items()}

    def restore():
        for _ in range(idle_max):
            if eng.slo.levels == ceiling:
                return
            eng.step()

    eng.step = checked_step
    t0 = time.perf_counter()
    add(reqs[:n_first])
    while eng.queue_depth:
        eng.step()
    if burst_at_ceiling:
        restore()
        if eng.slo.levels != ceiling:
            raise AssertionError(f"tiers not restored before the burst: "
                                 f"{eng.slo.levels}")
    burst_step, shed0 = eng.steps, eng.slo.shed_events
    add(reqs[n_first:])
    eng.drain()
    t1 = time.perf_counter()
    run_steps = eng.steps
    restore()
    return dict(reqs=reqs, seconds=t1 - t0, burst_step=burst_step,
                burst_sheds=eng.slo.shed_events - shed0, run_steps=run_steps,
                idle_steps=eng.steps - run_steps, levels=levels,
                enqueued=enqueued, step_end=step_end,
                step_walls=walls[:run_steps],
                tokens=sum(len(r.out) for r in reqs))


def hold_engine_shapes(captured, kernel_rows, cfg, dev, card):
    """The kernel at an engine's shapes (one captured launch each), with
    mixed per-row budgets, held against its plain version by phase 2's rule
    and timed as in phase 4.  Returns (max abs error, the times)."""
    from repro_torch.kernels import dslot_matmul as dm

    g = torch.Generator(dev).manual_seed(7)
    max_err, times = 0.0, []
    for label, rows in kernel_rows.items():
        args = list(captured[rows])
        bud = torch.randint(1, cfg.dslot.n_bits + 1, (rows,), generator=g,
                            device=dev, dtype=torch.int32)
        args[10], args[11] = bud.max(), bud
        q, w = args[0], args[1]
        kw = kernel_kw(args)
        a = dm.DslotMatmulOut(*dm._launch(*args))
        b = dm.DslotMatmulOut(*dm._replay(*args))
        torch.cuda.synchronize()
        err = compare(label, a, b, False, q, w, kw)
        max_err = max(max_err, err)
        log(f"  {label}: q {tuple(q.shape)}, row budgets "
            f"{bud[:8].tolist()}..., max err {err:.3g}, planes_used mean "
            f"{float(a.planes_used.float().mean()):.3f}")
        times.append(time_call(
            label, q, w, kw, (rows, cfg.d_model, cfg.d_ff),
            lambda a=args: dm._launch(*a), lambda a=args: dm._replay(*a),
            card))
    return max_err, times


def log_forward(label, walls, trace, which) -> None:
    """One engine forward's wall times, with the device time, idle share
    and top kernels of its trace (taken at ``which``)."""
    walls = sorted(walls)
    wall = walls[len(walls) // 2]
    line = (f"  {label}: wall median {wall:.2f} ms (min {walls[0]:.2f}, "
            f"max {walls[-1]:.2f}, {len(walls)} calls)")
    if trace is None:
        log(line + "; device time: not measured (the profiler trace holds "
            "no device time)")
        return
    dev_ms, rows = trace
    kern = sum(r[0] for r in rows if any(
        k in r[2] for k in ("plane_kernel", "product_kernel",
                            "split_parts_kernel")))
    log(line + f"; device time (torch.profiler, {which}) {dev_ms:.3f} ms, "
        f"idle share {1 - dev_ms / wall:.3f}; dslot kernels {kern:.3f} ms; "
        f"top kernels:")
    for ms, count, key in rows[:6]:
        log(f"    {ms:.4f} ms x{count} {key[:90]}")


def engine_gates(eng, run: dict) -> None:
    """Phase 6's gates on one DSLOT engine run (see ``phase6``)."""
    reqs = run["reqs"]
    bad = [(r.uid, r.phase) for r in reqs if r.phase != "done"]
    if bad:
        raise AssertionError(f"requests not done: {bad}")
    if eng.errors or eng.quarantined or eng.timeouts:
        raise AssertionError(f"errors {eng.errors}, quarantined "
                             f"{eng.quarantined}, timeouts {eng.timeouts}")
    if run["burst_sheds"] < 1:
        raise AssertionError("the burst shed no plane")
    ceiling = {n: t.ceiling for n, t in eng.slo.tiers.items()}
    if eng.slo.levels != ceiling:
        raise AssertionError(f"tiers not restored after "
                             f"{run['idle_steps']} idle steps: "
                             f"{eng.slo.levels}")
    mean = tier_means(reqs, "planes_used_mean")
    if mean["degradable"] > mean["reserved"]:
        raise AssertionError(f"degradable used {mean['degradable']} planes, "
                             f"reserved {mean['reserved']}")


def pct(xs: list, p: float):
    """The ``p`` quantile of sorted ``xs`` (the SLO controller's rule)."""
    return xs[min(len(xs) - 1, int(p * (len(xs) - 1) + 0.5))]


def tier_means(reqs, key: str) -> dict:
    out = {}
    for tier in ("reserved", "standard", "degradable"):
        vals = [float(getattr(r.result, key)) for r in reqs
                if r.tier == tier and getattr(r.result, key) is not None]
        out[tier] = sum(vals) / len(vals) if vals else float("nan")
    return out


# Reserved streams of the engine against solo ``generate`` of the same
# request: both run the same bf16 model at 8 planes, but the engine's
# products have other shapes (64-token chunks in a 2-lane batch, a 16-row
# decode) than solo's (the whole prompt, one row), so cuBLAS and the
# attention sums add in other orders and a bf16 output or an 8-bit
# activation can round the other way — the effects phase 5 bounds with
# LM_LOGIT_RTOL.  Where such noise meets a near-tie of the two best logits,
# greedy streams part and then differ for good, so the token agreement is
# reported and the gate is on logits.  Each reserved request's prompt and
# output go through one forward of the model (8 planes, the calibrated
# scale, so in exact arithmetic the same function as the engine's chunks and
# decode steps): at every position, the token the engine emitted must be
# within LM_LOGIT_RTOL of the largest logit.  Where the stream parts from
# solo's, that is the near-tie rule.  A wrong ring row or another slot's
# budget moves logits by their own size.
def hold_reserved(model, params, reqs, dev, n_bits: int) -> dict:
    import numpy as np

    from repro_torch.runtime import precision_scope
    from repro_torch.serve.engine import generate

    agree, parted, worst = [], [], (0.0, None)
    for r in reqs:
        if r.tier != "reserved":
            continue
        solo = generate(model, params, {"tokens": torch.as_tensor(
            r.prompt[None]).to(dev)}, r.max_new, n_planes=n_bits)
        same = [a == b for a, b in zip(r.out, solo.tokens[0].tolist())]
        agree.append(sum(same) / len(same))
        if not all(same):
            parted.append((r.uid, same.index(False)))
        ctx = np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
        with precision_scope(n_bits):
            logits, _, _ = model.forward(params, {"tokens": torch.as_tensor(
                ctx[None]).to(dev)})
        lg = logits[0, len(r.prompt) - 1:].float()        # row k -> out[k]
        out = torch.as_tensor(r.out, device=dev)[:, None]
        ratio = (lg.max(dim=-1).values - lg.gather(1, out)[:, 0]) \
            / lg.abs().max(dim=-1).values
        k = int(ratio.argmax())
        if float(ratio[k]) >= worst[0]:
            worst = (float(ratio[k]), (r.uid, k))
    if worst[0] > LM_LOGIT_RTOL:
        raise AssertionError(
            f"reserved request {worst[1][0]}, token {worst[1][1]}: "
            f"{worst[0]:.4g} of the largest logit below the best token "
            f"(limit {LM_LOGIT_RTOL})")
    return dict(agreement=sum(agree) / len(agree), per_request=agree,
                parted=parted, worst=worst)


def phase6(card, dev):
    """The slot-pool engine at full width: olmo-1b with ReLU MLPs on the
    kernel.  Returns (kernel launches of the driven run, max abs error, the
    two kernel shapes' times)."""
    from repro_torch.configs.base import DslotConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeConfig, ServeEngine, SloConfig

    base = dataclasses.replace(get_arch(ENGINE_ARCH), act="relu", glu=False)
    dense = build_model(base)
    t0 = time.perf_counter()
    params = dense.init(torch.Generator(dev).manual_seed(0), device=dev)
    sync(dev)
    scale = calibrated_act_scale(dense, params, base.vocab_size, dev)
    cfg = dataclasses.replace(base, dslot=DslotConfig(
        enabled=True, block_m=ENGINE_SLOTS, block_n=128, block_k=None,
        act_scale=scale))
    model = build_model(cfg)
    scfg = ServeConfig(n_slots=ENGINE_SLOTS, max_len=ENGINE_MAX_LEN,
                       prefill_chunk=ENGINE_CHUNK,
                       chunks_per_step=ENGINE_LANES,
                       slo=SloConfig(**ENGINE_SLO))
    specs = engine_traffic(ENGINE_REQUESTS, cfg.vocab_size)
    # warm-up: 6 of the requests on an engine of their own, whose forwards
    # are traced (the pool is always 16 rows and the lanes 2 x 64, so the
    # shapes are the timed run's); the timed run below is not traced
    warm = ServeEngine(model, params, scfg)
    warm._decode = Timed(warm._decode, dev, trace_at=3)
    warm.pipeline._extend_lanes = Timed(warm.pipeline._extend_lanes, dev,
                                        trace_at=3)
    drive_engine(warm, specs[:6], dev, n_first=6, idle_max=0)
    traces = {"decode forward": warm._decode.trace,
              "admission forward": warm.pipeline._extend_lanes.trace}
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    eng = ServeEngine(model, params, scfg)
    sync(dev)
    log(f"  {cfg.name} with a ReLU MLP (act relu, no GLU): "
        f"{model.param_count(params) / 1e9:.4f} B parameters ({cfg.dtype}), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}; init + calibration {t1 - t0:.2f} s, "
        f"engine (prepare_dslot) {time.perf_counter() - t1:.2f} s; "
        f"calibrated act_scale {scale!r}; {cfg.dslot}; {scfg}")
    eng._decode = Timed(eng._decode, dev)
    eng.pipeline._extend_lanes = Timed(eng.pipeline._extend_lanes, dev)
    captured = {}
    orig_run = dm.run

    def capture(*args):
        rows = args[0].shape[0]
        if rows in ENGINE_KERNEL_ROWS.values() and rows not in captured:
            captured[rows] = args
        return orig_run(*args)

    dm.dslot_matmul_cuda.launches = 0
    dm.run = capture
    try:
        run = drive_engine(eng, specs, dev, n_first=ENGINE_SLOTS)
    finally:
        dm.run = orig_run
    launches = dm.dslot_matmul_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decodes, lanes = eng._decode.calls, eng.pipeline._extend_lanes.calls
    expected = cfg.n_layers * (decodes + eng.pipeline.forwards)
    log(f"  {ENGINE_REQUESTS} requests ({ENGINE_SLOTS} at step 0, a burst of "
        f"{ENGINE_REQUESTS - ENGINE_SLOTS} at step {run['burst_step']}): "
        f"{run['run_steps']} steps to drain, {run['idle_steps']} idle steps "
        f"to restore; {decodes} decode forwards, {lanes} admission lane "
        f"forwards; {launches} kernel launches (expected {expected})")
    if launches != expected or lanes != eng.pipeline.forwards:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{expected}")
    engine_gates(eng, run)

    max_err, times = hold_engine_shapes(captured, ENGINE_KERNEL_ROWS, cfg,
                                        dev, card)
    del captured

    held = hold_reserved(model, eng.params, run["reqs"], dev,
                         cfg.dslot.n_bits)
    log(f"  reserved streams vs solo generate: token agreement "
        f"{held['agreement']:.4f} (per request "
        f"{[round(a, 4) for a in held['per_request']]}; parted at (uid, "
        f"token) {held['parted']}); emitted tokens below the best logit of "
        f"a forward of the stream by at most {held['worst'][0]:.4g} of the "
        f"largest (uid, token {held['worst'][1]}; limit {LM_LOGIT_RTOL})")

    # what it reads
    log(f"  times [{card}]")
    log(f"  engine: {run['tokens']} tokens in {run['seconds']:.2f} s, "
        f"{run['tokens'] / run['seconds']:.1f} tokens/s")
    for label, adm in (("decode-only steps", False),
                       ("steps with admission", True)):
        walls = sorted(w for w, a in run["step_walls"] if a == adm)
        log(f"  engine step wall, {label}: median {pct(walls, 0.5):.2f} ms "
            f"(min {walls[0]:.2f}, max {walls[-1]:.2f}, {len(walls)} steps)")
    for label, timed in (("decode forward", eng._decode),
                         ("admission forward", eng.pipeline._extend_lanes)):
        log_forward(label, timed.walls, traces[label],
                    "the warm-up's third call")
    for tier in ("reserved", "standard", "degradable"):
        rs = [r for r in run["reqs"] if r.tier == tier]
        steps = sorted(r.ttft_steps for r in rs)
        ms = sorted((run["step_end"][r.first_token_step]
                     - run["enqueued"][r.uid]) * 1e3 for r in rs)
        log(f"  {tier} ({len(rs)} requests): TTFT p50 {pct(steps, 0.5)} / "
            f"p95 {pct(steps, 0.95)} steps, {pct(ms, 0.5):.1f} / "
            f"{pct(ms, 0.95):.1f} ms; planes_used_mean "
            f"{tier_means(rs, 'planes_used_mean')[tier]:.4f}, skipped_frac "
            f"{tier_means(rs, 'skipped_frac')[tier]:.4f}")
    lv = run["levels"]
    log(f"  SLO: {eng.slo.shed_events} shed events ({run['burst_sheds']} "
        f"after the burst), {eng.slo.restore_events} restore events, min "
        f"levels {eng.slo.min_levels}; levels every 8 steps "
        f"{[tuple(v.values()) for v in lv[::8]]}")
    log(f"  peak memory: {peak_gb:.2f} GB [{card}]")

    del eng
    torch.cuda.empty_cache()
    plain_eng = ServeEngine(dense, params, scfg)
    plain = drive_engine(plain_eng, specs, dev, n_first=ENGINE_SLOTS)
    if any(r.phase != "done" for r in plain["reqs"]):
        raise AssertionError("dense-MLP engine left requests unfinished")
    same = [a.out == b.out for a, b in zip(run["reqs"], plain["reqs"])]
    log(f"  same run, dense MLP on the same weights: {plain['tokens']} "
        f"tokens in {plain['seconds']:.2f} s, "
        f"{plain['tokens'] / plain['seconds']:.1f} tokens/s; streams equal "
        f"to the DSLOT engine's: {sum(same)} of {len(same)} (random "
        f"weights: not gated)")
    return launches, max_err, times


# ------------------------------------------------------------ phase 7

MNIST_PER_CLASS = 30 + 8        # the example's default, with 8 held out
MNIST_EPOCHS, MNIST_LR, MNIST_EVAL = 20, 2e-2, 80
MNIST_PLANES = (8, 6, 4, 2)
# Trained parameters on the card against the same training on the CPU: both
# run the same f32 SGD (cuDNN and the CPU's convolutions in full f32) from
# the same seeded weights and differ only in summation order, which SGD
# carries forward.  Over this run's 80 steps two f32 orders drift apart by
# 7.8e-6 of the largest parameter (the port on the CPU against the JAX
# reference) and 2.8e-5 (an H100's cuDNN against the CPU); the gate allows
# 2^-12 (2.4e-4).  One wrong gradient or update moves the parameters by a
# step's size, about 1e-2.
TRAIN_RTOL = 2.0 ** -12


def train_gate(dev):
    """Phase 7.1: ``train_cnn`` on the card and on the CPU from the same
    seeded weights.  Returns the card's params and accuracy, and the
    held-out images and labels."""
    from repro_torch.configs.dslot_mnist import CONFIG
    from repro_torch.core.mnist_cnn import train_cnn
    from repro_torch.data.mnist import synth_mnist

    imgs, labels = synth_mnist(MNIST_PER_CLASS, seed=0)
    tx, ty = imgs[:-MNIST_EVAL], labels[:-MNIST_EVAL]
    kw = dict(epochs=MNIST_EPOCHS, lr=MNIST_LR)
    train_cnn(CONFIG, tx[:128], ty[:128], epochs=1, device=dev)   # warm-up
    sync(dev)
    t0 = time.perf_counter()
    params, acc = train_cnn(CONFIG, tx, ty, device=dev, **kw)
    sync(dev)
    t1 = time.perf_counter()
    cpu, cpu_acc = train_cnn(CONFIG, tx, ty, device="cpu", **kw)
    t2 = time.perf_counter()
    steps = MNIST_EPOCHS * (len(tx) // 64)
    errs = {}
    for name, a, b in zip(("conv", "dense"), params, cpu):
        errs[name] = (float((a.cpu() - b).abs().max()), float(b.abs().max()))
    log(f"  train_cnn: {len(tx)} images, {MNIST_EPOCHS} epochs, {steps} SGD "
        f"steps at lr {MNIST_LR}: card {(t1 - t0) * 1e3:.1f} ms "
        f"(accuracy {acc:.4f}), CPU {(t2 - t1) * 1e3:.1f} ms (accuracy "
        f"{cpu_acc:.4f}); card vs CPU max |diff| "
        + ", ".join(f"{n} {e:.3g} of max {m:.4f}" for n, (e, m) in
                    errs.items()) + f" (limit {TRAIN_RTOL:.3g} of max)")
    for name, (err, mx) in errs.items():
        if err > TRAIN_RTOL * mx:
            raise AssertionError(f"trained {name} on the card differs from "
                                 f"the CPU's by {err} (max {mx})")
    return params, acc, imgs[-MNIST_EVAL:], labels[-MNIST_EVAL:]


def simulator_gate(params, held, held_labels, dev) -> float:
    """Phases 7.2-7.4: per-class Algorithm-1 statistics on the card against
    the CPU, DSLOT against SIP, and the modeled Table I.  Returns the mean
    cycles-saved fraction over the classes."""
    from repro_torch.core import dslot_conv2d_stats, sip_conv2d, table1_model

    xe = torch.as_tensor(held).to(dev)
    w_cpu = params.conv.cpu()
    card_s = cpu_s = 0.0
    rates, saved = [], []
    log("  class  neg-rate  cycles-saved  SOPs   (paper Fig. 8 / Fig. 9)")
    for d in range(10):
        sel = held_labels == d
        sync(dev)
        t0 = time.perf_counter()
        res = dslot_conv2d_stats(xe[torch.as_tensor(sel).to(dev)],
                                 params.conv)
        sync(dev)
        t1 = time.perf_counter()
        ref = dslot_conv2d_stats(torch.as_tensor(held[sel]), w_cpu)
        cpu_s += time.perf_counter() - t1
        card_s += t1 - t0
        for field in ("is_negative", "term_digit", "cycles_used"):
            if not torch.equal(getattr(res.report, field).cpu(),
                               getattr(ref.report, field)):
                raise AssertionError(f"class {d}: {field} on the card "
                                     f"differs from the CPU's")
        rates.append(float(res.report.negative_rate))
        saved.append(float(res.report.mean_savings))
        log(f"    {d}     {rates[-1]:.4f}    {saved[-1]:.4f}      "
            f"{res.report.is_negative.numel()}")
    mean_saved = sum(saved) / len(saved)
    log(f"  mean negative rate {sum(rates) / len(rates):.4f} (paper: "
        f"~0.125), mean cycles saved {mean_saved:.4f}; is_negative, "
        f"term_digit and cycles_used equal to the CPU's for every class; "
        f"simulator time, 10 classes: card {card_s * 1e3:.1f} ms, CPU "
        f"{cpu_s * 1e3:.1f} ms")

    res = dslot_conv2d_stats(xe[:16], params.conv)
    diff = float((res.y_conv - sip_conv2d(xe[:16], params.conv)).abs().max())
    log(f"  DSLOT vs SIP on 16 images: max |diff| {diff} (must be 0)")
    if diff != 0.0:
        raise AssertionError(f"DSLOT differs from SIP by {diff}")

    label = ("modeled Virtex-7 FPGA figures from the paper's eqs. 8-11 and "
             "Table I's power (not measured; not card numbers)")
    m = table1_model()
    engines = list(m.values()) + [
        m["dslot"].with_early_termination(mean_saved)]
    for e in engines:
        log(f"  Table I, {label}: {e.name}: CPD {e.cpd_ns:.3f} ns, "
            f"{e.dynamic_power_mw} mW, {e.luts} LUTs, II "
            f"{e.init_interval_cycles:.3f} cycles, {e.gops:.4f} GOPS, "
            f"{e.gops_per_watt:.2f} GOPS/W, "
            f"{e.energy_per_window_nj():.4f} nJ per window")
    return mean_saved


def phase7(card, dev):
    """The paper's experiment on the card: train the CNN, the simulators,
    then the trained weights through the kernel.  Returns (kernel launches
    of the driven path, max abs error, the four launches' times)."""
    from repro_torch.configs.dslot_mnist import CONFIG
    from repro_torch.core import mnist_cnn
    from repro_torch.data.mnist import synth_mnist
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.kernels import ops

    params, train_acc, held, held_labels = train_gate(dev)
    simulator_gate(params, held, held_labels, dev)

    # 7.5: trained weights through the kernel, prepared once
    xe = torch.as_tensor(held).to(dev)
    ey = torch.as_tensor(held_labels).to(dev)
    images_np, _ = synth_mnist(103, seed=0)
    images = torch.as_tensor(images_np[:1024]).to(dev)
    ref = mnist_cnn.forward(params, xe, CONFIG)
    dm.dslot_matmul_cuda.launches = 0
    n0 = ops.prepare_call_count()
    with Captured(dm) as cap:
        prep = mnist_cnn.calibrate_cnn(
            mnist_cnn.prepare_cnn(params, CONFIG, block_m=32), xe[:16],
            CONFIG)
        n_prep = ops.prepare_call_count() - n0
        agreement = {}
        for npl in MNIST_PLANES:
            k0 = dm.dslot_matmul_cuda.launches
            res = mnist_cnn.forward_dslot(prep, xe, CONFIG, n_planes=npl)
            sync(dev)
            if dm.dslot_matmul_cuda.launches - k0 != 2:
                raise AssertionError(f"forward_dslot launched "
                                     f"{dm.dslot_matmul_cuda.launches - k0} "
                                     f"times, expected 2")
            pred = res.logits.argmax(-1)
            agreement[npl] = float((pred == ref.argmax(-1)).float().mean())
            log(f"  B={MNIST_EVAL} n_planes {npl}: accuracy "
                f"{float((pred == ey).float().mean()):.4f}, argmax agreement "
                f"{agreement[npl]:.4f}; " + "; ".join(
                    f"{k} planes_used_mean "
                    f"{float(v.planes_used.float().mean()):.4f} skipped_frac "
                    f"{float(v.skipped_frac):.4f}"
                    for k, v in res.layer_stats.items()))
        big = mnist_cnn.forward_dslot(prep, images, CONFIG, n_planes=8)
        sync(dev)
    launches = dm.dslot_matmul_cuda.launches
    if ops.prepare_call_count() - n0 != n_prep:
        raise AssertionError("the precision sweep re-prepared the weights")
    if len(cap.calls) != 1 + 2 * len(MNIST_PLANES) + 2:
        raise AssertionError(f"{len(cap.calls)} kernel calls captured")
    log(f"  kernel launches on the path: {launches} (calibrate 1, 2 per "
        f"forward_dslot: {len(MNIST_PLANES)} at B={MNIST_EVAL}, 1 at "
        f"B=1024); prepares {n_prep}, none in the sweep")
    if agreement[8] < 0.95:
        raise AssertionError(f"argmax agreement {agreement[8]} < 0.95")

    max_err = 0.0
    for i, (args, out) in enumerate(cap.calls):
        kw = kernel_kw(args)
        a = dm.DslotMatmulOut(*out)
        b = dm.DslotMatmulOut(*dm._replay(*args))
        sync(dev)
        max_err = max(max_err, compare(f"phase 7 launch {i}", a, b, False,
                                       args[0], args[1], kw))
    log(f"  every launch held against the plain version: max err "
        f"{max_err:.3g}")

    # 7.6: the two shapes of the sweep at 8 planes and phase 3's B = 1024
    st = big.layer_stats["conv1"].planes_used
    log(f"  B=1024 n_planes 8: conv tiles terminated {int((st < 8).sum())} "
        f"of {st.numel()} (planes_used mean {float(st.float().mean()):.4f})")
    shapes = (("trained conv launch B=80", cap.calls[1], MNIST_EVAL),
              ("trained head launch B=80", cap.calls[2], MNIST_EVAL),
              ("trained conv launch B=1024", cap.calls[-2], 1024),
              ("trained head launch B=1024", cap.calls[-1], 1024))
    side = CONFIG.image_size - CONFIG.kernel_size + 1
    dims = {"conv": lambda b: (b * side * side, prep.conv_params["dslot"]
                               .d_in, prep.conv_params["dslot"].d_out),
            "head": lambda b: (b, prep.head_params["dslot"].d_in,
                               prep.head_params["dslot"].d_out)}
    times = []
    for label, (args, out), b in shapes:
        log(f"  {label}: planes_used mean "
            f"{float(out[1].float().mean()):.4f} over {out[1].numel()} tiles")
        times.append(time_call(
            label, args[0], args[1], kernel_kw(args),
            dims[label.split()[1]](b), lambda a=args: dm._launch(*a),
            lambda a=args: dm._replay(*a), card))
    del cap

    def fwd():
        return mnist_cnn.forward_dslot(prep, images, CONFIG, n_planes=8)

    fwd_all = sorted(cuda_ms(fwd) for _ in range(7))
    fwd_ms = fwd_all[len(fwd_all) // 2]
    log(f"  trained forward_dslot B=1024 n_planes=8: median {fwd_ms:.4f} ms, "
        f"min {fwd_all[0]:.4f}, max {fwd_all[-1]:.4f} over 7 repeats of 10 "
        f"calls [{card}]")
    prof = forward_profile(fwd)
    if prof is None:
        log("  trained forward_dslot device time: not measured (the "
            "profiler trace holds no device time)")
    else:
        dev_ms, rows = prof
        log(f"  trained forward_dslot device time (torch.profiler, 5 "
            f"calls): {dev_ms:.4f} ms per call, idle share "
            f"{1 - dev_ms / fwd_ms:.3f} of the median")
    return launches, max_err, times


# ------------------------------------------------------------ phase 8

# (arch, rows, prompt tokens): each prompt is long enough for its model's
# own path: h2o-danube's 4608 wrap its 4096-slot window ring at prefill,
# granite-moe's 4 x 2048 = 8192 prefill tokens take the two-block MoE path,
# mamba2's 2048 make 8 SSD chunks of 256, recurrentgemma's 2560 wrap its
# 2048-slot local-attention ring.
ZOO_RUNS = (("h2o-danube-3-4b", 4, 4608), ("granite-moe-1b-a400m", 4, 2048),
            ("mamba2-780m", 4, 2048), ("recurrentgemma-2b", 4, 2560))
ZOO_NEW = 16
ZOO_SMALL = (2, 256, 8)     # gate (b): rows, prompt, new tokens at 2 layers
# Gate (a) holds each decode step's logits, and the prefill's, against a
# train-mode forward of prompt + generated tokens at the same position; for
# MoE at a dropless capacity (at the published 1.25 the seeded router drops
# a quarter of the (token, choice) pairs at prefill, and a dropped choice is
# by design a different function from the dropless decode).  It runs twice.
# In the model's bf16 the two sides round apart now and then and the flips
# spread through the layers: a 48-layer mamba2 prompt of 512 tokens on the
# CPU gives 0.045 of the largest logit in bf16 and 1.2e-5 in f32 on the same
# weights, and phase 8's first card run measured 0.019-0.076 over the four
# models; the bound is 2^-3.  The same weights widened to f32 leave only
# the order of f32 sums: within ``ZOO_F32_RTOL``.  A wrong ring slot, a lost
# recurrent state or a dropped MoE choice moves logits by their own size.
ZOO_RTOL = 2.0 ** -3
ZOO_F32_RTOL = 1e-3
# Gate (b): the model's first 2 layers (weights widened to f32) on the card
# and on the CPU, the CPU parity tests' bound.  In bf16 the copies part by
# rounding as above, and granite-moe's router then moves choices across its
# top-8 and capacity edges (0.109 of the largest logit in the first card
# run), so the device comparison is made where only summation order differs.
CARD_RTOL = 1e-4
# The SSD chunked form against its sequential recurrence on one layer's own
# inputs at full width, both f32: the reference's tests hold the two to
# about 1e-4; here within 1e-4 of the largest output.
SSD_RTOL = 1e-4
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_SLOTS, HYBRID_MAX_LEN = 16, 4096
HYBRID_CHUNK, HYBRID_LANES = 128, 2
# 12 at step 0, a burst of 12 once the tiers are back at their ceilings
HYBRID_REQUESTS, HYBRID_LONG = 24, 4
HYBRID_LONGEST = 3000
HYBRID_KERNEL_ROWS = {"hybrid decode launch": HYBRID_SLOTS,
                      "hybrid admission launch": HYBRID_LANES * HYBRID_CHUNK}


class MoeDrops:
    """Stands in for ``moe.route`` and counts the (token, choice) pairs
    kept and dropped by prefill blocks and by decode steps."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.prefill = [0, 0]
        self.decode = [0, 0]

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route

    def __call__(self, p, flat, cfg, C):
        out = self.route(p, flat, cfg, C)
        keep = out[3]
        side = self.decode if C == flat.shape[1] * cfg.top_k else self.prefill
        side[0] += keep.numel()
        side[1] += int((~keep).sum())
        return out


def recorded_generate(model, params, batch, n_new, forced=None):
    """``generate`` with greedy sampling, keeping the logits it samples
    from: (prefill logits, [the ``n_new`` decode steps' logits], tokens (B,
    n_new)).  With ``forced`` (B, n_new) the streams are fed those tokens
    instead of their own."""
    from repro_torch.serve.engine import generate, greedy_sample

    seen = []

    def sample(logits):
        seen.append(logits)
        i = len(seen) - 1
        if forced is not None and i < forced.shape[1]:
            return forced[:, i]
        return greedy_sample(logits)

    res = generate(model, params, batch, n_new, sample=sample)
    return seen[0], seen[1:], res.tokens


def rel_err(a, b) -> float:
    """max |a - b| over the largest |b|."""
    b = b.float()
    return float((a.float() - b).abs().max() / b.abs().max())


def gate_decode_vs_train(model, params, batch, n_new
                         ) -> tuple[float, torch.Tensor]:
    """Gate (a): each decode step's logits of ``generate`` against a train
    forward of the prompt and the generated tokens.  Returns (the worst
    relative error, the generated tokens)."""
    S = batch["tokens"].shape[1]
    pre, steps, toks = recorded_generate(model, params, batch, n_new)
    full = {"tokens": torch.cat([batch["tokens"], toks.to(
        batch["tokens"].dtype)], dim=1)}
    logits, _, _ = model.forward(params, full)
    worst = rel_err(pre, logits[:, S - 1])
    for i, lg in enumerate(steps):
        worst = max(worst, rel_err(lg, logits[:, S + i]))
    del logits
    return worst, toks


def widened(cfg, params):
    """The f32 model and the same weights widened to f32 (exact)."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.tree import tree_map

    return (build_model(dataclasses.replace(cfg, dtype="float32")),
            tree_map(lambda a: a.float() if a.is_floating_point() else a,
                     params))


def gate_card_vs_cpu(cfg, params, dev) -> tuple[float, str]:
    """Gate (b): the model's first 2 layers, weights widened to f32, on the
    card and on the CPU: greedy tokens and prefill logits.  Where the
    streams part, the card's token must be within ``CARD_RTOL`` of the
    CPU's best logit at that step, with the CPU fed the card's tokens (an
    f32 near-tie)."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.tree import tree_map

    two = {**params, "decoder": {"groups": [], "rest": two_layers(
        params["decoder"], build_model(cfg).decoder)}}
    model, two = widened(dataclasses.replace(cfg, n_layers=2), two)
    B, S, n_new = ZOO_SMALL
    g = torch.Generator(dev).manual_seed(3)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device=dev)}
    card = recorded_generate(model, two, batch, n_new)
    cpu_p, cpu_b = tree_map(lambda a: a.cpu(), (two, batch))
    host = recorded_generate(model, cpu_p, cpu_b, n_new)
    err = rel_err(card[0].cpu(), host[0])
    if err > CARD_RTOL:
        raise AssertionError(f"{cfg.name} 2 layers: prefill logits card vs "
                             f"CPU {err:.4g} of the largest")
    toks = card[2].cpu()
    if torch.equal(toks, host[2]):
        return err, "same tokens"
    pre, steps, _ = recorded_generate(model, cpu_p, cpu_b, n_new,
                                      forced=toks)
    worst = 0.0
    for i, logits in enumerate([pre] + steps[:n_new - 1]):
        gap = (logits.max(-1).values - logits.gather(
            1, toks[:, i:i + 1].long())[:, 0]) / logits.abs().max(-1).values
        worst = max(worst, float(gap.max()))
    if worst > CARD_RTOL:
        raise AssertionError(f"{cfg.name} 2 layers: card token {worst:.4g} "
                             f"of the largest logit below the CPU's best")
    return err, f"streams part at near-ties (worst gap {worst:.4g})"


def two_layers(stack_params, stack):
    """Layers 0 and 1 of a stack's params, as a 2-layer stack's rest."""
    from repro_torch.models.transformer import _index

    out = []
    for i in range(2):
        if stack.n_groups:
            g, pos = divmod(i, stack.period)
            out.append(_index(stack_params["groups"][pos], g))
        else:
            out.append(stack_params["rest"][i])
    return out


def ssd_gate(model, params, batch) -> float:
    """One layer's ``ssd_chunked`` against ``ssd_sequential`` on the inputs
    that layer gets at prefill (the first call's arguments)."""
    from repro_torch.device import full_f32
    from repro_torch.models import ssm

    seen = []
    chunked = ssm.ssd_chunked

    def capture(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return chunked(*args, **kw)

    ssm.ssd_chunked = capture
    try:
        model.prefill(params, batch)
    finally:
        ssm.ssd_chunked = chunked
    (x, dtv, A, B, C, chunk), kw = seen[0]
    with full_f32():
        y1, h1 = chunked(x, dtv, A, B, C, chunk, **kw)
        y2, h2 = ssm.ssd_sequential(x, dtv, A, B, C, **kw)
    err = max(rel_err(y1, y2), rel_err(h1, h2))
    log(f"  ssd_chunked vs ssd_sequential, layer 0 at full width (x "
        f"{tuple(x.shape)}, chunk {chunk}): max |diff| {err:.3g} of the "
        f"largest (limit {SSD_RTOL})")
    if err > SSD_RTOL:
        raise AssertionError(f"ssd_chunked vs ssd_sequential: {err}")
    return err


def profile_line(label, fn, wall, card):
    prof = forward_profile(fn, calls=1)
    if prof is None:
        log(f"  {label}: {wall:.2f} ms; device time: not measured (the "
            f"profiler trace holds no device time) [{card}]")
        return
    dev_ms, rows = prof
    log(f"  {label}: {wall:.2f} ms (median), device time (torch.profiler) "
        f"{dev_ms:.3f} ms, idle share {1 - dev_ms / wall:.3f} [{card}]; top "
        f"kernels:")
    for ms, count, key in rows[:6]:
        log(f"    {ms:.4f} ms x{count} {key[:90]}")


def zoo_run(card, dev, arch, B, S):
    """Phase 8, one architecture at full width and depth through
    ``generate``, with gates (a) and (b) and its times."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import moe
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import generate

    cfg = get_arch(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(dev).manual_seed(0), device=dev)
    sync(dev)
    g = torch.Generator(dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                     device=dev)}
    log(f"  {arch}: {model.param_count(params) / 1e9:.4f} B parameters "
        f"({cfg.dtype}), {cfg.n_layers} layers {cfg.block_pattern}, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, window {cfg.window or '-'}; "
        f"init {time.perf_counter() - t0:.2f} s; B = {B}, prompt {S}, "
        f"{ZOO_NEW} new tokens")
    with MoeDrops(moe) as drops:
        res = generate(model, params, batch, ZOO_NEW)
        sync(dev)
    toks = res.tokens
    if toks.shape != (B, ZOO_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"{arch}: tokens {tuple(toks.shape)} out of "
                             f"[0, {cfg.vocab_size})")
    if cfg.n_experts:
        kept, dropped = drops.prefill
        log(f"  MoE dispatch: prefill dropped {dropped} of {kept} (token, "
            f"choice) pairs ({dropped / kept:.4f}); decode dropped "
            f"{drops.decode[1]} of {drops.decode[0]}")
        if drops.decode[1] or not drops.decode[0]:
            raise AssertionError(f"{arch}: decode dropped {drops.decode}")
    gate_cfg, note = cfg, ""
    if cfg.n_experts:
        # dropless: every expert can take every token (reason at ZOO_RTOL)
        gate_cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.n_experts / cfg.top_k)
        note = f" (capacity_factor {gate_cfg.capacity_factor:g}, dropless)"
    errs = {}
    with MoeDrops(moe) as gate_drops:
        errs["bf16"], gate_toks = gate_decode_vs_train(
            build_model(gate_cfg), params, batch, ZOO_NEW)
        errs["f32"], _ = gate_decode_vs_train(*widened(gate_cfg, params),
                                              batch, ZOO_NEW)
    # the run timed below is the one gate (a) held, token for token (MoE's
    # gate runs dropless, a different function from the published run)
    if not cfg.n_experts and not torch.equal(gate_toks, toks):
        raise AssertionError(f"{arch}: generate's tokens differ from gate "
                             f"(a)'s run of generate on the same batch")
    if cfg.n_experts and (gate_drops.prefill[1] or gate_drops.decode[1]):
        raise AssertionError(f"{arch}: the dropless gate dropped "
                             f"{gate_drops.prefill} {gate_drops.decode}")
    log(f"  gate (a), decode steps vs a train forward of prompt + tokens"
        f"{note}: max |diff| {errs['bf16']:.4g} of the largest logit in "
        f"bf16 (limit {ZOO_RTOL}), {errs['f32']:.4g} with the weights in "
        f"f32 (limit {ZOO_F32_RTOL})")
    if errs["bf16"] > ZOO_RTOL or errs["f32"] > ZOO_F32_RTOL:
        raise AssertionError(f"{arch}: decode vs train {errs}")
    if cfg.family == "ssm":
        ssd_gate(model, params, batch)
    err_b, how = gate_card_vs_cpu(cfg, params, dev)
    log(f"  gate (b), 2 layers at full width in f32, card vs CPU (B = "
        f"{ZOO_SMALL[0]}, prompt {ZOO_SMALL[1]}, {ZOO_SMALL[2]} new): prefill "
        f"logits {err_b:.4g} of the largest (limit {CARD_RTOL}); {how}")

    gen_ms, gen_all = median_ms(lambda: generate(model, params, batch,
                                                 ZOO_NEW), reps=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  generate: median {gen_ms:.1f} ms of "
        f"{[round(t, 1) for t in gen_all]}, {B * ZOO_NEW / gen_ms * 1e3:.1f} "
        f"tokens/s [{card}]")

    def run_prefill():
        return model.prefill(params, batch, max_len=S + ZOO_NEW)

    _, state = run_prefill()
    tok = torch.zeros((B, 1), dtype=torch.int64, device=dev)

    def run_decode():
        return model.decode_step(params, state, tok)

    pre_ms, _ = median_ms(run_prefill, reps=3)
    dec_ms, _ = median_ms(run_decode, reps=5)
    profile_line(f"prefill ({B} x {S} tokens)", run_prefill, pre_ms, card)
    profile_line("decode step", run_decode, dec_ms, card)
    log(f"  peak memory: {peak_gb:.2f} GB [{card}]")
    del params, state, model
    gc.collect()
    torch.cuda.empty_cache()


def hybrid_traffic(n: int, vocab: int, window: int, seed: int = 8
                   ) -> list[dict]:
    """``n`` requests from a numpy seed: prompts of 16 to ``HYBRID_LONGEST``
    tokens, at least ``HYBRID_LONG`` of them longer than ``window``, 16-32
    new tokens, tiers reserved : standard : degradable = 1 : 2 : 1."""
    import numpy as np

    rng = np.random.default_rng(seed)
    tiers = rng.permutation(["reserved", "standard", "standard",
                             "degradable"] * (n // 4))
    lens = rng.integers(16, HYBRID_LONGEST + 1, n)
    lens[rng.permutation(n)[:HYBRID_LONG]] = rng.integers(
        window + 1, HYBRID_LONGEST + 1, HYBRID_LONG)
    return [dict(uid=i, tier=str(tiers[i]),
                 prompt=rng.integers(0, vocab, int(lens[i])).astype(np.int32),
                 max_new=int(rng.integers(16, 33))) for i in range(n)]


def hybrid_engine(card, dev):
    """Phase 8, last run: full-width recurrentgemma-2b with ReLU MLPs on
    the kernel through the ServeEngine, phase 6's gates.  Returns (kernel
    launches of the run, max abs error, the two kernel shapes' times)."""
    from repro_torch.configs.base import DslotConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeConfig, ServeEngine, SloConfig

    base = dataclasses.replace(get_arch(HYBRID_ARCH), act="relu", glu=False)
    dense = build_model(base)
    t0 = time.perf_counter()
    params = dense.init(torch.Generator(dev).manual_seed(0), device=dev)
    sync(dev)
    scale = calibrated_act_scale(dense, params, base.vocab_size, dev)
    cfg = dataclasses.replace(base, dslot=DslotConfig(
        enabled=True, block_m=HYBRID_SLOTS, block_n=128, block_k=None,
        act_scale=scale))
    model = build_model(cfg)
    scfg = ServeConfig(n_slots=HYBRID_SLOTS, max_len=HYBRID_MAX_LEN,
                       prefill_chunk=HYBRID_CHUNK,
                       chunks_per_step=HYBRID_LANES,
                       slo=SloConfig(**ENGINE_SLO))
    specs = hybrid_traffic(HYBRID_REQUESTS, cfg.vocab_size, cfg.window)
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    eng = ServeEngine(model, params, scfg)
    sync(dev)
    lens = sorted(len(s["prompt"]) for s in specs)
    log(f"  {cfg.name} with a ReLU MLP (act relu, no GLU): "
        f"{model.param_count(params) / 1e9:.4f} B parameters ({cfg.dtype}), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"window {cfg.window}; init + calibration {t1 - t0:.2f} s, engine "
        f"(prepare_dslot) {time.perf_counter() - t1:.2f} s; calibrated "
        f"act_scale {scale!r}; {cfg.dslot}; {scfg}; prompts {lens}")
    # the third forward of each kind is traced (and left out of the walls)
    eng._decode = Timed(eng._decode, dev, trace_at=3)
    eng.pipeline._extend_lanes = Timed(eng.pipeline._extend_lanes, dev,
                                       trace_at=3)
    captured = {}
    orig_run = dm.run

    def capture(*args):
        rows = args[0].shape[0]
        if rows in HYBRID_KERNEL_ROWS.values() and rows not in captured:
            captured[rows] = args
        return orig_run(*args)

    dm.dslot_matmul_cuda.launches = 0
    dm.run = capture
    try:
        run = drive_engine(eng, specs, dev, n_first=HYBRID_REQUESTS // 2,
                           burst_at_ceiling=True)
    finally:
        dm.run = orig_run
    launches = dm.dslot_matmul_cuda.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decodes, lanes = eng._decode.calls, eng.pipeline._extend_lanes.calls
    expected = cfg.n_layers * (decodes + eng.pipeline.forwards)
    log(f"  {HYBRID_REQUESTS} requests ({HYBRID_REQUESTS // 2} at step 0, a "
        f"burst of {HYBRID_REQUESTS - HYBRID_REQUESTS // 2} at step "
        f"{run['burst_step']}): {run['run_steps']} steps to drain, "
        f"{run['idle_steps']} idle steps to restore; {decodes} decode "
        f"forwards, {lanes} admission lane forwards; {launches} kernel "
        f"launches (expected {expected})")
    if launches != expected or lanes != eng.pipeline.forwards:
        raise AssertionError(f"{launches} kernel launches, expected "
                             f"{expected}")
    engine_gates(eng, run)

    max_err, times = hold_engine_shapes(captured, HYBRID_KERNEL_ROWS, cfg,
                                        dev, card)
    del captured

    held = hold_reserved(model, eng.params, run["reqs"], dev,
                         cfg.dslot.n_bits)
    log(f"  reserved streams vs solo generate: token agreement "
        f"{held['agreement']:.4f} (parted at (uid, token) {held['parted']}); "
        f"emitted tokens below the best logit of a forward of the stream by "
        f"at most {held['worst'][0]:.4g} of the largest (uid, token "
        f"{held['worst'][1]}; limit {LM_LOGIT_RTOL})")
    log(f"  times [{card}]")
    log(f"  engine: {run['tokens']} tokens in {run['seconds']:.2f} s, "
        f"{run['tokens'] / run['seconds']:.1f} tokens/s")
    for label, timed in (("decode forward", eng._decode),
                         ("admission forward", eng.pipeline._extend_lanes)):
        log_forward(label, timed.walls, timed.trace, "the third call")
    for tier in ("reserved", "standard", "degradable"):
        rs = [r for r in run["reqs"] if r.tier == tier]
        steps = sorted(r.ttft_steps for r in rs)
        log(f"  {tier} ({len(rs)} requests): TTFT p50 {pct(steps, 0.5)} / "
            f"p95 {pct(steps, 0.95)} steps; planes_used_mean "
            f"{tier_means(rs, 'planes_used_mean')[tier]:.4f}")
    log(f"  SLO: {eng.slo.shed_events} shed events ({run['burst_sheds']} "
        f"after the burst), {eng.slo.restore_events} restore events, min "
        f"levels {eng.slo.min_levels}")
    log(f"  peak memory: {peak_gb:.2f} GB [{card}]")
    del eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return launches, max_err, times


def phase8(card, dev):
    """The rest of the model zoo at full width: four ``generate`` runs, then
    the hybrid engine.  Returns what ``hybrid_engine`` returns."""
    for arch, B, S in ZOO_RUNS:
        zoo_run(card, dev, arch, B, S)
    return hybrid_engine(card, dev)


# ------------------------------------------------------------ phase 9

TRAIN_ARCH = "olmo-1b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_MICRO = 2048, 8, 2    # 16384 tokens a step
TRAIN_LR = 3e-4
TRAIN_TIMED = 6                 # after one untimed step; then one traced
TRAIN_CKPT_AFTER = 3            # save_async after this step, overlapping the next
TRAIN_SMALL = (4, 256)          # gates (a)-(c): global batch and sequence
# Gate (a), card vs CPU on the 2-layer f32 copy: both sum the same f32
# products in other orders (cuBLAS vs the CPU's BLAS, atomics in the
# card's embedding backward), so the loss agrees to f32 rounding and each
# gradient to a few ulps of its leaf's largest entry.  Adam's first step is
# about lr * sign(g): where |g| is near zero the sign may differ, so
# parameters are held tightly only where the CPU's |g| is firm.
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_REL = 1e-4
TRAIN_FIRM = 1e-3               # |g| above this share of its leaf's largest
TRAIN_REMAT_REL = 1e-6          # gate (b): remat recomputes the same ops
TRAIN_CKPT_RTOL = 1e-5          # gate (e): one step from the restored state


def kernel_kinds(rows) -> list[tuple[str, float]]:
    """Device ms per kind of kernel in a trace, largest first: f32 and
    bf16 products (cuBLAS/CUTLASS names), elementwise and copies,
    reductions, the rest."""
    kinds: dict[str, float] = {}
    for ms, _, key in rows:
        k = key.lower()
        if "sgemm" in k or "f32f32" in k:
            kind = "f32 products"
        elif any(t in k for t in ("gemm", "nvjet", "xmma", "cutlass")):
            kind = "bf16 products"
        elif "reduce" in k or "softmax" in k:
            kind = "reductions"
        elif "elementwise" in k or "copy" in k:
            kind = "elementwise and copies"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + ms
    return sorted(kinds.items(), key=lambda kv: -kv[1])


def train_opt(total_steps: int):
    """``launch/train.py``'s AdamW wiring for a run of ``total_steps``."""
    from repro_torch.optim.adamw import AdamWConfig

    return AdamWConfig(peak_lr=TRAIN_LR,
                       warmup_steps=min(100, total_steps // 10),
                       decay_steps=total_steps)


def to_device(host: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def train_small_gates(dev) -> None:
    """Gates (a)-(c) on the model's first 2 layers at full width in f32
    (one remat group per layer, so remat applies)."""
    from repro_torch import convert
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.step import (init_train_state, make_train_step,
                                        microbatch_grads)
    from repro_torch.tree import leaves, tree_map

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=2,
                              scan_unroll=1, dtype="float32")
    model = build_model(cfg)
    opt = train_opt(TRAIN_TIMED + 2)
    B, S = TRAIN_SMALL
    host_state = tree_map(lambda a: a.numpy(), init_train_state(
        model, torch.Generator().manual_seed(1), device="cpu"))

    def fresh(device):
        return convert.train_state(host_state, device=device)

    host = TokenPipeline(vocab=cfg.vocab_size, seq_len=S, global_batch=B,
                         microbatches=2, seed=3).next_host_batch()
    step = make_train_step(model, opt)

    # (a) card = CPU
    t0 = time.perf_counter()
    card_g, card_loss, _ = microbatch_grads(model, fresh(dev).params,
                                            to_device(host, dev))
    cpu_g, cpu_loss, _ = microbatch_grads(model, fresh("cpu").params,
                                          to_device(host, "cpu"))
    worst_g = max(rel_err(a.cpu(), b) for a, b in
                  zip(leaves(card_g), leaves(cpu_g)))
    card_s, mc = step(fresh(dev), to_device(host, dev))
    cpu_s, mh = step(fresh("cpu"), to_device(host, "cpu"))
    lr = float(mh["lr"])
    errs = {k: abs(float(mc[k]) - float(mh[k])) / abs(float(mh[k]))
            for k in ("loss", "grad_norm")}
    errs["loss (grads pass)"] = abs(float(card_loss) - float(cpu_loss)) \
        / abs(float(cpu_loss))
    firm_d = all_d = 0.0
    for a, b, g in zip(leaves(card_s.params), leaves(cpu_s.params),
                       leaves(cpu_g)):
        d = (a.cpu() - b).abs()
        firm = g.abs() > TRAIN_FIRM * g.abs().max()
        all_d = max(all_d, float(d.max()))
        if bool(firm.any()):
            firm_d = max(firm_d, float(d[firm].max()))
    log(f"  gate (a) card vs CPU, 2 layers f32 at full width, {B} x {S} "
        f"tokens in 2 microbatches ({time.perf_counter() - t0:.1f} s): "
        f"loss rel {errs['loss']:.3g}, grad_norm rel "
        f"{errs['grad_norm']:.3g} (limit {TRAIN_LOSS_RTOL}); gradients "
        f"{worst_g:.3g} of the leaf's largest (limit {TRAIN_GRAD_REL}); "
        f"params {firm_d / lr:.3g} lr where |g| is firm (limit 1e-3), "
        f"{all_d / lr:.3g} lr anywhere (limit 2)")
    if max(errs.values()) > TRAIN_LOSS_RTOL or worst_g > TRAIN_GRAD_REL \
            or firm_d > 1e-3 * lr or all_d > 2 * lr:
        raise AssertionError(f"gate (a) card vs CPU: {errs}, grads "
                             f"{worst_g}, params {firm_d}, {all_d}")
    del card_s, cpu_s, cpu_g

    # (b) remat on = off
    off = build_model(dataclasses.replace(cfg, remat=False))
    off_g, _, _ = microbatch_grads(off, fresh(dev).params,
                                   to_device(host, dev))
    worst_r = max(rel_err(a, b) for a, b in
                  zip(leaves(off_g), leaves(card_g)))
    log(f"  gate (b) remat on vs off on the card: gradients {worst_r:.3g} of "
        f"the leaf's largest (limit {TRAIN_REMAT_REL})")
    if worst_r > TRAIN_REMAT_REL:
        raise AssertionError(f"gate (b) remat on vs off: {worst_r}")
    del off_g, card_g

    # (c) M = 1 vs M = 4
    one = {k: v.reshape(1, B, S) for k, v in host.items()}
    four = {k: v.reshape(4, B // 4, S) for k, v in host.items()}
    s1, m1 = step(fresh(dev), to_device(one, dev))
    s4, m4 = step(fresh(dev), to_device(four, dev))
    dl = abs(float(m1["loss"]) - float(m4["loss"]))
    dp = max(float((a - b).abs().max()) for a, b in
             zip(leaves(s1.params), leaves(s4.params)))
    log(f"  gate (c) M = 1 vs M = 4 on the card: loss {dl:.3g} (limit "
        f"1e-4), params {dp:.3g} (limit 5e-3)")
    if dl >= 1e-4 or dp >= 5e-3:
        raise AssertionError(f"gate (c) microbatching: loss {dl}, params {dp}")


def phase9(card, dev) -> None:
    """Training at full published width and depth (see the module
    docstring): gates (a)-(e) and the step's figures."""
    import math
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.optim.adamw import schedule
    from repro_torch.train.step import init_train_state, make_train_step
    from repro_torch.tree import leaves, tree_map

    train_small_gates(dev)
    gc.collect()
    torch.cuda.empty_cache()

    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg)
    total = TRAIN_TIMED + 2                 # untimed, timed, traced
    opt = train_opt(total)
    step = make_train_step(model, opt)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, microbatches=TRAIN_MICRO)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             device=dev)
    n_params = model.param_count(state.params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  {TRAIN_ARCH}: {n_params / 1e9:.4f} B parameters ({cfg.dtype}), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, remat {cfg.remat}, scan_unroll "
        f"{cfg.scan_unroll}, attn_chunk {cfg.attn_chunk}; seq {TRAIN_SEQ}, "
        f"global batch {TRAIN_BATCH}, M = {TRAIN_MICRO} ({tokens} tokens a "
        f"step); AdamW peak lr {opt.peak_lr}, warmup {opt.warmup_steps}, "
        f"decay {opt.decay_steps}")

    ck_dir = ROOT / "build" / "phase9_ckpt"
    shutil.rmtree(ck_dir, ignore_errors=True)
    ck = Checkpointer(str(ck_dir), keep=1)
    write_s = []
    write = ck._write

    def timed_write(*args):
        t = time.perf_counter()
        out = write(*args)
        write_s.append(time.perf_counter() - t)
        return out

    ck._write = timed_write
    rows, walls, events = [], [], []
    try:
        for k in range(1, total + 1):
            if k == TRAIN_CKPT_AFTER + 1:
                saved_pipe = pipe.state()
            batch = to_device(pipe.next_host_batch(), dev)
            sync(dev)
            if k == total:                  # the traced step
                (state, m), trace = traced(lambda: step(state, batch))
            else:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                state, m = step(state, batch)
                end.record()
                sync(dev)
                wall = (time.perf_counter() - t0) * 1e3
                if k > 1:
                    walls.append(wall)
                    events.append(start.elapsed_time(end))
            row = {n: float(m[n]) for n in ("loss", "grad_norm", "lr")}
            want_lr = float(schedule(opt, torch.tensor(k, device=dev)))
            rows.append(row)
            log(f"  step {k}: loss {row['loss']:.6f}, grad_norm "
                f"{row['grad_norm']:.6f}, lr {row['lr']:.6e}"
                + (f", wall {wall:.1f} ms" if k != total else ", traced"))
            if not (math.isfinite(row["loss"])
                    and math.isfinite(row["grad_norm"])):
                raise AssertionError(f"gate (d): step {k} is not finite")
            if row["lr"] != want_lr:
                raise AssertionError(f"gate (d): step {k} lr {row['lr']} != "
                                     f"schedule {want_lr}")
            if k == TRAIN_CKPT_AFTER + 1:
                loss4 = row["loss"]
                alive = ck._thread is not None and ck._thread.is_alive()
                log(f"    the checkpoint write was "
                    f"{'still running' if alive else 'done'} when step {k} "
                    f"ended")
            if k == TRAIN_CKPT_AFTER:
                sync(dev)
                free = shutil.disk_usage(ck_dir).free
                expect = tree_map(lambda a: a.detach().cpu().clone(), state)
                t0 = time.perf_counter()
                ck.save_async(k, state)
                snap_ms = (time.perf_counter() - t0) * 1e3
                log(f"    save_async after step {k}: snapshot {snap_ms:.0f} "
                    f"ms; free disk before {free / 1e9:.1f} GB")
        timed = [r["loss"] for r in rows[1:1 + TRAIN_TIMED]]
        if not timed[-1] < timed[0]:
            raise AssertionError(f"gate (d): the last timed loss {timed[-1]} "
                                 f"is not below the first {timed[0]}")
        peak = torch.cuda.max_memory_allocated()

        walls_s = sorted(walls)
        med = walls_s[len(walls_s) // 2]
        ev = sorted(events)[len(events) // 2]
        mfu = 6 * n_params * tokens / (med / 1e3 * PEAK_BF16_FLOPS)
        log(f"  train step wall (CUDA events around a synchronised step) "
            f"median {med:.1f} ms, min {walls_s[0]:.1f}, max "
            f"{walls_s[-1]:.1f} over {len(walls)} steps (events median "
            f"{ev:.1f} ms); {tokens / (med / 1e3):.0f} tokens/s; model-FLOPs "
            f"share {mfu:.4f} (6 N T = {6 * n_params * tokens:.4g} over the "
            f"wall x 989 TFLOP/s, the H100 SXM bf16 dense spec figure) "
            f"[{card}]")
        log(f"  peak memory (torch.cuda.max_memory_allocated) "
            f"{peak / 1e9:.2f} GB")
        if trace is None:
            log("  traced step: device time not measured (the profiler trace "
                "holds no device time)")
        else:
            dev_ms, krows = trace
            log(f"  traced step {total}: device time (torch.profiler) "
                f"{dev_ms:.1f} ms, idle share {1 - dev_ms / med:.3f} of the "
                f"median wall; top kernels:")
            for ms, count, key in krows[:10]:
                log(f"    {ms:.3f} ms x{count} {key[:90]}")
            log("  by kind: " + ", ".join(
                f"{kind} {ms:.1f} ms" for kind, ms in kernel_kinds(krows)))

        # (e) checkpoint: restore into a fresh state
        ck.wait()
        nbytes = sum(f.stat().st_size for f in ck_dir.rglob("*")
                     if f.is_file())
        log(f"  gate (e) checkpoint of step {TRAIN_CKPT_AFTER}: write "
            f"{write_s[0]:.1f} s on its thread, {nbytes / 1e9:.2f} GB "
            f"written")
        del state, m, batch
        gc.collect()
        torch.cuda.empty_cache()
        fresh = init_train_state(model, torch.Generator(dev).manual_seed(9),
                                 device=dev)
        t0 = time.perf_counter()
        restored = ck.restore(TRAIN_CKPT_AFTER, fresh)
        sync(dev)
        log(f"    restore (crc checked) {time.perf_counter() - t0:.1f} s")
        del fresh
        for a, b in zip(leaves(restored), leaves(expect)):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                raise AssertionError("gate (e): a restored leaf differs from "
                                     "the state saved")
        del expect
        pipe.restore(saved_pipe)
        _, m = step(restored, to_device(pipe.next_host_batch(), dev))
        again = float(m["loss"])
        err = abs(again - loss4) / abs(loss4)
        log(f"    every leaf bit-equal; one step from the restored state: "
            f"loss {again:.6f} vs step {TRAIN_CKPT_AFTER + 1}'s {loss4:.6f} "
            f"(rel {err:.3g}, limit {TRAIN_CKPT_RTOL})")
        if err > TRAIN_CKPT_RTOL:
            raise AssertionError(f"gate (e): loss after restore {again} vs "
                                 f"{loss4}")
    finally:
        ck.wait()
        shutil.rmtree(ck_dir, ignore_errors=True)


# ------------------------------------------------------------ phase 3

def cpu_copy(prep):
    """The prepared CNN with every tensor moved to the CPU."""
    def move(params):
        dw = params["dslot"]
        fields = {f.name: getattr(dw, f.name) for f in dataclasses.fields(dw)}
        moved = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                 for k, v in fields.items()}
        return {"w": params["w"].cpu(), "dslot": type(dw)(**moved)}
    return prep._replace(conv_params=move(prep.conv_params),
                         head_params=move(prep.head_params))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs.dslot_mnist import CONFIG
    from repro_torch.core import mnist_cnn
    from repro_torch.data.mnist import synth_mnist
    from repro_torch.kernels import _build
    from repro_torch.kernels import dslot_matmul as dm

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -------------------------------------------------- 1. device, build
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.build("dslot_matmul")
    log(f"build: dslot_matmul.cu in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log("dslot_matmul").splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # -------------------------------------------------- 2. kernel vs plain
    log("phase 2: kernel vs plain version")
    max_err = 0.0
    shape_times = {}
    for n, case in enumerate(phase2_cases()):
        q, prep, kw = run_case(case, seed=100 + n, dev=dev)
        a = dm.dslot_matmul_cuda(q, prep.w, **kw)
        a2 = dm.dslot_matmul_cuda(q, prep.w, **kw)
        b = dm.dslot_matmul_plain(q, prep.w, **kw)
        torch.cuda.synchronize()
        if not (torch.equal(a.out, a2.out)
                and torch.equal(a.planes_used, a2.planes_used)):
            raise AssertionError(f"{case.name}: two launches differ")
        err = compare(case.name, a, b, case.weights == "dyadic", q, prep.w,
                      kw)
        max_err = max(max_err, err)
        if case.weights == "inert" and not (
                int(a.planes_used.max()) == 0 and float(a.out.abs().max())
                == 0.0):
            raise AssertionError(f"{case.name}: an inert weight must issue "
                                 f"no planes and emit zeros")
        log(f"  {case.name}: max err {err:.3g}, planes_used mean "
            f"{float(a.planes_used.float().mean()):.3f} "
            f"(plain {float(b.planes_used.float().mean()):.3f}), "
            f"tiles {a.planes_used.numel()}")
        if case.name.endswith("f32 normal n8"):     # one timing per shape
            shape_times[case.name.split(" f32")[0]] = time_call(
                case.name, q, prep.w, kw, (case.M, case.K, case.N),
                lambda: dm.dslot_matmul_cuda(q, prep.w, **kw),
                lambda: dm.dslot_matmul_plain(q, prep.w, **kw), card)
        del q, prep, kw, a, a2, b
        torch.cuda.empty_cache()

    # -------------------------------------------------- 3. main path
    log("phase 3: MNIST CNN main path, B = 1024")
    images_np, _ = synth_mnist(103, seed=0)
    calib_np, _ = synth_mnist(26, seed=1)
    images = torch.as_tensor(images_np[:1024]).to(dev)
    calib = torch.as_tensor(calib_np[:256]).to(dev)

    dm.dslot_matmul_cuda.launches = 0
    params = mnist_cnn.init_cnn(CONFIG, torch.Generator().manual_seed(0))
    prep = mnist_cnn.prepare_cnn(params, CONFIG)
    prep = mnist_cnn.calibrate_cnn(prep, calib, CONFIG)
    after_calibrate = dm.dslot_matmul_cuda.launches
    ref = mnist_cnn.forward(params, images, CONFIG)
    agreement = {}
    for npl in (8, 6, 4, 2):
        n0 = dm.dslot_matmul_cuda.launches
        res = mnist_cnn.forward_dslot(prep, images, CONFIG, n_planes=npl)
        torch.cuda.synchronize()
        launched = dm.dslot_matmul_cuda.launches - n0
        if launched != 2:
            raise AssertionError(f"forward_dslot launched the kernel "
                                 f"{launched} times, expected 2")
        if res.logits.shape != (1024, CONFIG.n_classes) or not bool(
                torch.isfinite(res.logits).all()):
            raise AssertionError("logits must be finite, shape (1024, 10)")
        agreement[npl] = float((res.logits.argmax(-1)
                                == ref.argmax(-1)).float().mean())
        st = res.layer_stats
        log(f"  n_planes {npl}: argmax agreement {agreement[npl]:.4f}; "
            + "; ".join(f"{k} planes_used mean "
                        f"{float(v.planes_used.float().mean()):.3f} "
                        f"skipped_frac {float(v.skipped_frac):.4f}"
                        for k, v in st.items()))
    main_launches = dm.dslot_matmul_cuda.launches
    log(f"  kernel launches on the main path: {main_launches} "
        f"(calibrate {after_calibrate}, then 2 per forward_dslot)")
    if agreement[8] < 0.95:
        raise AssertionError(f"argmax agreement {agreement[8]} < 0.95")

    # the same prepared state on the CPU: kernel vs plain on 16 images
    small = images[:16]
    on_card = mnist_cnn.forward_dslot(prep, small, CONFIG, n_planes=8)
    on_cpu = mnist_cnn.forward_dslot(cpu_copy(prep), small.cpu(), CONFIG,
                                     n_planes=8)
    logit_err = float((on_card.logits.cpu() - on_cpu.logits).abs().max())
    if not torch.allclose(on_card.logits.cpu(), on_cpu.logits, rtol=1e-4,
                          atol=1e-4):
        raise AssertionError(f"16-image logits: card vs CPU err {logit_err}")
    for name, st in on_card.layer_stats.items():
        if not torch.equal(st.planes_used.cpu(),
                           on_cpu.layer_stats[name].planes_used):
            raise AssertionError(f"16-image {name} planes_used differ")
    log(f"  16 images, card vs CPU plain version: logits max err "
        f"{logit_err:.3g}, planes_used equal")
    max_err = max(max_err, logit_err)

    # -------------------------------------------------- 4. times
    log(f"phase 4: times [{card}]")
    with Captured(dm) as cap:
        mnist_cnn.forward_dslot(prep, images, CONFIG, n_planes=8)
    calls = [args for args, _ in cap.calls]
    del cap
    if len(calls) != 2:
        raise AssertionError(f"forward_dslot made {len(calls)} kernel calls, "
                             f"expected 2 (conv, head)")
    main_times = []
    side = CONFIG.image_size - CONFIG.kernel_size + 1   # valid conv
    layers = (("forward conv launch", prep.conv_params["dslot"],
               images.shape[0] * side * side),
              ("forward head launch", prep.head_params["dslot"],
               images.shape[0]))
    for (label, dw, rows), args in zip(layers, calls):
        q, w = args[0], args[1]
        kw = kernel_kw(args)
        dims = (rows, dw.d_in, dw.d_out)
        a = dm.DslotMatmulOut(*dm._launch(*args))
        b = dm.DslotMatmulOut(*dm._replay(*args))
        torch.cuda.synchronize()
        max_err = max(max_err, compare(label, a, b, False, q, w, kw))
        main_times.append(time_call(
            label, q, w, kw, dims, lambda a=args: dm._launch(*a),
            lambda a=args: dm._replay(*a), card))
    def fwd():
        return mnist_cnn.forward_dslot(prep, images, CONFIG, n_planes=8)

    fwd_all = sorted(cuda_ms(fwd) for _ in range(7))
    fwd_ms = fwd_all[len(fwd_all) // 2]
    log(f"  forward_dslot B=1024 n_planes=8: median {fwd_ms:.4f} ms, min "
        f"{fwd_all[0]:.4f}, max {fwd_all[-1]:.4f} over 7 repeats of 10 "
        f"calls; host issue {host_us(fwd, reps=20):.1f} us per call [{card}]")
    prof = forward_profile(fwd)
    if prof is None:
        log("  forward_dslot device time: not measured (the profiler trace "
            "holds no device time)")
    else:
        dev_ms, rows = prof
        log(f"  forward_dslot device time (torch.profiler, 5 calls): "
            f"{dev_ms:.4f} ms per call, idle share "
            f"{1 - dev_ms / fwd_ms:.3f} of the median; kernels:")
        for ms, count, key in rows[:12]:
            log(f"    {ms:.4f} ms x{count} {key[:90]}")
    for shape, t in shape_times.items():
        log(f"  shape {shape}: kernel {t['ms']:.4f} ms vs bound "
            f"{t['bound_ms']:.4g} ms")

    # -------------------------------------------------- 5. LM serving path
    log(f"phase 5: LM serving path, {LM_ARCH} through generate")
    lm_launches, lm_err, lm_times = phase5(card, dev)
    max_err = max(max_err, lm_err)
    main_times += lm_times

    # -------------------------------------------------- 6. serving engine
    log(f"phase 6: the slot-pool ServeEngine, {ENGINE_ARCH} with ReLU MLPs")
    eng_launches, eng_err, eng_times = phase6(card, dev)
    max_err = max(max_err, eng_err)
    main_times += eng_times

    # -------------------------------------------------- 7. paper experiment
    log("phase 7: the paper's experiment, the MNIST CNN trained on the card")
    mn_launches, mn_err, mn_times = phase7(card, dev)
    max_err = max(max_err, mn_err)
    main_times += mn_times

    # -------------------------------------------------- 8. the model zoo
    log(f"phase 8: the rest of the model zoo at full width [{card}]")
    hy_launches, hy_err, hy_times = phase8(card, dev)
    max_err = max(max_err, hy_err)
    main_times += hy_times

    # -------------------------------------------------- 9. training
    log(f"phase 9: training {TRAIN_ARCH} at full width [{card}]")
    n0 = dm.dslot_matmul_cuda.launches
    phase9(card, dev)
    log(f"  dslot kernel launches in phase 9: "
        f"{dm.dslot_matmul_cuda.launches - n0} (the model has no DSLOT "
        f"layer; training launches no hand-written kernel)")

    t_bytes = sum(t["t_bytes"] for t in main_times)
    t_ops = sum(t["t_ops"] for t in main_times)
    record = {"kernels": [{
        "name": "dslot_matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches + lm_launches + eng_launches + mn_launches
        + hy_launches,
        "max_abs_err": max_err,
        "ms": sum(t["ms"] for t in main_times),
        "plain_ms": sum(t["plain_ms"] for t in main_times),
        "bound_ms": sum(t["bound_ms"] for t in main_times),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(t["library_ms"] for t in main_times),
        "graph_ms": sum(t["graph_ms"] for t in main_times),
        "library_graph_ms": sum(t["library_graph_ms"] for t in main_times)}]}
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
