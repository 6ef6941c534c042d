#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, hold its CUDA kernel
against the kernel's plain PyTorch version, train a model at full width,
serve one over two ranks sharing the card, train it sharded over them,
and hold the launch tools' counts and dry run against the card.

    python3 chip_smoke.py          # from the repository root; needs one GPU

Phases (any failure exits non-zero and prints no result line):

1. Device and build: the card's name and power limit, then ``nvcc`` builds
   ``src/repro_torch/kernels/csrc/dslot_matmul.cu`` for ``sm_90a`` on a
   host thread while phase 9 runs first (it launches no hand-written
   kernel, and its steps are device-bound), then phase 11 (no hand-written
   kernel either; its timed runs come after the build's remaining tens of
   seconds); phase 2 starts once the build has ended, and phases 3-8, 10
   and 12 follow.
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
   they ride with each sub-chunk); the tiles the kernel once refused
   (``REPAIRED_TILES``: 128 x 24 and 1024 x 24 at K = 1024, the second
   with a 2-stage ring at the shared-memory edge, 512 x 8 at K = 25 and
   1024, ``block_n`` 1 at N = 70000 and 64 at N = 64 * 65537, past
   grid.y's 65535 tiles, 144 x 24 with physical rows past ``block_m``,
   256 x 66; ``WALKED_TILES``, each timed once: 16 x 256 at the olmo
   engine's admission shape, 1024 x 136, 512 x 32 with int32 q (whose
   (4, 4) warp tiles overflow 3 ring stages), ``block_m`` 2048 and 4096
   at 8 and 24 columns; each ReLU case's kernel, from ``dm.route``, is
   printed and must be the one ``WALKED_TILES`` names: the band kernel's
   2-block clusters at 16 x 256, ``cluster_kernel`` for the others), each with
   ReLU on and off and f32 dyadic, f32
   and bf16 weights; seamless's MLP up at 171 tiles of 24 columns, timed
   at 128 x 24 and at phase 10's 32 x 24, each held to the band kernel
   (``SPLIT_KERNEL``), and ``split_warp_cases``: column tiles of 24, 40,
   48 and 56 at ``block_m`` 32, 16, 64 and 128 (row and column tiles of
   alternating sign, column tile 1 of plane bound 0 and a last block of
   one column tile, row budgets at the engine's admission shape, three
   parts), each on the band kernel; the band kernel's cases
   (``band_cases``: the engine's and the hybrid's admission shapes with
   vote tiles of alternating sign, dyadic and bf16-held normal weights,
   row budgets, an N tile of plane bound 0, a tile of 44 real rows in 128,
   the decode band split over 2-block clusters, and an f32 layer of three
   parts), each with the parts ``dslot_prepare`` built; and the tiles the
   port's launchers pass (``LAUNCHER_TILES``: 32 x 32, 16 x 16 and 16 x 32
   at ``block_k`` 16), each timed at the engine's admission shape with
   bf16-held weights, its kernel (``dm.route``, the band kernel's
   column-tile votes) printed and held against the one ``LAUNCHER_TILES``
   names, and each with the cases of ``launcher_band_cases`` (row and
   column tiles of alternating sign, a column tile of plane bound 0 inside
   a 128-column block, N = 1024 + ``block_n``, row budgets; dyadic,
   bf16-held normal and f32 normal weights).  Every case runs the kernel twice and
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
   held against the plain version), and at every ``SERVING_ROWS`` shape
   (the serving rows of ``PERF.md``, seeded bf16-held weights through
   ``dslot_execute``; eager and from a graph) and ``LAUNCHER_ROWS``
   (``launch/serve.py --dslot``'s LM prefill and decode at its 32 x 32
   tiles), beside the kernel's bound:
   the larger of bytes / 3.35 TB/s and the needed bf16 tensor-core
   products / 989 TFLOP/s, both H100 SXM data-sheet peaks at 700 W.  A
   product with f32 weights needs 3 bf16 products (hi, mid and lo parts of
   each weight: f32 accuracy without TF32), one whose weights are all bf16
   values (a bf16 model's, widened to f32) needs 1; W's bytes are 2 a
   weight there, else 4, whatever its storage.
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
   request must report ``planes_used_mean <= 2``; so must one ``generate``
   at ``launch/serve.py --dslot``'s ``DslotConfig`` (32 x 32 tiles) on the
   same weights, its tokens/s and token agreement printed beside the
   128 x 128 run's.  One launch of each shape
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

10. Tensor- and expert-parallel serving (``repro_torch.launch.mesh``,
   ``dslot_prepare(mesh=...)``, ``ServeConfig.mesh``,
   ``repro_torch.distributed``): a world of 2 ranks sharing ``cuda:0``
   over ``gloo`` (one card, and NCCL needs a device per rank), started by
   ``run_world`` after the parent has built the kernel, with a collective
   timeout of ``TP_TIMEOUT`` s; the ranks share the (1, 2) mesh of
   ``make_test_mesh(model=2)``.  Gate (a): ``tp_cases`` (phase 2's shapes
   with ReLU, f32 and bf16 weights, scalar and per-row budgets, sorted
   columns on and off, seamless's MLP up at ``block_n`` 24 with Nt = 171
   at ``block_m`` 32 and 128 and the conv with Nt = 1 at ``block_m`` 128
   and 512, so pad tiles of bound 0 appear; then three
   cases without ReLU) through ``dslot_execute``, sharded and unsharded on
   the card: with ReLU the output and every ``DslotStats`` field must be
   equal bit for bit; without ReLU (the kernel's product path picks its K
   split from the launch's tile count, which differs at the engine's
   decode shape) the outputs are held by phase 2's rule and the statistics
   must be equal; each rank's own launch is held
   against the plain version by phase 2's rule.  Gate (b): phase 6's model,
   ``act_scale`` and ``ServeConfig`` with the mesh, on ``TP_REQUESTS``
   seeded requests with per-request budgets ``TP_BUDGETS`` outside the
   reserved tier, the forward split over the model axis (each rank keeps
   its model slice of the parameters; attention by heads over KV rings
   split along their slots, the vocab, the DSLOT up-projection's N tiles),
   run twice on every rank.  The gate run, on an f32 copy of the model
   with its dense ReLU MLP (the bf16 weights cast up; no DSLOT quantizer,
   which turns an f32 rounding difference into a whole 8-bit step): the
   token streams and per-request ``planes_used_mean`` must equal those of
   the unsharded f32 engine, which the parent runs first on the same card
   with the same weights and traffic, recording each sampled token's top-2
   logit margin; a stream that differs is accepted only where that margin
   at its first differing token is within ``SV_LOGIT_REL`` (the CPU test's
   f32 bound) of the row's largest |logit|.  The timed run, the bf16 DSLOT
   model without the collective clock: its streams are counted against
   the unsharded bf16 engine's, not held, beside one device's run that
   walks the admission's keys in ``SV_WITNESS_CHUNK`` chunks.  In both:
   the auditor empty every step; no errors, quarantines or timeouts; the
   DSLOT run's launches = 16 x forwards; every KV ring of each rank's pool
   a ``KVShard`` of ``ENGINE_MAX_LEN / 2`` slots.  Rank 0's bf16 decode
   forward at most ``SV_SPLIT_FLOPS`` of the unsharded forward's dot FLOPs
   (``op_cost``; the DSLOT launches are opaque to it, and the DSLOT MLP's
   down-projection
   stays whole on every rank).  Gate (c):
   ``apply_moe_ep`` at granite-moe-1b-a400m's full width (d_model 1024, 32
   experts, top-8, d_ff 512, bf16) on 4 x 2048 tokens at its capacity
   factor within ``EP_Y_ATOL`` / ``EP_AUX_ATOL`` of the dense ``apply_moe``
   on the card, and bit-equal with full per-expert budgets.  Gate (d): the
   collective matmul at (4096, 2048) @ (2048, 8192) within ``CM_RTOL`` of
   the largest |y| of ``x @ w``.  Printed per rank with the card: engine
   tokens/s, decode and admission forward walls with device time and idle
   share (a traced warm-up call), every DSLOT ``all_gather``'s time, the
   gate run's model-axis collective seconds by kind (``CollectiveClock``:
   "g" sums, head and logit gathers, the attention's max and sum), peak
   memory, the decode forward's dot FLOPs, the EP and collective-matmul
   times; rank 0's kernel time at the shard shapes (16, 2048) and (128,
   2048) @ (2048, 4096) as in phase 4.  Gate (e): the hybrid split engine,
   phase 8's recurrentgemma-2b with ReLU, non-GLU DSLOT MLPs over the same
   (1, 2): its RG-LRU mixers split by width (1280 of 2560 channels a rank,
   ``h`` and conv tail halved), its 10 heads by 5 under "group" over a
   2048-slot local-attention ring of 1024 slots a rank, its vocab and its
   DSLOT up-projection's N tiles, on ``HS_REQUESTS`` seeded requests (one
   prompt of ``HS_LONG_PROMPT`` tokens, past the window) through phase 8's
   slots, chunk and lanes at ``max_len`` ``HS_MAX_LEN``, with gate (b)'s
   three runs and rules: the dense f32 copy's streams,
   ``planes_used_mean`` and logits held to the unsharded f32 engine's, the
   bf16 DSLOT run's partings counted beside one device's reordering, the
   DSLOT launches = 26 x forwards; rank 0's decode forward at most
   ``HS_SPLIT_FLOPS`` of the unsharded forward's dot FLOPs; every rank's
   recurrent-state bytes exactly half of one device's; the kernel held and
   timed by rank 0 at the hybrid's shard shapes (16, 2560) and (256, 2560)
   @ (2560, 3840), ``block_m`` 16.

11. Sharded training (``repro_torch.train.sharding``,
   ``make_sharded_train_step``, ``distributed.compression``,
   ``distributed.fault_tolerance``, ``Checkpointer`` with shardings): the
   single-device yardsticks on the card first, on phase 9's gate copy
   (olmo-1b's first 2 layers at full width in f32, ``TRAIN_SMALL``
   batches): one step, 8 steps, and 8 steps in M = 4 microbatches.  Gate
   (c) here: int8 and top-k (1%) compression of that copy's gradient
   tree, two rounds each: the int8 payload below ``SH_INT8_RATIO`` of f32,
   and decompressed payload plus residual equal to gradient plus the
   previous residual within ``SH_EF_REL`` of each leaf's largest.  Then a
   world of 2 ranks sharing ``cuda:0`` over ``gloo`` (as phase 10).  Gate
   (a): one sharded step over (2, 1) and over (1, 2), loss and grad_norm
   within ``TRAIN_LOSS_RTOL`` of the single device's, parameters within
   1e-3 lr where its |g| exceeds ``TRAIN_FIRM`` of its leaf's largest and
   2 lr anywhere, metrics equal on both ranks.  Gate (b):
   ``ResilientTrainer`` over (2, 1), ``ckpt_every`` 3, a
   ``NodeFailure(lost_nodes=1)`` at step 4, the survivor restored onto
   (1, 1), 8 steps: ``steps_done`` 8, ``restarts`` 1, ``reshards`` 1,
   finite losses, the restored leaves bit-equal to the committed
   checkpoint; the survivor's steps after the restart against one device
   stepping from that checkpoint, losses within ``TRAIN_LOSS_RTOL`` and
   final parameters within 1e-3 lr where its |m| is firm and 2 lr
   anywhere; against the uninterrupted single device, the losses before
   the failure within ``TRAIN_LOSS_RTOL`` and the final parameters within
   2 lr anywhere (their firm difference is printed beside the drift of one
   device taking the same batches in M = 4 one-row microbatches: reason at
   ``SH_ELASTIC``).  Over (1, 2) the step splits its compute over the
   model axis (heads, MLP columns and the vocab; ``pspec.model_shard``), so
   gate (a) there holds the split.  The timed runs: olmo-1b at full width,
   its first ``SH_TIMED_LAYERS`` of 16 layers (the depth cut that keeps
   the script within its time limit; phase 9's config and data: seq 2048,
   global batch 8, M = 2) over (2, 1) and over (1, 2), 1 untimed and
   ``SH_TIMED`` timed step each (a cut that keeps the script within its
   time limit since the step gathers its layers at each use), a sharded
   ``save_async`` after the untimed step of the (2, 1) run, its write
   overlapping the timed step;
   printed per rank: every step's loss, grad_norm, lr, wall and the
   seconds of its own collectives by kind (parameter gathers -- each remat
   group's leaves at use and again in its recompute, ``pspec.layer_gather``
   -- and gradient reduce-scatters over the batch axis, the split's
   collectives over the model axis; synchronized before and after, inside
   the step's wall), the median, min and max wall, the world's tokens/s
   beside phase 9's, the collective shares, the stored state and the peak
   memory over the steps beside ``SH_WHOLE_TREE_PEAK_GB``, and the
   checkpoint's snapshot and write times.  Every sharded step of the phase
   gathers its layer stacks group by group.  Gate (d): the untimed
   first (1, 2) step counted by ``op_cost`` on rank 0, its dot FLOPs at most
   ``SH_SPLIT_FLOPS`` of the same model's step on the card alone at the
   same global batch (``timed_yardstick``).  Gate (e): mamba2-780m at
   full width, its first ``MX_LAYERS`` layers in f32, one step over (1,
   2) with its Mamba2 mixers split by SSD head (24 of 48 a rank; ``w_in``,
   the conv and the per-head leaves gathered whole and read in part) on
   ``MX_SMALL`` batches, against the same step on one device on the card
   by gate (a)'s bounds, rank 0's dot
   FLOPs (``op_cost``) at most ``SH_SPLIT_FLOPS`` of the one device's.
   Phase 11 launches no DSLOT kernel (GLU MLPs), and says so.
12. The launch tools (``repro_torch.launch.op_cost``, ``dryrun``,
   ``roofline``, ``summarize``): (a) one more step of phase 9's program
   after its timed steps, counted by ``op_cost`` on the card: dot FLOPs
   beside 6·N·T, the roofline's three terms and modeled step beside phase
   9's wall, ``roofline_frac`` beside its model-FLOPs share; (b) the dry
   run of that one-device program on fake CPU tensors in a subprocess,
   gates: its dot FLOPs equal (a)'s exactly and its peak lies within 5% of
   phase 9's ``max_memory_allocated``; (c) one more phase-5 ``generate``
   counted by ``op_cost``, gate: its opaque DSLOT launches equal the launch
   counter (216); (d) the olmo-1b ``train_4k`` cell on the 16 x 16 fake
   world through the dry run's CLI in a subprocess: its record (with the
   peak's breakdown), roofline and summarize rows, gate: MODEL/op at least
   ``MODEL_OP_MIN`` (the step's compute split over the model axis); (e)
   the dry run of phase 11's (2, 1) timed program (``trace_cell`` on a
   fake world of 2 ranks, fake CPU tensors, in a subprocess), gate: its
   peak within 5% of rank 0's measured peak over that run's steps.  (b),
   (d) and (e) need no card: they start side by side as phase 11 starts
   and run beside it on the host's cores; phase 12 reads them last.

Phases 5, 6 and 8 also count the W splits (``dslot_split_parts``, once
per DSLOT layer while the layers are prepared), hold one split each in
phases 5 and 6 against its plain version bit for bit, check that it
allocates its parts alone (no cast) and, where its trace holds device
time, launches ``split_parts_kernel`` once, and time it, and
phases 6 and 8 check that the traced admission and decode forwards launch
no split.  Each phase's seconds are printed.

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel record (``dslot_matmul`` and ``dslot_split_parts``),
and the card's name and power limit are printed just before that.  The record's ``launches`` counts the kernel
launches of the driven paths (phase 3's CNN, phase 5's two ``generate``
runs, phase 6's timed engine run, phase 7's calibrate, sweep and B = 1024
forward, phase 8's hybrid engine run, and both ranks' timed runs of the
two split engines in phase 10); its times and bound are sums over the
seventeen main-path launches timed in phases 4-8 and 10 (CNN conv and
head; LM encoder, prefill and decode; engine decode and admission; trained
conv and head at B = 80 and B = 1024; hybrid decode and admission; the
two split engines' decode and admission shard launches).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
try:   # the H100's data-sheet rates at 700 W: HBM3 bytes/s, dense bf16 FLOP/s
    from repro_torch.launch.roofline import HBM_BW as PEAK_BYTES_PER_S
    from repro_torch.launch.roofline import PEAK_FLOPS as PEAK_BF16_FLOPS
except ImportError:
    print("chip_smoke: src/repro_torch not found beside this script; run it "
          "from a checkout of the repository", file=sys.stderr)
    raise SystemExit(1) from None
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside tensor cores, data sheet, 700 W
OUT_RTOL = 1e-5
MARGIN_RTOL = 1e-5
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/dslot_matmul.cu"
REPLACES = "src/repro/kernels/dslot_matmul.py:169"
# the source's kernels, as the profiler names them
DSLOT_KERNELS = ("plane_kernel", "product_kernel", "walk_kernel",
                 "band_kernel", "split_parts_kernel")
# W's bf16 parts (dslot_split_parts): launches while the driven paths
# prepared their layers (phases 5, 6 and 8), and the times of the splits
# held against the plain version
SPLIT = {"launches": 0, "times": []}


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
    timed: bool = False     # timed in phase 4 (as every "f32 normal n8" is)
    n_bits: int = 8
    mixed: bool = False     # q rows of one sign per vote tile, alternating
    bf16_held: bool = False  # f32 weights that bf16 holds (a bf16 model's)
    prepared: bool = False  # pass dslot_prepare's W parts to the kernel
    rows: int | None = None  # real rows; the rest are the wrapper's pad rows
    col_mixed: bool = False  # column tiles of alternating sign


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
        *repaired_tile_cases(),
        *band_cases(),
        *launcher_tile_cases(),
        *launcher_band_cases(),
        *split_warp_cases(),
    ]


# The band kernel's serving shapes (ReLU, signed 8-bit q, block_n 128, the
# MLP's prepared W parts): the engine's and the hybrid's admission with
# vote tiles of alternating sign ("mixed": the positive ones die at
# different planes, the negative ones never), dyadic (exact) and
# bf16-held normal weights (one part); row budgets; an N tile of plane
# bound 0; a 128-row tile with 44 real rows (the rest the wrapper's pad
# rows, whose products the band skips); and the decode band, whose N
# tiles split over 2-block clusters.
def band_cases() -> list[Case]:
    sig = dict(relu=True, signed=True, block_n=128, block_k=None,
               prepared=True, mixed=True)
    adm = dict(M=128, K=2048, N=8192, block_m=16, **sig)
    hyb = dict(M=256, K=2560, N=7680, block_m=16, **sig)
    dec = dict(M=16, K=2048, N=8192, block_m=16, **sig)
    return [
        Case("band engine adm mixed dyadic rows", weights="dyadic",
             precision="rows", **adm),
        Case("band engine adm mixed bf16-held normal n8", weights="normal",
             bf16_held=True, timed=True, **adm),
        Case("band engine adm mixed dyadic bound0", weights="dyadic",
             zero_tile=3, **adm),
        Case("band hybrid adm mixed dyadic n8", weights="dyadic", **hyb),
        Case("band hybrid adm mixed bf16-held normal rows", weights="normal",
             bf16_held=True, precision="rows", **hyb),
        Case("band hybrid adm mixed bf16-held normal n8", weights="normal",
             bf16_held=True, timed=True, **hyb),
        Case("band pad rows 44 of 128 dyadic n8", weights="dyadic",
             rows=44, **{**sig, "M": 128, "K": 1024, "N": 4096,
                         "block_m": 128}),
        Case("band decode cluster dyadic rows", weights="dyadic",
             precision="rows", **dec),
        Case("band decode cluster bf16-held normal n8", weights="normal",
             bf16_held=True, timed=True, **dec),
        Case("band mlp f32 normal n6 (3 parts)", weights="normal",
             precision=6, **{**sig, "M": 512, "K": 1024, "N": 1024,
                             "block_m": 64, "mixed": False}),
    ]


# Tiles the kernel once refused ("invalid argument"), each with ReLU on
# (the plane path) and off (the product path), f32 dyadic (exact), f32
# normal and bf16 normal weights.  128 x 24 and 512 x 8 need more than 16
# warps of (1, 1) warp tiles, and a column count that is not a multiple of
# 16 rules out (2, 2) and (4, 4); 1024 x 24 at K = 1024 also needs a 2-stage
# ring (3 stages would take 250 KB of shared memory, above the 227 KB a
# block may have); block_n 1 at N = 70000 and 64 at N = 64 * 65537 have
# more N tiles than grid.y holds (65535), the second also more product
# column tiles; 144 x 24 takes 160 physical rows (5 warps of 32 x 8 rows a
# column), more than block_m, and 256 x 66 pads to 256 x 72 and takes 9
# warps of 256 x 8.  The seamless MLP up at 2048 tokens and 171 tiles of 24
# columns is timed at 128 x 24 and at phase 10's 32 x 24.
REPAIRED_TILES = (
    ("bm=128 bn=24 K=1024", dict(M=512, K=1024, N=96, block_m=128,
                                 block_n=24, block_k=None)),
    ("bm=1024 bn=24 K=1024 2-stage ring",
     dict(M=2048, K=1024, N=48, block_m=1024, block_n=24, block_k=None)),
    ("bm=512 bn=8 K=25", dict(M=1024, K=25, N=16, block_m=512, block_n=8,
                              block_k=None)),
    ("bm=512 bn=8 K=1024", dict(M=1024, K=1024, N=16, block_m=512,
                                block_n=8, block_k=None)),
    ("bm=16 bn=1 N=70000", dict(M=32, K=64, N=70000, block_m=16, block_n=1,
                                block_k=None)),
    ("bm=16 bn=64 N=4194368", dict(M=16, K=16, N=64 * 65537, block_m=16,
                                   block_n=64, block_k=None)),
    ("bm=144 bn=24 K=256 rows past bm",
     dict(M=288, K=256, N=48, block_m=144, block_n=24, block_k=None)),
    ("bm=256 bn=66 K=64", dict(M=512, K=64, N=132, block_m=256, block_n=66,
                               block_k=None)),
)

# Tiles refused until walk_kernel and the (4, 4) 2-stage ring, each timed
# once (its "f32 normal n6" ReLU case), with the kernel its ReLU cases
# take.  16 x 256 at the olmo engine's admission shape needs 32 warps of
# (1, 1) and has no (2, 2) fit: the band kernel's 2-block clusters take it;
# 1024 x 136 needs 68 warps of 256 x 8, and its f32 sums (557 KB) fit no
# SM: a 16-block cluster_kernel takes it; 512 x 32 with int32 q (n_bits 20)
# overflows 3 ring stages of (4, 4) warp tiles (287 KB): cluster_kernel,
# 32-row slices of it over 16 blocks; block_m 2048 and 4096 at 8 and 24
# columns overflow even a 2-stage ring beside their digit tile:
# cluster_kernel.
WALKED_TILES = (
    ("bm=16 bn=256 K=2048", dict(M=128, K=2048, N=8192, block_m=16,
                                 block_n=256, block_k=None), "band_kernel"),
    ("bm=1024 bn=136 K=256", dict(M=2048, K=256, N=272, block_m=1024,
                                  block_n=136, block_k=128),
     "cluster_kernel"),
    ("bm=512 bn=32 K=256 n_bits=20",
     dict(M=1024, K=256, N=64, block_m=512, block_n=32, block_k=128,
          n_bits=20), "cluster_kernel"),
    ("bm=2048 bn=8 K=256", dict(M=4096, K=256, N=16, block_m=2048,
                                block_n=8, block_k=128), "cluster_kernel"),
    ("bm=2048 bn=24 K=256", dict(M=4096, K=256, N=48, block_m=2048,
                                 block_n=24, block_k=128), "cluster_kernel"),
    ("bm=4096 bn=8 K=256", dict(M=8192, K=256, N=16, block_m=4096,
                                block_n=8, block_k=128), "cluster_kernel"),
    ("bm=4096 bn=24 K=256", dict(M=8192, K=256, N=48, block_m=4096,
                                 block_n=24, block_k=128), "cluster_kernel"),
)
WALKED_KERNEL = {f"tile {label} ": kernel
                 for label, _, kernel in WALKED_TILES}

# The tiles the port's own launchers pass, timed at the olmo engine's
# admission shape with bf16-held weights and the prepared parts, with the
# kernel each takes: ``launch/serve.py --dslot`` (32 x 32),
# ``launch/serve_lm.py``'s DSLOT generation (16 x 16) and its SLO engine
# (16 x 32, block_k 16), on the band kernel (one vote per row tile and
# column tile).
LAUNCHER_TILES = (
    ("serve --dslot bm=32 bn=32", dict(block_m=32, block_n=32,
                                       block_k=None), "band_kernel"),
    ("serve_lm bm=16 bn=16", dict(block_m=16, block_n=16, block_k=None),
     "band_kernel"),
    ("serve_lm slo bm=16 bn=32 bk=16", dict(block_m=16, block_n=32,
                                            block_k=16), "band_kernel"),
)
LAUNCHER_KERNEL = {f"launcher {label} ": kernel
                   for label, _, kernel in LAUNCHER_TILES}


def launcher_tile_cases() -> list[Case]:
    return [Case(f"launcher {label} bf16-held normal n8", M=128, K=2048,
                 N=8192, relu=True, signed=True, weights="normal",
                 bf16_held=True, prepared=True, sort=True, timed=True,
                 **shape) for label, shape, _ in LAUNCHER_TILES]


# The launcher tiles' vote tiles one by one (``band_cases`` for them): row
# tiles and column tiles of alternating sign, so that the column tiles of
# one 128-column block stop at different planes; column tile 1 (inside the
# first block) of plane bound 0 and N = 1024 + block_n (a last block partly
# past N) on dyadic weights; bf16-held normal weights with row budgets at
# the engine's admission shape; f32 normal weights (three parts) at 6
# planes.
def launcher_band_cases() -> list[Case]:
    out = []
    for label, shape, _ in LAUNCHER_TILES:
        geo = dict(M=128, K=2048, relu=True, signed=True, prepared=True,
                   mixed=True, col_mixed=True, **shape)
        out += [Case(f"launcher {label} mixed dyadic n8 bound0 partial",
                     N=1024 + shape["block_n"], weights="dyadic",
                     zero_tile=1, **geo),
                Case(f"launcher {label} mixed bf16-held normal rows",
                     N=8192, weights="normal", bf16_held=True,
                     precision="rows", **geo),
                Case(f"launcher {label} mixed f32 normal n6 (3 parts)",
                     N=1024, weights="normal", precision=6, **geo)]
    return out


# The column tiles of 24, 40, 48 and 56 on the band kernel (block_n,
# block_m): a block holds the whole column tiles that fit in 128 columns,
# and each 8-column half of a warp votes for its own column tile.  Their
# ``band_cases``: row and column tiles of alternating sign, column tile 1
# of plane bound 0 and one column tile past 8 blocks (a partial last
# block) on dyadic weights; bf16-held normal weights with row budgets at
# the engine's admission shape; f32 normal weights (three parts) at 6
# planes.  The two timed seamless MLP up rows at 24 columns
# (``repaired_tile_cases``) take the same kernel.
SPLIT_WARP_TILES = ((24, 32), (40, 16), (48, 64), (56, 128))
SPLIT_KERNEL = {"mlp bm=128 bn=24 ": "band_kernel",
                "mlp bm=32 bn=24 ": "band_kernel",
                "split-warp ": "band_kernel"}


def split_warp_cases() -> list[Case]:
    out = []
    for bn, bm in SPLIT_WARP_TILES:
        geo = dict(M=128, K=2048, relu=True, signed=True, prepared=True,
                   mixed=True, col_mixed=True, block_m=bm, block_n=bn,
                   block_k=None)
        partial = bn * (8 * (128 // bn) + 1)
        label = f"split-warp bm={bm} bn={bn}"
        out += [Case(f"{label} mixed dyadic n8 bound0 partial", N=partial,
                     weights="dyadic", zero_tile=1, **geo),
                Case(f"{label} mixed bf16-held normal rows",
                     N=8192 // bn * bn, weights="normal", bf16_held=True,
                     precision="rows", **geo),
                Case(f"{label} mixed f32 normal n6 (3 parts)", N=partial,
                     weights="normal", precision=6, **geo)]
    return out


def walked_route(case: Case, q, w, bk: int) -> str | None:
    """The kernel a walked, launcher or split-warp tile's ReLU case took
    (``dm.route``), held against ``WALKED_KERNEL``, ``LAUNCHER_KERNEL`` and
    ``SPLIT_KERNEL``; None for the other cases."""
    from repro_torch.kernels import dslot_matmul as dm

    want = [k for label, k in {**WALKED_KERNEL, **LAUNCHER_KERNEL,
                               **SPLIT_KERNEL}.items()
            if case.name.startswith(label)]
    if not want or not case.relu:
        return None
    got = dm.route(q.shape[0], q.shape[1], w.shape[1], case.block_m,
                   case.block_n, bk, case.n_bits,
                   case.relu, q.dtype, w.dtype)
    if got == "walk_kernel":
        got += (" (its f32 sums exceed what a 16-block cluster holds, or "
                "a slice the shared memory)")
    if got != want[0]:
        raise AssertionError(f"{case.name}: took {got}, not {want[0]}")
    return got


def repaired_tile_cases() -> list[Case]:
    out = []
    walked = tuple((label, shape) for label, shape, _ in WALKED_TILES)
    for label, shape in REPAIRED_TILES + walked:
        timed = (label, shape) in walked
        for relu in (True, False):
            geo = dict(shape, relu=relu, signed=True)
            tag = "" if relu else " no-relu"
            out += [Case(f"tile {label} f32 dyadic rows{tag}",
                         weights="dyadic", precision="rows", **geo),
                    Case(f"tile {label} f32 normal n6{tag}",
                         weights="normal", precision=6,
                         timed=timed and relu, **geo),
                    Case(f"tile {label} bf16 normal n8{tag}",
                         weights="normal", wdtype=torch.bfloat16, **geo)]
    up = dict(M=2048, K=1024, N=171 * 24, block_n=24, block_k=None,
              relu=True, signed=True)
    return out + [
        Case("mlp bm=128 bn=24 f32 normal n8 repaired", weights="normal",
             block_m=128, timed=True, **up),
        Case("mlp bm=32 bn=24 (phase 10) f32 normal n8", weights="normal",
             block_m=32, timed=True, **up)]


def phase2(card, dev) -> tuple[float, dict]:
    """Every ``phase2_cases`` case through the kernel twice and the plain
    version once; returns the largest error and the times of the shapes
    timed (one case a shape)."""
    from repro_torch.kernels import dslot_matmul as dm

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
        took = walked_route(case, q, prep.w, prep.block_k)
        log(f"  {case.name}: max err {err:.3g}, planes_used mean "
            f"{float(a.planes_used.float().mean()):.3f} "
            f"(plain {float(b.planes_used.float().mean()):.3f}), "
            f"tiles {a.planes_used.numel()}"
            + (f", kernel {took}" if took else ""))
        if case.timed or case.name.endswith("f32 normal n8"):  # one a shape
            shape_times[case.name.split(" f32")[0]] = time_call(
                case.name, q, prep.w, kw, (case.rows or case.M, case.K,
                                           case.N),
                lambda: dm.dslot_matmul_cuda(q, prep.w, **kw),
                lambda: dm.dslot_matmul_plain(q, prep.w, **kw), card)
        del q, prep, kw, a, a2, b
        torch.cuda.empty_cache()
    return max_err, shape_times


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
    in [-20, 0], unshifted.  ``mixed`` makes the q rows of vote tile v
    negative for odd v and |q| scaled by 1, 1/8, 1/2, 1/4 in turn for even
    v; ``col_mixed`` shifts the columns of column tile j (of ``block_n``)
    by 6 standard deviations times -1 for odd j and 1, 1/8, 1/2, 1/4 in
    turn for even j; ``bf16_held`` rounds f32 weights to bf16 values; rows
    from ``case.rows`` on are zero (the wrapper's pad rows).
    """
    from repro_torch.kernels.dslot_matmul import q_storage_dtype

    g = torch.Generator().manual_seed(seed)
    if case.signed:  # n_bits > 8: the same law scaled to the wider range
        top = 2 ** (case.n_bits - 1) - 1
        q = ((torch.randn((case.M, case.K), generator=g) * 40 + 20)
             * (top / 127)).round()
        q = q.clamp(-top, top).to(q_storage_dtype(case.n_bits, True))
        mean, rms = 20.0 * top / 127, 44.7 * top / 127
    else:
        q = torch.randint(0, 256, (case.M, case.K), generator=g,
                          dtype=torch.uint8)
        mean, rms = 127.5, 147.2
    w = torch.randn((case.K, case.N), generator=g) * case.K ** -0.5
    z = torch.full((case.N,), 3.3) if case.N <= 16 \
        else torch.linspace(0.0, 6.0, case.N)
    if case.col_mixed:
        tile = torch.arange(case.N) // case.block_n
        z = 6.0 * torch.where(
            tile % 2 == 1, -1.0,
            torch.tensor([1.0, 0.125, 0.5, 0.25])[(tile // 2) % 4])
    if case.weights == "wide":
        u = torch.rand((case.K, case.N), generator=g) * -20.0
        w = torch.sign(w) * torch.exp2(u)
    else:
        w = w - z * rms / (case.K * mean)
    if case.weights == "dyadic":
        w = (w * 64).round().clamp(-64, 64) / 64
    elif case.weights == "inert":
        w = -w.abs()
    if case.bf16_held:
        w = w.to(torch.bfloat16).to(torch.float32)
    if case.mixed:
        tile = torch.arange(case.M) // case.block_m
        scale = torch.tensor([1.0, 0.125, 0.5, 0.25])[(tile // 2) % 4]
        mag = q.to(torch.int32).abs()
        q = torch.where((tile % 2 == 1)[:, None], -mag,
                        (mag * scale[:, None]).round().to(torch.int32))
        q = q.to(q_storage_dtype(case.n_bits, True))
    if case.rows is not None:
        q[case.rows:] = 0
    return q, w.to(case.wdtype)


def run_case(case: Case, seed: int, dev: torch.device):
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.kernels.ops import dslot_prepare

    q, w = make_inputs(case, seed)
    prep = dslot_prepare(w.to(dev), n_bits=case.n_bits, relu=case.relu,
                         signed=case.signed,
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
    kw = dict(n_bits=case.n_bits, relu=case.relu, block_m=case.block_m,
              block_n=case.block_n, block_k=prep.block_k, n_planes_rt=npl,
              row_budget=budget, suffix_colsum=prep.suffix_colsum,
              total_colsum=prep.total_colsum, plane_bound=bound)
    if case.prepared:
        if prep.parts is None:
            raise AssertionError(f"{case.name}: dslot_prepare built no parts")
        kw["parts"] = prep.parts
    if case.rows is not None:
        kw["rows"] = case.rows
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
                row_budget=args[11], plane_bound=args[12],
                parts=args[13] if len(args) > 13 else None,
                rows=args[14] if len(args) > 14 else None)


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


def count_splits(label, fn, expected: int):
    """``fn()`` with the W-split launches counted from 0: each prepared
    DSLOT layer splits its W once, so ``expected`` (its DSLOT layers)."""
    from repro_torch.kernels import dslot_matmul as dm

    dm.split_parts.launches = 0
    out = fn()
    n = dm.split_parts.launches
    if n != expected:
        raise AssertionError(f"{label}: {n} W splits, expected {expected}")
    SPLIT["launches"] += n
    log(f"  {label}: {n} W splits (dslot_split_parts), one per DSLOT layer")
    return out


def hold_split(label, args, card) -> None:
    """The W split of one prepared layer (``dm.run``'s arguments ``args``:
    its padded W and the parts ``dslot_prepare`` stored), held against the
    plain version bit for bit; one call must allocate only its parts (a
    cast before the kernel would allocate its copy of W) and, where its
    trace holds device time (a trace of one short kernel in this long
    process has come back empty), launch ``split_parts_kernel`` once and
    no other kernel; then timed as in phase 4: kernel (eager and from a
    graph), plain version and ``Tensor.to(torch.bfloat16)``, which computes
    the same function where one part of 128-column tiles is the bf16
    weights themselves, beside its bound: W read once and the parts
    written once over 3.35 TB/s."""
    from repro_torch.kernels import dslot_matmul as dm

    w, bn, parts = args[1], args[6], args[13]
    n = parts.shape[0]
    want = dm.split_parts_plain(w, bn, n)
    got = dm.split_parts(w, bn, n)
    torch.cuda.synchronize()
    if not (torch.equal(got, want) and torch.equal(parts, want)):
        raise AssertionError(f"{label}: W's parts differ from the plain "
                             f"version")
    stat = "allocation.all.allocated"
    before = torch.cuda.memory_stats()[stat]
    dm.split_parts(w, bn, n)
    allocs = torch.cuda.memory_stats()[stat] - before
    if allocs != 1:
        raise AssertionError(f"{label}: one split allocated {allocs} "
                             f"tensors, not its parts alone")
    trace = traced(lambda: dm.split_parts(w, bn, n))[1]
    if trace is None:
        log(f"  {label}: one split allocates its parts alone; its kernels "
            f"not measured (no device time in the trace)")
    elif [(r[1], "split_parts_kernel" in r[2]) for r in trace[1]] \
            != [(1, True)]:
        raise AssertionError(f"{label}: one split launched "
                             f"{[(r[1], r[2]) for r in trace[1]]}, not "
                             f"split_parts_kernel alone")
    else:
        log(f"  {label}: one split allocates its parts alone and is one "
            f"launch of split_parts_kernel")
    k_ms = cuda_ms(lambda: dm.split_parts(w, bn, n))
    k_graph = graph_ms(lambda: dm.split_parts(w, bn, n))
    p_ms = cuda_ms(lambda: dm.split_parts_plain(w, bn, n), reps=3, warm=1)
    lib_ms = cuda_ms(lambda: w.to(torch.bfloat16)) \
        if n == 1 and bn % 128 == 0 else None
    nbytes = w.numel() * w.element_size() + parts.numel() * 2
    b_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    log(f"  {label}: W {tuple(w.shape)} {w.dtype} -> {n} part(s) "
        f"{tuple(parts.shape)}, equal to the plain version; kernel "
        f"{k_ms:.4f} ms (graph {k_graph:.4f}), plain {p_ms:.4f} ms, "
        f"Tensor.to(bfloat16) "
        f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
        f"{b_ms:.4g} ms (bytes; {nbytes / 1e6:.2f} MB) [{card}]")
    SPLIT["times"].append({"ms": k_ms, "graph_ms": k_graph, "plain_ms": p_ms,
                           "library_ms": lib_ms, "bound_ms": b_ms})


def no_split_in(label, trace) -> None:
    """A traced engine forward must launch no W split: its layers' parts
    were built once, when the engine prepared them."""
    if trace is None:
        log(f"  {label}: W splits in the trace not measured (no device "
            f"time in the trace)")
        return
    if any("split_parts_kernel" in r[2] for r in trace[1]):
        raise AssertionError(f"{label}: the traced forward launched "
                             f"split_parts_kernel")
    log(f"  {label}: no split_parts_kernel in the traced forward")


def bound_ms(q, w, kw, used, dims) -> tuple[float, str, float, float]:
    """Least time for the call on an H100 SXM at 700 W: bytes moved once
    over 3.35 TB/s against the bf16 tensor-core flops this run's data needs
    over 989 TFLOP/s (``bf16_parts``: 3 bf16 products per product with
    f32 weights, 1 with weights that bf16 holds exactly).  Returns (bound
    ms, what bounds it, bytes, f32 flops).

    ``dims`` is the unpadded (M, K, N), and both terms count only real
    rows, columns and K: bytes are q (M, K), W (K, N) at 2 bytes a weight
    where bf16 holds every weight and 4 otherwise (whatever its storage:
    a kernel that reads prepared bf16 parts needs no more), the f32 out
    (M, N),
    the termination tables, ``planes_used`` per tile and the M row budgets,
    not the pad rows and columns the wrapper adds for its tiles.  A ReLU
    tile needs its partial sum after every plane it entered (the
    termination check reads it), so it costs ``planes_used`` products of
    its rows and columns; a tile without ReLU needs one product of the
    truncated q, and none when it entered no plane.
    """
    M, K, N = dims
    w_bytes = 2 if bf16_parts(w) == 1 else 4
    nbytes = (M * K * q.element_size() + K * N * w_bytes
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


# The serving rows of the band kernel (rows, K, N, block_m; block_n 128):
# the shapes of phases 5, 6, 8 and 10's launches, timed here side by side
# on seeded inputs through ``dslot_prepare`` / ``dslot_execute``.
SERVING_ROWS = (
    ("engine admission", 128, 2048, 8192, 16),
    ("hybrid admission", 256, 2560, 7680, 16),
    ("hybrid tp2 admission shard", 256, 2560, 3840, 16),
    ("tp2 admission shard", 128, 2048, 4096, 16),
    ("LM encoder", 32, 1024, 4096, 128),
    ("LM decode", 4, 1024, 4096, 128),
    ("tp2 decode shard", 16, 2048, 4096, 16),
    ("hybrid tp2 decode shard", 16, 2560, 3840, 16),
    ("engine decode", 16, 2048, 8192, 16),
    ("hybrid decode", 16, 2560, 7680, 16),
    ("LM prefill", 4160, 1024, 4096, 128))
# ``launch/serve.py --dslot``'s own shapes (seamless-m4t-medium at its 32 x
# 32 tiles): rows, K, N, block_m, block_n
LAUNCHER_ROWS = (
    ("serve --dslot LM prefill", 4160, 1024, 4096, 32, 32),
    ("serve --dslot LM decode", 4, 1024, 4096, 32, 32))


def serving_rows(card, dev) -> None:
    """Each ``SERVING_ROWS`` shape (block_n 128), then each
    ``LAUNCHER_ROWS`` one: bf16-held weights (a bf16 model's, widened to
    f32, as ``prepare_mlp_dslot`` prepares them: one part), N(0, K^-1/2)
    shifted down by a ramp of 0 to 3 standard deviations across N, and
    N(0.2, 1) activations, through the MLP's ``dslot_execute``; its launch
    held against the plain version by phase 2's rule and timed as every
    phase-4 shape (eager and from a graph, beside torch.matmul and the
    bound)."""
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.kernels.ops import dslot_execute, dslot_prepare

    g = torch.Generator().manual_seed(25)
    rows_all = [(*r, 128) for r in SERVING_ROWS] + list(LAUNCHER_ROWS)
    for label, rows, K, N, bm, bn in rows_all:
        w = torch.randn((K, N), generator=g) * K ** -0.5
        w = (w - torch.linspace(0.0, 3.0, N) * K ** -0.5).to(torch.bfloat16)
        x = torch.randn((rows, K), generator=g) + 0.2
        prep = dslot_prepare(w.to(dev, torch.float32), n_bits=8, relu=True,
                             signed=True, sort_columns=True, block_m=bm,
                             block_n=bn)
        with Captured(dm) as cap:
            dslot_execute(prep, x.to(dev))
        args = cap.calls[0][0]
        q, kw = args[0], kernel_kw(args)
        a = dm.DslotMatmulOut(*dm._launch(*args))
        b = dm.DslotMatmulOut(*dm._replay(*args))
        torch.cuda.synchronize()
        compare(label, a, b, False, q, args[1], kw)
        log(f"  {label}: planes_used mean "
            f"{float(a.planes_used.float().mean()):.4f} over "
            f"{a.planes_used.numel()} tiles")
        time_call(f"{label} ({rows}, {K}) @ ({K}, {N}), block_m {bm}"
                  + ("" if bn == 128 else f", block_n {bn}"), q,
                  args[1], kw, (rows, K, N), lambda a=args: dm._launch(*a),
                  lambda a=args: dm._replay(*a), card)
        del w, x, prep, cap, args, q, kw, a, b
        torch.cuda.empty_cache()


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


def launcher_generate(cfg, model, params, batch, results, npl8, expected,
                      gen_ms, dev) -> int:
    """``generate`` on the same model and weights at ``launch/serve.py
    --dslot``'s ``DslotConfig`` (32 x 32 tiles, the band kernel's column-tile
    votes): its launches (``expected``, counted from 0), tokens in range,
    the token agreement with the 128 x 128 run (printed), and its tokens/s
    beside that run's.  Returns its launches."""
    from repro_torch.configs.base import DslotConfig
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve.engine import generate

    dcfg = DslotConfig(enabled=True, n_planes=8, block_m=32, block_n=32)
    m32 = build_model(dataclasses.replace(cfg, dslot=dcfg))
    p32 = count_splits("prepare_dslot at 32 x 32",
                       lambda: m32.prepare_dslot(params),
                       cfg.encoder_layers + cfg.n_layers)
    dm.dslot_matmul_cuda.launches = 0
    res = generate(m32, p32, batch, LM_NEW, n_planes=npl8)
    torch.cuda.synchronize()
    n = dm.dslot_matmul_cuda.launches
    if n != expected:
        raise AssertionError(f"generate at 32 x 32 launched the kernel {n} "
                             f"times, expected {expected}")
    toks = res.tokens
    if toks.shape != (LM_BATCH, LM_NEW) or not bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"32 x 32: tokens {tuple(toks.shape)} out of "
                             f"[0, {cfg.vocab_size})")
    agree = float((toks == results["n_planes=8"].tokens).float().mean())
    ms, all_ms = median_ms(lambda: generate(m32, p32, batch, LM_NEW,
                                            n_planes=npl8))
    log(f"  generate at launch/serve.py --dslot's {dcfg.block_m} x "
        f"{dcfg.block_n}: {n} kernel launches, median {ms:.2f} ms "
        f"({LM_BATCH * LM_NEW / ms * 1e3:.1f} tokens/s) of "
        f"{[round(t, 2) for t in all_ms]}, against {gen_ms:.2f} ms "
        f"({LM_BATCH * LM_NEW / gen_ms * 1e3:.1f} tokens/s) at 128 x 128; "
        f"tokens agree with the 128 x 128 run {agree:.4f}; planes_used_mean "
        f"{[round(float(v), 4) for v in res.planes_used_mean]}")
    del m32, p32
    return n


def phase5(card, dev):
    """The LM serving path: ``generate`` on full-width seamless-m4t-medium.
    Returns (kernel launches in the driven runs, max abs error, the three
    kernel shapes' times, a third generate counted by ``op_cost`` for phase
    12 (c))."""
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.runtime import precision_scope
    from repro_torch.serve.engine import generate

    from repro_torch.configs.registry import get_arch

    lm = get_arch(LM_ARCH)
    cfg, model, params, prep, dense, batch = count_splits(
        "prepare_dslot", lambda: lm_setup(dev),
        lm.encoder_layers + lm.n_layers)
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
    # phase 12 (c): one more generate under op_cost, its launches counted
    # both ways
    from repro_torch.launch.op_cost import OpCost
    dm.dslot_matmul_cuda.launches = 0
    with OpCost() as cost:
        generate(model, prep, batch, LM_NEW, n_planes=8)
    torch.cuda.synchronize()
    counted = {"launches": dm.dslot_matmul_cuda.launches,
               "totals": cost.totals(), "expected": expected}
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
    hold_split("LM layer W split", shapes[0][1], card)
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
    launches += launcher_generate(cfg, model, params, batch, results, npl8,
                                  expected, gen_ms, dev)

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
        kern = sum(r[0] for r in rows if any(k in r[2]
                                             for k in DSLOT_KERNELS))
        log(f"  {label} device time (torch.profiler): {dev_ms:.3f} ms, idle "
            f"share {1 - dev_ms / wall:.3f} of the median "
            f"{wall:.3f} ms; dslot kernels {kern:.3f} ms; top kernels:")
        for ms, count, key in rows[:8]:
            log(f"    {ms:.4f} ms x{count} {key[:90]}")
    log(f"  peak memory in the generate runs: {peak_gb:.2f} GB [{card}]")
    return launches, max_err, times, counted


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
                    tier=s["tier"], n_planes=s.get("n_planes"))
            for s in specs]
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
    kern = sum(r[0] for r in rows if any(k in r[2] for k in DSLOT_KERNELS))
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
    for label, trace in traces.items():
        no_split_in(label, trace)
    t1 = time.perf_counter()
    eng = count_splits("engine (prepare_dslot)",
                       lambda: ServeEngine(model, params, scfg),
                       cfg.n_layers)
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
    hold_split("engine layer W split",
               captured[ENGINE_KERNEL_ROWS["engine admission launch"]], card)
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
    eng = count_splits("engine (prepare_dslot)",
                       lambda: ServeEngine(model, params, scfg),
                       cfg.n_layers)
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
        no_split_in(label, timed.trace)
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


def counted_step(step, state, batch, dev) -> dict:
    """One more step of ``step`` under ``launch.op_cost.OpCost`` (phase 12
    (a)): its totals and wall.  The step updates ``state`` in place."""
    from repro_torch.launch.op_cost import OpCost

    sync(dev)
    t0 = time.perf_counter()
    with OpCost() as cost:
        step(state, batch)
    sync(dev)
    return {"totals": cost.totals(),
            "wall_ms": (time.perf_counter() - t0) * 1e3}


def phase9(card, dev) -> dict:
    """Training at full published width and depth (see the module
    docstring): gates (a)-(e) and the step's figures.  Returns the timed
    steps' tokens/s (``tps``), median wall, model-FLOPs share, parameters,
    tokens a step and peak memory, and the step counted by ``op_cost``
    after the timed steps (``counted``, for phase 12)."""
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
        counted = counted_step(step, state, batch, dev)
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
    return {"tps": tokens / (med / 1e3), "wall_ms": med, "mfu": mfu,
            "n_params": n_params, "tokens": tokens, "peak": peak,
            "counted": counted}


# ------------------------------------------------------------ phase 10

TP_RANKS = 2                    # ranks sharing one card
TP_DEVICE = "cuda:0"
TP_BACKEND = "gloo"             # NCCL refuses two ranks on one device
TP_TIMEOUT = 300                # seconds a collective may wait for a peer
TP_DEADLINE = 900               # seconds the whole world may take
TP_REQUESTS = 8                 # a cut that keeps the script in its limit
TP_BUDGETS = (8, 6, 5, 4)       # per-request planes of non-reserved requests
TP_KERNEL_ROWS = {"tp2 decode shard launch": ENGINE_SLOTS,
                  "tp2 admission shard launch": ENGINE_LANES * ENGINE_CHUNK}
EP_ARCH, EP_BATCH, EP_SEQ = "granite-moe-1b-a400m", 4, 2048
EP_Y_ATOL, EP_AUX_ATOL = 2e-3, 1e-3     # the reference test's bounds
# Gate (b) of the split: rank 0's decode forward against the unsharded one,
# in op_cost's dot FLOPs.  Over (1, 2) at 16 rows and 512 slots the split
# halves wq/wk/wv/wo, the attention (every head against half the slots) and
# the tied head; the DSLOT up-projection is opaque to op_cost and its
# down-projection stays whole (the sharded DSLOT up-projection gathers its
# output): 941.9 of 1346.9 MFLOP a row, 0.699; the bound stays below the
# 0.712 that taking the attention scores twice would count.
SV_SPLIT_FLOPS = 0.705
# Gate (b)'s streams are held on an f32 copy of the model with its dense
# ReLU MLP (the bf16 weights cast up, no DSLOT quantizer): the split sums
# the same products in another order than one device, which in f32 moves a
# value by ~1e-7 of itself.  The DSLOT MLP's 8-bit quantizer turns such a
# difference into a whole step wherever an input lies that close to a step
# boundary, and that moves the logits as a bf16 rounding does (on an H100
# 80GB HBM3 at 700 W the f32 copy with the DSLOT MLP parted at a margin of
# 0.0041, the dense one not at all).  A stream that parts is accepted
# only where the unsharded run's top-2 margin at the first differing token
# is within SV_LOGIT_REL of the row's largest |logit|:
# tests/test_torch_serve_split.py's f32 bound REL, which each sampled row's
# two largest logits must keep as well.  The bf16 DSLOT run is
# timed and launches the kernel; its partings are counted, beside those of
# one device walking the admission's keys in SV_WITNESS_CHUNK chunks (the
# same function in another order).
SV_LOGIT_REL = 1e-5
SV_WITNESS_CHUNK = 128
# The hybrid split engine: phase 8's recurrentgemma-2b with ReLU, non-GLU
# DSLOT MLPs over (1, 2): its RG-LRU width 2560 and its 10 heads split in
# two ("group": one kv head), its 2048-slot local-attention ring 1024
# slots a rank.  HS_REQUESTS seeded requests, one prompt longer than the
# window (the split ring's carry window).  Rank 0's decode forward against
# the unsharded one in op_cost's dot FLOPs, a row a token at 16 rows: the
# RG-LRU mixers' products (5 x 2560^2 x 2 a layer), the attention's and
# the tied head (2 x 2560 x 256000) halve; the DSLOT up-projection is
# opaque and its down-projection (7680 x 2560 x 2) stays whole: ~0.64,
# where mixers left whole give ~0.79.
HS_REQUESTS, HS_PROMPT, HS_LONG_PROMPT = 8, 512, 2348
HS_MAX_LEN = 2560
HS_KERNEL_ROWS = {"hybrid tp2 decode shard launch": HYBRID_SLOTS,
                  "hybrid tp2 admission shard launch":
                  HYBRID_LANES * HYBRID_CHUNK}
HS_SPLIT_FLOPS = 0.70
TP_ENGINES = ("olmo", "hybrid")
CM_SHAPE = (4096, 2048, 8192)   # olmo's up-projection width: (S, K) @ (K, N)
CM_RTOL = 1e-5                  # of the largest |y|


def tp_cases() -> list[Case]:
    """Phase 2's shapes with ReLU for the sharded execute, among them
    seamless's MLP up at 2048 tokens with ``block_n`` 24 (Nt = 171, odd:
    one pad tile of bound 0) at ``block_m`` 32 and 128, and the CNN conv
    (Nt = 1: rank 1 holds only a pad tile) at ``block_m`` 128 and 512;
    then three without ReLU, which take the kernel's product path."""
    B = 1024
    conv = dict(M=B * 576, K=25, N=8, block_m=128, block_n=8, block_k=None,
                relu=True, signed=False)
    head = dict(M=B, K=1152, N=10, block_m=128, block_n=8, block_k=None,
                relu=False, signed=False)
    mlp = dict(M=2048, K=1024, N=4096, block_m=128, block_n=128,
               relu=True, signed=True, sort=True)
    bn24 = {**mlp, "block_m": 32, "block_n": 24, "block_k": None,
            "sort": False}
    return [
        Case("conv f32 normal n8", weights="normal", **conv),
        Case("conv bf16 normal n3", weights="normal", wdtype=torch.bfloat16,
             precision=3, **conv),
        Case("mlp bk=auto f32 normal n8", weights="normal", block_k=None,
             **mlp),
        Case("mlp bk=auto bf16 normal n3", weights="normal", block_k=None,
             wdtype=torch.bfloat16, precision=3, **mlp),
        Case("mlp bk=256 f32 normal rows unsorted", weights="normal",
             block_k=256, precision="rows", **{**mlp, "sort": False}),
        Case("mlp bn=24 f32 dyadic rows", weights="dyadic", precision="rows",
             **bn24),
        Case("mlp bn=24 bf16 normal n8 sorted", weights="normal",
             wdtype=torch.bfloat16, **{**bn24, "sort": True}),
        # tiles the kernel once refused: 128 x 24, and 512 x 8 at the conv
        Case("mlp bm=128 bn=24 f32 dyadic rows", weights="dyadic",
             precision="rows", **{**bn24, "block_m": 128}),
        Case("conv bm=512 f32 normal n8", weights="normal",
             **{**conv, "block_m": 512}),
        Case("mlp bm=256 bn=32 f32 dyadic rows", weights="dyadic",
             precision="rows",
             **{**mlp, "M": 512, "N": 128, "block_m": 256, "block_n": 32,
                "block_k": 256, "sort": False}),
        Case("head f32 normal n8 no-relu", weights="normal", **head),
        Case("mlp bk=256 f32 normal n8 no-relu", weights="normal",
             block_k=256, **{**mlp, "relu": False}),
        # the engine's decode shape: 128 tiles of 64 columns, 64 a shard,
        # both fewer than the SMs, so the two split K differently
        Case("decode f32 normal n8 no-relu", weights="normal",
             **{**mlp, "M": 16, "K": 2048, "N": 8192, "block_m": 16,
                "block_k": None, "relu": False, "sort": False}),
    ]


STAT_FIELDS = ("planes_used", "planes_bounded", "row_planes_used")


def bit_equal(a, b) -> dict:
    """Which of ``dslot_execute``'s results are equal bit for bit."""
    (ya, sa), (yb, sb) = a, b
    eq = {"out": torch.equal(ya, yb),
          "skipped_frac": torch.equal(sa.skipped_frac, sb.skipped_frac)}
    eq.update({f: torch.equal(getattr(sa, f), getattr(sb, f))
               for f in STAT_FIELDS})
    return eq


def tp_execute(rank, mesh, dev) -> float:
    """Gate (a): every case through ``dslot_execute``, sharded over the
    mesh and unsharded, on this card.  Activations are the case's q as
    floats with a calibrated step of 1, so both quantize to q exactly.
    Returns the largest error of this rank's launches against the plain
    version."""
    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.kernels.ops import dslot_execute, dslot_prepare

    max_err = 0.0
    for n, case in enumerate(tp_cases()):
        q, w = make_inputs(case, seed=300 + n)
        x, w = q.to(dev, torch.float32), w.to(dev)
        kw = dict(relu=case.relu, signed=case.signed,
                  sort_columns=case.sort, block_m=case.block_m,
                  block_n=case.block_n, block_k=case.block_k, x_scale=1.0)
        npl = case.precision
        if npl == "rows":
            npl = torch.randint(1, 9, (case.M,), dtype=torch.int32,
                                generator=torch.Generator().manual_seed(
                                    400 + n)).to(dev)
        whole = dslot_execute(dslot_prepare(w, **kw), x, n_planes=npl)
        prep = dslot_prepare(w, mesh=mesh, **kw)
        with Captured(dm) as cap:
            mine = dslot_execute(prep, x, n_planes=npl)
        torch.cuda.synchronize()
        (args, res), = cap.calls
        a = dm.DslotMatmulOut(*res)
        b = dm.DslotMatmulOut(*dm._replay(*args))
        torch.cuda.synchronize()
        err = compare(f"[rank {rank}] {case.name} shard", a, b,
                      case.weights == "dyadic", args[0], args[1],
                      kernel_kw(args))
        max_err = max(max_err, err)
        eq = bit_equal(mine, whole)
        Nt = -(-case.N // case.block_n)
        per = args[1].shape[1] // case.block_n
        line = (f"  [rank {rank}] {case.name}: Nt {Nt} -> {per} tiles a "
                f"rank ({per * TP_RANKS - Nt} pad); sharded vs unsharded "
                f"equal: "
                f"{' '.join(k for k, v in eq.items() if v)}"
                f"{'' if all(eq.values()) else '; differ: '}"
                f"{' '.join(k for k, v in eq.items() if not v)}; this "
                f"rank's launch vs plain max err {err:.3g}")
        if all(eq.values()):
            if rank == 0:
                log(line)
            continue
        log(line)
        if case.relu:
            raise AssertionError(f"{case.name}: the sharded execute differs "
                                 f"from the unsharded one under ReLU")
        # the product path picks its K split from the launch's tile count
        # (module docstring): outputs by phase 2's rule, planes equal
        mine_out, whole_out = mine[0], whole[0]
        tol = OUT_RTOL * whole_out.abs() + OUT_RTOL * float(
            whole_out.abs().max())
        if not (bool(((mine_out - whole_out).abs() <= tol).all())
                and all(eq[f] for f in STAT_FIELDS)):
            raise AssertionError(f"{case.name}: sharded product path "
                                 f"outside phase 2's rule")
        log(f"  [rank {rank}] {case.name}: held by phase 2's rule, max "
            f"|sharded - unsharded| "
            f"{float((mine_out - whole_out).abs().max()):.3g}")
    return max_err


class GatherTimes:
    """Stands in for ``ops.all_gather``: each call synchronized before and
    after and timed on the host, by the gathered tensor's rows and type,
    with a running total.  A gather of card tensors under gloo waits for
    the device anyway (it copies them to the host), so the synchronization
    adds little to the forward around it."""

    def __init__(self, ops):
        self.ops, self.fn, self.ms, self.total = ops, ops.all_gather, {}, 0.0

    def __enter__(self):
        self.ops.all_gather = self
        return self

    def __exit__(self, *exc):
        self.ops.all_gather = self.fn

    def __call__(self, t, mesh, axis, dim):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(t, mesh, axis, dim)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        self.ms.setdefault((t.shape[0], str(t.dtype)[6:]), []).append(ms)
        self.total += ms
        return out


class GatheredIn:
    """Wraps one engine forward: the milliseconds of ``gathers`` spent
    inside each of its calls, in call order."""

    def __init__(self, fn, gathers: GatherTimes):
        self.fn, self.gathers, self.ms = fn, gathers, []

    def __call__(self, *args):
        t0 = self.gathers.total
        out = self.fn(*args)
        self.ms.append(self.gathers.total - t0)
        return out


def tp_traffic(which: str, cfg) -> list[dict]:
    """The split engine ``which``'s traffic, a plane budget from
    ``TP_BUDGETS`` on every request outside the reserved tier: for
    "olmo", phase 6's rule for ``TP_REQUESTS`` requests (its own seed); for
    "hybrid", ``HS_REQUESTS`` requests with prompts of 16 to ``HS_PROMPT``
    tokens, one of ``HS_LONG_PROMPT`` (past the window), and 8-16 new
    tokens, tiers 1 : 2 : 1."""
    import numpy as np

    if which == "olmo":
        specs = engine_traffic(TP_REQUESTS, cfg.vocab_size, seed=10)
    else:
        rng = np.random.default_rng(12)
        tiers = rng.permutation(["reserved", "standard", "standard",
                                 "degradable"] * (HS_REQUESTS // 4))
        lens = rng.integers(16, HS_PROMPT + 1, HS_REQUESTS)
        lens[1] = HS_LONG_PROMPT
        specs = [dict(uid=i, tier=str(tiers[i]),
                      prompt=rng.integers(0, cfg.vocab_size, int(lens[i]))
                      .astype(np.int32), max_new=int(rng.integers(8, 17)))
                 for i in range(HS_REQUESTS)]
    rng = np.random.default_rng(11)
    for s in specs:
        if s["tier"] != "reserved":
            s["n_planes"] = int(rng.choice(TP_BUDGETS))
    return specs


def tp_base(which: str, dev):
    """The split engine ``which``'s model without DSLOT -- "olmo": phase
    6's olmo-1b, "hybrid": phase 8's recurrentgemma-2b, each with a ReLU,
    non-GLU MLP: its config, the dense model and its weights from seed
    0."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model_zoo import build_model

    arch = ENGINE_ARCH if which == "olmo" else HYBRID_ARCH
    base = dataclasses.replace(get_arch(arch), act="relu", glu=False)
    dense = build_model(base)
    return base, dense, dense.init(torch.Generator(dev).manual_seed(0),
                                   device=dev)


def tp_engine_model(which: str, base, scale):
    """The split engine ``which``'s DSLOT model (the kernel at ``block_m``
    16, act_scale ``scale``) and serving config: phase 6's for "olmo",
    phase 8's slots, chunk and lanes at ``HS_MAX_LEN`` for "hybrid"."""
    from repro_torch.configs.base import DslotConfig
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serve import ServeConfig, SloConfig

    if which == "olmo":
        geo = (ENGINE_SLOTS, ENGINE_MAX_LEN, ENGINE_CHUNK, ENGINE_LANES)
    else:
        geo = (HYBRID_SLOTS, HS_MAX_LEN, HYBRID_CHUNK, HYBRID_LANES)
    cfg = dataclasses.replace(base, dslot=DslotConfig(
        enabled=True, block_m=geo[0], block_n=128, block_k=None,
        act_scale=scale))
    scfg = ServeConfig(n_slots=geo[0], max_len=geo[1], prefill_chunk=geo[2],
                       chunks_per_step=geo[3], slo=SloConfig(**ENGINE_SLO))
    return cfg, build_model(cfg), scfg


def recurrent_bytes(state) -> int:
    """The bytes of a decode state's recurrent states (``SSMState``,
    ``RGLRUState``)."""
    from repro_torch.models.rglru import RGLRUState
    from repro_torch.models.ssm import SSMState

    return sum(t.numel() * t.element_size() for node in state["caches"]
               if isinstance(node, (SSMState, RGLRUState)) for t in node)


def streams(run) -> list:
    return [(list(map(int, r.out)), r.result.planes_used_mean)
            for r in run["reqs"]]


class Margins:
    """Stands in for an engine's ``sample``: records, for every token each
    request samples (admission first, then pooled decode steps), the row's
    two largest logits and its largest |logit|, in stream order."""

    def __init__(self, eng):
        self.eng, self.fn, self.rows, self.pending = eng, eng.sample, [], []
        tick = eng.pipeline.tick

        def counted_tick(free_slot):
            done = tick(free_slot)
            self.pending.extend(t.req.uid for t in done)
            return done
        eng.pipeline.tick = counted_tick
        eng.sample = self

    def __call__(self, logits):
        lg = logits.float()
        top = torch.cat([lg.topk(2, dim=-1).values,
                         lg.abs().amax(dim=-1, keepdim=True)], dim=-1)
        if logits.shape[0] == 1 and self.pending:       # an admission
            uids = [self.pending.pop(0)]
        else:
            uids = [None if r is None else r.uid for r in self.eng.slot_req]
        self.rows.append((uids, top))
        return self.fn(logits)

    def by_uid(self) -> dict:
        """uid -> [(top-2 margin over the largest |logit|, largest logit,
        second logit, largest |logit|)] in stream order."""
        out: dict = {}
        for uids, top in self.rows:
            for u, (a, b, big) in zip(uids, top.tolist()):
                if u is not None:
                    out.setdefault(u, []).append(((a - b) / big, a, b, big))
        return out


def ring_slots(state) -> list:
    """(class name, slots) of every KV ring of a decode state."""
    from repro_torch.models.attention import KVCache

    found = []

    def walk(node):
        if isinstance(node, KVCache):
            found.append((type(node).__name__, int(node.k.shape[1])))
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
    walk(state["caches"])
    return found


def split_partings(specs, got, plain) -> tuple[list, list]:
    """Where the streams in ``got`` leave the unsharded run's: (uid, first
    differing token, the unsharded run's top-2 margin there) of every
    request whose stream differs, and the uids of those whose stream is
    equal but whose ``planes_used_mean`` is not."""
    parted, planes = [], []
    for spec, (toks, pm), (ref, rm) in zip(specs, got, plain["streams"]):
        if toks == ref:
            if pm != rm:
                planes.append(spec["uid"])
            continue
        j = next((i for i, (a, b) in enumerate(zip(toks, ref)) if a != b),
                 min(len(toks), len(ref)))
        seen = plain["margins"].get(spec["uid"], [])
        parted.append((spec["uid"], j, seen[j][0] if j < len(seen)
                       else float("inf")))
    return parted, planes


def logit_drift(specs, got, plain) -> tuple[float, int | None]:
    """The largest difference, over the requests whose streams in ``got``
    equal the unsharded run's (so every forward saw the same tokens), of a
    sampled row's two largest logits from the unsharded row's, over that
    row's largest |logit|; and the request it came from."""
    worst, at = 0.0, None
    for spec, (toks, _), (ref, _) in zip(specs, got["streams"],
                                         plain["streams"]):
        if toks != ref:
            continue
        for (_, a, b, _), (_, ra, rb, big) in zip(
                got["margins"][spec["uid"]], plain["margins"][spec["uid"]]):
            d = max(abs(a - ra), abs(b - rb)) / big
            if d > worst:
                worst, at = d, spec["uid"]
    return worst, at


def decode_dot_flops(eng, dev) -> float:
    """op_cost's dot FLOPs of one pooled decode forward of ``eng`` at full
    budgets (its ring writes land at positions already written)."""
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.serve import ServeEngine

    toks = torch.zeros((eng.n_slots, 1), dtype=torch.int32, device=dev)
    budgets = torch.full((eng.n_slots,), eng.n_bits, dtype=torch.int32,
                         device=dev)
    cost = OpCost()
    with cost:
        ServeEngine._decode(eng, toks, budgets)
    sync(dev)
    return float(cost.totals()["dot_flops"])


def gate_copy(base, params):
    """Gate (b)'s model: phase 6's olmo-1b with its dense ReLU MLP (no
    DSLOT quantizer) in f32, and ``params`` cast up to f32."""
    from repro_torch.models.model_zoo import build_model
    from repro_torch.tree import tree_map

    return build_model(dataclasses.replace(base, dtype="float32")), tree_map(
        lambda a: a.float() if a.is_floating_point() else a, params)


def split_run(eng, specs, dev) -> dict:
    """``specs`` through ``eng`` (its ``_decode`` a ``Timed``) with its
    kernel launches counted from 0: the run's streams, launches (one a
    layer a forward with a DSLOT MLP, else none), forwards and fault
    counts."""
    from repro_torch.kernels import dslot_matmul as dm

    dm.dslot_matmul_cuda.launches = 0
    run = drive_engine(eng, specs, dev, n_first=len(specs))
    forwards = eng._decode.calls + eng.pipeline.forwards
    return dict(run=run, streams=streams(run),
                launches=dm.dslot_matmul_cuda.launches,
                expected=eng.model.cfg.n_layers * forwards * eng.dslot,
                done=all(r.phase == "done" for r in run["reqs"]),
                faults=(eng.errors, eng.quarantined, eng.timeouts),
                tokens=run["tokens"], seconds=run["seconds"],
                steps=run["run_steps"], rings=ring_slots(eng.state),
                state_bytes=recurrent_bytes(eng.state))


def tp_engine(rank, mesh, dev, spec, which: str) -> dict:
    """Gate (b) (``which`` "olmo") or (e) ("hybrid") on this rank: the
    tensor-parallel ``ServeEngine``.  A warm-up on 6 requests of at most
    4 new tokens (none of ``HS_LONG_PROMPT`` tokens) traces one forward of
    each kind; the gate run, on
    ``gate_copy``, times the model-axis collectives by kind
    (``CollectiveClock``, which synchronizes the card around each); the
    timed bf16 run, without that clock, counts this rank's launches and
    times every forward and every DSLOT ``all_gather`` inside it; rank 0
    then holds and times its launches at the two shard shapes while rank 1
    waits."""
    import torch.distributed as dist

    from repro_torch.kernels import dslot_matmul as dm
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeEngine
    from repro_torch.train.step import CollectiveClock

    base, _, params = tp_base(which, dev)
    cfg, model, scfg = tp_engine_model(which, base,
                                       spec[which]["act_scale"])
    scfg = dataclasses.replace(scfg, mesh=mesh)
    specs = spec[which]["traffic"]
    kernel_rows = TP_KERNEL_ROWS if which == "olmo" else HS_KERNEL_ROWS
    warm = ServeEngine(model, params, scfg)
    warm._decode = Timed(warm._decode, dev, trace_at=3)
    warm.pipeline._extend_lanes = Timed(warm.pipeline._extend_lanes, dev,
                                        trace_at=3)
    short = [dict(s, max_new=min(s["max_new"], 4)) for s in specs
             if len(s["prompt"]) < HS_LONG_PROMPT][:6]
    drive_engine(warm, short, dev, n_first=len(short), idle_max=0)
    traces = {"decode forward": warm._decode.trace,
              "admission forward": warm.pipeline._extend_lanes.trace}
    del warm
    gc.collect()
    torch.cuda.empty_cache()

    model32, params32 = gate_copy(base, params)
    eng = ServeEngine(model32, params32, scfg)
    del params32
    eng._decode = Timed(eng._decode, dev)
    clock = CollectiveClock()
    eng.clock = lambda kind: clock(kind, dev)
    margins = Margins(eng)
    gate = split_run(eng, specs, dev)
    del gate["run"], eng
    gate.update(model_s=dict(clock.seconds), margins=margins.by_uid())
    del margins
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, scfg)
    gathers = GatherTimes(ops)
    decode = GatheredIn(eng._decode, gathers)
    admission = GatheredIn(eng.pipeline._extend_lanes, gathers)
    eng._decode = Timed(decode, dev)
    eng.pipeline._extend_lanes = Timed(admission, dev)
    captured, orig_run = {}, dm.run

    def capture(*args):
        rows = args[0].shape[0]
        if rows in kernel_rows.values() and rows not in captured:
            captured[rows] = args
        return orig_run(*args)

    dm.run = capture
    try:
        with gathers:
            out = split_run(eng, specs, dev)
    finally:
        dm.run = orig_run
    del out["run"]
    out.update(gate=gate, layers=cfg.n_layers,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               decode_walls=eng._decode.walls,
               admission_walls=eng.pipeline._extend_lanes.walls,
               decode_gathers=decode.ms, admission_gathers=admission.ms,
               traces=traces, gathers=gathers.ms,
               decode_flops=decode_dot_flops(eng, dev))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    out["max_err"], out["times"] = 0.0, []
    if rank == 0:
        shard = dataclasses.replace(cfg, d_ff=cfg.d_ff // TP_RANKS)
        out["max_err"], out["times"] = hold_engine_shapes(
            captured, kernel_rows, shard, dev, spec["card"])
    dist.barrier()
    return out


def tp_moe(rank, mesh, dev, card) -> dict:
    """Gate (c): expert parallelism at granite-moe-1b-a400m's full width
    against the dense ``apply_moe`` on this card, and the times of both.
    ``apply_moe_ep`` sets one capacity over the rank's tokens, ``apply_moe``
    one for each ``TOKEN_BLOCK`` of them; the two compute the same function
    where neither drops a choice, and the drops under each rule are
    counted."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import full_f32
    from repro_torch.distributed.expert_parallel import apply_moe_ep
    from repro_torch.models.moe import (TOKEN_BLOCK, apply_moe, init_moe,
                                        moe_capacity, route)

    cfg = get_arch(EP_ARCH)
    p = init_moe(cfg, torch.Generator(dev).manual_seed(3), dev)
    x = (torch.randn((EP_BATCH, EP_SEQ, cfg.d_model), device=dev,
                     generator=torch.Generator(dev).manual_seed(4)) * 0.5
         ).to(getattr(torch, cfg.dtype))
    full = torch.full((cfg.n_experts,), 8, dtype=torch.int32, device=dev)
    T = EP_BATCH * EP_SEQ
    flat = x.reshape(1, T, cfg.d_model)
    drops = {"one capacity": int((~route(p, flat, cfg, moe_capacity(
        cfg, T))[3]).sum()),
        "blocks": sum(int((~route(p, flat[:, i:i + TOKEN_BLOCK], cfg,
                                  moe_capacity(cfg, TOKEN_BLOCK))[3]).sum())
                      for i in range(0, T, TOKEN_BLOCK))}
    with full_f32():
        y, aux = apply_moe(p, x, cfg)
        ye, auxe = apply_moe_ep(p, x, cfg, mesh)
        yf, _ = apply_moe_ep(p, x, cfg, mesh, expert_planes=full)
        torch.cuda.synchronize()
        dense_ms = cuda_ms(lambda: apply_moe(p, x, cfg), reps=5, warm=1)
        ep_ms = cuda_ms(lambda: apply_moe_ep(p, x, cfg, mesh), reps=5,
                        warm=1)
    err = float((ye.float() - y.float()).abs().max())
    aux_err = abs(float(auxe) - float(aux))
    if err > EP_Y_ATOL or aux_err > EP_AUX_ATOL:
        raise AssertionError(f"[rank {rank}] expert parallel vs dense: y err "
                             f"{err} (limit {EP_Y_ATOL}), aux err {aux_err} "
                             f"(limit {EP_AUX_ATOL})")
    if not torch.equal(yf, ye):
        raise AssertionError(f"[rank {rank}] full per-expert budgets changed "
                             f"the output")
    return dict(err=err, aux_err=aux_err, y_max=float(y.float().abs().max()),
                dense_ms=dense_ms, ep_ms=ep_ms, exact=torch.equal(ye, y),
                drops=drops)


def tp_matmul(rank, mesh, dev) -> dict:
    """Gate (d): the collective matmul at olmo's up-projection width over
    the ranks, against this rank's columns of ``x @ w``, and its times
    beside the all-gather lowering and the local product."""
    from repro_torch.device import full_f32
    from repro_torch.distributed import axis_rank
    from repro_torch.distributed.overlap import (collective_matmul_ag,
                                                 plain_matmul_ag)

    S, K, N = CM_SHAPE
    g = torch.Generator(dev).manual_seed(9)
    X = torch.randn((S, K), generator=g, device=dev)
    W = torch.randn((K, N), generator=g, device=dev)
    j, n = axis_rank(mesh, "model"), TP_RANKS
    xl = X[j * S // n:(j + 1) * S // n]
    wl = W[:, j * N // n:(j + 1) * N // n].contiguous()
    with full_f32():
        ref = X @ wl
    y = collective_matmul_ag(xl, wl, mesh)
    yp = plain_matmul_ag(xl, wl, mesh)
    torch.cuda.synchronize()
    big = float(ref.abs().max())
    err = float((y - ref).abs().max()) / big
    err_plain = float((yp - ref).abs().max()) / big
    if max(err, err_plain) > CM_RTOL:
        raise AssertionError(f"[rank {rank}] collective matmul error {err} "
                             f"(all-gather lowering {err_plain}) of the "
                             f"largest |y|, limit {CM_RTOL}")

    def local():
        with full_f32():
            return X @ wl
    return dict(err=err, err_plain=err_plain,
                ring_ms=cuda_ms(lambda: collective_matmul_ag(xl, wl, mesh),
                                reps=5, warm=1),
                plain_ms=cuda_ms(lambda: plain_matmul_ag(xl, wl, mesh),
                                 reps=5, warm=1),
                local_ms=cuda_ms(local, reps=5, warm=1))


def phase10_rank(rank, spec) -> dict:
    """One rank of phase 10 (gates (a)-(e)); every rank runs the same
    program on the shared card."""
    from repro_torch.launch.mesh import make_test_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(TP_DEVICE)
    mesh = make_test_mesh(model=TP_RANKS)
    if rank == 0:
        log(f"  mesh {mesh}")
    t0 = time.perf_counter()
    out = {"execute_err": tp_execute(rank, mesh, dev)}
    out["execute_s"] = time.perf_counter() - t0
    for which in TP_ENGINES:
        t0 = time.perf_counter()
        out[which] = tp_engine(rank, mesh, dev, spec, which)
        out[which]["world_s"] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    out["moe"] = tp_moe(rank, mesh, dev, spec["card"])
    gc.collect()
    torch.cuda.empty_cache()
    out["matmul"] = tp_matmul(rank, mesh, dev)
    return out


def split_plain(which: str, dev, card) -> tuple[dict, dict]:
    """The unsharded engine ``which`` on this card with the split run's
    weights, act_scale and traffic: in bf16, again walking the admission's
    keys in ``SV_WITNESS_CHUNK`` chunks, and on gate (b)'s f32 copy, each
    sampled token's top-2 margin kept; the bf16 engine's decode dot FLOPs
    and recurrent-state bytes.  Returns (those runs, what the ranks need:
    the act_scale and the traffic)."""
    from repro_torch.serve import ServeEngine

    base, dense, params = tp_base(which, dev)
    scale = calibrated_act_scale(dense, params, base.vocab_size, dev)
    cfg, model, scfg = tp_engine_model(which, base, scale)
    specs = tp_traffic(which, cfg)
    plain = {}
    for kind in ("bf16", "witness", "f32"):
        if kind == "bf16":
            eng = ServeEngine(model, params, scfg)
        elif kind == "witness":
            eng = ServeEngine(tp_engine_model(which, dataclasses.replace(
                base, attn_chunk=SV_WITNESS_CHUNK), scale)[1], params, scfg)
        else:
            model32, params32 = gate_copy(base, params)
            eng = ServeEngine(model32, params32, scfg)
            del params32
        margins = Margins(eng)
        run = drive_engine(eng, specs, dev, n_first=len(specs))
        plain[kind] = dict(streams=streams(run), margins=margins.by_uid())
        if kind == "bf16":
            plain["flops"] = decode_dot_flops(eng, dev)
            plain["state_bytes"] = recurrent_bytes(eng.state)
        log(f"  [{which}] unsharded engine ({kind}), {len(specs)} requests "
            f"(prompts {sorted(len(s['prompt']) for s in specs)}, budgets "
            f"{[s.get('n_planes', 8) for s in specs]}): {run['tokens']} "
            f"tokens in {run['seconds']:.2f} s, "
            f"{run['tokens'] / run['seconds']:.1f} tokens/s, "
            f"{run['run_steps']} steps [{card}]")
        del eng, margins, run
        gc.collect()
        torch.cuda.empty_cache()
    del params, model, dense
    gc.collect()
    torch.cuda.empty_cache()
    plain["witness_parted"], _ = split_partings(
        specs, plain["witness"]["streams"], plain["bf16"])
    log(f"  [{which}] one device, the admission's keys in "
        f"{SV_WITNESS_CHUNK}-key chunks: "
        f"{len(specs) - len(plain['witness_parted'])} of {len(specs)} bf16 "
        f"streams equal to the first run's; parted (uid, token, margin): "
        f"{[(u, j, round(m, 6)) for u, j, m in plain['witness_parted']]} "
        f"[{card}]")
    return plain, dict(act_scale=scale, traffic=specs)


def hold_split_engine(which: str, res: list, plain: dict, specs: list,
                      card) -> int:
    """Gates (b) ("olmo") or (e) ("hybrid") on the ranks' runs of the split
    engine ``which`` against ``split_plain``'s, and its log.  Returns the
    ranks' kernel launches in the timed runs."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.attention import cache_capacity

    gate = "(b)" if which == "olmo" else "(e)"
    limit = SV_SPLIT_FLOPS if which == "olmo" else HS_SPLIT_FLOPS
    max_len = ENGINE_MAX_LEN if which == "olmo" else HS_MAX_LEN
    arch = get_arch(ENGINE_ARCH if which == "olmo" else HYBRID_ARCH)
    ring = cache_capacity(arch, max_len)
    slots = ring // TP_RANKS
    launches = 0
    log(f"  [{which}] the split engine ran {res[0][which]['world_s']:.1f} s "
        f"on rank 0 (warm-up, gate run, timed run, kernel holds)")
    for rank, r in enumerate(res):
        e = r[which]
        for kind, run in (("f32", e["gate"]), ("bf16", e)):
            # f32: gate_copy, held; bf16: the DSLOT model, counted
            if not run["done"] or any(run["faults"]):
                raise AssertionError(f"[{which}] rank {rank} ({kind}): "
                                     f"requests not done or faults "
                                     f"{run['faults']}")
            if run["launches"] != run["expected"]:
                raise AssertionError(f"[{which}] rank {rank} ({kind}): "
                                     f"{run['launches']} kernel launches, "
                                     f"expected {run['expected']}")
            if not run["rings"] or any(rg != ("KVShard", slots)
                                       for rg in run["rings"]):
                raise AssertionError(f"[{which}] rank {rank} ({kind}): KV "
                                     f"rings {run['rings']}, expected "
                                     f"KVShard of {slots} slots each")
            parted, planes = split_partings(specs, run["streams"],
                                            plain[kind])
            if kind == "f32" and planes:
                raise AssertionError(f"[{which}] rank {rank}: requests "
                                     f"{planes}' planes_used_mean differ "
                                     f"from the unsharded f32 engine's")
            for uid, j, margin in parted:
                log(f"  [{which}] [rank {rank}] {kind} request {uid}: "
                    f"stream differs from the unsharded engine's at token "
                    f"{j}, where the unsharded run's top-2 logit margin is "
                    f"{margin:.4g} of the row's largest |logit|"
                    + (f" (accepted only within {SV_LOGIT_REL:.4g})"
                       if kind == "f32" else " (counted, not held)"))
                if kind == "f32" and not margin <= SV_LOGIT_REL:
                    raise AssertionError(
                        f"[{which}] rank {rank}: request {uid}'s f32 token "
                        f"stream differs from the unsharded engine's at a "
                        f"margin of {margin:.4g}, past {SV_LOGIT_REL:.4g}")
            run["parted"], run["planes"] = len(parted), len(planes)
        g = e["gate"]
        drift, at = logit_drift(specs, g, plain["f32"])
        if not drift <= SV_LOGIT_REL:
            raise AssertionError(f"[{which}] rank {rank}: request {at}'s f32 "
                                 f"logits differ from the unsharded engine's "
                                 f"by {drift:.4g} of the row's largest, past "
                                 f"{SV_LOGIT_REL:.4g}")
        share = e["decode_flops"] / plain["flops"]
        if rank == 0 and share > limit:
            raise AssertionError(f"[{which}] rank 0's decode forward takes "
                                 f"{share:.4f} of the unsharded forward's dot "
                                 f"FLOPs (limit {limit})")
        # a rank's recurrent states: its half of the RG-LRU's width (the
        # hybrid's mixers carry no B/C conv tail)
        if e["state_bytes"] * TP_RANKS != plain["state_bytes"]:
            raise AssertionError(f"[{which}] rank {rank} holds "
                                 f"{e['state_bytes']} recurrent-state bytes, "
                                 f"one device {plain['state_bytes']}")
        launches += e["launches"]
        log(f"  [{which}] [rank {rank}] gate {gate} run (f32, dense ReLU "
            f"MLP): {g['tokens']} tokens in {g['seconds']:.2f} s under the "
            f"collective clock, {g['steps']} steps; "
            f"{len(specs) - g['parted']} of {len(specs)} streams and their "
            f"planes_used_mean equal to the unsharded f32 engine's, each "
            f"sampled row's two largest logits within {drift:.3g} of its "
            f"largest |logit| (limit {SV_LOGIT_REL:.3g}); model-axis "
            f"collectives: " + ", ".join(
                f"{k} {v:.3f} s" for k, v in sorted(g["model_s"].items())
                if k.startswith("model"))
            + f" of {g['seconds']:.2f} s [{card}]")
        log(f"  [{which}] [rank {rank}] engine (bf16, timed without the "
            f"clock): {e['tokens']} tokens in {e['seconds']:.2f} s, "
            f"{e['tokens'] / e['seconds']:.1f} tokens/s, {e['steps']} steps; "
            f"{e['launches']} kernel launches (layers x forwards = "
            f"{e['expected']}); {len(specs) - e['parted']} of {len(specs)} "
            f"streams equal to the unsharded bf16 engine's ({e['planes']} of "
            f"those with another planes_used_mean; one device in "
            f"{SV_WITNESS_CHUNK}-key chunks: "
            f"{len(specs) - len(plain['witness_parted'])}); peak memory "
            f"{e['peak_gb']:.2f} GB [{card}]")
        log(f"  [{which}] [rank {rank}] split: {len(e['rings'])} KV rings of "
            f"{slots} slots each (KVShard, of {ring}); recurrent states "
            f"{e['state_bytes']} bytes, one device's {plain['state_bytes']}; "
            f"decode forward {e['decode_flops']:.6e} dot FLOPs, {share:.4f} "
            f"of the unsharded forward's {plain['flops']:.6e} (limit "
            f"{limit}) [{card}]")
        for label, key in (("decode forward", "decode_walls"),
                           ("admission forward", "admission_walls")):
            log_forward(f"[{which}] [rank {rank}] {label} [{card}]", e[key],
                        e["traces"][label], "the warm-up's third call")
        for (rows, dt), ms in sorted(e["gathers"].items()):
            ms = sorted(ms)
            log(f"  [{which}] [rank {rank}] all_gather of ({rows}, ...) "
                f"{dt}: median {ms[len(ms) // 2]:.3f} ms (min {ms[0]:.3f}, "
                f"max {ms[-1]:.3f}, {len(ms)} calls in the timed run) "
                f"[{card}]")
        for label in ("decode", "admission"):
            # each forward's gathers against that forward's own wall
            walls, ms = e[f"{label}_walls"], e[f"{label}_gathers"]
            share = sorted(g / w for g, w in zip(ms, walls))
            ms = sorted(ms)
            log(f"  [{which}] [rank {rank}] DSLOT all_gather per {label} "
                f"forward ({e['layers']} layers, in the timed run): median "
                f"{ms[len(ms) // 2]:.2f} ms, share of the same forward's "
                f"wall median {share[len(share) // 2]:.3f} (min "
                f"{share[0]:.3f}, max {share[-1]:.3f}, {len(share)} "
                f"forwards) [{card}]")
    return launches


def phase10(card, dev):
    """Tensor- and expert-parallel serving over ``TP_RANKS`` ranks on this
    one card.  Returns (the ranks' kernel launches on the engine runs, max
    abs error, rank 0's shard-shape times)."""
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import run_world

    _build.build("dslot_matmul")     # built once here; every rank loads it
    log(f"  world: {TP_RANKS} ranks sharing {TP_DEVICE} over {TP_BACKEND} (one "
        f"card, and NCCL needs a device per rank), collective timeout "
        f"{TP_TIMEOUT} s")
    spec, plain = {"card": card}, {}
    for which in TP_ENGINES:
        plain[which], spec[which] = split_plain(which, dev, card)

    t0 = time.perf_counter()
    res = run_world(phase10_rank, TP_RANKS, backend=TP_BACKEND,
                    device=TP_DEVICE, timeout=TP_TIMEOUT, deadline=TP_DEADLINE,
                    args=(spec,))
    log(f"  the world of {TP_RANKS} ranks ran in "
        f"{time.perf_counter() - t0:.1f} s (gate (a) "
        f"{res[0]['execute_s']:.1f} s of it)")
    max_err = max(max(r["execute_err"], *(r[w]["max_err"]
                                          for w in TP_ENGINES)) for r in res)
    launches, times = 0, []
    for which in TP_ENGINES:
        launches += hold_split_engine(which, res, plain[which],
                                      spec[which]["traffic"], card)
        times += res[0][which]["times"]
    for rank, r in enumerate(res):
        m, c = r["moe"], r["matmul"]
        log(f"  [rank {rank}] expert parallel {EP_ARCH} ({EP_BATCH} x "
            f"{EP_SEQ} tokens): max |y - dense| {m['err']:.3g} (|y| up to "
            f"{m['y_max']:.3g}; equal: {m['exact']}), aux err "
            f"{m['aux_err']:.3g}; choices dropped: {m['drops']}; dense "
            f"apply_moe {m['dense_ms']:.3f} ms, "
            f"apply_moe_ep {m['ep_ms']:.3f} ms [{card}]")
        log(f"  [rank {rank}] collective matmul {CM_SHAPE[0]} x "
            f"{CM_SHAPE[1]} @ {CM_SHAPE[1]} x {CM_SHAPE[2]}: error "
            f"{c['err']:.3g} of the largest |y| (all-gather lowering "
            f"{c['err_plain']:.3g}); ring {c['ring_ms']:.3f} ms, all-gather "
            f"lowering {c['plain_ms']:.3f} ms, the rank's product alone "
            f"{c['local_ms']:.3f} ms [{card}]")
    return launches, max_err, times


# ------------------------------------------------------------ phase 11

SH_RANKS = 2                    # ranks sharing one card
SH_DEVICE = "cuda:0"
SH_BACKEND = "gloo"             # NCCL refuses two ranks on one device
SH_TIMEOUT = 600                # seconds a collective may wait for a peer
SH_DEADLINE = 900               # seconds the whole world may take
SH_MESHES = ((2, 1), (1, 2))    # gate (a): (data, model)
SH_AXES = ("data", "model")
SH_TIMED = 1                    # timed steps after one untimed step
SH_TIMED_LAYERS = 4             # the timed runs' depth: olmo-1b's first 4 of 16
SH_TIMED_MESHES = ((2, 1), (1, 2))
SH_SPLIT_FLOPS = 0.6            # gate (d): (1, 2) rank 0 / one device
SH_CKPT_AFTER = 0               # sharded save_async after this timed step
# a rank's peak over the timed runs when the step gathered the whole
# parameter tree before the forward and all-reduced full-size gradients
# (H100 80GB HBM3 at 700 W), printed beside the layer-by-layer gather's
SH_WHOLE_TREE_PEAK_GB = {(2, 1): 13.57, (1, 2): 11.03}
SH_ELASTIC = dict(n_steps=8, fail_at=4, lost_nodes=1, ckpt_every=3)
# Gate (b) holds the restart apart from the reordering.  The run's first
# steps take each rank's rows one at a time (one row a microbatch on a
# rank) and average the two shards' gradients: the same gradients as one
# device's 2-row microbatches, in other products and another summing order.
# A parameter moved by them moves every later gradient a little, and over 8
# steps that grows past gate (a)'s 1e-3 lr where firm (0.10-0.12 lr on an
# H100 at 700 W), as far as one device taking the same batches in M = 4
# one-row microbatches drifts.  So the survivor's steps after the restart
# are held at gate (a)'s bounds against one device stepping from the
# committed checkpoint it restored; against the uninterrupted run, its
# losses before the failure within TRAIN_LOSS_RTOL and its final parameters
# within 2 lr anywhere, with the firm difference and the M = 4 drift
# printed beside each other.
# Gate (e): mamba2-780m at full width, 8 of its 48 layers (two remat
# groups of 4), f32, one step over (1, 2) against one device by gate (a)'s
# bounds.  Over (1, 2) its 48 SSD heads and its vocab of 50280 split in
# two; the B/C and dt columns of w_in (304 of 6448) stay on both ranks:
# rank 0's dot FLOPs ~0.51 of one device's, within SH_SPLIT_FLOPS.
MX_ARCH, MX_LAYERS = "mamba2-780m", 8
MX_SMALL = (4, 512)             # global batch, sequence: 2 SSD chunks of 256
SH_EF_REL = 1e-6                # gate (c): error feedback, of a leaf's largest
SH_INT8_RATIO = 0.3             # gate (c): the reference test's bound


def small_train_setup(dev):
    """Phase 9's gate copy: olmo-1b's first 2 layers at full width in f32,
    its state from a seeded generator on ``dev`` (each process draws the
    same one) and its batches (``TRAIN_SMALL``)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.step import init_train_state
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=2,
                              scan_unroll=1, dtype="float32")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(dev).manual_seed(1),
                             device=dev)
    B, S = TRAIN_SMALL
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=S, global_batch=B,
                         microbatches=2, seed=3)
    batches = [pipe.next_host_batch()
               for _ in range(SH_ELASTIC["n_steps"])]
    return cfg, model, state, batches


def mixer_setup(dev):
    """Gate (e)'s model: ``MX_ARCH`` at full width with ``MX_LAYERS``
    layers in f32, its state from a seeded generator on ``dev`` (each
    process draws the same one) and one batch (``MX_SMALL``, M = 2)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.step import init_train_state

    cfg = dataclasses.replace(get_arch(MX_ARCH), n_layers=MX_LAYERS,
                              dtype="float32")
    model = build_model(cfg)
    state = init_train_state(model, torch.Generator(dev).manual_seed(2),
                             device=dev)
    B, S = MX_SMALL
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=S, global_batch=B,
                         microbatches=2, seed=4)
    return model, state, pipe.next_host_batch()


def sh_mixer(rank, dev) -> dict:
    """Gate (e) in a rank: one step of ``mixer_setup``'s model over (1,
    ``SH_RANKS``), its mixers split over the model axis; rank 0 counts it
    with ``op_cost`` and returns the gathered parameters."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import pspec
    from repro_torch.train.sharding import gather_tree, shard_tree
    from repro_torch.train.step import make_sharded_train_step

    model, full, batch = mixer_setup(dev)
    mesh = make_mesh((1, SH_RANKS), SH_AXES)
    pspec.set_mesh(mesh)
    try:
        ssh, bsh = sharded_setup(mesh, full, batch)
        state = shard_tree(full, ssh.specs, mesh)
        del full
        step = make_sharded_train_step(model, train_opt(TRAIN_TIMED + 2),
                                       ssh)
        local = to_device(make_global_batch(mesh, batch, bsh), dev)
        cost = OpCost() if rank == 0 else contextlib.nullcontext()
        sync(dev)
        t0 = time.perf_counter()
        with cost:
            state, m = step(state, local)
        sync(dev)
        out = {"metrics": {k: float(v) for k, v in m.items()},
               "seconds": time.perf_counter() - t0}
        params = gather_tree(state.params, ssh.specs.params, mesh)
        if rank == 0:
            out["dot_flops"] = cost.totals()["dot_flops"]
            out["params"] = host_params(state._replace(params=params))
    finally:
        pspec.set_mesh(None)
    del state, params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def clone_state(state):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: a.clone(), state)


def host_params(state) -> list:
    from repro_torch.tree import leaves
    return [a.detach().float().cpu().numpy().copy()
            for a in leaves(state.params)]


def sharded_setup(mesh, state, host):
    """The state's shardings and the batch shardings of ``host``."""
    from repro_torch.train.sharding import (make_batch_shardings,
                                            make_state_shardings)

    B = host["tokens"].shape[0] * host["tokens"].shape[1]
    return make_state_shardings(mesh, state), make_batch_shardings(
        mesh, host, B, batch_axis=1)


def sh_gate_a(rank, dev, model, state0, batch) -> dict:
    """Gate (a) in a rank: one sharded step of the 2-layer copy over each
    mesh of ``SH_MESHES``; rank 0 returns the gathered parameters."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import pspec
    from repro_torch.train.sharding import gather_tree, shard_tree
    from repro_torch.train.step import make_sharded_train_step

    out = {}
    for shape in SH_MESHES:
        mesh = make_mesh(shape, SH_AXES)
        pspec.set_mesh(mesh)
        full = clone_state(state0)
        ssh, bsh = sharded_setup(mesh, full, batch)
        state = shard_tree(full, ssh.specs, mesh)
        del full
        step = make_sharded_train_step(model, train_opt(TRAIN_TIMED + 2),
                                       ssh)
        state, m = step(state, to_device(
            make_global_batch(mesh, batch, bsh), dev))
        res = {"metrics": {k: float(v) for k, v in m.items()}}
        params = gather_tree(state.params, ssh.specs.params, mesh)
        if rank == 0:
            res["params"] = host_params(state._replace(params=params))
        out[shape] = res
        del state, params
        pspec.set_mesh(None)
        gc.collect()
        torch.cuda.empty_cache()
    return out


def sh_elastic(rank, dev, model, state0, batches, lr) -> dict:
    """Gate (b) in a rank: ``ResilientTrainer`` over (2, 1), a failure of
    one rank, the survivor restored resharded onto (1, 1); on the survivor,
    one device stepping from the committed checkpoint it restored, and its
    steps held against the survivor's (``hold_train`` in units of ``lr``)."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.distributed.fault_tolerance import (NodeFailure,
                                                         ResilientTrainer)
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.sharding import gather_tree, shard_tree
    from repro_torch.train.step import (make_sharded_train_step,
                                        make_train_step)
    from repro_torch.tree import leaves

    el = SH_ELASTIC
    opt = train_opt(TRAIN_TIMED + 2)
    template = state0
    ck_dir = ROOT / "build" / "phase11_elastic"
    if rank == 0:
        shutil.rmtree(ck_dir, ignore_errors=True)

    class Recording(Checkpointer):
        """Keeps each restore's leaves, gathered, on the host."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.restored = []

        def restore(self, step, target, shardings=None):
            got = super().restore(step, target, shardings)
            full = gather_tree(got, shardings.specs, shardings.mesh)
            self.restored.append(
                (step, [a.detach().cpu().clone() for a in leaves(full)]))
            return got

    def make(n_lost):
        n = SH_RANKS - n_lost
        mesh = make_mesh((n, 1), SH_AXES)        # collective: every rank
        if mesh.get_coordinate() is None:
            return None
        ssh, bsh = sharded_setup(mesh, template, batches[0])

        def place(host):
            return to_device(make_global_batch(mesh, host, bsh), dev)

        return mesh, ssh, make_sharded_train_step(model, opt, ssh), place

    mesh0 = make_mesh((SH_RANKS, 1), SH_AXES)
    ssh0, _ = sharded_setup(mesh0, template, batches[0])
    state = shard_tree(template, ssh0.specs, mesh0)
    ck = Recording(str(ck_dir), keep=2)
    t0 = time.perf_counter()
    state, rep = ResilientTrainer(
        checkpointer=ck, make_mesh_and_step=make,
        ckpt_every=el["ckpt_every"]).run(
            state, lambda s: batches[s], el["n_steps"],
            inject={el["fail_at"]: NodeFailure("rank 1 died",
                                               lost_nodes=el["lost_nodes"])})
    out = dict(steps_done=rep.steps_done, restarts=rep.restarts,
               reshards=rep.reshards, losses=rep.losses,
               seconds=time.perf_counter() - t0, survivor=state is not None)
    if state is not None:
        (step, got), = ck.restored
        committed = Checkpointer(str(ck_dir)).restore(step, template)
        out["restored_step"] = step
        out["restored_equal"] = all(
            a.dtype == b.dtype and torch.equal(a, b.cpu())
            for a, b in zip(got, leaves(committed)))
        single = make_train_step(model, opt)
        replay = []
        for s in range(step, el["n_steps"]):
            committed, m = single(committed, to_device(batches[s], dev))
            replay.append(float(m["loss"]))
        out["params"] = host_params(state)
        out["replay_losses"] = replay
        out["replay_params"] = hold_train(
            out["params"], host_params(committed),
            [a.abs().cpu().numpy() for a in leaves(committed.opt.m)], lr)
        del committed
        shutil.rmtree(ck_dir, ignore_errors=True)
    del template, state
    gc.collect()
    torch.cuda.empty_cache()
    return out


def timed_model():
    """The timed runs' model: olmo-1b at full width, its first
    ``SH_TIMED_LAYERS`` layers."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model_zoo import build_model

    return build_model(dataclasses.replace(get_arch(TRAIN_ARCH),
                                           n_layers=SH_TIMED_LAYERS))


def sh_timed(rank, dev, card, shape) -> dict:
    """A timed run in a rank: ``timed_model`` over ``shape``, phase 9's
    data; per step its wall and the seconds of its own collectives by kind;
    over (2, 1) one sharded save_async; over a split model axis the
    untimed first step counted by ``op_cost`` on rank 0 (its dot FLOPs)."""
    import shutil

    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.data.pipeline import TokenPipeline, make_global_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models import pspec
    from repro_torch.optim.adamw import schedule
    from repro_torch.train.sharding import shard_tree
    from repro_torch.train.step import (CollectiveClock, init_train_state,
                                        make_sharded_train_step)
    from repro_torch.tree import leaves

    model = timed_model()
    cfg = model.cfg
    mesh = make_mesh(shape, SH_AXES)
    pspec.set_mesh(mesh)
    total = SH_TIMED + 1
    opt = train_opt(total)
    ckpt = shape == (SH_RANKS, 1)
    pipe = TokenPipeline(vocab=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, microbatches=TRAIN_MICRO)
    full = init_train_state(model, torch.Generator(dev).manual_seed(0),
                            device=dev)
    n_params = model.param_count(full.params)
    ssh, bsh = sharded_setup(mesh, full, pipe.next_host_batch())
    pipe.restore({"cursor": 0, "seed": pipe.seed})
    state = shard_tree(full, ssh.specs, mesh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    stored = sum(a.numel() * a.element_size() for a in leaves(state))
    clock = CollectiveClock()
    step = make_sharded_train_step(model, opt, ssh, clock)
    ck_dir = ROOT / "build" / "phase11_ckpt"
    if rank == 0 and ckpt:
        shutil.rmtree(ck_dir, ignore_errors=True)
    ck = Checkpointer(str(ck_dir), keep=1)
    write_s = []
    write = ck._write

    def timed_write(*args):
        t = time.perf_counter()
        res = write(*args)
        write_s.append(time.perf_counter() - t)
        return res

    ck._write = timed_write
    torch.cuda.reset_peak_memory_stats(dev)
    rows = []
    snap_ms = wait_s = flops = None
    nbytes = 0
    try:
        for k in range(1, total + 1):
            batch = to_device(make_global_batch(mesh, pipe.next_host_batch(),
                                                bsh), dev)
            before = dict(clock.seconds)
            # gate (d): the untimed first step over a split model axis is
            # rank 0's counted one
            count = k == 1 and shape[1] > 1 and rank == 0
            cost = OpCost() if count else contextlib.nullcontext()
            sync(dev)
            t0 = time.perf_counter()
            with cost:
                state, m = step(state, batch)
            sync(dev)
            wall = time.perf_counter() - t0
            if count:
                flops = cost.totals()["dot_flops"]
            row = {n: float(m[n]) for n in ("loss", "grad_norm", "lr")}
            row.update(wall_ms=wall * 1e3, **{
                f"{kind}_ms": (clock.seconds[kind] - before[kind]) * 1e3
                for kind in clock.seconds})
            row["coll_ms"] = sum(row[f"{kind}_ms"] for kind in clock.seconds)
            if not (math.isfinite(row["loss"])
                    and math.isfinite(row["grad_norm"])):
                raise AssertionError(f"phase 11: step {k} is not finite")
            if row["lr"] != float(schedule(opt, torch.tensor(k,
                                                             device=dev))):
                raise AssertionError(f"phase 11: step {k} lr {row['lr']}")
            rows.append(row)
            if ckpt and k == 1 + SH_CKPT_AFTER:
                sync(dev)
                t0 = time.perf_counter()
                ck.save_async(k, state, ssh)
                snap_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev)
        if ckpt:
            t0 = time.perf_counter()
            ck.wait()
            wait_s = time.perf_counter() - t0
            nbytes = sum(f.stat().st_size for f in ck_dir.rglob("*")
                         if f.is_file()) if rank == 0 else 0
    finally:
        ck.wait()
        pspec.set_mesh(None)
        if rank == 0 and ckpt:
            shutil.rmtree(ck_dir, ignore_errors=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dict(rows=rows, peak=peak, peak_gb=peak / 1e9,
                stored_gb=stored / 1e9,
                n_params=n_params, snap_ms=snap_ms, write_s=write_s,
                wait_s=wait_s, ckpt_gb=nbytes / 1e9, dot_flops=flops)


def phase11_rank(rank, spec) -> dict:
    """One rank of phase 11: gates (a), (b) and (e), then the timed run."""
    from repro_torch.kernels import dslot_matmul as dm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(SH_DEVICE)
    dm.dslot_matmul_cuda.launches = 0
    t0 = time.perf_counter()
    _, model, state0, batches = small_train_setup(dev)
    out = {"gate_a": sh_gate_a(rank, dev, model, state0, batches[0])}
    out["gate_a_s"] = time.perf_counter() - t0
    out["gate_b"] = sh_elastic(rank, dev, model, state0, batches,
                               spec["lr"])
    del state0
    gc.collect()
    torch.cuda.empty_cache()
    out["gate_e"] = sh_mixer(rank, dev)
    out["timed"], out["timed_s"] = {}, {}
    for shape in SH_TIMED_MESHES:
        t0 = time.perf_counter()
        out["timed"][shape] = sh_timed(rank, dev, spec["card"], shape)
        out["timed_s"][shape] = time.perf_counter() - t0
    out["dslot_launches"] = dm.dslot_matmul_cuda.launches
    return out


def log_timed(rank, shape, t, base, tokens, single_tps, card) -> None:
    """The log of one rank's timed run over ``shape``."""
    timed = t["rows"][1:]
    walls = sorted(x["wall_ms"] for x in timed)
    med = walls[len(walls) // 2]

    def share(key):
        vals = sorted(x[key] / x["wall_ms"] for x in timed)
        return vals[len(vals) // 2]

    for k, x in enumerate(t["rows"], 1):
        log(f"  [rank {rank}] {shape} step {k}: loss {x['loss']:.6f}, "
            f"grad_norm {x['grad_norm']:.6f}, lr {x['lr']:.6e}, wall "
            f"{x['wall_ms']:.1f} ms, collectives {x['coll_ms']:.1f} ms "
            f"(gather {x['gather_ms']:.1f}, reduce {x['reduce_ms']:.1f}, "
            f"model {x['model_ms']:.1f})" + (" untimed" if k == 1 else ""))
    log(f"  [rank {rank}] {TRAIN_ARCH} full width, {base.n_layers} layers "
        f"({t['n_params'] / 1e9:.4f} B parameters, {base.dtype}, remat "
        f"{base.remat}, scan_unroll {base.scan_unroll}) over {shape}, "
        f"{tokens} tokens a step: step wall median {med:.1f} ms, min "
        f"{walls[0]:.1f}, max {walls[-1]:.1f} over {len(walls)} steps; "
        f"{tokens / (med / 1e3):.0f} tokens/s of the world (phase 9, one "
        f"rank alone on this card at all 16 layers: {single_tps:.0f}); "
        f"collectives {share('coll_ms'):.3f} of the "
        f"step's own wall (median; gather {share('gather_ms'):.3f}, reduce "
        f"{share('reduce_ms'):.3f}, model {share('model_ms'):.3f}); stored "
        f"state {t['stored_gb']:.2f} GB, peak memory over the steps "
        f"{t['peak_gb']:.2f} GB (the whole-tree gather's: "
        f"{SH_WHOLE_TREE_PEAK_GB[shape]:.2f} GB) [{card}]")
    if rank == 0 and t["snap_ms"] is not None:
        log(f"  [rank {rank}] sharded save_async after step "
            f"{1 + SH_CKPT_AFTER}: snapshot (gather + host copy) "
            f"{t['snap_ms']:.0f} ms, write {t['write_s'][0]:.1f} s on "
            f"rank 0's thread, {t['ckpt_gb']:.2f} GB written, wait at the "
            f"end {t['wait_s']:.1f} s [{card}]")


def hold_train(params, want, grads, lr, steps=1) -> tuple[float, float]:
    """(max |diff| where |g| is firm, max |diff| anywhere), each in lr."""
    firm_d = all_d = 0.0
    for a, b, g in zip(params, want, grads):
        d = abs(a - b)
        firm = abs(g) > TRAIN_FIRM * abs(g).max()
        all_d = max(all_d, float(d.max()))
        if firm.any():
            firm_d = max(firm_d, float(d[firm].max()))
    return firm_d / lr, all_d / lr


def sh_gate_c(model, state, batch, dev, card) -> None:
    """Gate (c): int8 and top-k compression of one step's full-width
    gradient tree, two rounds each (the second with a residual)."""
    from repro_torch.distributed import compression as comp
    from repro_torch.train.step import microbatch_grads
    from repro_torch.tree import leaves

    grads, _, _ = microbatch_grads(model, state.params, batch)
    n = sum(g.numel() for g in leaves(grads))
    for kind in ("int8", "top-k 1%"):
        ef = comp.init_ef_state(grads)
        worst = 0.0
        for rnd in range(2):
            g = grads if rnd == 0 else tree_scale(grads, 0.5)
            sync(dev)
            t0 = time.perf_counter()
            if kind == "int8":
                payload, new = comp.int8_compress(g, ef)
                dec = comp.int8_decompress(payload)
                ratio = comp.compressed_ratio(g, payload[0])
            else:
                payload, new = comp.topk_compress(g, ef, frac=0.01)
                dec = comp.topk_decompress(payload, g)
                ratio = comp.compressed_ratio(g, payload)
            sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            for d, e, gg, r in zip(leaves(dec), leaves(new.residual),
                                   leaves(g), leaves(ef.residual)):
                want = gg.float() + r
                worst = max(worst, float((d + e - want).abs().max())
                            / max(float(want.abs().max()), 1e-30))
            ef = new
            del payload, dec
        log(f"  gate (c) {kind} on the 2-layer copy's gradient tree ({n} "
            f"entries): payload {ratio:.4f} of f32 (int8 limit "
            f"{SH_INT8_RATIO}); error feedback: decompressed + residual = "
            f"gradient + previous residual within {worst:.3g} of a leaf's "
            f"largest (limit {SH_EF_REL}); compress + decompress {ms:.1f} ms "
            f"[{card}]")
        if worst > SH_EF_REL or (kind == "int8" and ratio >= SH_INT8_RATIO):
            raise AssertionError(f"gate (c) {kind}: ratio {ratio}, error "
                                 f"feedback {worst}")
        del ef, new
    del grads


def tree_scale(tree, s):
    from repro_torch.tree import tree_map
    return tree_map(lambda a: a * s, tree)


def timed_yardstick(dev) -> float:
    """Gate (d)'s yardstick: the dot FLOPs ``op_cost`` counts in one step
    of ``timed_model`` on this card alone, at the timed runs' global batch
    (phase 9's data)."""
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.train.step import init_train_state, make_train_step

    model = timed_model()
    state = init_train_state(model, torch.Generator(dev).manual_seed(0),
                             device=dev)
    pipe = TokenPipeline(vocab=model.cfg.vocab_size, seq_len=TRAIN_SEQ,
                         global_batch=TRAIN_BATCH, microbatches=TRAIN_MICRO)
    cost = OpCost()
    with cost:
        make_train_step(model, train_opt(SH_TIMED + 1))(
            state, to_device(pipe.next_host_batch(), dev))
    sync(dev)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return cost.totals()["dot_flops"]


def phase11(card, dev, single_tps: float) -> dict:
    """Sharded training over ``SH_RANKS`` ranks on this one card (see the
    module docstring): the single-device yardsticks and gate (c) here, then
    the world.  ``single_tps``: phase 9's tokens/s, for the log.  Returns
    rank 0's peak bytes over each timed run, by mesh (phase 12 (e))."""
    from repro_torch.launch.mesh import run_world
    from repro_torch.train.step import make_train_step, microbatch_grads
    from repro_torch.tree import leaves

    t_start = time.perf_counter()
    _, model, state0, batches = small_train_setup(dev)
    step = make_train_step(model, train_opt(TRAIN_TIMED + 2))
    # the single-device yardsticks on this card
    first = to_device(batches[0], dev)
    state = clone_state(state0)
    g0, _, _ = microbatch_grads(model, state.params, first)
    firm0 = [a.abs().cpu().numpy() for a in leaves(g0)]
    del g0
    one, m1 = step(state, first)
    want_a = dict(params=host_params(one),
                  metrics={k: float(v) for k, v in m1.items()})
    want_losses = [want_a["metrics"]["loss"]]
    for b in batches[1:]:
        one, m = step(one, to_device(b, dev))
        want_losses.append(float(m["loss"]))
    want_b = host_params(one)
    firm_b = [a.abs().cpu().numpy() for a in leaves(one.opt.m)]
    del one, state
    # the same 8 steps on one device in M = 4 microbatches
    four = clone_state(state0)
    for b in batches:
        four, _ = step(four, to_device(
            {k: v.reshape(4, -1, v.shape[-1]) for k, v in b.items()}, dev))
    drift = hold_train(host_params(four), want_b, firm_b,
                       want_a["metrics"]["lr"])
    del four
    state = clone_state(state0)
    sh_gate_c(model, state, first, dev, card)
    del state, state0, first
    gc.collect()
    torch.cuda.empty_cache()
    # gate (e)'s yardstick: the mixer model's step on one device, counted
    from repro_torch.launch.op_cost import OpCost

    mx_model, mx_state, mx_batch = mixer_setup(dev)
    mx_first = to_device(mx_batch, dev)
    g0, _, _ = microbatch_grads(mx_model, mx_state.params, mx_first)
    mx_firm = [a.abs().cpu().numpy() for a in leaves(g0)]
    del g0
    cost = OpCost()
    sync(dev)
    t0 = time.perf_counter()
    with cost:
        one, m1 = make_train_step(mx_model, train_opt(TRAIN_TIMED + 2))(
            mx_state, mx_first)
    sync(dev)
    want_e = dict(params=host_params(one), seconds=time.perf_counter() - t0,
                  metrics={k: float(v) for k, v in m1.items()},
                  dot_flops=cost.totals()["dot_flops"],
                  n_params=mx_model.param_count(one.params))
    del one, mx_state, mx_first, cost
    gc.collect()
    torch.cuda.empty_cache()
    single_flops = timed_yardstick(dev)

    log(f"  world: {SH_RANKS} ranks sharing {SH_DEVICE} over {SH_BACKEND}, "
        f"collective timeout {SH_TIMEOUT} s (yardsticks and gate (c) "
        f"{time.perf_counter() - t_start:.1f} s)")
    t0 = time.perf_counter()
    res = run_world(phase11_rank, SH_RANKS, backend=SH_BACKEND,
                    device=SH_DEVICE, timeout=SH_TIMEOUT,
                    deadline=SH_DEADLINE,
                    args=(dict(card=card, lr=want_a["metrics"]["lr"]),))
    log(f"  the world of {SH_RANKS} ranks ran in "
        f"{time.perf_counter() - t0:.1f} s (gate (a) "
        f"{res[0]['gate_a_s']:.1f} s, gate (b) {res[0]['gate_b']['seconds']:.1f}"
        f" s, the timed runs "
        + ", ".join(f"{shape} {sec:.1f} s"
                    for shape, sec in res[0]["timed_s"].items())
        + " on rank 0)")
    lr = want_a["metrics"]["lr"]
    failed = []

    # gate (a)
    for shape in SH_MESHES:
        ms = [r["gate_a"][shape]["metrics"] for r in res]
        if any(m != ms[0] for m in ms):
            raise AssertionError(f"gate (a) {shape}: ranks' metrics differ")
        errs = {k: abs(ms[0][k] - want_a["metrics"][k])
                / abs(want_a["metrics"][k]) for k in ("loss", "grad_norm")}
        firm_d, all_d = hold_train(res[0]["gate_a"][shape]["params"],
                                   want_a["params"], firm0, lr)
        log(f"  gate (a) sharded step over mesh {shape} vs the single-device "
            f"step, 2 layers f32 at full width: loss rel {errs['loss']:.3g}, "
            f"grad_norm rel {errs['grad_norm']:.3g} (limit "
            f"{TRAIN_LOSS_RTOL}); params {firm_d:.3g} lr where |g| is firm "
            f"(limit 1e-3), {all_d:.3g} lr anywhere (limit 2)")
        if max(errs.values()) > TRAIN_LOSS_RTOL or firm_d > 1e-3 \
                or all_d > 2:
            failed.append(f"gate (a) {shape}: {errs}, params {firm_d}, "
                          f"{all_d} lr")

    # gate (b)
    el = SH_ELASTIC
    for rank, r in enumerate(res):
        b = r["gate_b"]
        if (b["restarts"], b["reshards"]) != (1, 1) or \
                b["survivor"] != (rank < SH_RANKS - el["lost_nodes"]):
            failed.append(f"gate (b) rank {rank}: restarts {b['restarts']}, "
                          f"reshards {b['reshards']}, survivor "
                          f"{b['survivor']}")
    b = res[0]["gate_b"]
    k = b["restored_step"]
    before, after = b["losses"][:el["fail_at"]], b["losses"][el["fail_at"]:]
    if b["steps_done"] != el["n_steps"] or not all(
            math.isfinite(x) for x in b["losses"]) or not b["restored_equal"] \
            or len(after) != el["n_steps"] - k:
        failed.append(f"gate (b): {b['steps_done']} steps, losses "
                      f"{b['losses']}, restored equal {b['restored_equal']}")
    # the restart: the survivor's steps k+1.. against one device from the
    # committed step-k checkpoint
    replay_rel = max(abs(x - y) / abs(y)
                     for x, y in zip(after, b["replay_losses"]))
    r_firm, r_all = b["replay_params"]
    # the uninterrupted run: losses before the failure, final parameters
    pre_rel = max(abs(x - y) / abs(y) for x, y in zip(before, want_losses))
    firm_d, all_d = hold_train(b["params"], want_b, firm_b, lr)
    log(f"  gate (b) elastic restart: {SH_RANKS} ranks over ({SH_RANKS}, 1), "
        f"ckpt_every {el['ckpt_every']}, NodeFailure(lost_nodes="
        f"{el['lost_nodes']}) at step {el['fail_at']}; steps_done "
        f"{b['steps_done']}, restarts {b['restarts']}, reshards "
        f"{b['reshards']}, {len(b['losses'])} losses (replayed steps "
        f"included) all finite, in {b['seconds']:.1f} s; step {k} restored "
        f"onto (1, 1) bit-equal to the committed checkpoint")
    log(f"  gate (b) the survivor's steps {k + 1}-{el['n_steps']} vs one "
        f"device stepping from the committed step-{k} checkpoint: losses rel "
        f"{replay_rel:.3g} (limit {TRAIN_LOSS_RTOL}); final params "
        f"{r_firm:.3g} lr where the single device's |m| is firm (limit "
        f"1e-3), {r_all:.3g} lr anywhere (limit 2)")
    log(f"  gate (b) vs {el['n_steps']} uninterrupted single-device steps: "
        f"losses of steps 1-{el['fail_at']} rel {pre_rel:.3g} (limit "
        f"{TRAIN_LOSS_RTOL}); final params {all_d:.3g} lr anywhere (limit "
        f"2), {firm_d:.3g} lr where |m| is firm, beside the same steps on "
        f"one device in M = 4 one-row microbatches: {drift[0]:.3g} lr where "
        f"firm, {drift[1]:.3g} lr anywhere")
    if replay_rel > TRAIN_LOSS_RTOL or r_firm > 1e-3 or r_all > 2 \
            or pre_rel > TRAIN_LOSS_RTOL or all_d > 2:
        failed.append(f"gate (b): replay losses {replay_rel}, params "
                      f"{r_firm}, {r_all} lr; before the failure {pre_rel}; "
                      f"uninterrupted {all_d} lr")

    # the timed runs
    base = timed_model().cfg
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for shape in SH_TIMED_MESHES:
        for rank, r in enumerate(res):
            log_timed(rank, shape, r["timed"][shape], base, tokens,
                      single_tps, card)

    # gate (d): the split computes its share
    flops = res[0]["timed"][(1, SH_RANKS)]["dot_flops"]
    ratio = flops / single_flops
    log(f"  gate (d) rank 0's dot_flops of one (1, {SH_RANKS}) step under "
        f"op_cost: {flops:.6e} against one device's step of the same model "
        f"and global batch {single_flops:.6e}: ratio {ratio:.4f} (limit "
        f"{SH_SPLIT_FLOPS})")
    if ratio > SH_SPLIT_FLOPS:
        failed.append(f"gate (d): (1, {SH_RANKS}) dot FLOPs ratio {ratio}")

    # gate (e): the recurrent mixers split, against one device
    es = [r["gate_e"] for r in res]
    if any(e["metrics"] != es[0]["metrics"] for e in es):
        raise AssertionError("gate (e): ranks' metrics differ")
    e = es[0]
    lr_e = want_e["metrics"]["lr"]
    errs = {k: abs(e["metrics"][k] - want_e["metrics"][k])
            / abs(want_e["metrics"][k]) for k in ("loss", "grad_norm")}
    firm_d, all_d = hold_train(e["params"], want_e["params"], mx_firm, lr_e)
    ratio = e["dot_flops"] / want_e["dot_flops"]
    log(f"  gate (e) {MX_ARCH} at full width, {MX_LAYERS} layers, f32 "
        f"({want_e['n_params'] / 1e9:.4f} B parameters), global batch "
        f"{MX_SMALL[0]} x {MX_SMALL[1]} tokens, M = 2: one (1, {SH_RANKS}) "
        f"step with the mixers split over the model axis vs one device: "
        f"loss rel {errs['loss']:.3g}, grad_norm rel {errs['grad_norm']:.3g} "
        f"(limit {TRAIN_LOSS_RTOL}); params {firm_d:.3g} lr where |g| is "
        f"firm (limit 1e-3), {all_d:.3g} lr anywhere (limit 2); rank 0's "
        f"dot FLOPs {e['dot_flops']:.6e} against one device's "
        f"{want_e['dot_flops']:.6e}: ratio {ratio:.4f} (limit "
        f"{SH_SPLIT_FLOPS}); step {e['seconds'] * 1e3:.1f} ms on rank 0 "
        f"under op_cost (one device {want_e['seconds'] * 1e3:.1f} ms, "
        f"counted too) [{card}]")
    if max(errs.values()) > TRAIN_LOSS_RTOL or firm_d > 1e-3 or all_d > 2 \
            or ratio > SH_SPLIT_FLOPS:
        failed.append(f"gate (e): {errs}, params {firm_d}, {all_d} lr, dot "
                      f"FLOPs ratio {ratio}")
    launched = sum(r["dslot_launches"] for r in res)
    log(f"  dslot kernel launches in phase 11: {launched} (the model's MLPs "
        f"are GLU; sharded training launches no hand-written kernel)")
    if failed:
        raise AssertionError("phase 11: " + "; ".join(failed))
    return {shape: res[0]["timed"][shape]["peak"]
            for shape in SH_TIMED_MESHES}


# ------------------------------------------------------------ phase 3

# ------------------------------------------------------------ phase 12

PEAK_RTOL = 0.05                # gate (b): dry-run peak against the card's
MODEL_OP_MIN = 0.6              # gate (d): train_4k MODEL/op on 16 x 16
DRYRUN_TIMEOUT = 600            # seconds a dry-run subprocess may take


def dryrun_proc(args: list) -> subprocess.Popen:
    """A dry run in its own process on fake CPU tensors (no card)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen([sys.executable, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finished(proc: subprocess.Popen, what: str) -> str:
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"{what} ran past {DRYRUN_TIMEOUT} s") from None
    if proc.returncode != 0:
        raise AssertionError(f"{what} failed:\n{err[-3000:]}")
    return out


def log_roofline(label: str, row: dict) -> float:
    """Log a roofline row; returns its modeled step seconds (the dominant
    term)."""
    modeled = max(row["compute_s"], row["memory_s"], row["collective_s"])
    log(f"  {label}: compute {row['compute_s'] * 1e3:.1f} ms, memory "
        f"{row['memory_s'] * 1e3:.1f} ms (every op's bytes "
        f"{row['memory_upper_s'] * 1e3:.1f} ms), collective "
        f"{row['collective_s'] * 1e3:.1f} ms: {row['dominant']}-bound, "
        f"modeled step {modeled * 1e3:.1f} ms; roofline_frac "
        f"{row['roofline_frac']:.4f}, useful/op FLOPs "
        f"{row['useful_ratio']:.3f} (H100 data-sheet rates, 700 W)")
    return modeled


# the dry run of phase 9's one-device program: microbatches_for gives one
# device min(batch, 2 x microbatches) microbatches, TRAIN_MICRO of them
P9_DRYRUN = f"""
import json
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import trace_cell
shape = ShapeConfig("phase9", "train", {TRAIN_SEQ}, {TRAIN_BATCH},
                    microbatches={TRAIN_MICRO // 2})
print(json.dumps(trace_cell(get_arch("{TRAIN_ARCH}"), shape, None)))
"""


# the dry run of phase 11's (2, 1) timed program, rank 0 of a fake world of
# SH_RANKS: microbatches_for gives each rank TRAIN_MICRO microbatches
P11_DRYRUN = f"""
import dataclasses, json
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import start_world, trace_cell
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import pspec
start_world({SH_RANKS})
mesh = make_mesh(({SH_RANKS}, 1), {SH_AXES!r})
pspec.set_mesh(mesh)
shape = ShapeConfig("phase11", "train", {TRAIN_SEQ}, {TRAIN_BATCH},
                    microbatches={TRAIN_MICRO // 2})
arch = dataclasses.replace(get_arch("{TRAIN_ARCH}"),
                           n_layers={SH_TIMED_LAYERS})
print(json.dumps(trace_cell(arch, shape, mesh)))
"""


PHASE12_OUT = ROOT / "build" / "phase12_dryrun"


def phase12_start() -> tuple:
    """Phase 12's three dry runs, (b), (d) and (e), started as subprocesses
    on the host's cores (they need no card and nothing phases 9 and 11
    measure), so that they run beside phase 11; the caller stops them
    (``stop``)."""
    return (dryrun_proc(["-c", P9_DRYRUN]),
            dryrun_proc(["-m", "repro_torch.launch.dryrun", "--arch",
                         TRAIN_ARCH, "--shape", "train_4k", "--out",
                         str(PHASE12_OUT)]),
            dryrun_proc(["-c", P11_DRYRUN]))


def sharded_peak_gate(proc, measured: int) -> None:
    """Phase 12 (e): the dry run of phase 11's (2, 1) timed program
    (``proc``, ``P11_DRYRUN``) against rank 0's measured peak over that
    run's steps."""
    dry = json.loads(finished(proc, "the phase-11 dry run").splitlines()[-1])
    mem = dry["memory"]
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    log(f"  (e) dry run of phase 11's ({SH_RANKS}, 1) timed program, rank 0 "
        f"of a fake world of {SH_RANKS} on fake CPU tensors "
        f"({dry['compile_s']:.1f} s, M = {dry['microbatches']}): peak "
        f"{peak / 1e9:.3f} GB predicted (state and batch "
        f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB) against "
        f"{measured / 1e9:.3f} GB max_memory_allocated on rank 0 (rel "
        f"{peak / measured - 1:+.4f}, limit {PEAK_RTOL}); collectives "
        f"{dry['collectives']['counts']}")
    log("  (e) the rank's peak: " + ", ".join(
        f"{k} {v / 1e9:.3f} GB" for k, v in dry["peak_breakdown"].items()))
    if dry["microbatches"] != TRAIN_MICRO:
        raise AssertionError(f"gate (e): the dry run took "
                             f"{dry['microbatches']} microbatches")
    if abs(peak / measured - 1) > PEAK_RTOL:
        raise AssertionError(f"gate (e): predicted peak {peak} against "
                             f"{measured}")


def stop(procs) -> None:
    """Kill every subprocess of ``procs`` still running."""
    for proc in procs:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def phase12(card, trained: dict, lm_counted: dict, sharded_peaks: dict,
            procs: tuple) -> None:
    """The launch tools against the card: (a) phase 9's step counted by
    ``op_cost`` and put through the roofline; (b) the dry run of that same
    one-device program on fake CPU tensors, whose dot FLOPs must equal
    (a)'s and whose peak must lie within PEAK_RTOL of phase 9's
    ``max_memory_allocated``; (c) phase 5's generate counted by ``op_cost``,
    whose opaque DSLOT launches must equal the launch counter; (d) the
    olmo-1b ``train_4k`` cell on the 16 x 16 fake world through the CLI,
    its roofline and summarize rows; (e) the dry run of phase 11's (2, 1)
    timed program against ``sharded_peaks`` (``sharded_peak_gate``).
    (b), (d) and (e) are ``procs`` (``phase12_start``), side by side."""
    from repro_torch.launch import roofline, summarize

    out_dir = PHASE12_OUT
    p9, cell, p11 = procs
    try:
        # (a)
        c = trained["counted"]["totals"]
        six_nt = 6 * trained["n_params"] * trained["tokens"]
        log(f"  (a) {TRAIN_ARCH} step (seq {TRAIN_SEQ}, batch {TRAIN_BATCH}, "
            f"M = {TRAIN_MICRO}, remat) under op_cost on the card: dot_flops "
            f"{c['dot_flops']:.6e} against 6 N T {six_nt:.6e} (ratio "
            f"{c['dot_flops'] / six_nt:.4f}); hbm_bytes "
            f"{c['hbm_bytes']:.4e}, every op's bytes "
            f"{c['hbm_bytes_upper']:.4e}, vector_flops "
            f"{c['vector_flops']:.4e}, collectives "
            f"{c['coll_total_bytes']}; the counted step's wall "
            f"{trained['counted']['wall_ms']:.1f} ms")
        rec = {"arch": TRAIN_ARCH, "shape": "phase 9", "mesh": {"card": 1},
               "memory": {"argument_size_in_bytes": trained["peak"]},
               "corrected": c}
        row = roofline.analyze_cell(rec, model_flops=six_nt)
        modeled = log_roofline("(a) roofline of the counted step", row)
        log(f"      phase 9's measured wall {trained['wall_ms']:.1f} ms "
            f"(modeled / measured "
            f"{modeled * 1e3 / trained['wall_ms']:.4f}), model-FLOPs share "
            f"{trained['mfu']:.4f} against roofline_frac "
            f"{row['roofline_frac']:.4f}")

        # (b)
        t0 = time.perf_counter()
        dry = json.loads(finished(p9, "the phase-9 dry run").splitlines()[-1])
        mem = dry["memory"]
        peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        flops = dry["corrected"]["dot_flops"]
        log(f"  (b) dry run of the same one-device program on fake CPU "
            f"tensors ({dry['compile_s']:.1f} s, M = {dry['microbatches']}): "
            f"dot_flops {flops:.6e} (card {c['dot_flops']:.6e}); peak "
            f"{peak / 1e9:.3f} GB predicted (state and batch "
            f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB) against "
            f"{trained['peak'] / 1e9:.3f} GB max_memory_allocated in phase 9 "
            f"(rel {peak / trained['peak'] - 1:+.4f}, limit {PEAK_RTOL})")
        if dry["microbatches"] != TRAIN_MICRO:
            raise AssertionError(f"gate (b): the dry run took "
                                 f"{dry['microbatches']} microbatches")
        if flops != c["dot_flops"]:
            raise AssertionError("gate (b): dot_flops of the fake trace "
                                 "differ from the card's")
        if abs(peak / trained["peak"] - 1) > PEAK_RTOL:
            raise AssertionError(f"gate (b): predicted peak {peak} against "
                                 f"{trained['peak']}")

        # (c)
        n = lm_counted["launches"]
        got = lm_counted["totals"]["dslot_launches"]
        log(f"  (c) {LM_ARCH} generate under op_cost: {got} opaque DSLOT "
            f"launches, launch counter {n} (expected "
            f"{lm_counted['expected']}); hbm_bytes "
            f"{lm_counted['totals']['hbm_bytes']:.4e}, dot_flops "
            f"{lm_counted['totals']['dot_flops']:.4e} outside the kernel")
        if not got == n == lm_counted["expected"]:
            raise AssertionError(f"gate (c): op_cost counted {got} DSLOT "
                                 f"launches, the launch counter {n}")

        # (d)
        finished(cell, "the train_4k dry run")
        rec = json.loads((out_dir / f"{TRAIN_ARCH}__train_4k__single.json")
                         .read_text())
        mem = rec["memory"]
        gib = (mem["argument_size_in_bytes"]
               + mem["temp_size_in_bytes"]) / 2 ** 30
        traced = rec.get("microbatches_traced", [rec["microbatches"]])
        log(f"  (d) {TRAIN_ARCH} train_4k on the 16 x 16 fake world "
            f"({time.perf_counter() - t0:.1f} s after (b)): trace "
            f"{rec['compile_s']:.1f} s, M = {rec['microbatches']} (traced "
            f"at {traced}), peak {gib:.2f} GiB a rank, collectives "
            f"{rec['collectives']['counts']}")
        row = roofline.analyze_cell(rec)
        log_roofline("(d) roofline", row)
        for line in summarize.render([summarize.row(rec)]).splitlines():
            log(f"      {line}")
        parts = rec["peak_breakdown"]
        log("  (d) the rank's peak: " + ", ".join(
            f"{k} {v / 1e9:.2f} GB" for k, v in parts.items()))
        log(f"  (d) MODEL/op {row['useful_ratio']:.4f} (limit "
            f"{MODEL_OP_MIN}: the step's compute split over the model axis)")
        if row["useful_ratio"] < MODEL_OP_MIN:
            raise AssertionError(f"gate (d): MODEL/op "
                                 f"{row['useful_ratio']} < {MODEL_OP_MIN}")

        # (e)
        sharded_peak_gate(p11, sharded_peaks[(SH_RANKS, 1)])
    finally:   # no subprocess outlives the phase
        stop(procs)


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


def split_record() -> dict:
    """The W split's entry of the kernel record: its launches while the
    driven paths prepared their layers, its times summed over the splits
    held in phases 5 and 6."""
    t = SPLIT["times"]
    if SPLIT["launches"] == 0 or not t:
        raise AssertionError("the driven paths launched no W split")
    lib = [x["library_ms"] for x in t]
    return {"name": "dslot_split_parts", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": REPLACES,
            "launches": SPLIT["launches"], "max_abs_err": 0.0,
            "ms": sum(x["ms"] for x in t),
            "plain_ms": sum(x["plain_ms"] for x in t),
            "bound_ms": sum(x["bound_ms"] for x in t), "bound_by": "bytes",
            "library_ms": None if None in lib else sum(lib),
            "graph_ms": sum(x["graph_ms"] for x in t)}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from repro_torch.configs.dslot_mnist import CONFIG
    from repro_torch.core import mnist_cnn
    from repro_torch.data.mnist import synth_mnist
    from repro_torch.kernels import _build
    from repro_torch.kernels import dslot_matmul as dm

    t_start = time.perf_counter()
    laps = [t_start]

    def lap(name):
        now = time.perf_counter()
        log(f"  {name} took {now - laps[-1]:.1f} s")
        laps.append(now)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -------------------------------------------------- 1. device, build
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    # nvcc builds the kernel on a host core while phase 9, which launches
    # no hand-written kernel and whose steps are device-bound, trains
    built = {}

    def build():
        t0 = time.perf_counter()
        try:
            _build.build("dslot_matmul")
        except BaseException as exc:  # raised again after phase 9
            built["error"] = exc
        built["s"] = time.perf_counter() - t0

    nvcc_thread = threading.Thread(target=build)
    nvcc_thread.start()

    # -------------------------------------------------- 9. training
    log(f"phase 9: training {TRAIN_ARCH} at full width [{card}] (first, "
        f"while nvcc builds the kernel)")
    n0 = dm.dslot_matmul_cuda.launches
    trained = phase9(card, dev)
    log(f"  dslot kernel launches in phase 9: "
        f"{dm.dslot_matmul_cuda.launches - n0} (the model has no DSLOT "
        f"layer; training launches no hand-written kernel)")
    lap("phase 9")
    # -------------------------------------------------- 11. sharded training
    # next, while nvcc may still build: it launches no hand-written kernel;
    # its ranks share the card, so phase 9's cached blocks are released
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 11: sharded training over {SH_RANKS} ranks [{card}] (while "
        f"nvcc builds the kernel; phase 12's three dry runs start beside it, "
        f"on the host's cores)")
    procs = phase12_start()
    try:
        sharded_peaks = phase11(card, dev, trained["tps"])
        lap("phase 11")
        nvcc_thread.join()
        if "error" in built:
            raise built["error"]
        log(f"build: dslot_matmul.cu in {built['s']:.1f} s (beside phases 9 "
            f"and 11)")
        for line in _build.build_log("dslot_matmul").splitlines():
            if "registers" in line or "spill" in line:
                log("  ptxas:", line.strip())

        lap("phase 1 (the build's wait after phase 11)")
        # ---------------------------------------------- 2. kernel vs plain
        log("phase 2: kernel vs plain version")
        max_err, shape_times = phase2(card, dev)

        lap("phase 2")
        # ---------------------------------------------- 3. main path
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
            raise AssertionError(f"16-image logits: card vs CPU err "
                                 f"{logit_err}")
        for name, st in on_card.layer_stats.items():
            if not torch.equal(st.planes_used.cpu(),
                               on_cpu.layer_stats[name].planes_used):
                raise AssertionError(f"16-image {name} planes_used differ")
        log(f"  16 images, card vs CPU plain version: logits max err "
            f"{logit_err:.3g}, planes_used equal")
        max_err = max(max_err, logit_err)

        lap("phase 3")
        # ---------------------------------------------- 4. times
        log(f"phase 4: times [{card}]")
        with Captured(dm) as cap:
            mnist_cnn.forward_dslot(prep, images, CONFIG, n_planes=8)
        calls = [args for args, _ in cap.calls]
        del cap
        if len(calls) != 2:
            raise AssertionError(f"forward_dslot made {len(calls)} kernel "
                                 f"calls, expected 2 (conv, head)")
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
            f"calls; host issue {host_us(fwd, reps=20):.1f} us per call "
            f"[{card}]")
        prof = forward_profile(fwd)
        if prof is None:
            log("  forward_dslot device time: not measured (the profiler "
                "trace holds no device time)")
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
        log(f"  the serving rows [{card}]")
        serving_rows(card, dev)

        lap("phase 4")
        # ---------------------------------------------- 5. LM serving path
        log(f"phase 5: LM serving path, {LM_ARCH} through generate")
        lm_launches, lm_err, lm_times, lm_counted = phase5(card, dev)
        max_err = max(max_err, lm_err)
        main_times += lm_times

        lap("phase 5")
        # ---------------------------------------------- 6. serving engine
        log(f"phase 6: the slot-pool ServeEngine, {ENGINE_ARCH} with ReLU "
            f"MLPs")
        eng_launches, eng_err, eng_times = phase6(card, dev)
        max_err = max(max_err, eng_err)
        main_times += eng_times

        lap("phase 6")
        # ---------------------------------------------- 7. paper experiment
        log("phase 7: the paper's experiment, the MNIST CNN trained on the "
            "card")
        mn_launches, mn_err, mn_times = phase7(card, dev)
        max_err = max(max_err, mn_err)
        main_times += mn_times

        lap("phase 7")
        # ---------------------------------------------- 8. the model zoo
        log(f"phase 8: the rest of the model zoo at full width [{card}]")
        hy_launches, hy_err, hy_times = phase8(card, dev)
        max_err = max(max_err, hy_err)
        main_times += hy_times

        lap("phase 8")
        # ---------------------------------------------- 10. parallel serving
        log(f"phase 10: tensor- and expert-parallel serving over {TP_RANKS} "
            f"ranks [{card}]")
        tp_launches, tp_err, tp_times = phase10(card, dev)
        max_err = max(max_err, tp_err)
        main_times += tp_times

        lap("phase 10")
        # ---------------------------------------------- 12. launch tools
        log(f"phase 12: the op counter, the dry run and the roofline "
            f"[{card}]")
        t0 = time.perf_counter()
        phase12(card, trained, lm_counted, sharded_peaks, procs)
        log(f"  phase 12 took {time.perf_counter() - t0:.1f} s")
    finally:
        stop(procs)

    t_bytes = sum(t["t_bytes"] for t in main_times)
    t_ops = sum(t["t_ops"] for t in main_times)
    record = {"kernels": [{
        "name": "dslot_matmul", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": main_launches + lm_launches + eng_launches + mn_launches
        + hy_launches + tp_launches,
        "max_abs_err": max_err,
        "ms": sum(t["ms"] for t in main_times),
        "plain_ms": sum(t["plain_ms"] for t in main_times),
        "bound_ms": sum(t["bound_ms"] for t in main_times),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": sum(t["library_ms"] for t in main_times),
        "graph_ms": sum(t["graph_ms"] for t in main_times),
        "library_graph_ms": sum(t["library_graph_ms"] for t in main_times)},
        split_record()]}
    log(f"phases 1-12 took {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
