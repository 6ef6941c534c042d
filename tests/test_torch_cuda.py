"""The CUDA kernel on the card (``repro_torch.kernels.csrc.dslot_matmul``).

These tests need an NVIDIA GPU with ``nvcc``: they carry the ``gpu`` marker
and skip with a reason elsewhere.  They import neither JAX nor the
reference package, so they also run where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

On dyadic weights (multiples of 2^-6) every partial sum is exact in f32,
so the kernel and its plain version must agree bit for bit, ``planes_used``
included.
"""

import dataclasses
import shutil

import numpy as np
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro_torch import convert
from repro_torch.configs.base import DslotConfig
from repro_torch.configs.dslot_mnist import CONFIG
from repro_torch.configs.registry import ARCHS
from repro_torch.core import (csd_matmul, dslot_conv2d_stats, mnist_cnn,
                              sip_conv2d)
from repro_torch.data.mnist import synth_mnist
from repro_torch.kernels import _build
from repro_torch.kernels import dslot_matmul as dm
from repro_torch.models import stats
from repro_torch.models.model_zoo import build_model
from repro_torch.runtime import precision_scope
from repro_torch.serve import (Request, ServeConfig, ServeEngine, SloConfig,
                               check_invariants)
from repro_torch.serve.engine import generate
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.models.model_zoo import loss_fn
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (init_train_state, make_train_step,
                                    microbatch_grads)
from repro_torch.tree import leaves, tree_map
from repro_torch.launch.mesh import run_world

import torch_parallel_ranks


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _dyadic_case(dev, signed, wdtype, seed=7, M=256, K=200, N=64):
    rng = np.random.default_rng(seed)
    lo, hi = (-127, 128) if signed else (0, 256)
    q = torch.as_tensor(rng.integers(lo, hi, (M, K)))
    q = q.to(torch.int8 if signed else torch.uint8).to(dev)
    w = rng.integers(-64, 65, (K, N)) / 64.0
    w[:, : N // 2] -= 0.5                  # clustered ReLU-dead columns
    return q, torch.as_tensor(w, dtype=torch.float32).to(dev, wdtype)


@pytest.mark.gpu
@pytest.mark.parametrize("relu,signed,wdtype", [
    (True, False, torch.float32), (True, True, torch.bfloat16),
    (False, False, torch.float32), (True, False, torch.bfloat16)])
def test_kernel_matches_plain_exactly(cuda, relu, signed, wdtype):
    q, w = _dyadic_case(cuda, signed, wdtype)
    bud = torch.as_tensor(np.random.default_rng(8).integers(1, 9, 256),
                          dtype=torch.int32, device=cuda)
    bound = torch.tensor([8, 0, 8, 3], dtype=torch.int32, device=cuda)
    for kw in ({"block_k": None}, {"block_k": 48, "n_planes_rt": 3},
               {"block_k": 40, "row_budget": bud, "n_planes_rt": bud.max()},
               {"block_k": 64, "plane_bound": bound}):
        args = dict(n_bits=8, relu=relu, block_m=64, block_n=16, **kw)
        n0 = dm.dslot_matmul_cuda.launches
        a = dm.dslot_matmul_cuda(q, w, **args)
        b = dm.dslot_matmul_plain(q, w, **args)
        torch.cuda.synchronize()
        assert dm.dslot_matmul_cuda.launches == n0 + 1
        assert torch.equal(a.planes_used, b.planes_used), kw
        assert torch.equal(a.out, b.out), kw
    if relu and not signed:
        assert int(a.planes_used.min()) < 8, "termination must fire"


@pytest.mark.gpu
@pytest.mark.parametrize("block_m,block_n", [(128, 8), (128, 128), (32, 24),
                                             (16, 5)])
def test_kernel_geometries(cuda, block_m, block_n):
    """Every thread layout the launcher picks for a tile shape."""
    q, w = _dyadic_case(cuda, False, torch.float32, M=256,
                        N=block_n * max(1, 120 // block_n))
    args = dict(relu=True, block_m=block_m, block_n=block_n, block_k=72)
    a = dm.dslot_matmul_cuda(q, w, **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    assert torch.equal(a.planes_used, b.planes_used)
    assert torch.equal(a.out, b.out)


@pytest.mark.gpu
@pytest.mark.parametrize("signed,wdtype", [(False, torch.float32),
                                           (True, torch.float32),
                                           (False, torch.bfloat16)])
def test_split_k_product_matches_plain(cuda, signed, wdtype):
    """The product path (no ReLU) at the CNN head's shape, where K splits
    across blocks: row budgets and a plane bound of 0 cross the slices."""
    q, w = _dyadic_case(cuda, signed, wdtype, M=1024, K=1152, N=16)
    bud = torch.as_tensor(np.random.default_rng(9).integers(1, 9, 1024),
                          dtype=torch.int32, device=cuda)
    for kw in ({}, {"n_planes_rt": 3},
               {"row_budget": bud, "n_planes_rt": bud.max(),
                "plane_bound": torch.tensor([8, 0], dtype=torch.int32,
                                            device=cuda)}):
        args = dict(n_bits=8, relu=False, block_m=128, block_n=8,
                    block_k=None, **kw)
        a = dm.dslot_matmul_cuda(q, w, **args)
        b = dm.dslot_matmul_plain(q, w, **args)
        torch.cuda.synchronize()
        assert torch.equal(a.planes_used, b.planes_used), kw
        assert torch.equal(a.out, b.out), kw


@pytest.mark.gpu
@pytest.mark.parametrize("block_m,block_n,K", [(16, 5, 1024), (32, 24, 1024),
                                               (24, 10, 200), (48, 12, 1024),
                                               (256, 32, 1024)])
def test_padded_mma_geometries(cuda, block_m, block_n, K):
    """Tiles that the mma shape (16 rows, 8 columns) pads: the physical pad
    neither votes nor is stored.  Each of these tiles streams W with its q
    rows staged once, except 256 x 32 at K = 1024, whose q rows do not fit
    beside the ring and are copied with each sub-chunk."""
    q, w = _dyadic_case(cuda, True, torch.float32, M=block_m * 8, K=K,
                        N=block_n * 6)
    bud = torch.as_tensor(np.random.default_rng(10).integers(1, 9,
                                                             block_m * 8),
                          dtype=torch.int32, device=cuda)
    for kw in ({"block_k": None}, {"block_k": 72 if K == 200 else 256},
               {"block_k": None, "row_budget": bud,
                "n_planes_rt": bud.max()}):
        args = dict(relu=True, block_m=block_m, block_n=block_n, **kw)
        a = dm.dslot_matmul_cuda(q, w, **args)
        b = dm.dslot_matmul_plain(q, w, **args)
        torch.cuda.synchronize()
        assert torch.equal(a.planes_used, b.planes_used), kw
        assert torch.equal(a.out, b.out), kw


@pytest.mark.gpu
@pytest.mark.parametrize("K", [200, 1024])
def test_wide_range_f32_weights(cuda, K):
    """f32 weights of magnitudes 2^-20 to 1 go through the tensor cores as
    three bf16 parts and keep f32 accuracy: within rtol 1e-5 plus
    1e-5 * max|out| of the plain version (f32 sums in other orders)."""
    rng = np.random.default_rng(11)
    q = torch.as_tensor(rng.integers(0, 256, (256, K)),
                        dtype=torch.uint8).to(cuda)
    w = rng.choice([-1.0, 1.0], (K, 64)) * np.exp2(rng.uniform(-20, 0,
                                                               (K, 64)))
    w = torch.as_tensor(w, dtype=torch.float32).to(cuda)
    args = dict(relu=True, block_m=64, block_n=32, block_k=None)
    a = dm.dslot_matmul_cuda(q, w, **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    tol = 1e-5 * b.out.abs() + 1e-5 * b.out.abs().max()
    assert bool(((a.out - b.out).abs() <= tol).all()), \
        float((a.out - b.out).abs().max())
    assert torch.equal(a.planes_used, b.planes_used)


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [False, True])
def test_two_launches_bit_identical(cuda, relu):
    """No float atomics: the split-K product and the plane path give the
    same bits on every launch, on weights whose sums round."""
    rng = np.random.default_rng(12)
    q = torch.as_tensor(rng.integers(0, 256, (1024, 1152)),
                        dtype=torch.uint8).to(cuda)
    w = torch.as_tensor(rng.normal(0, 0.03, (1152, 16)),
                        dtype=torch.float32).to(cuda)
    args = dict(relu=relu, block_m=128, block_n=8, block_k=None)
    a = dm.dslot_matmul_cuda(q, w, **args)
    b = dm.dslot_matmul_cuda(q, w, **args)
    torch.cuda.synchronize()
    assert torch.equal(a.out, b.out)
    assert torch.equal(a.planes_used, b.planes_used)


@pytest.mark.gpu
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, w = _dyadic_case(cuda, False, torch.float32)
    with pytest.raises(TypeError):
        dm.dslot_matmul_cuda(q.to(torch.int64), w, block_m=64, block_n=16)
    with pytest.raises(TypeError):
        dm.dslot_matmul_cuda(q, w.to(torch.float16), block_m=64, block_n=16)
    # the kernel takes n_bits up to 30 (its plane scales are bf16 powers of
    # two); above that the launcher refuses and the wrapper raises
    with pytest.raises(RuntimeError, match="launch failed"):
        dm.dslot_matmul_cuda(q, w, n_bits=31, block_m=64, block_n=16)


# Tiles the kernel once refused: (block_m, block_n, K, M, N).  128 x 24 and
# 512 x 8 need more than 16 warps of (1, 1) warp tiles; 1024 x 24 at
# K = 1024 also a 2-stage ring; N = 70000 at block_n 1 and 64 x 65537 at
# block_n 64 more N tiles than grid.y holds; 144 x 24 rounds its physical
# rows up to 160, past block_m; 256 x 66 pads to 256 x 72 (9 warps of
# 256 x 8).
REPAIRED_TILES = [(128, 24, 1024, 512, 96), (1024, 24, 1024, 2048, 48),
                  (512, 8, 25, 1024, 16), (512, 8, 1024, 1024, 16),
                  (16, 1, 64, 32, 70000), (16, 64, 16, 16, 64 * 65537),
                  (144, 24, 256, 288, 48), (256, 66, 64, 512, 132)]


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_m,block_n,K,M,N", REPAIRED_TILES)
def test_repaired_tiles_match_plain_exactly(cuda, block_m, block_n, K, M, N,
                                            relu, wdtype):
    """Each repaired tile on dyadic weights, with row budgets: output and
    planes_used equal to the plain version's bit for bit."""
    q, w = _dyadic_case(cuda, True, wdtype, seed=11, M=M, K=K, N=N)
    bud = torch.as_tensor(np.random.default_rng(12).integers(1, 9, M),
                          dtype=torch.int32, device=cuda)
    args = dict(relu=relu, block_m=block_m, block_n=block_n, block_k=None,
                row_budget=bud, n_planes_rt=bud.max())
    a = dm.dslot_matmul_cuda(q, w, **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    torch.cuda.synchronize()
    assert torch.equal(a.planes_used, b.planes_used)
    assert torch.equal(a.out, b.out)


@pytest.mark.gpu
def test_forward_dslot_launches_twice_and_matches_cpu(cuda):
    params = mnist_cnn.init_cnn(CONFIG, torch.Generator().manual_seed(0))
    images = torch.rand((8, 28, 28),
                        generator=torch.Generator().manual_seed(1)).to(cuda)
    prep = mnist_cnn.calibrate_cnn(mnist_cnn.prepare_cnn(params, CONFIG),
                                   images, CONFIG)
    n0 = dm.dslot_matmul_cuda.launches
    res = mnist_cnn.forward_dslot(prep, images, CONFIG, n_planes=6)
    torch.cuda.synchronize()
    assert dm.dslot_matmul_cuda.launches == n0 + 2
    cpu = mnist_cnn.prepare_cnn(mnist_cnn.CNNParams(
        params.conv.cpu(), params.dense.cpu()), CONFIG)
    cpu = mnist_cnn.calibrate_cnn(cpu, images.cpu(), CONFIG)
    ref = mnist_cnn.forward_dslot(cpu, images.cpu(), CONFIG, n_planes=6)
    # separately calibrated head scales may differ in the last ulp
    torch.testing.assert_close(res.logits.cpu(), ref.logits, rtol=1e-4,
                               atol=1e-4)


def _seamless_dead_columns(device):
    """Reduced seamless-m4t-medium with DSLOT on (block_m = B = 4, so a
    decode step's rows fill their tile) and half of every up-projection's
    columns ReLU-dead (norm2 bias 1, those columns' weights lowered by 0.5),
    so whole tiles terminate early; params on ``device``."""
    cfg = dataclasses.replace(
        ARCHS["seamless-m4t-medium"].reduced(),
        dslot=DslotConfig(enabled=True, block_m=4, block_n=32))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    for stack in ("encoder", "decoder"):
        for layer in params[stack]["rest"]:
            layer["norm2"]["bias"] += 1.0
            layer["mlp"]["up"]["w"][:, ::2] -= 0.5
    params = convert.model_params(params, device=device)
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (4, 6), generator=g),
             "frontend": torch.randn((4, cfg.frontend_len, cfg.d_model),
                                     generator=g) * 0.5,
             "src_embeds": torch.randn((4, 8, cfg.d_model), generator=g)}
    batch = {k: v.to(device) for k, v in batch.items()}
    return cfg, model, model.prepare_dslot(params), batch


@pytest.mark.gpu
def test_seamless_generate_on_card_matches_cpu(cuda):
    """The reduced LM serving path through the kernel equals the same run on
    the CPU (the kernel's plain version): tokens and plane statistics."""
    cfg, model, params, batch = _seamless_dead_columns(cuda)
    _, _, params_cpu, batch_cpu = _seamless_dead_columns("cpu")
    budgets = torch.tensor([8, 8, 4, 2], dtype=torch.int32)
    n0 = dm.dslot_matmul_cuda.launches
    res = generate(model, params, batch, 5, n_planes=budgets.to(cuda))
    torch.cuda.synchronize()
    layers = cfg.encoder_layers + cfg.n_layers
    assert dm.dslot_matmul_cuda.launches == n0 + layers + 5 * cfg.n_layers
    ref = generate(model, params_cpu, batch_cpu, 5, n_planes=budgets)
    assert torch.equal(res.tokens.cpu(), ref.tokens)
    assert torch.equal(res.planes_used_mean.cpu(), ref.planes_used_mean)
    assert torch.equal(res.skipped_frac.cpu(), ref.skipped_frac)
    assert float(ref.skipped_frac.max()) > 0, "termination must fire"
    with stats.collect() as card, precision_scope(6):
        logits, _, _ = model.forward(params, batch, mode="prefill")
    with stats.collect() as host, precision_scope(6):
        want, _, _ = model.forward(params_cpu, batch_cpu, mode="prefill")
    for a, b in zip(card["mlp_up_dslot.row_planes_used"],
                    host["mlp_up_dslot.row_planes_used"]):
        assert torch.equal(a.cpu(), b)
    # f32 products in another order (and on the tensor cores as three bf16
    # parts inside the kernel): the CPU parity tests' bound
    torch.testing.assert_close(logits.cpu(), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))



def _olmo_engine_run(device, arch="olmo-1b", prompt_len=5):
    """The reduced f32 olmo-1b (or ``arch``) with a ReLU MLP on the
    digit-serial path (calibrated act_scale, block_m = n_slots) through the
    slot-pool engine: a burst of 6 requests on 2 slots (prompts of
    ``prompt_len`` + 2i tokens), chunked batched admission, per-request
    budgets and SLO plane shedding.  Returns the requests and the engine's
    decode forward count."""
    cfg = dataclasses.replace(
        ARCHS[arch].reduced(), act="relu", glu=False,
        dslot=DslotConfig(enabled=True, block_m=2, block_n=32, block_k=16,
                          act_scale=0.05))
    model = build_model(cfg)
    params = convert.model_params(
        model.init(torch.Generator().manual_seed(0), device="cpu"),
        device=device)
    eng = ServeEngine(model, params, ServeConfig(
        n_slots=2, max_len=64, prefill_chunk=4, chunks_per_step=2,
        slo=SloConfig(queue_high_water=1, shed_patience=1,
                      restore_patience=2, target_ttft_steps=100)))
    decodes = []
    decode = eng._decode
    eng._decode = lambda *a: decodes.append(1) or decode(*a)
    rng = np.random.default_rng(2)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, prompt_len + 2 * i),
                    max_new=4, n_planes=(8, 6, None, 3, 8, 5)[i],
                    tier=("reserved", "degradable", "standard")[i % 3])
            for i in range(6)]
    for r in reqs:
        assert eng.try_add(r)
    while not all(r.done for r in reqs):
        eng.step()
        check_invariants(eng)
    return cfg, eng, reqs, len(decodes)


@pytest.mark.gpu
def test_olmo_engine_on_card_matches_cpu(cuda):
    """The engine's reduced DSLOT scenario on the card gives the streams and
    per-request plane accounts of the same run on the CPU (the kernel's
    plain version), with one kernel launch per layer per forward."""
    _engine_on_card_matches_cpu(cuda, "olmo-1b", 5)


@pytest.mark.gpu
def test_recurrentgemma_engine_on_card_matches_cpu(cuda):
    """The same scenario on the hybrid RG-LRU stack with ReLU MLPs: its
    prompts (30-40 tokens) wrap the local-attention ring (window 32
    reduced) inside the lanes."""
    _engine_on_card_matches_cpu(cuda, "recurrentgemma-2b", 30)


def _engine_on_card_matches_cpu(cuda, arch, prompt_len):
    n0 = dm.dslot_matmul_cuda.launches
    cfg, eng, reqs, decodes = _olmo_engine_run(cuda, arch, prompt_len)
    torch.cuda.synchronize()
    launched = dm.dslot_matmul_cuda.launches - n0
    assert launched == cfg.n_layers * (decodes + eng.pipeline.forwards)
    _, ref_eng, ref, _ = _olmo_engine_run("cpu", arch, prompt_len)
    assert eng.slo.shed_events == ref_eng.slo.shed_events > 0
    for a, b in zip(reqs, ref):
        assert a.phase == b.phase == "done"
        assert a.out == b.out, a.uid
        assert a.token_steps == b.token_steps
        assert abs(a.result.planes_used_mean - b.result.planes_used_mean) \
            <= 1e-6, a.uid


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "granite-moe-1b-a400m",
                                  "mamba2-780m", "recurrentgemma-2b"])
def test_zoo_generate_on_card_matches_cpu(cuda, arch):
    """One reduced f32 ``generate`` per new layer kind (sliding window, MoE,
    mamba2 SSD, RG-LRU) on the card equals the CPU run: the same tokens,
    and prefill logits within the CPU parity tests' 1e-4 of the largest.
    The 40-token prompts wrap the reduced window's ring (32)."""
    cfg = ARCHS[arch].reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (3, 40), generator=g)}
    on_card = tree_map(lambda a: a.to(cuda), (params, batch))
    res = generate(model, *on_card, 6)
    ref = generate(model, params, batch, 6)
    assert torch.equal(res.tokens.cpu(), ref.tokens)
    logits, _ = model.prefill(*on_card)
    want, _ = model.prefill(params, batch)
    torch.testing.assert_close(logits.cpu(), want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.gpu
def test_train_cnn_epoch_on_card_matches_cpu(cuda):
    """One epoch of ``train_cnn`` on the card (cuDNN, full f32) against the
    same epoch on the CPU from the same seeded weights: the two sum in
    other orders, which over 5 steps stays far inside 1e-5 of the largest
    parameter; the accuracy counts must be equal."""
    imgs, labels = synth_mnist(8, seed=0)
    kw = dict(epochs=1, batch=16, lr=2e-2, seed=0)
    card, acc_card = mnist_cnn.train_cnn(CONFIG, imgs, labels, device=cuda,
                                         **kw)
    cpu, acc_cpu = mnist_cnn.train_cnn(CONFIG, imgs, labels, device="cpu",
                                       **kw)
    for a, b in zip(card, cpu):
        assert a.is_cuda
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    assert round(acc_card * len(imgs)) == round(acc_cpu * len(imgs))


@pytest.mark.gpu
def test_dslot_conv2d_stats_on_card_matches_cpu(cuda):
    """The digit-serial simulator on the card: every Algorithm-1 field and
    the SOPs equal the CPU's, and DSLOT equals SIP there too."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(0, 1, (3, 16, 16)), dtype=torch.float32)
    x[:, :3] = 0.0
    w = torch.as_tensor(rng.normal(-0.05, 0.25, (8, 5, 5)),
                        dtype=torch.float32)
    card = dslot_conv2d_stats(x.to(cuda), w.to(cuda))
    cpu = dslot_conv2d_stats(x, w)
    for field in ("is_negative", "term_digit", "cycles_used", "cycles_saved",
                  "savings_frac"):
        assert torch.equal(getattr(card.report, field).cpu(),
                           getattr(cpu.report, field)), field
    assert torch.equal(card.y_conv.cpu(), cpu.y_conv)
    assert torch.equal(card.y_pooled.cpu(), cpu.y_pooled)
    assert torch.equal(sip_conv2d(x.to(cuda), w.to(cuda)), card.y_conv)
    q = torch.as_tensor(rng.integers(-255, 256, (64, 48)), dtype=torch.int32)
    w_q = torch.as_tensor(rng.integers(-127, 128, (48, 16)),
                          dtype=torch.int32)
    out, _ = csd_matmul(q.to(cuda), w_q.to(cuda))
    assert torch.equal(out.cpu(), q @ w_q)


def _relu_dslot_olmo():
    cfg = dataclasses.replace(
        ARCHS["olmo-1b"].reduced(), act="relu", glu=False,
        dslot=DslotConfig(enabled=True, block_m=16, block_n=32))
    return cfg, build_model(cfg)


@pytest.mark.gpu
def test_dslot_kernel_raises_under_autograd(cuda):
    """The kernel has no backward pass: a train forward whose up-projection
    weights autograd tracks raises before launching, instead of dropping
    their gradient; without grad the same forward launches the kernel."""
    cfg, model = _relu_dslot_olmo()
    params = model.init(torch.Generator(cuda).manual_seed(0), device=cuda)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    toks = torch.randint(0, cfg.vocab_size, (2, 8), device=cuda)
    batch = {"tokens": toks, "labels": toks}
    n0 = dm.dslot_matmul_cuda.launches
    with pytest.raises(RuntimeError, match="no backward pass"):
        loss_fn(model, live, batch)
    assert dm.dslot_matmul_cuda.launches == n0
    with torch.no_grad():
        loss, _ = loss_fn(model, live, batch)
    assert dm.dslot_matmul_cuda.launches == n0 + cfg.n_layers
    assert bool(torch.isfinite(loss))


@pytest.mark.gpu
def test_train_step_on_card_matches_cpu(cuda):
    """One AdamW step of a reduced olmo-1b (f32, two remat groups and a rest
    layer, M = 2) on the card and on the CPU from the same state: loss and
    grad_norm within 1e-5 relative, gradients within 1e-4 of each leaf's
    largest; parameters within 1e-3 * lr where the CPU's |g| exceeds 1e-3
    of its leaf's largest, and within 2 * lr everywhere (Adam's first step
    is about lr * sign(g), and a near-zero gradient may change sign)."""
    cfg = dataclasses.replace(ARCHS["olmo-1b"].reduced(), n_layers=5)
    model = build_model(cfg)
    lr = 1e-3
    opt = AdamWConfig(peak_lr=lr, warmup_steps=0, decay_steps=7)
    state = init_train_state(model, torch.Generator().manual_seed(0),
                             device="cpu")
    on_card = tree_map(lambda a: a.to(cuda, copy=True), state)
    host = TokenPipeline(vocab=cfg.vocab_size, seq_len=32, global_batch=4,
                         microbatches=2).next_host_batch()
    cpu_batch = {k: torch.from_numpy(v) for k, v in host.items()}
    card_batch = {k: v.to(cuda) for k, v in cpu_batch.items()}
    g_card, _, _ = microbatch_grads(model, on_card.params, card_batch)
    g_cpu, _, _ = microbatch_grads(model, state.params, cpu_batch)
    for a, b in zip(leaves(g_card), leaves(g_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=0,
                                   atol=1e-4 * float(b.abs().max()))
    step = make_train_step(model, opt)
    card, mc = step(on_card, card_batch)
    cpu, mh = step(state, cpu_batch)
    for k in ("loss", "grad_norm", "lr"):
        assert mc[k].is_cuda
        torch.testing.assert_close(mc[k].cpu(), mh[k], rtol=1e-5, atol=0)
    for a, b, g in zip(leaves(card.params), leaves(cpu.params),
                       leaves(g_cpu)):
        d = (a.cpu() - b).abs()
        assert float(d.max()) <= 2 * lr
        firm = g.abs() > 1e-3 * g.abs().max()
        assert float(d[firm].max()) <= 1e-3 * lr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler means a clear error, never a silent plain-version
    fallback."""
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_target",
                        lambda name: tmp_path / "missing" / f"lib{name}.so")
    monkeypatch.setattr(_build, "_LOADED", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("dslot_matmul")


@pytest.mark.gpu
def test_sharded_execute_on_card_equals_unsharded(cuda):
    """Two ranks sharing the card over gloo: the sharded execute (ReLU,
    f32 and bf16 weights, scalar and per-row budgets, sorted columns, a
    tile count the shards do not divide) equals the unsharded launch bit
    for bit, statistics included."""
    _build.build("dslot_matmul")          # once, before the ranks load it
    rng = np.random.default_rng(5)
    cases = []
    for wdtype, npl, sort in (("float32", 8, True), ("bfloat16", 3, False),
                              ("float32", "rows", True)):
        w = rng.normal(0, 0.05, (96, 120)).astype(np.float32)
        w[:, ::3] -= 0.1                   # ReLU-dead columns terminate
        x = rng.normal(0.2, 0.5, (64, 96)).astype(np.float32)
        if npl == "rows":
            npl = rng.integers(1, 9, 64).astype(np.int32)
        cases.append(dict(w=w, wdtype=wdtype, x=x, npl=npl, kw=dict(
            sort_columns=sort, block_m=16, block_n=24, signed=True)))
    flags = run_world(torch_parallel_ranks.card_execute, 2, backend="gloo",
                      device="cuda:0", timeout=120, deadline=300,
                      args=(cases,))
    for rank_flags in flags:
        for case_flags in rank_flags:
            assert all(case_flags.values()), case_flags


@pytest.mark.gpu
def test_sharded_step_on_card_matches_single_device(cuda):
    """A 2-rank sharded train step (mesh (2, 1), ``gloo``, both ranks on
    ``cuda:0``) of reduced olmo-1b against the single-device step on the
    card: loss and grad_norm within 1e-5 relative, parameters within
    1e-3 lr where the single step's |m| is firm and 2 lr anywhere (the two
    data shards' gradient means are the same f32 sums in another order)."""
    _card_step_matches_single_device(cuda, (2, 1))


@pytest.mark.gpu
def test_split_step_on_card_matches_single_device(cuda):
    """The same over mesh (1, 2): the compute split over the model axis
    (heads, MLP columns, the vocab), the row-parallel sums in another
    order; the same bounds."""
    _card_step_matches_single_device(cuda, (1, 2))


def _card_step_matches_single_device(cuda, shape):
    import torch_sharded_ranks as sranks

    cfg = ARCHS["olmo-1b"].reduced()
    opt = dict(peak_lr=1e-3, warmup_steps=0, decay_steps=10)
    st = init_train_state(build_model(cfg), torch.Generator().manual_seed(0),
                          device="cpu")
    state_np = tree_map(lambda a: a.numpy(), st)
    host = TokenPipeline(vocab=cfg.vocab_size, seq_len=16, global_batch=8,
                         microbatches=2).next_host_batch()
    one, m1 = make_train_step(build_model(cfg), AdamWConfig(**opt))(
        convert.train_state(state_np, device=cuda),
        {k: torch.from_numpy(v).to(cuda) for k, v in host.items()})
    (full, m2), _ = run_world(sranks.card_step, 2, backend="gloo",
                              device="cuda:0", timeout=120, deadline=300,
                              args=(cfg, state_np, host, opt, shape))
    for k in ("loss", "grad_norm"):
        assert abs(m2[k] - float(m1[k])) <= 1e-5 * abs(float(m1[k])), k
    lr = float(m1["lr"])
    for a, b, m in zip(leaves(full.params), leaves(one.params),
                       leaves(one.opt.m)):
        d = np.abs(np.asarray(a, np.float32) - b.float().cpu().numpy())
        m = m.abs().cpu().numpy()
        firm = m > 1e-3 * m.max()
        assert d.max() <= 2 * lr
        if firm.any():
            assert d[firm].max() <= 1e-3 * lr


# Tiles that only walk_kernel took, and (4, 4) with a 2-stage ring:
# (block_m, block_n, K, M, N, n_bits).  16 x 256 needs 32 warps of (1, 1)
# and has no (2, 2) fit (16 rows); 1024 x 136 needs 68 warps of 256 x 8
# and its f32 sums (557 KB) fit no SM; 512 x 32 with int32 q (n_bits 20)
# overflows 3 ring stages of (4, 4) (287 KB); block_m 2048 and 4096 at 8
# and 24 columns overflow even a 2-stage ring beside their digit tile.
# Row budgets of at most 8 planes keep n_bits 20's sums exact in f32.
WALKED_TILES = [(16, 256, 1024, 64, 512, 8), (1024, 136, 256, 2048, 272, 8),
                (512, 32, 256, 1024, 64, 20), (2048, 8, 256, 4096, 16, 8),
                (2048, 24, 256, 4096, 48, 8), (4096, 8, 256, 8192, 16, 8),
                (4096, 24, 256, 8192, 48, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_m,block_n,K,M,N,n_bits", WALKED_TILES)
def test_walked_tiles_match_plain_exactly(cuda, block_m, block_n, K, M, N,
                                          n_bits, relu, wdtype):
    """Each tile the kernel refused before, on dyadic weights with row
    budgets: output and planes_used equal to the plain version's bit for
    bit, and two launches give the same bits."""
    rng = np.random.default_rng(13)
    top = 2 ** (n_bits - 1) - 1
    q = torch.as_tensor(rng.integers(-top, top + 1, (M, K)))
    q = q.to(dm.q_storage_dtype(n_bits, signed=True)).to(cuda)
    w = rng.integers(-64, 65, (K, N)) / 64.0
    w[:, : N // 2] -= 0.5                  # clustered ReLU-dead columns
    w = torch.as_tensor(w, dtype=torch.float32).to(cuda, wdtype)
    bud = torch.as_tensor(rng.integers(1, 9, M), dtype=torch.int32,
                          device=cuda)
    args = dict(n_bits=n_bits, relu=relu, block_m=block_m, block_n=block_n,
                block_k=128 if K == 256 else None, row_budget=bud,
                n_planes_rt=bud.max())
    a = dm.dslot_matmul_cuda(q, w, **args)
    a2 = dm.dslot_matmul_cuda(q, w, **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    torch.cuda.synchronize()
    assert torch.equal(a.planes_used, b.planes_used)
    assert torch.equal(a.out, b.out)
    assert torch.equal(a.out, a2.out)


# Walked tiles by the kernel each takes: (block_m, block_n, K, M, N, n_bits,
# signed q, relu, kernel).  16 x 256 with 8-bit signed q on the band
# kernel's 2-block clusters; the same tile with int16 q over a cluster of
# two column groups; 256 x 256 over 8 row groups by 2 column groups;
# 2048 x 8 with unsigned q over 16 row groups; without ReLU at 26 bits
# (past the product path) a tall tile's resident slices and a 16 x 256
# tile's streamed ones; 512 x 32 with int32 q, whose (4, 4) warp tiles
# overflow 3 ring stages of one block, over 16 row groups of 32 rows, with
# ReLU at 20 bits and without at 26; 4096 x 136, whose f32 sums (2.2 MB)
# no cluster holds, on walk_kernel.
CLUSTER_TILES = [(16, 256, 1024, 64, 512, 8, True, True, "band_kernel"),
                 (16, 256, 1024, 64, 512, 12, True, True, "cluster_kernel"),
                 (256, 256, 256, 512, 512, 12, True, True, "cluster_kernel"),
                 (2048, 8, 256, 4096, 16, 8, False, True, "cluster_kernel"),
                 (2048, 8, 256, 4096, 16, 26, True, False, "cluster_kernel"),
                 (16, 256, 256, 64, 512, 26, True, False, "cluster_kernel"),
                 (512, 32, 256, 1024, 64, 20, True, True, "cluster_kernel"),
                 (512, 32, 256, 1024, 64, 26, True, False, "cluster_kernel"),
                 (4096, 136, 128, 4096, 136, 8, True, True, "walk_kernel")]


@pytest.mark.gpu
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block_m,block_n,K,M,N,n_bits,signed,relu,kernel",
                         CLUSTER_TILES)
def test_cluster_tiles_match_plain_exactly(cuda, block_m, block_n, K, M, N,
                                           n_bits, signed, relu, kernel,
                                           wdtype):
    """Each walked tile's kernel (``dm.route``), on dyadic weights with row
    budgets (at most 8 planes: 26-bit sums stay exact in f32): output and
    planes_used equal to the plain version's bit for bit, and two launches
    give the same bits."""
    rng = np.random.default_rng(14)
    top = 2 ** (n_bits - 1) - 1 if signed else 2 ** n_bits - 1
    q = torch.as_tensor(rng.integers(-top if signed else 0, top + 1, (M, K)))
    q = q.to(dm.q_storage_dtype(n_bits, signed=signed)).to(cuda)
    w = rng.integers(-64, 65, (K, N)) / 64.0
    w[:, : N // 2] -= 0.5                  # clustered ReLU-dead columns
    w = torch.as_tensor(w, dtype=torch.float32).to(cuda, wdtype)
    bud = torch.as_tensor(rng.integers(1, 9, M), dtype=torch.int32,
                          device=cuda)
    bk = 128 if K <= 256 else None
    assert dm.route(M, K, N, block_m, block_n, bk or K, n_bits, relu,
                    q.dtype, w.dtype) == kernel
    args = dict(n_bits=n_bits, relu=relu, block_m=block_m, block_n=block_n,
                block_k=bk, row_budget=bud, n_planes_rt=bud.max())
    a = dm.dslot_matmul_cuda(q, w, **args)
    a2 = dm.dslot_matmul_cuda(q, w, **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    torch.cuda.synchronize()
    assert torch.equal(a.planes_used, b.planes_used)
    assert torch.equal(a.out, b.out)
    assert torch.equal(a.out, a2.out)


# The (4, 4) warp tiles of plane_kernel: block_m a multiple of 64, block_n
# of 32, more rows times columns than (2, 2) covers in 8 warps and at most
# what (4, 4) covers in 8.
WIDE_TILES = [(bm, bn) for bn in range(32, 257, 32)
              for bm in range(64, 513, 64) if 4096 < bm * bn <= 16384]
# q types with the widest digits each holds, ReLU, and int32 past the
# product path without it
WIDE_Q = [(torch.uint8, 8, False, True), (torch.int8, 8, True, True),
          (torch.uint16, 16, False, True), (torch.int16, 16, True, True),
          (torch.int32, 20, True, True), (torch.int32, 26, True, False)]


@pytest.mark.gpu
def test_wide_q_tiles_take_no_two_stage_four_by_four(cuda):
    """Every (4, 4) geometry at every q type, K 64 to 16384 and both weight
    types launches the kernel ``dm.route`` names, once (all launches in one
    ``torch.profiler`` trace, in stream order), and never a 2-stage ring of
    (4, 4) warp tiles; 512 x 32 with int32 q past K = 64 takes
    cluster_kernel."""
    import re
    from torch.profiler import ProfilerActivity, profile

    assert len(WIDE_TILES) == 17
    want = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for bm, bn in WIDE_TILES:
            for qt, n_bits, signed, relu in WIDE_Q:
                top = 2 ** (n_bits - 1) - 1 if signed else 2 ** n_bits - 1
                for K in (64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384):
                    for wdtype in (torch.float32, torch.bfloat16):
                        kernel = dm.route(bm, K, bn, bm, bn, K, n_bits, relu,
                                          qt, wdtype)
                        if (bm, bn, qt) == (512, 32, torch.int32) and K > 64:
                            assert kernel == "cluster_kernel", (K, n_bits)
                        q = torch.full((bm, K), top, dtype=qt).to(cuda)
                        w = torch.full((K, bn), -2.0 ** -6, dtype=wdtype,
                                       device=cuda)
                        dm.dslot_matmul_cuda(q, w, n_bits=n_bits, relu=relu,
                                             block_m=bm, block_n=bn,
                                             block_k=K)
                        want.append(kernel)
        torch.cuda.synchronize()
    assert len(want) == 17 * 6 * 9 * 2
    launched = sorted((e.time_range.start, e.name) for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and any(k in e.name for k in dm._ROUTES))
    assert len(launched) == len(want)
    two_stage = re.compile(r"plane_kernel<4, 4, [^<>]*, 2, true>")
    for kernel, (_, name) in zip(want, launched):
        assert kernel in name, (kernel, name)
        assert not two_stage.search(name), name


# ------------------------------------------------------------ band path

# The serving shapes (rows, K, N, block_m) the band kernel takes: engine and
# hybrid admission, their decode, the tp2 shards, the LM encoder, decode and
# a prefill of 4160 rows at block_m 128.
BAND_SHAPES = [(128, 2048, 8192, 16), (256, 2560, 7680, 16),
               (16, 2048, 8192, 16), (16, 2560, 3840, 16),
               (32, 1024, 4096, 128), (4, 1024, 4096, 128),
               (4160, 1024, 4096, 128)]


def _band_launch(cuda, rows, K, N, bm, w, x, npl=None):
    """The captured launch of ``dslot_execute`` on prepared ``w``: kernel
    result, a second launch, the plain version on the same arguments."""
    from repro_torch.kernels.ops import dslot_execute, dslot_prepare

    prep = dslot_prepare(w, n_bits=8, relu=True, signed=True, block_m=bm,
                         block_n=128)
    calls = []
    run = dm.run
    dm.run = lambda *a: calls.append(a) or run(*a)
    try:
        n0 = dm.split_parts.launches
        dslot_execute(prep, x, n_planes=npl)
        assert dm.split_parts.launches == n0, "execute must not split W"
    finally:
        dm.run = run
    args = calls[0]
    assert args[13] is prep.parts and args[14] == rows
    a = dm._launch(*args)
    b = dm._launch(*args)
    c = dm._replay(*args)
    torch.cuda.synchronize()
    return a, b, c


@pytest.mark.gpu
@pytest.mark.parametrize("rows,K,N,bm", BAND_SHAPES)
def test_band_kernel_matches_plain_at_serving_shapes(cuda, rows, K, N, bm):
    """Dyadic weights (bf16 holds them: one prepared part) make every sum
    exact, so the band kernel equals its plain version bit for bit, per-row
    budgets included, and two launches give the same bits."""
    rng = np.random.default_rng(rows + K)
    w = torch.as_tensor(rng.integers(-64, 65, (K, N)) / 64.0 - 0.25,
                        dtype=torch.float32).to(cuda)
    x = torch.as_tensor(rng.normal(0.2, 1.0, (rows, K)),
                        dtype=torch.float32).to(cuda)
    npl = torch.as_tensor(rng.integers(1, 9, rows), dtype=torch.int32,
                          device=cuda)
    for budget in (None, npl):
        a, b, c = _band_launch(cuda, rows, K, N, bm, w, x, budget)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert torch.equal(a[1], c[1])
        assert torch.equal(a[0], c[0])


@pytest.mark.gpu
def test_band_kernel_mixed_vote_tiles(cuda):
    """The CPU test's mixed-vote case on the card: vote tiles of one N tile
    stop at different planes, each by its own vote (f32 weights: three
    prepared parts; sums in another order, so outputs within 1e-5)."""
    x, w = torch_parallel_ranks.mixed_vote_case()
    a, b, c = _band_launch(cuda, x.shape[0], 128, 128, 16,
                           torch.as_tensor(w).to(cuda),
                           torch.as_tensor(x).to(cuda))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(a[1], c[1])
    assert len(set(a[1][:, 0].tolist())) >= 3
    scale = float(c[0].abs().max())
    assert bool(((a[0] - c[0]).abs() <= 1e-5 * c[0].abs() + 1e-5 * scale)
                .all())


def _split_launches(fn):
    """``fn()`` under ``torch.profiler``: (its result, the names of the
    CUDA kernels it launched)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.gpu
@pytest.mark.parametrize("block_n", [5, 66, 128, 136])
def test_split_parts_kernel_matches_plain(cuda, block_n):
    """W's parts bit-equal to ``split_parts_plain`` from f32 weights to
    three parts and to one, from bf16 weights to one and three, from a
    contiguous view at an offset (4 bytes past the allocation: the general
    path even where block_n is a multiple of 8) and from an N of one tile
    (66 at block_n 66: rows not 16-byte aligned); each call one launch of
    split_parts_kernel and no other kernel."""
    rng = np.random.default_rng(block_n)
    mag = np.exp2(rng.uniform(-20.0, 0.0, (64, 3 * block_n)))
    w = torch.as_tensor(np.where(rng.random(mag.shape) < 0.5, -mag, mag),
                        dtype=torch.float32)
    flat = torch.as_tensor(rng.normal(0.0, 1.0, w.numel() + 1),
                           dtype=torch.float32)
    cases = [(3, w), (1, w), (1, w.to(torch.bfloat16)),
             (3, w.to(torch.bfloat16)), (3, "view"), (1, w[:, :block_n])]
    n0 = dm.split_parts.launches
    for n_parts, src in cases:
        if isinstance(src, str):    # a view with an offset, on the card
            base = flat.to(cuda)
            dev = base[1:].view(w.shape)
            src = flat[1:].view(w.shape)
            assert dev.data_ptr() % 16 == 4 and dev.is_contiguous()
        else:
            dev = src.contiguous().to(cuda)
        got, names = _split_launches(
            lambda: dm.split_parts(dev, block_n, n_parts))
        assert len(names) == 1 and "split_parts_kernel" in names[0], names
        want = dm.split_parts_plain(src.contiguous(), block_n, n_parts)
        assert torch.equal(got.cpu(), want), (n_parts, src.dtype)
    assert dm.split_parts.launches == n0 + len(cases)


# ------------------------------------------------------------ narrow tiles

# The launchers' tiles on the band kernel: (M, K, block_m, block_n,
# block_k).  Engine admission's 32 x 32 and 16 x 16 (bands of 64 rows),
# 16 x 32 at block_k 16 (votes inside a sub-chunk), 16 x 64; a 32-row band
# at block_k 32 (computed as 64 rows), decode bands of 16 rows (blocks of
# one warpgroup) and 1024 rows (bands of 64 over 8 blocks of 128 columns,
# of 128 rows over 9).
NARROW_TILES = [(128, 256, 32, 32, None), (128, 256, 16, 16, None),
                (128, 256, 16, 32, 16), (128, 256, 16, 64, None),
                (32, 256, 16, 16, 32), (16, 256, 16, 32, 16),
                (16, 256, 16, 16, None), (1024, 256, 32, 32, 128)]


def _narrow_case(cuda, M, K, N, bm, bn, seed=15):
    """Signed 8-bit q whose row tiles alternate sign and dyadic weights
    whose column tiles alternate sign (the negative ones at falling
    magnitudes), so that the vote tiles of a 128-column block stop at
    different planes; column tile 1 gets plane bound 0 and column tile 2
    bound 5, row budgets 1-8."""
    rng = np.random.default_rng(seed)
    rt = np.arange(M) // bm
    q = rng.integers(0, 128, (M, K)) * np.where(rt % 2 == 0, 1, -1)[:, None]
    q = torch.as_tensor(q).to(torch.int8).to(cuda)
    ct = np.arange(N) // bn
    mag = np.array([1.0, 0.125, 0.5, 0.25])[(ct // 2) % 4]
    w = rng.integers(-16, 17, (K, N)) / 64.0 + np.where(ct % 2 == 1, 0.25,
                                                        -0.25 * mag)
    w = torch.as_tensor(w, dtype=torch.float32).to(cuda)
    bound = torch.full((N // bn,), 8, dtype=torch.int32)
    bound[1], bound[2] = 0, 5
    bud = torch.as_tensor(rng.integers(1, 9, M), dtype=torch.int32,
                          device=cuda)
    return q, w, bound.to(cuda), bud


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("M,K,bm,bn,bk", NARROW_TILES)
def test_narrow_tiles_match_plain_exactly(cuda, M, K, bm, bn, bk, extra):
    """Each narrow tile on the band kernel (``dm.route``), on dyadic weights
    with mixed column-tile votes, per-column-tile plane bounds (0 and 5
    among 8) and with and without row budgets, at N = 1024 and at N =
    1024 + block_n (a last block partly past N): output and planes_used
    equal to the plain version's bit for bit, with W split in the launch
    and with prepared parts, and two launches give the same bits."""
    N = 1024 + extra * bn
    q, w, bound, bud = _narrow_case(cuda, M, K, N, bm, bn)
    assert dm.route(M, K, N, bm, bn, bk or K, 8, True, q.dtype,
                    w.dtype) == "band_kernel"
    parts = dm.split_parts(w, bn, 1)
    for kw in ({}, {"row_budget": bud, "n_planes_rt": bud.max()}):
        args = dict(relu=True, block_m=bm, block_n=bn, block_k=bk,
                    plane_bound=bound, **kw)
        a = dm.dslot_matmul_cuda(q, w, **args)
        a2 = dm.dslot_matmul_cuda(q, w, parts=parts, **args)
        b = dm.dslot_matmul_plain(q, w, **args)
        torch.cuda.synchronize()
        assert torch.equal(a.planes_used, b.planes_used), kw
        assert torch.equal(a.out, b.out), kw
        assert torch.equal(a2.out, a.out)
        assert torch.equal(a2.planes_used, a.planes_used)
    assert len(set(b.planes_used[0, :128 // bn].tolist())) >= 3 or bn == 64


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,bm,bn,bk", [(128, 256, 32, 32, None),
                                          (128, 256, 16, 32, 16),
                                          (16, 256, 16, 16, 32)])
def test_narrow_tiles_three_parts(cuda, M, K, bm, bn, bk):
    """f32 weights of magnitudes 2^-20 to 1 (three bf16 parts) at narrow
    tiles, N past the last 128-column block: within rtol 1e-5 plus 1e-5 *
    max|out| of the plain version (f32 sums in another order), the same
    planes_used."""
    rng = np.random.default_rng(17)
    N = 1024 + bn
    q = torch.as_tensor(rng.integers(-127, 128, (M, K)),
                        dtype=torch.int8).to(cuda)
    w = rng.choice([-1.0, 1.0], (K, N)) * np.exp2(rng.uniform(-20, 0,
                                                             (K, N)))
    w = torch.as_tensor(w, dtype=torch.float32).to(cuda)
    assert dm.part_count(w) == 3
    args = dict(relu=True, block_m=bm, block_n=bn, block_k=bk)
    a = dm.dslot_matmul_cuda(q, w, parts=dm.split_parts(w, bn, 3), **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    tol = 1e-5 * b.out.abs() + 1e-5 * b.out.abs().max()
    assert bool(((a.out - b.out).abs() <= tol).all()), \
        float((a.out - b.out).abs().max())
    assert torch.equal(a.planes_used, b.planes_used)


# The launchers' tiles at the engine's admission shape take the band kernel,
# 32 x 24 too (its 8-column halves vote apart); the tiles that took another
# kernel before keep it (8-bit unsigned q, 16-bit q, block_n 8, block_k 8,
# block_m 128 at block_k 16).
ROUTES = [(32, 32, 2048, torch.int8, 8, "band_kernel"),
          (16, 16, 2048, torch.int8, 8, "band_kernel"),
          (16, 32, 16, torch.int8, 8, "band_kernel"),
          (16, 64, 2048, torch.int8, 8, "band_kernel"),
          (16, 128, 2048, torch.int8, 8, "band_kernel"),
          (32, 32, 2048, torch.uint8, 8, "plane_kernel"),
          (32, 32, 2048, torch.int16, 12, "plane_kernel"),
          (16, 8, 2048, torch.int8, 8, "plane_kernel"),
          (32, 24, 2048, torch.int8, 8, "band_kernel"),
          (16, 32, 8, torch.int8, 8, "plane_kernel"),
          (128, 32, 16, torch.int8, 8, "plane_kernel")]


@pytest.mark.gpu
@pytest.mark.parametrize("bm,bn,bk,q_dtype,n_bits,kernel", ROUTES)
def test_launcher_tiles_route(cuda, bm, bn, bk, q_dtype, n_bits, kernel):
    N = 8192 // bn * bn
    assert dm.route(128, 2048, N, bm, bn, bk, n_bits, True, q_dtype,
                    torch.float32) == kernel


@pytest.mark.gpu
def test_sharded_narrow_tiles_on_card_equal_unsharded(cuda):
    """A layer at 16 x 16 split over two ranks sharing the card (each rank
    holds 9 tiles of 16 columns: 144, not a multiple of 128), ReLU with f32
    and bf16 weights, scalar and per-row budgets: equal to the unsharded
    launch bit for bit, statistics included."""
    _build.build("dslot_matmul")          # once, before the ranks load it
    rng = np.random.default_rng(16)
    cases = []
    for wdtype, npl, bk in (("float32", 8, None), ("bfloat16", 5, 16),
                            ("float32", "rows", 32)):
        w = rng.normal(0, 0.05, (128, 272)).astype(np.float32)
        w[:, ::3] -= 0.1                   # ReLU-dead columns terminate
        x = rng.normal(0.2, 0.5, (64, 128)).astype(np.float32)
        if npl == "rows":
            npl = rng.integers(1, 9, 64).astype(np.int32)
        cases.append(dict(w=w, wdtype=wdtype, x=x, npl=npl, kw=dict(
            sort_columns=True, block_m=16, block_n=16, block_k=bk,
            signed=True)))
    assert dm.route(64, 128, 144, 16, 16, 128, 8, True, torch.int8,
                    torch.float32) == "band_kernel"
    flags = run_world(torch_parallel_ranks.card_execute, 2, backend="gloo",
                      device="cuda:0", timeout=120, deadline=300,
                      args=(cases,))
    for rank_flags in flags:
        for case_flags in rank_flags:
            assert all(case_flags.values()), case_flags


# ------------------------------------------------------------ split-warp tiles

# Column tiles of 24, 40, 48 and 56 on the band kernel: (M, K, block_m,
# block_n, block_k).  A block holds the whole column tiles that fit in 128
# columns (120 at 24 and 40, 96 at 48, 112 at 56), so the two 8-column
# halves of a warp may vote for two tiles.  32 x 24 and 128 x 24 in one
# band; 16 x 40; 64 x 48 at block_k 128 over two bands; a 32-row band at
# 56 and a 16-row band at 24 (both computed as 64 rows); 32 x 56 at
# block_k 64 over 16 bands of 64 rows at N = 896 (8 blocks); 128 x 24 over
# 8 bands.
SPLIT_TILES = [(128, 256, 32, 24, None), (128, 256, 128, 24, None),
               (128, 256, 16, 40, None), (256, 256, 64, 48, 128),
               (32, 256, 16, 56, None), (16, 256, 16, 24, None),
               (1024, 256, 32, 56, 64), (1024, 256, 128, 24, None)]


def _split_n(bn, extra):
    """8 blocks of whole column tiles, and with ``extra`` one tile more: a
    last block that holds one column tile."""
    return bn * (8 * (128 // bn) + extra)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [0, 1])
@pytest.mark.parametrize("M,K,bm,bn,bk", SPLIT_TILES)
def test_split_warp_tiles_match_plain_exactly(cuda, M, K, bm, bn, bk,
                                              extra):
    """Each split-warp tile on the band kernel (``dm.route``), on dyadic
    weights with column tiles of alternating sign, plane bounds 0 and 5
    among 8 and with and without row budgets: output and planes_used equal
    to the plain version's bit for bit, with W split in the launch and with
    prepared parts, and two launches give the same bits."""
    N = _split_n(bn, extra)
    q, w, bound, bud = _narrow_case(cuda, M, K, N, bm, bn)
    assert dm.route(M, K, N, bm, bn, bk or K, 8, True, q.dtype,
                    w.dtype) == "band_kernel"
    parts = dm.split_parts(w, bn, 1)
    for kw in ({}, {"row_budget": bud, "n_planes_rt": bud.max()}):
        args = dict(relu=True, block_m=bm, block_n=bn, block_k=bk,
                    plane_bound=bound, **kw)
        a = dm.dslot_matmul_cuda(q, w, **args)
        a2 = dm.dslot_matmul_cuda(q, w, parts=parts, **args)
        b = dm.dslot_matmul_plain(q, w, **args)
        torch.cuda.synchronize()
        assert torch.equal(a.planes_used, b.planes_used), kw
        assert torch.equal(a.out, b.out), kw
        assert torch.equal(a2.out, a.out)
        assert torch.equal(a2.planes_used, a.planes_used)
    assert len(set(b.planes_used[0].tolist())) >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,bm,bn,bk", SPLIT_TILES[:5])
def test_split_warp_tiles_three_parts(cuda, M, K, bm, bn, bk):
    """f32 weights of magnitudes 2^-20 to 1 (three bf16 parts) at the
    split-warp tiles with a partial last block: within rtol 1e-5 plus 1e-5
    * max|out| of the plain version (f32 sums in another order), the same
    planes_used."""
    rng = np.random.default_rng(18)
    N = _split_n(bn, 1)
    q = torch.as_tensor(rng.integers(-127, 128, (M, K)),
                        dtype=torch.int8).to(cuda)
    w = rng.choice([-1.0, 1.0], (K, N)) * np.exp2(rng.uniform(-20, 0,
                                                             (K, N)))
    w = torch.as_tensor(w, dtype=torch.float32).to(cuda)
    assert dm.part_count(w) == 3
    args = dict(relu=True, block_m=bm, block_n=bn, block_k=bk)
    a = dm.dslot_matmul_cuda(q, w, parts=dm.split_parts(w, bn, 3), **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    tol = 1e-5 * b.out.abs() + 1e-5 * b.out.abs().max()
    assert bool(((a.out - b.out).abs() <= tol).all()), \
        float((a.out - b.out).abs().max())
    assert torch.equal(a.planes_used, b.planes_used)


@pytest.mark.gpu
@pytest.mark.parametrize("bn", [24, 56])
def test_split_warp_tiles_pad_rows(cuda, bn):
    """128 rows of which 44 are real (the rest the wrapper's zero pad rows):
    the band computes 64 rows, the pad rows past them vote with zero sums,
    and output and planes_used equal the plain version's bit for bit."""
    N = _split_n(bn, 1)
    q, w, bound, _ = _narrow_case(cuda, 128, 256, N, 32, bn)
    q[44:] = 0
    args = dict(relu=True, block_m=32, block_n=bn, plane_bound=bound)
    a = dm.dslot_matmul_cuda(q, w, rows=44, **args)
    b = dm.dslot_matmul_plain(q, w, **args)
    torch.cuda.synchronize()
    assert torch.equal(a.planes_used, b.planes_used)
    assert torch.equal(a.out, b.out)


# (M, K, N, block_m, block_n, block_k, q dtype, kernel): seamless's MLP up
# at 2048 tokens at 128 x 24 and 32 x 24, and 40, 48 and 56 columns, take
# the band kernel; 24 columns at block_k 16, at block_m 144 or with
# unsigned q keep plane_kernel.
SPLIT_ROUTES = [(2048, 1024, 4104, 128, 24, 1024, torch.int8, "band_kernel"),
                (2048, 1024, 4104, 32, 24, 1024, torch.int8, "band_kernel"),
                (128, 2048, 8160, 16, 40, 2048, torch.int8, "band_kernel"),
                (128, 2048, 8160, 64, 48, 2048, torch.int8, "band_kernel"),
                (128, 2048, 8176, 32, 56, 2048, torch.int8, "band_kernel"),
                (2048, 1024, 4104, 32, 24, 16, torch.int8, "plane_kernel"),
                (288, 256, 48, 144, 24, 256, torch.int8, "plane_kernel"),
                (2048, 1024, 4104, 32, 24, 1024, torch.uint8,
                 "plane_kernel")]


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bm,bn,bk,q_dtype,kernel", SPLIT_ROUTES)
def test_split_warp_tiles_route(cuda, M, K, N, bm, bn, bk, q_dtype, kernel):
    assert dm.route(M, K, N, bm, bn, bk, 8, True, q_dtype,
                    torch.float32) == kernel


@pytest.mark.gpu
def test_sharded_split_warp_tiles_on_card_equal_unsharded(cuda):
    """A layer at 32 x 24 split over two ranks sharing the card (11 tiles:
    6 a rank, one of them a pad tile), ReLU with f32 and bf16 weights,
    scalar and per-row budgets: equal to the unsharded launch bit for bit,
    statistics included, where each rank's columns start at another place
    in the unsharded layer's blocks of 120."""
    _build.build("dslot_matmul")          # once, before the ranks load it
    rng = np.random.default_rng(28)
    cases = []
    for wdtype, npl, sort in (("float32", 8, True), ("bfloat16", 5, False),
                              ("float32", "rows", False)):
        w = rng.normal(0, 0.05, (128, 264)).astype(np.float32)
        w[:, ::3] -= 0.1                   # ReLU-dead columns terminate
        x = rng.normal(0.2, 0.5, (64, 128)).astype(np.float32)
        if npl == "rows":
            npl = rng.integers(1, 9, 64).astype(np.int32)
        cases.append(dict(w=w, wdtype=wdtype, x=x, npl=npl, kw=dict(
            sort_columns=sort, block_m=32, block_n=24, signed=True)))
    assert dm.route(64, 128, 144, 32, 24, 128, 8, True, torch.int8,
                    torch.float32) == "band_kernel"
    flags = run_world(torch_parallel_ranks.card_execute, 2, backend="gloo",
                      device="cuda:0", timeout=120, deadline=300,
                      args=(cases,))
    for rank_flags in flags:
        for case_flags in rank_flags:
            assert all(case_flags.values()), case_flags
