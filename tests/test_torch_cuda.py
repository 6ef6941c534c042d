"""The CUDA kernel on the card (``repro_torch.kernels.csrc.dslot_matmul``).

These tests need an NVIDIA GPU with ``nvcc``: they carry the ``gpu`` marker
and skip with a reason elsewhere.  They import neither JAX nor the
reference package, so they also run where only PyTorch is installed::

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

On dyadic weights (multiples of 2^-6) every partial sum is exact in f32,
so the kernel and its plain version must agree bit for bit, ``planes_used``
included.
"""

import shutil

import numpy as np
import pytest
import torch

from repro_torch.configs.dslot_mnist import CONFIG
from repro_torch.core import mnist_cnn
from repro_torch.kernels import _build
from repro_torch.kernels import dslot_matmul as dm


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
def test_kernel_rejects_what_it_does_not_take(cuda):
    q, w = _dyadic_case(cuda, False, torch.float32)
    with pytest.raises(TypeError):
        dm.dslot_matmul_cuda(q.to(torch.int64), w, block_m=64, block_n=16)
    with pytest.raises(TypeError):
        dm.dslot_matmul_cuda(q, w.to(torch.float16), block_m=64, block_n=16)
    # a 256 x 66 tile needs 32 x 33 threads, more than a block may have:
    # the launcher refuses it and the wrapper raises
    w66 = torch.cat([w, w[:, :2]], dim=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        dm.dslot_matmul_cuda(q, w66, block_m=256, block_n=66)


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
