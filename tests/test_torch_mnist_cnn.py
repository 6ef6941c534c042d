"""Port parity for the paper's MNIST CNN slice, plus the port's own
contracts: no JAX in the port, and no silent CPU fallback.

The reference's parameters are carried to the port with
``repro_torch.convert``; both packages then run prepare -> calibrate ->
``forward_dslot`` on the same synthetic images (the reference through its
Pallas kernel in interpret mode, the port through the kernel's plain
version on CPU tensors).  Per-layer ``planes_used`` must be equal and the
logits agree within the stated tolerance.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.configs.dslot_mnist import CONFIG as JCONFIG
from repro.core import mnist_cnn as jcnn
from repro.data.mnist import synth_mnist as jsynth
from repro_torch import convert
from repro_torch.configs.dslot_mnist import CONFIG
from repro_torch.core import mnist_cnn as tcnn
from repro_torch.data.mnist import synth_mnist
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    """Reference params (jax PRNG), four synthetic images, and the same
    params carried over to the port."""
    params = jcnn.init_cnn(JCONFIG, jax.random.PRNGKey(0))
    images, _ = synth_mnist(1, seed=3)
    ported = convert.cnn_params((np.asarray(params.conv),
                                 np.asarray(params.dense)), device="cpu")
    return params, images[:4], ported


def test_config_and_data_match_reference():
    assert dataclasses.asdict(CONFIG) == dataclasses.asdict(JCONFIG)
    ti, tl = synth_mnist(3, seed=7)
    ji, jl = jsynth(3, seed=7)
    assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()


def test_float_forward_matches_reference(reference):
    params, images, ported = reference
    ref = jcnn.forward(params, jnp.asarray(images), JCONFIG)
    out = tcnn.forward(ported, torch.as_tensor(images), CONFIG)
    # 25-term conv sums and a 1152-term head sum in another order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_forward_dslot_matches_reference(reference):
    """The whole slice at B = 4: prepare, calibrate, then three runtime
    precisions including a per-image budget vector."""
    params, images, ported = reference
    jprep = jcnn.calibrate_cnn(jcnn.prepare_cnn(params, JCONFIG,
                                                use_pallas=True),
                               jnp.asarray(images), JCONFIG)
    tprep = tcnn.calibrate_cnn(tcnn.prepare_cnn(ported, CONFIG),
                               torch.as_tensor(images), CONFIG)
    # the conv scale comes from the images (equal); the head scale from the
    # conv outputs, whose f32 sums may differ in the last ulp
    assert float(tprep.conv_params["dslot"].x_scale) == \
        float(jprep.conv_params["dslot"].x_scale)
    np.testing.assert_allclose(float(tprep.head_params["dslot"].x_scale),
                               float(jprep.head_params["dslot"].x_scale),
                               rtol=3e-7)
    per_image = np.asarray([8, 2, 5, 3], np.int32)
    for npl_j, npl_t in ((8, 8), (3, 3),
                         (jnp.asarray(per_image), torch.as_tensor(per_image))):
        jr = jcnn.forward_dslot(jprep, jnp.asarray(images), JCONFIG,
                                n_planes=npl_j)
        tr = tcnn.forward_dslot(tprep, torch.as_tensor(images), CONFIG,
                                n_planes=npl_t)
        assert set(tr.layer_stats) == {"conv1", "dense1"}
        for name, st in tr.layer_stats.items():
            np.testing.assert_array_equal(
                st.planes_used.numpy(),
                np.asarray(jr.layer_stats[name].planes_used), err_msg=name)
        # logits ~1: 1152-term head sums in another order, after a conv
        # layer whose outputs agree to a few ulps
        np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                                   rtol=1e-5, atol=1e-5)


def test_forward_dslot_unprepared_matches_prepared(reference):
    _, images, ported = reference
    x = torch.as_tensor(images)
    a = tcnn.forward_dslot(ported, x, CONFIG, block_m=32, block_k=64)
    b = tcnn.forward_dslot(tcnn.prepare_cnn(ported, CONFIG, block_m=32,
                                            block_k=64), x, CONFIG)
    assert torch.equal(a.logits, b.logits)
    ref = tcnn.forward(ported, x, CONFIG)
    assert (a.logits.argmax(-1) == ref.argmax(-1)).all()
    assert (a.layer_stats["dense1"].planes_used == CONFIG.n_bits).all()


def test_prepare_once_whole_cnn():
    params = tcnn.init_cnn(CONFIG, torch.Generator().manual_seed(0),
                           device="cpu")
    imgs = torch.rand((4, 28, 28), generator=torch.Generator().manual_seed(1))
    n0 = tops.prepare_call_count()
    prep = tcnn.prepare_cnn(params, CONFIG, block_m=32, block_k=64)
    assert tops.prepare_call_count() - n0 == 2          # conv + head
    r8 = tcnn.forward_dslot(prep, imgs, CONFIG, n_planes=8)
    r2 = tcnn.forward_dslot(prep, imgs, CONFIG, n_planes=torch.tensor(2))
    assert tops.prepare_call_count() - n0 == 2
    assert (r8.logits - r2.logits).abs().max() > 0


def test_convert_layouts():
    rng = np.random.default_rng(0)
    conv = rng.normal(size=(3, 3, 2, 4)).astype(np.float32)
    p = convert.layer_params({"w": conv, "dslot": object()}, device="cpu")
    assert set(p) == {"w"} and p["w"].shape == (3, 3, 2, 4)
    bf = jnp.asarray(rng.normal(size=(8, 4)), jnp.bfloat16)
    t = convert.to_tensor(bf, device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(bf.astype(jnp.float32)))
    with pytest.raises(ValueError):
        convert.cnn_params((np.zeros((8, 5, 4)), np.zeros((10, 10))),
                           device="cpu")
    with pytest.raises(ValueError):
        convert.layer_params({"w": np.zeros(5)}, device="cpu")


def test_default_device_without_gpu_raises(monkeypatch):
    """Entry points run on CUDA unless asked for the CPU; with no GPU they
    raise instead of falling back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcnn.init_cnn(CONFIG, g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.cnn_params((np.zeros((8, 5, 5)), np.zeros((1152, 10))))
    from repro_torch.layers import DslotDense
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DslotDense(4, 4).init(g)
    assert tcnn.init_cnn(CONFIG, g, device="cpu").conv.device.type == "cpu"


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)
