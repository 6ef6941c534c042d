"""Port parity for training the paper's CNN and for the paper's experiment
(``repro_torch.core.mnist_cnn.train_cnn`` / ``fit_cnn`` and
``repro_torch.launch.mnist_dslot``).

The reference draws its initial weights from a JAX PRNG key, so the port's
SGD loop (``fit_cnn``) starts from the reference's ``init_cnn`` carried
over with ``repro_torch.convert``; both then train on the same synthetic
images in the same batch order.  Two f32 implementations sum in other
orders, and SGD carries the difference forward: over this run's 15 steps
the parameters stay within 2e-7 of the largest, so they are held to 1e-5
of it, while one wrong gradient or update moves them by the size of a step
(about 1e-2).  Accuracy is a count of argmax hits and must be equal.

The reference-trained weights then go through both packages' prepared
``forward_dslot`` (the reference through its Pallas kernel in interpret
mode) at ``block_m`` 32: per-layer ``planes_used`` must be equal and the
logits agree within the tolerance of ``tests/test_torch_mnist_cnn.py``.
"""

import ast
import json
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.configs.dslot_mnist import CONFIG as JCONFIG
from repro.core import mnist_cnn as jcnn
from repro_torch import convert
from repro_torch.configs.dslot_mnist import CONFIG
from repro_torch.core import mnist_cnn as tcnn
from repro_torch.data.mnist import synth_mnist
from repro_torch.launch import mnist_dslot

ROOT = Path(__file__).resolve().parents[1]
PARAM_RTOL = 1e-5
TRAIN = dict(epochs=3, batch=16, lr=2e-2, seed=0)


def _ported(params):
    return convert.cnn_params((np.asarray(params.conv),
                               np.asarray(params.dense)), device="cpu")


@pytest.fixture(scope="module")
def trained():
    """The reference trained on 80 images (5 steps an epoch), the port's
    loop from the same initial weights, and 8 held-out images."""
    imgs, labels = synth_mnist(8, seed=0)
    ref, ref_acc = jcnn.train_cnn(JCONFIG, imgs, labels, **TRAIN)
    init = _ported(jcnn.init_cnn(JCONFIG, jax.random.PRNGKey(TRAIN["seed"])))
    port, port_acc = tcnn.fit_cnn(CONFIG, init, imgs, labels, **TRAIN)
    held, _ = synth_mnist(1, seed=5)
    return dict(ref=ref, ref_acc=ref_acc, port=port, port_acc=port_acc,
                n=len(imgs), init=init, held=held[:8])


@pytest.mark.parametrize("name", ["conv", "dense"])
def test_fit_cnn_matches_reference_train_cnn(trained, name):
    ref = np.asarray(getattr(trained["ref"], name))
    port = getattr(trained["port"], name)
    assert port.dtype == torch.float32 and not port.requires_grad
    moved = np.abs(ref - getattr(trained["init"], name).numpy()).max()
    assert moved > 0.05, "training must move the weights"
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=PARAM_RTOL * np.abs(ref).max())


def test_train_accuracy_matches_reference(trained):
    n = trained["n"]
    assert round(trained["port_acc"] * n) == round(trained["ref_acc"] * n)
    assert trained["port_acc"] > 0.5


def test_loss_gradient_matches_reference(trained):
    """One batch's gradients at the initial weights, zero (background)
    windows and ReLU ties included."""
    imgs, labels = synth_mnist(2, seed=1)
    init = trained["init"]
    jp = jcnn.CNNParams(conv=jnp.asarray(init.conv.numpy()),
                        dense=jnp.asarray(init.dense.numpy()))

    def jloss(p):
        logp = jax.nn.log_softmax(jcnn.forward(p, jnp.asarray(imgs), JCONFIG))
        return -jnp.mean(jnp.take_along_axis(
            logp, jnp.asarray(labels)[:, None], 1))

    jg = jax.grad(jloss)(jp)
    tp = [t.clone().requires_grad_(True) for t in init]
    logp = torch.log_softmax(tcnn.forward(tcnn.CNNParams(*tp),
                                          torch.as_tensor(imgs), CONFIG), -1)
    loss = -logp.gather(1, torch.as_tensor(labels).long()[:, None]).mean()
    tg = torch.autograd.grad(loss, tp)
    for a, b in zip(tg, jg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_train_cnn_seeded_init():
    imgs, labels = synth_mnist(2, seed=2)
    a, acc_a = tcnn.train_cnn(CONFIG, imgs, labels, epochs=1, batch=8,
                              device="cpu")
    b, acc_b = tcnn.train_cnn(CONFIG, imgs, labels, epochs=1, batch=8,
                              device="cpu")
    assert torch.equal(a.conv, b.conv) and torch.equal(a.dense, b.dense)
    assert acc_a == acc_b
    init = tcnn.init_cnn(CONFIG, torch.Generator().manual_seed(0),
                         device="cpu")
    again, _ = tcnn.fit_cnn(CONFIG, init, imgs, labels, epochs=1, batch=8)
    assert torch.equal(again.conv, a.conv)
    other, _ = tcnn.train_cnn(CONFIG, imgs, labels, epochs=1, batch=8,
                              seed=1, device="cpu")
    assert not torch.equal(other.conv, a.conv)


@pytest.fixture(scope="module")
def prepared(trained):
    """Both packages' prepared state of the reference-trained weights at
    block_m 32, calibrated on 4 held-out images."""
    held = trained["held"]
    jprep = jcnn.calibrate_cnn(
        jcnn.prepare_cnn(trained["ref"], JCONFIG, use_pallas=True,
                         block_m=32), jnp.asarray(held[:4]), JCONFIG)
    tprep = tcnn.calibrate_cnn(
        tcnn.prepare_cnn(_ported(trained["ref"]), CONFIG, block_m=32),
        torch.as_tensor(held[:4]), CONFIG)
    return jprep, tprep, held


@pytest.mark.parametrize("n_planes", [8, 4, 2])
def test_forward_dslot_trained_weights_matches_reference(prepared, n_planes):
    jprep, tprep, held = prepared
    jr = jcnn.forward_dslot(jprep, jnp.asarray(held), JCONFIG,
                            n_planes=n_planes)
    tr = tcnn.forward_dslot(tprep, torch.as_tensor(held), CONFIG,
                            n_planes=n_planes)
    for name, st in tr.layer_stats.items():
        np.testing.assert_array_equal(
            st.planes_used.numpy(),
            np.asarray(jr.layer_stats[name].planes_used), err_msg=name)
    np.testing.assert_allclose(tr.logits.numpy(), np.asarray(jr.logits),
                               rtol=1e-5, atol=1e-5)


def _example_json_keys() -> set:
    """Every string key of a dict literal in ``examples/mnist_dslot.py``:
    the keys of the JSON the reference example writes."""
    tree = ast.parse((ROOT / "examples" / "mnist_dslot.py").read_text())
    return {k.value for node in ast.walk(tree) if isinstance(node, ast.Dict)
            for k in node.keys if isinstance(k, ast.Constant)}


def _json_keys(node) -> set:
    if isinstance(node, dict):
        return set(node).union(*(_json_keys(v) for v in node.values()))
    if isinstance(node, list):
        return set().union(*(_json_keys(v) for v in node))
    return set()


def test_launcher_smoke_writes_reference_keys(tmp_path, capsys):
    out = tmp_path / "planes.json"
    mnist_dslot.main(["--smoke", "--device", "cpu", "--json", str(out)])
    printed = capsys.readouterr().out
    assert "DSLOT vs SIP max abs diff: 0.0" in printed
    assert "not measured" in printed              # Table I is modeled
    data = json.loads(out.read_text())
    assert _json_keys(data) - {"conv1", "dense1"} == _example_json_keys()
    assert data["smoke"] is True and data["prepares"] == 2
    assert data["backend"] == "plain"
    assert [r["n_planes"] for r in data["precision_sweep"]] == [8, 6, 4, 2]
    for row in data["precision_sweep"]:
        assert set(row["layers"]) == {"conv1", "dense1"}
        assert row["layers"]["dense1"]["planes_used_mean"] == row["n_planes"]


def test_launcher_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mnist_dslot.main(["--smoke"])
