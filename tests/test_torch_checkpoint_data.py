"""Port parity for the checkpointer (``repro_torch.checkpoint``), the token
pipeline (``repro_torch.data.pipeline``) and the two training launchers
(``repro_torch.launch.train``, ``repro_torch.launch.train_lm``) against the
JAX reference (``repro.checkpoint``, ``repro.data.pipeline``,
``repro.launch.train``, ``examples/train_lm.py``), on the CPU.

The reference's own cases (``tests/test_checkpoint_data.py``, the LM ones)
run on torch trees.  Tolerances: pipeline tokens exactly; checkpoint leaves
bit for bit in both directions (bf16 as its bits); launcher losses and
gradient norms within their printed precision (the reference prints 4 and
3 decimals), learning rates as printed.
"""

import dataclasses
import json
import os
import re
import runpy
import shutil
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.checkpoint.checkpointer import _flatten as j_flatten
from repro.configs.registry import ARCHS as JARCHS
from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models.model_zoo import build_model as jbuild
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train.step import init_train_state as jinit
from repro.train.step import make_train_step as jstep
from repro_torch import convert
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.registry import ARCHS
from repro_torch.data.pipeline import TokenPipeline, _hash_tokens
from repro_torch.launch import train, train_lm
from repro_torch.models.model_zoo import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten_with_path, leaves


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16),
                       "c": torch.tensor(3, dtype=torch.int32)}}


# ------------------------------------------- the reference's own cases

def test_roundtrip_exact(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(7, t)
    r = ck.restore(7, t)
    for a, b in zip(leaves(t), leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_async_and_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (1, 2, 3, 4):
        ck.save_async(s, t)
        ck.wait()
    assert ck.all_steps() == [3, 4]


def test_corruption_detected(tmp_path):
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    path = ck.save(1, t)
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    first = next(iter(man["leaves"]))
    man["leaves"][first]["crc32"] ^= 0xDEADBEEF
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(man, f)
    with pytest.raises(IOError, match="corruption"):
        ck.restore(1, t)


def test_uncommitted_checkpoint_ignored(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree())
    os.makedirs(str(tmp_path / "step_00000002"))   # no _COMMITTED marker
    assert ck.latest_step() == 1


def test_pipeline_determinism_and_restart():
    p1 = TokenPipeline(vocab=97, seq_len=16, global_batch=4, seed=5)
    a = p1.next_host_batch()
    st = p1.state()
    b = p1.next_host_batch()
    p2 = TokenPipeline(vocab=97, seq_len=16, global_batch=4, seed=5)
    p2.restore(st)
    b2 = p2.next_host_batch()
    np.testing.assert_array_equal(b["tokens"], b2["tokens"])
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_pipeline_learnable_structure():
    toks = _hash_tokens(0, np.arange(8), 17, 251)
    odd = toks[:, 1::2]
    even = toks[:, 0::2][:, : odd.shape[1]]
    np.testing.assert_array_equal(odd, (even * 7 + 13) % 251)


# ------------------------------------------------ parity: the pipeline

@pytest.mark.parametrize("vocab,seq,batch,micro,seed", [
    (97, 16, 4, 1, 5), (50_304, 33, 8, 2, 0), (256, 2048, 2, 2, 11)])
def test_pipeline_tokens_equal_reference_across_restore(vocab, seq, batch,
                                                        micro, seed):
    """Tokens and labels equal the reference's exactly, batch after batch,
    and a state saved by either package restores in the other."""
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch,
              microbatches=micro, seed=seed)
    tp, jp = TokenPipeline(**kw), JPipeline(**kw)
    for _ in range(2):
        a, b = tp.next_host_batch(), jp.next_host_batch()
        for k in ("tokens", "labels"):
            assert a[k].dtype == b[k].dtype == np.int32
            np.testing.assert_array_equal(a[k], b[k])
    assert tp.state() == jp.state()
    t2, j2 = TokenPipeline(**kw), JPipeline(**kw)
    t2.restore(jp.state())
    j2.restore(tp.state())
    np.testing.assert_array_equal(t2.next_host_batch()["tokens"],
                                  j2.next_host_batch()["tokens"])


# ------------------------------------------- parity: checkpoints

def _states(tmp_seed=0):
    """A reference TrainState of a reduced bf16 olmo after one step (so the
    moments are non-zero) and the port's state after one step from other
    weights: two different states of one structure."""
    jc = dataclasses.replace(JARCHS["olmo-1b"].reduced(), dtype="bfloat16")
    tc = dataclasses.replace(ARCHS["olmo-1b"].reduced(), dtype="bfloat16")
    pipe = TokenPipeline(vocab=256, seq_len=8, global_batch=2)
    batch = pipe.next_host_batch()
    opt = dict(peak_lr=1e-2, warmup_steps=0, decay_steps=10)
    js, _ = jstep(jbuild(jc), JAdamW(**opt))(
        jinit(jbuild(jc), jax.random.PRNGKey(tmp_seed)),
        jax.tree.map(jnp.asarray, batch))
    other = jinit(jbuild(jc), jax.random.PRNGKey(tmp_seed + 1))
    ts = convert.train_state(jax.tree.map(np.array, other), device="cpu")
    ts, _ = make_train_step(build_model(tc), AdamWConfig(**opt))(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    return js, ts


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_checkpoints_cross_packages_bit_equal(tmp_path, writer):
    """One package writes a TrainState (bf16 params, f32 moments, int32
    counts), the other restores it into its own TrainState: the same leaf
    paths, and every leaf equal bit for bit in its own dtype."""
    js, ts = _states()
    jkeys = [k for k, _ in j_flatten(js)]
    assert [k for k, _ in flatten_with_path(ts)] == jkeys
    assert ".params/embed/embedding" in jkeys and ".opt/.count" in jkeys \
        and ".step" in jkeys and ".opt/.m/final_norm/scale" not in jkeys
    if writer == "port":
        Checkpointer(str(tmp_path)).save(3, ts)
        got, want = JCheckpointer(str(tmp_path)).restore(3, js), ts
        pairs = zip(j_flatten(got), flatten_with_path(want))
    else:
        JCheckpointer(str(tmp_path)).save(3, js)
        got, want = Checkpointer(str(tmp_path)).restore(3, ts), js
        pairs = zip(flatten_with_path(got), j_flatten(want))
    n_bf16 = 0
    for (k1, a), (k2, b) in pairs:
        assert k1 == k2
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k1
        np.testing.assert_array_equal(a, b, err_msg=k1)
        n_bf16 += a.dtype == np.uint16
    assert n_bf16 > 0
    with open(tmp_path / "step_00000003" / "manifest.json") as f:
        dtypes = {m["dtype"] for m in json.load(f)["leaves"].values()}
    assert dtypes == {"bfloat16", "float32", "int32"}


def test_restore_places_leaves_on_the_target_dtype(tmp_path):
    """``restore`` casts to the target leaf's dtype (bf16 stored, f32
    target), as the reference's does."""
    ck = Checkpointer(str(tmp_path))
    t = _tree()
    ck.save(1, t)
    target = {**t, "nested": {**t["nested"],
                              "b": torch.zeros(5, dtype=torch.float32)}}
    r = ck.restore(1, target)
    assert r["nested"]["b"].dtype == torch.float32
    assert torch.equal(r["nested"]["b"], torch.ones(5))
    with pytest.raises(KeyError, match="missing leaf"):
        ck.restore(1, {**t, "extra": torch.zeros(1)})


# ------------------------------------------------ the launchers

_NUM = re.compile(r"-?\d+(\.\d+)?(e[-+]\d+)?")


def run_reference_train(capsys, argv) -> list[str]:
    capsys.readouterr()
    saved = sys.argv
    sys.argv = ["repro.launch.train", *argv]
    try:
        runpy.run_module("repro.launch.train", run_name="__main__")
    finally:
        sys.argv = saved
    return capsys.readouterr().out.splitlines()


def run_port(capsys, fn, argv):
    capsys.readouterr()
    res = fn(argv)
    return res, capsys.readouterr().out.splitlines()


def numbers(line):
    return [float(m.group()) for m in _NUM.finditer(line)]


def test_train_launcher_matches_reference_and_resumes_its_checkpoints(
        capsys, tmp_path):
    """The port's launcher prints the reference's lines (numbers from the
    weights masked; the parameter count equal); a checkpoint written by
    either launcher resumes in the other; resumed from the reference's
    step-4 checkpoint, both take steps 5-6 with the same losses, gradient
    norms and learning rates."""
    args = ["--arch", "olmo-1b", "--reduced", "--seq-len", "16",
            "--global-batch", "4", "--microbatches", "2", "--ckpt-every",
            "2", "--log-every", "1"]
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    want = run_reference_train(capsys, args + ["--steps", "4", "--ckpt-dir",
                                               str(ref_dir)])
    res, got = run_port(capsys, train.main, args + [
        "--steps", "4", "--ckpt-dir", str(port_dir), "--device", "cpu"])
    assert [_NUM.sub("#", a) for a in got] == \
        [_NUM.sub("#", b) for b in want]
    assert got[0] == want[0] == "arch=olmo-1b params=0.1M devices=1"
    assert [s for s, _ in res["log"]] == [1, 2, 3, 4]
    assert [a.split("lr")[1] for a in got[1:-1]] == \
        [b.split("lr")[1] for b in want[1:-1]]
    assert Checkpointer(str(port_dir)).all_steps() == [2, 4]

    # the reference resumes the port's checkpoint
    back = run_reference_train(capsys, args + ["--steps", "5", "--ckpt-dir",
                                               str(port_dir)])
    assert back[0] == "restored from step 4" and back[2].startswith(
        "step     5")

    # both resume the reference's step-4 checkpoint
    shutil.copytree(ref_dir, tmp_path / "ref2")
    want = run_reference_train(capsys, args + ["--steps", "6", "--ckpt-dir",
                                               str(ref_dir)])
    res, got = run_port(capsys, train.main, args + [
        "--steps", "6", "--ckpt-dir", str(tmp_path / "ref2"), "--device",
        "cpu"])
    assert res["restored"] == 4 and got[:2] == want[:2]
    assert len(got) == len(want) == 5
    for a, b in zip(got[2:4], want[2:4]):
        (sa, la, ga, lra), (sb, lb, gb, lrb) = numbers(a), numbers(b)
        assert sa == sb and lra == lrb
        assert abs(la - lb) <= 2e-4 and abs(ga - gb) <= 2e-3, (a, b)


def test_train_lm_launcher_structure(capsys, tmp_path, monkeypatch):
    """The example's model (8L x 512, vocab 32768: 50.3M parameters, the
    count from the reference's shapes); on a reduced stand-in the loop prints the
    example's lines at its steps, checkpoints every 50 steps keeping 2, and
    the loss falls."""
    cfg = train_lm.config()
    jcfg = dataclasses.replace(
        JARCHS["olmo-1b"], n_layers=8, d_model=512, n_heads=8, n_kv_heads=8,
        d_ff=2048, vocab_size=32_768, scan_unroll=2, attn_chunk=128,
        dtype="float32")
    same = {f.name for f in dataclasses.fields(cfg)} - {"dslot"}
    assert {k: getattr(cfg, k) for k in same} == \
        {k: getattr(jcfg, k) for k in same}
    shapes = jax.eval_shape(jbuild(jcfg).init, jax.random.PRNGKey(0))
    n_ref = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes))
    meta = build_model(cfg).init(torch.Generator().manual_seed(0),
                                 device="meta")
    assert build_model(cfg).param_count(meta) == n_ref

    monkeypatch.setattr(train_lm, "config", lambda: dataclasses.replace(
        ARCHS["olmo-1b"].reduced(), n_layers=1, scan_layers=False))
    monkeypatch.setattr(train_lm, "SEQ_LEN", 16)
    res, got = run_port(capsys, train_lm.main, [
        "--steps", "100", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert re.fullmatch(r"model: 1L d64 -> \d+\.\dM params", got[0])
    steps = [int(line.split()[1]) for line in got[1:-1]]
    assert steps == [1] + list(range(10, 101, 10))
    for line in got[1:-1]:
        assert re.fullmatch(r"step +\d+  loss \d+\.\d{4}  gnorm \d+\.\d{2}  "
                            r"\d+ tok/s", line), line
    assert got[-1].startswith("done in ") and got[-1].endswith(str(tmp_path))
    assert res["steps"] == [50, 100]
    assert res["log"][-1][1]["loss"] < res["log"][0][1]["loss"] - 0.1


@pytest.mark.parametrize("launcher,argv", [
    (train, ["--arch", "olmo-1b", "--reduced", "--steps", "1"]),
    (train_lm, ["--steps", "1"])])
def test_train_launchers_without_gpu_raise(launcher, argv, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main(argv)
