"""Port parity for the batch serving path (``repro_torch.serve.engine.
generate`` and ``python -m repro_torch.launch.serve``) against the JAX
reference, on the reduced seamless-m4t-medium config (encoder + decoder with
cross-attention, audio frontend frames, ReLU MLPs).

Reference parameters cross over through ``repro_torch.convert``, with half
of every MLP up-projection's columns made ReLU-dead so that the DSLOT early
exit fires.  The reference runs its jnp replay (``use_pallas=False``), the
port the kernel's plain version on CPU tensors.  Greedy tokens must be
equal; the per-request plane statistics equal within 1e-6 (means of f32
per-row values, summed in another order).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro.models.model_zoo import build_model as jbuild
from repro.serve.engine import generate as jgenerate
from repro_torch.convert import model_params
from repro_torch.kernels import dslot_matmul as dm
from repro_torch.launch import serve as tserve
from repro_torch.models.model_zoo import build_model as tbuild
from repro_torch.serve.engine import (generate as tgenerate, greedy_sample,
                                      temperature_sample)

from test_torch_models import cfg_pair, dead_columns, model_batch, ref_params

# block_m = B: a decode step's 4 rows fill their tile.  Pad rows vote in
# the termination check (as in the reference), so a tile with pad rows
# never terminates and the decode statistics would show no skip at all.
DSLOT = dict(enabled=True, block_m=4, block_n=32)
MAX_NEW = 5


@pytest.fixture(scope="module")
def seamless():
    """Both packages' reduced seamless models (DSLOT on), one set of
    weights, one batch of 4 prompts."""
    jc, tc = cfg_pair("seamless-m4t-medium", dslot=DSLOT)
    p, _ = ref_params(jc, seed=3)
    p = dead_columns(p)
    jb, tb = model_batch(tc, 4, 6, seed=4)
    return jc, tc, p, model_params(p, device="cpu"), jb, tb


def run_both(seamless, dslot: bool, n_planes=None):
    jc, tc, p, tp, jb, tb = seamless
    if not dslot:
        jc = dataclasses.replace(jc, dslot=dataclasses.replace(
            jc.dslot, enabled=False))
        tc = dataclasses.replace(tc, dslot=dataclasses.replace(
            tc.dslot, enabled=False))
    jm, tm = jbuild(jc), tbuild(tc)
    jp = jm.prepare_dslot(jax.tree.map(jnp.asarray, p))
    tp = tm.prepare_dslot(tp)
    jn = None if n_planes is None else jnp.asarray(n_planes, jnp.int32)
    tn = None if n_planes is None else torch.as_tensor(n_planes)
    return (jgenerate(jm, jp, jb, MAX_NEW, n_planes=jn),
            tgenerate(tm, tp, tb, MAX_NEW, n_planes=tn))


def stat_close(port, ref):
    np.testing.assert_allclose(np.asarray(port, np.float64),
                               np.asarray(ref, np.float64), rtol=0,
                               atol=1e-6)


def test_generate_dense_mlp_matches_reference(seamless):
    jr, tr = run_both(seamless, dslot=False)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    assert tr.planes_used_mean is None and jr.planes_used_mean is None
    assert tr.stats == {} and tr.steps == MAX_NEW and tr.phase == "done"


@pytest.mark.parametrize("n_planes", [8, [8, 8, 4, 2]])
def test_generate_dslot_matches_reference(seamless, n_planes):
    jr, tr = run_both(seamless, dslot=True, n_planes=n_planes)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    np.testing.assert_array_equal(tr.n_planes.numpy(),
                                  np.asarray(jr.n_planes))
    stat_close(tr.planes_used_mean.numpy(), jr.planes_used_mean)
    stat_close(tr.skipped_frac.numpy(), jr.skipped_frac)
    stat_close(float(tr.planes_bounded_mean), float(jr.planes_bounded_mean))
    assert tr.tokens.shape == (4, MAX_NEW)
    assert float(tr.skipped_frac.max()) > 0, "termination must fire"
    if isinstance(n_planes, list):
        assert float(tr.planes_used_mean[3]) <= 2.0


@pytest.mark.parametrize("dslot,n_planes", [(False, None),
                                             (True, [8, 8, 4, 2])])
def test_generate_bf16_matches_eager_reference(seamless, dslot, n_planes):
    """The same model in bf16, the reference run op by op (see
    ``BF16_MEAN`` in test_torch_models: compiled, its bf16 roundings depend
    on XLA's fusion).  Tokens equal, plane statistics within 1e-6."""
    jb, tb = seamless[4:]
    jc, tc = cfg_pair("seamless-m4t-medium", dslot={**DSLOT, "enabled": dslot},
                      dtype="bfloat16")
    jm, tm = jbuild(jc), tbuild(tc)
    p = dead_columns(ref_params(jc, seed=3)[0])
    tp = tm.prepare_dslot(model_params(p, device="cpu"))
    assert tp["embed"]["embedding"].dtype == torch.bfloat16
    jn = None if n_planes is None else jnp.asarray(n_planes, jnp.int32)
    tn = None if n_planes is None else torch.as_tensor(n_planes)
    with jax.disable_jit():
        jp = jm.prepare_dslot(jax.tree.map(jnp.asarray, p))
        jr = jgenerate(jm, jp, jb, MAX_NEW, n_planes=jn)
    tr = tgenerate(tm, tp, tb, MAX_NEW, n_planes=tn)
    np.testing.assert_array_equal(tr.tokens.numpy(), np.asarray(jr.tokens))
    if not dslot:
        assert tr.planes_used_mean is None and jr.planes_used_mean is None
        return
    stat_close(tr.planes_used_mean.numpy(), jr.planes_used_mean)
    stat_close(tr.skipped_frac.numpy(), jr.skipped_frac)
    stat_close(float(tr.planes_bounded_mean), float(jr.planes_bounded_mean))
    assert float(tr.skipped_frac.max()) > 0, "termination must fire"


def test_generate_launch_count(seamless, monkeypatch):
    """One digit-serial MLP call per layer: encoder and decoder at prefill,
    then the decoder at each of the ``max_new`` decode steps."""
    _, tc, _, tp, _, tb = seamless
    calls = []
    run = dm.run
    monkeypatch.setattr(dm, "run", lambda *a: calls.append(a[0].shape)
                        or run(*a))
    tm = tbuild(tc)
    tgenerate(tm, tm.prepare_dslot(tp), tb, MAX_NEW, n_planes=6)
    enc, dec = tc.encoder_layers, tc.n_layers
    assert len(calls) == enc + dec + dec * MAX_NEW
    rows = [s[0] for s in calls]
    assert rows[:enc] == [4 * 8] * enc                   # encoder: B x 8
    assert rows[enc:enc + dec] == [4 * (8 + 6)] * dec    # frames + prompt
    assert set(rows[enc + dec:]) == {4}                  # decode: B


def test_samplers():
    logits = torch.as_tensor(np.random.default_rng(5).normal(size=(3, 50)),
                             dtype=torch.float32)
    greedy = greedy_sample(logits)
    assert greedy.dtype == torch.int32
    assert torch.equal(greedy, logits.argmax(-1).int())
    draws = [temperature_sample(logits, torch.Generator().manual_seed(7))
             for _ in range(2)]
    assert torch.equal(draws[0], draws[1])
    assert bool(((draws[0] >= 0) & (draws[0] < 50)).all())
    cold = temperature_sample(logits, torch.Generator().manual_seed(8),
                              temp=1e-4)
    assert torch.equal(cold, greedy)


def test_generate_with_temperature_sampler(seamless):
    _, tc, _, tp, _, tb = seamless
    tm = tbuild(tc)
    tp = tm.prepare_dslot(tp)
    runs = [tgenerate(tm, tp, tb, 3, sample=temperature_sample,
                      generator=torch.Generator().manual_seed(9)).tokens
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    assert bool(((runs[0] >= 0) & (runs[0] < tc.vocab_size)).all())


@pytest.mark.parametrize("arch,dslot", [("seamless-m4t-medium", True),
                                        ("qwen2.5-3b", False)])
def test_launcher_runs_on_cpu(arch, dslot, capsys):
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--max-new", "3"] + (["--dslot", "--n-planes", "6"] if dslot
                                 else [])
    toks = tserve.main(argv)
    assert tuple(toks.shape) == (2, 3) and toks.device.type == "cpu"
    out = capsys.readouterr().out
    assert "generated (2, 3)" in out
    assert ("digit-serial MLP calls" in out) == dslot
