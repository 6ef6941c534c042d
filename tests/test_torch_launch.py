"""The port's launchers against the reference's examples on the CPU:
``repro_torch.launch.quickstart`` (``examples/quickstart.py``) and
``repro_torch.launch.serve_lm`` (``examples/serve_lm.py``), and
``generate``'s deprecated ``return_stats`` shim
(``tests/test_public_api.py``).

The quickstart draws nothing from JAX keys, so its printed numbers are the
example's (the matmul error within f32 rounding).  ``serve_lm`` draws its
weights and batch from torch generators where the example uses JAX keys, so
tokens and plane statistics differ by the draw; its engine traffic is the
example's numpy draw, so every engine schedule line (slot phases, queue
depths, TTFTs, tier sizes) must be the example's.
"""

import dataclasses
import re
import runpy
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_one_thread  # noqa: F401  (PyTorch on one CPU thread)

from repro_torch.configs.base import DslotConfig
from repro_torch.configs.registry import get_arch
from repro_torch.launch import quickstart, serve_lm
from repro_torch.models.model_zoo import build_model
from repro_torch.serve import GenerateResult, engine, generate

ROOT = Path(__file__).resolve().parents[1]


def printed(capsys, fn) -> list[str]:
    capsys.readouterr()
    fn()
    # the port says "digit-plane passes" where the TPU example says "MXU"
    return capsys.readouterr().out.replace("MXU passes",
                                           "digit-plane passes").splitlines()


def example(name):
    return lambda: runpy.run_path(str(ROOT / "examples" / name),
                                  run_name="__main__")


def test_quickstart_prints_the_examples_numbers(capsys):
    want = printed(capsys, example("quickstart.py"))
    got = printed(capsys, lambda: quickstart.main(["--device", "cpu"]))
    assert len(got) == len(want) == 13
    assert got[:-1] == want[:-1]
    err = float(got[-1].split(":")[1])
    assert abs(err - float(want[-1].split(":")[1])) <= 1e-4 * err
    res = quickstart.main(["--device", "cpu"])
    assert res["cycles_used"] == [16, 15, 15, 16] and res["n_planes"] == 8


# lines whose numbers come from the weights (tokens, planes per row)
_DRAWN = ("token", "streamed", "planes/row", "controller", "mean skipped")


def test_serve_lm_prints_the_examples_schedule(capsys):
    want = printed(capsys, example("serve_lm.py"))
    got = printed(capsys, lambda: serve_lm.main(["--device", "cpu"]))
    assert len(got) == len(want)

    def masked(line):
        if any(k in line for k in _DRAWN):
            return re.sub(r"\d+(\.\d+)?", "#", line)
        return line

    assert [masked(a) for a in got] == [masked(b) for b in want]
    for a, b in zip(got, want):
        if "ttft p95" in a:              # ttft p95 and request counts
            assert a.split("ttft")[1] == b.split("ttft")[1]
    res = serve_lm.main(["--device", "cpu"])
    assert res["tokens_shape"] == (4, 8) and res["dslot_calls"] == 4
    assert res["served"] == {0: (3, 1), 1: (4, 2), 2: (5, 5), 3: (6, 7)}
    assert res["controller"]["shed_events"] > 0


@pytest.mark.parametrize("launcher", [quickstart, serve_lm])
def test_launchers_without_gpu_raise(launcher, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launcher.main([])


@pytest.mark.parametrize("dslot", [False, True])
def test_generate_return_stats_shim(dslot):
    """``return_stats=True`` gives ``(tokens, stats)``, ``False`` the bare
    tokens, one DeprecationWarning for both; unset, a ``GenerateResult``
    with the same tokens."""
    cfg = get_arch("olmo-1b").reduced()
    if dslot:
        cfg = dataclasses.replace(cfg, act="relu", glu=False,
                                  dslot=DslotConfig(enabled=True, block_m=16,
                                                    block_n=32))
    model = build_model(cfg)
    params = model.prepare_dslot(model.init(
        torch.Generator().manual_seed(0), device="cpu"))
    batch = {"tokens": torch.tensor([[1, 2, 3]])}
    engine._LEGACY_WARNED.discard("generate.return_stats")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        toks, stats = generate(model, params, batch, 2, return_stats=True)
        bare = generate(model, params, batch, 2, return_stats=False)
    assert len([w for w in rec
                if issubclass(w.category, DeprecationWarning)]) == 1
    assert toks.shape == (1, 2) and bare.shape == (1, 2)
    assert sorted(stats) == ([] if not dslot
                             else ["planes_used_mean", "skipped_frac"])
    res = generate(model, params, batch, 2)
    assert isinstance(res, GenerateResult)
    np.testing.assert_array_equal(res.tokens.numpy(), toks.numpy())
    np.testing.assert_array_equal(res.tokens.numpy(), bare.numpy())
