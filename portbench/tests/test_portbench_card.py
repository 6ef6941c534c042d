"""A cell end to end on the card (marked ``gpu``; it skips where there is
none): two short runs in one process, the second finding every kernel
built."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from .conftest import ROOT


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["opt.long-prompt",
                                      "seamless.batch-translate"])
def test_cell_on_the_card(card, workload):
    lines = []
    for seed in (3000000101, 3000000102):
        p = subprocess.run([sys.executable, "portbench/run.py",
                            "--workload", workload, "--seed", str(seed),
                            "--seconds", "5", "--trace", "0"],
                           capture_output=True, text=True, cwd=ROOT,
                           timeout=1200)
        assert p.returncode == 0, p.stderr[-3000:]
        lines.append(json.loads(p.stdout.strip().splitlines()[-1]))
    assert all(out["correct"] for out in lines)
    assert all(out["device"]["platform"] == "gpu" for out in lines)
    # the second run builds nothing
    assert lines[1]["metrics"]["setup_s"]["value"] < 120
