"""Shared fixtures: a copy of the benchmark cut to CPU sizes (the port's
``reduced()`` widths), run through the kernels' plain versions."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness import env  # noqa: E402

env.prepare_paths()

REDUCED = dict(d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
               vocab_size=256)


def cut_to_cpu(bench: Path, dtype: str = "float32") -> Path:
    """Configurations at ``ModelConfig.reduced()``'s widths (but one kv
    head a head, as the cells have it; 4 decoder layers, 2 + 2 for the
    encoder-decoder) and traffic at a few requests a second, written over
    the copy's own files."""
    for f in (bench / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        m = c["model"]
        m.update(REDUCED, dtype=dtype,
                 n_layers=2 if m["family"] == "encdec" else 4)
        if m["family"] == "encdec":
            m.update(encoder_layers=2, frontend_len=8)
            c["calibration"] = {"tokens": 4, "frontend": 8, "src": 4}
        else:
            c["calibration"] = {"tokens": 32}
        c["dslot"].update(block_m=16, block_n=32)
        f.write_text(json.dumps(c))
    for f in (bench / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        if mix["driver"] == "batch":
            mix.update(batch=3, frames=8, prompt_tokens=4, src_tokens=4,
                       new_tokens=5)
        else:
            mix["serve"].update(n_slots=4, max_len=96, prefill_chunk=16)
            mix["prompt"] = {"dist": "uniform", "lo": 4, "hi": 40}
            mix["output"] = {"dist": "uniform", "lo": 2, "hi": 8}
            mix["warm_s"] = 0.3
            if mix["loop"] == "closed":
                mix["clients"] = 4
            else:
                mix["rate_per_s"] = 20.0
            mix["check"]["sample"] = 3
        f.write_text(json.dumps(mix))
    return bench


def copy_bench(tmp: Path) -> tuple[Path, Path]:
    """(a CPU-sized copy of ``portbench/``, its ``BENCHMARK.json``)."""
    bench = tmp / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    return cut_to_cpu(bench), tmp / "BENCHMARK.json"


@pytest.fixture
def cpu_bench(tmp_path):
    return copy_bench(tmp_path)


def measure_cpu(bench, spec_path, workload: str, seconds: float = 1.5,
                trace: int = 0, seed: int = 3_000_000_019) -> dict:
    import time

    import torch

    from portbench import run
    args = run.parse(["--workload", workload, "--seed", str(seed),
                      "--seconds", str(seconds), "--trace", str(trace)])
    return run.measure(args, device=torch.device("cpu"), spec_path=spec_path,
                       bench_dir=bench, t_start=time.perf_counter())
