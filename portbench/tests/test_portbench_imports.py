"""What the benchmark may load: no JAX, no JAX package, no JAX-era
benchmarks (compared by the whole top-level name), and a reference that
imports nothing of the program.  The run refuses a machine with no card,
and a directory that holds only the benchmark."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

from .conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module)
    return names


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "portbench" / "reference").glob("*.py"):
        tops = {n.split(".")[0] for n in _imports(f)}
        assert tops <= {"torch", "numpy", "math", "contextlib",
                        "__future__"}, (f.name, tops)


def test_no_source_imports_a_forbidden_module():
    for f in (ROOT / "portbench").rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


RUN_CPU = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench.tests.conftest import copy_bench, measure_cpu
from pathlib import Path
bench, spec = copy_bench(Path({tmp!r}))
for w in ("opt.long-prompt", "seamless.batch-translate"):
    measure_cpu(bench, spec, w, seconds=0.5)
from portbench.harness import env
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
print(json.dumps(env.forbidden_modules()))
"""


def test_a_run_loads_no_forbidden_module(tmp_path):
    p = subprocess.run([sys.executable, "-c",
                        RUN_CPU.format(root=str(ROOT), tmp=str(tmp_path))],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    tops, found = [json.loads(x) for x in p.stdout.splitlines()[-2:]]
    assert "repro_torch" in tops and "torch" in tops
    assert not set(tops) & FORBIDDEN
    assert found == []


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from portbench.harness import env
    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxlike.sub", sys)
    assert env.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.models", sys)
    assert env.forbidden_modules() == ["repro.models"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        "--workload", "opt.long-prompt", "--seed",
                        "3000000007", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       cwd=ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                      "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


STRIPPED = """
import sys, time
sys.path.insert(0, {tmp!r})
import torch
from portbench import run
args = run.parse(["--workload", "opt.long-prompt", "--seed", "5",
                  "--seconds", "0.5", "--trace", "0"])
print(run.measure(args, device=torch.device("cpu")))
"""


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run([sys.executable, "-c",
                        STRIPPED.format(tmp=str(tmp_path))],
                       capture_output=True, text=True, timeout=300,
                       cwd=tmp_path, env={"PATH": "/usr/bin:/bin",
                                          "PYTHONPATH": ""})
    assert p.returncode != 0
    assert "repro_torch" in p.stderr
    assert p.stdout.strip() == ""
