"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, driver or metric
sits in a file of its own, found by its name: ``configs/<config>.json``,
``traffic/<traffic>.json``, ``drivers/<driver>.py`` (the mix names its
driver) and ``metrics/<metric>.py``.  A new cell is new files and new
entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict               # configs/<config>.json
    traffic: dict              # traffic/<traffic>.json
    end_to_end: list = field(default_factory=list)   # metric entries
    per_layer: list = field(default_factory=list)
    bench_dir: Path = BENCH_DIR

    def metrics(self, trace: bool) -> list[dict]:
        """The metric entries a run reports: the cell's end-to-end ones, or
        with ``trace`` its per-layer ones."""
        return self.per_layer if trace else self.end_to_end


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec_path: Path, bench_dir: Path = BENCH_DIR
              ) -> Cell:
    spec = json.loads(Path(spec_path).read_text())
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in {spec_path}; known: "
                       f"{sorted(work)}")
    w = work[name]
    cfg = json.loads((bench_dir / "configs" / f"{w['config']}.json")
                     .read_text())
    mix = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json")
                     .read_text())
    return Cell(name=name, workload=w, config=cfg, traffic=mix,
                end_to_end=[m for m in spec["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
                bench_dir=bench_dir)


def load_module(path: Path, name: str):
    """Import a driver or metric file by its path (names may hold dots)."""
    mod_spec = importlib.util.spec_from_file_location(
        "portbench_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def driver(cell: Cell):
    return load_module(cell.bench_dir / "drivers"
                       / f"{cell.traffic['driver']}.py",
                       "driver." + cell.traffic["driver"])


def reader(cell: Cell, metric: str):
    return load_module(cell.bench_dir / "metrics" / f"{metric}.py",
                       "metric." + metric)
