"""The harness is driven by data: a new configuration, traffic mix and
metric are new files and new ``BENCHMARK.json`` entries, picked up with no
edit to any file that is already there."""

from __future__ import annotations

import json

from .conftest import measure_cpu


def test_new_config_traffic_and_metric_files_are_picked_up(cpu_bench):
    bench, spec_path = cpu_bench
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    cfg = json.loads((bench / "configs" / "opt-1.3b.json").read_text())
    cfg["name"] = "opt-1.3b-wide"
    cfg["model"].update(name="opt-1.3b-wide", d_ff=256)
    (bench / "configs" / "opt-1.3b-wide.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "long-prompt.json").read_text())
    mix.update(rate_per_s=10.0, output={"dist": "uniform", "lo": 3,
                                        "hi": 3})
    (bench / "traffic" / "short-answers.json").write_text(json.dumps(mix))
    (bench / "metrics" / "answers_in_window.py").write_text(
        "def read(rec):\n"
        "    w0, w1 = rec['window']\n"
        "    return sum(1 for r in rec['requests']\n"
        "               if r['end'] is not None and w0 <= r['end'] < w1)\n")
    spec = json.loads(spec_path.read_text())
    spec["configs"].append(dict(spec["configs"][0],
                                name="opt-1.3b-wide",
                                file="portbench/configs/opt-1.3b-wide"
                                     ".json"))
    spec["workloads"].append(dict(name="opt-wide.short-answers",
                                  config="opt-1.3b-wide",
                                  traffic="short-answers", chips=1,
                                  why="a cell added as files alone"))
    spec["end_to_end"].append(dict(name="answers_in_window", unit="count",
                                   better="higher", bound=0.05,
                                   source="host_clock",
                                   workloads=["opt-wide.short-answers"]))
    spec_path.write_text(json.dumps(spec))
    out = measure_cpu(bench, spec_path, "opt-wide.short-answers")
    assert out["correct"]
    assert out["metrics"]["answers_in_window"]["value"] > 0
    assert out["metrics"]["answers_in_window"]["unit"] == "count"
    # the existing cells' metrics do not list the new one
    old = measure_cpu(bench, spec_path, "seamless.batch-translate")
    assert "answers_in_window" not in old["metrics"]
    after = {p: p.read_bytes() for p in before}
    assert after == before
