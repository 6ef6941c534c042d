"""CPU rehearsals of every cell's driver through the kernels' plain
versions, and the runs the check must refuse: a token altered where it is
produced, in the engine and in ``generate``."""

from __future__ import annotations

import json

import pytest

from .conftest import measure_cpu

CELLS = ("opt.long-prompt", "seamless.batch-translate", "opt.chat")
LATENCY = ("ttft_mean_ms",)                        # end to end
TAILS = ("ttft_p90_ms.tail", "itl_p95_ms.tail")   # per layer


def _bench_names(spec_path) -> set[str]:
    return {w["name"] for w in json.loads(spec_path.read_text())["workloads"]}


def add_chat_cell(spec_path) -> None:
    """``opt.chat`` as a later change adds it: its entry, and its name in the
    lists of the latency, tail and ``.tput`` metrics, over
    ``traffic/chat.json`` (the closed loop), which the benchmark keeps."""
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append(dict(name="opt.chat", config="opt-1.3b",
                                  traffic="chat", chips=1,
                                  why="128 closed-loop clients"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if (m["name"] in LATENCY + TAILS
                or m["name"].endswith(".tput")):
            m["workloads"].append("opt.chat")
    spec_path.write_text(json.dumps(spec))


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_and_is_correct_on_cpu(cpu_bench, workload):
    bench, spec_path = cpu_bench
    if workload not in _bench_names(spec_path):
        add_chat_cell(spec_path)
    assert workload in _bench_names(spec_path)
    out = measure_cpu(bench, spec_path, workload)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] > 0
    # the f32 program at these widths equals the f32 reference's choices
    assert out["check"]["logit_gap"]["value"] < 1e-3
    assert out["check"]["tokens_compared"]["value"] > 0
    names = set(out["metrics"])
    assert {"tokens_per_s", "setup_s"} <= names
    if workload.startswith("opt."):
        assert set(LATENCY) <= names
        assert not set(TAILS) & names
    assert list(out)[-1] == "check"
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("workload", ("opt.long-prompt",
                                      "seamless.batch-translate"))
def test_traced_run_reads_per_layer_metrics(cpu_bench, workload):
    bench, spec_path = cpu_bench
    out = measure_cpu(bench, spec_path, workload, trace=1)
    assert out["correct"]
    # no device on the CPU: the trace's readers return nothing
    assert "idle_share.ttft" not in out["metrics"]
    assert "dslot_roofline.tput" not in out["metrics"]
    assert "dslot_planes_used" in out["metrics"]
    if workload.startswith("opt."):
        assert set(TAILS) <= set(out["metrics"])
        assert not set(LATENCY) & set(out["metrics"])
    assert out["device"]["busy_s"] == 0.0


def _altering(real):
    """A sampler whose first row serves another token than the argmax:
    half the vocabulary further on."""
    def bad(logits, generator=None):
        tok = real(logits) if generator is None else real(logits, generator)
        tok = tok.clone()
        tok[0] = (tok[0] + logits.shape[-1] // 2) % logits.shape[-1]
        return tok
    return bad


def test_engine_token_altered_is_not_correct(cpu_bench, monkeypatch):
    from repro_torch.serve import engine
    bench, spec_path = cpu_bench
    monkeypatch.setattr(engine, "greedy_sample",
                        _altering(engine.greedy_sample))
    out = measure_cpu(bench, spec_path, "opt.long-prompt")
    assert not out["correct"]
    assert out["check"]["logit_gap"]["value"] > \
        out["check"]["logit_gap"]["limit"]


def test_generate_token_altered_is_not_correct(cpu_bench, monkeypatch):
    from repro_torch.serve import engine
    bench, spec_path = cpu_bench
    monkeypatch.setitem(engine.generate.__kwdefaults__, "sample",
                        _altering(engine.greedy_sample))
    out = measure_cpu(bench, spec_path, "seamless.batch-translate")
    assert not out["correct"]
