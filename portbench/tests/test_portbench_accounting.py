"""The window's accounting, the percentile, the traffic generator and the
frozen FLOP, byte and roofline arithmetic, on hand-worked numbers."""

from __future__ import annotations

import math

import numpy as np
import pytest

from portbench.harness import flops, readers, stats, traffic
from portbench.harness.trace import DeviceTrace, Spans

KERNELS = ("band_kernel", "plane_kernel")
OLMO = dict(family="dense", n_layers=16, d_model=2048, n_heads=16,
            n_kv_heads=16, d_ff=8192, vocab_size=50304, glu=False,
            dtype="bfloat16")


@pytest.mark.parametrize("n,p,want", [(100, 95, 95), (20, 95, 19),
                                      (19, 95, 19), (1, 95, 1), (10, 50, 5)])
def test_nearest_rank_percentile(n, p, want):
    xs = list(range(n, 0, -1))
    assert stats.percentile(xs, p) == want


def test_percentile_of_nothing():
    assert stats.percentile([], 95) is None
    assert readers.p95([]) is None


def _engine_rec():
    # window [10, 20): request a due at 9, tokens at 9.5 (before), 10.5, 11
    # request b due at 12, tokens at 13, 19.5, 20.5 (after)
    return dict(kind="engine", window=(10.0, 20.0), seconds=10.0,
                requests=[dict(t_ref=9.0, stamps=[9.5, 10.5, 11.0],
                               end=11.0, planes=6.0),
                          dict(t_ref=12.0, stamps=[13.0, 19.5, 20.5],
                               end=20.5, planes=8.0)])


def test_window_accounting():
    rec = _engine_rec()
    # only b's first token lands in the window: 1000 ms after it was due
    assert readers.ttft_ms(rec) == [1000.0]
    # gaps ending in the window: a 1.0, 0.5; b 6.5 (20.5 ends outside)
    assert sorted(readers.itl_ms(rec)) == [500.0, 1000.0, 6500.0]
    assert readers.window_tokens(rec) == 4
    # only a finished inside the window
    assert readers.planes_mean(rec) == 6.0


def test_decoder_flops_by_hand():
    per_token = 2 * 16 * (4 * 2048 ** 2 + 2 * 2048 * 8192)
    assert per_token == 1_610_612_736
    want = per_token + 4 * 16 * 2048 * 100 + 2 * 2048 * 50304
    assert flops.decoder_flops(OLMO, 1, 100, 1) == want == 1_829_765_120


def test_causal_context_sum():
    assert flops.causal_ctx_sum(0, 3) == 1 + 2 + 3
    assert flops.causal_ctx_sum(3, 5) == 4 + 5
    assert flops.causal_ctx_sum(0, 512) + flops.causal_ctx_sum(512, 1024) \
        == flops.causal_ctx_sum(0, 1024)


def test_encoder_flops_by_hand():
    m = dict(OLMO, family="encdec", encoder_layers=2, n_layers=3,
             d_model=8, n_heads=2, n_kv_heads=2, d_ff=16)
    layer = 4 * 64 + 2 * 8 * 16
    want = 2 * 5 * layer * 2 + 4 * 2 * 8 * 5 * 5 + 2 * 5 * 2 * 64 * 3
    assert flops.encoder_flops(m, 5, 1) == want


def test_dslot_least_time_decode_is_bytes_bound():
    t = flops.dslot_least_s(16, 2048, 8192, 2)
    moved = 16 * 2048 + 2048 * 8192 * 2 + 16 * 8192 * 2
    assert moved == 33_849_344
    assert t == pytest.approx(moved / 3.35e12)
    assert 2 * 16 * 2048 * 8192 / 989e12 < t


def test_dslot_least_time_admission_is_ops_bound():
    t = flops.dslot_least_s(1024, 2048, 8192, 2)
    assert t == pytest.approx(2 * 1024 * 2048 * 8192 / 989e12)


def test_roofline_and_mfu_readers():
    least = flops.dslot_least_s(16, 2048, 8192, 2)
    rec = dict(kind="engine", w_bytes=2,
               dslot_calls=[(16, 2048, 8192, 16)],
               trace={"by_name": {"void band_kernel<16, 1, true, 0>(A)":
                                  4 * 16 * least,
                                  "at::native::elementwise": 1.0},
                      "busy_s": 0.25, "window_s": 1.0},
               trace_window=(0.0, 2.0),
               steps=[dict(t0=0.0, t1=0.5, admit=True, flops=989e12 * 0.1),
                      dict(t0=0.5, t1=2.0, admit=False, flops=989e12 * 0.3)])
    assert readers.dslot_roofline_pct(rec, KERNELS) == pytest.approx(25.0)
    assert readers.idle_pct(rec) == pytest.approx(75.0)
    assert readers.mfu_pct(readers.total_flops(rec), 2.0) == \
        pytest.approx(20.0)
    adm = readers.admit_steps(rec)
    assert readers.mfu_pct(sum(s["flops"] for s in adm),
                           sum(s["t1"] - s["t0"] for s in adm)) == \
        pytest.approx(20.0)
    # no DSLOT kernel in the trace: the reader has nothing to read
    rec["trace"]["by_name"] = {"at::native::elementwise": 1.0}
    assert readers.dslot_roofline_pct(rec, KERNELS) is None


def test_trace_summary_union_and_gap_labels():
    tr = DeviceTrace()
    tr.events = [("k1", 100, 200), ("k2", 150, 300), ("k3", 500, 600),
                 ("k1", 900, 1000)]
    spans = Spans()
    spans.levels[True].append((0, 700, "sampling and host read"))
    spans.levels[False].append((320, 450, "decode forward"))
    s = tr.summary(0, 1000, spans)
    assert s["busy_s"] == pytest.approx((200 + 100 + 100) / 1e9)
    assert s["window_s"] == pytest.approx(1000 / 1e9)
    assert s["by_name"]["k1"] == pytest.approx(200 / 1e9)
    labels = dict((k, v) for k, v in s["idle_gaps"])
    # idle gaps [0, 100), [300, 500) and [600, 900) each begin inside the
    # outer span only (the decode span opens at 320)
    assert labels["sampling and host read (all gaps)"] == \
        pytest.approx((100 + 200 + 300) / 1e9)
    assert s["device_ops"][0][0] == "k1"
    assert DeviceTrace().summary(0, 10, spans) is None


def test_traffic_same_seed_same_work():
    mix = dict(loop="open", rate_per_s=4.0,
               prompt={"dist": "loguniform", "lo": 512, "hi": 3072},
               output={"dist": "uniform", "lo": 8, "hi": 64})
    B = traffic.BLOCK
    a = traffic.requests(mix, 5, 4 * B, 1000)
    b = traffic.requests(mix, 5, 4 * B, 1000)
    c = traffic.requests(mix, 2 ** 33 + 1, 4 * B, 1000)
    assert all(np.array_equal(x["prompt"], y["prompt"])
               for x, y in zip(a, b))
    # another seed: other token ids, the open loop's schedule unchanged
    assert [(len(s["prompt"]), s["max_new"], s["due"]) for s in a] == \
        [(len(s["prompt"]), s["max_new"], s["due"]) for s in c]
    assert not all(np.array_equal(x["prompt"], y["prompt"])
                   for x, y in zip(a, c))
    # each block holds the same quantiles, shuffled
    for lo in range(0, 4 * B, B):
        blk = slice(lo, lo + B)
        assert sorted(len(s["prompt"]) for s in a[blk]) == \
            sorted(len(s["prompt"]) for s in a[:B])
    assert [len(s["prompt"]) for s in a[:B]] != \
        sorted(len(s["prompt"]) for s in a[:B])
    # every block of B arrivals spans exactly B / rate seconds
    due = [s["due"] for s in a]
    assert due[B - 1] == pytest.approx(B / 4.0)
    assert due[2 * B - 1] - due[B - 1] == pytest.approx(B / 4.0)
    lens = [len(s["prompt"]) for s in a]
    assert min(lens) >= 512 and max(lens) <= 3072


def test_closed_loop_sizes_follow_the_seed():
    mix = dict(loop="closed", clients=4,
               prompt={"dist": "uniform", "lo": 64, "hi": 512},
               output={"dist": "uniform", "lo": 128, "hi": 384})
    B = traffic.BLOCK
    a = traffic.requests(mix, 5, 2 * B, 100)
    c = traffic.requests(mix, 6, 2 * B, 100)
    assert [len(s["prompt"]) for s in a] != [len(s["prompt"]) for s in c]
    for lo in (0, B):
        assert sorted(len(s["prompt"]) for s in a[lo:lo + B]) == \
            sorted(len(s["prompt"]) for s in c[lo:lo + B])


def test_closed_loop_stagger_spreads_first_outputs():
    mix = dict(loop="closed", clients=8, stagger=True,
               prompt={"dist": "uniform", "lo": 64, "hi": 512},
               output={"dist": "uniform", "lo": 128, "hi": 384})
    specs = traffic.requests(mix, 9, 32, 100)
    assert "due" not in specs[0]
    first = [s["max_new"] for s in specs[:8]]
    assert min(first) < 64 and max(first) <= 384
    assert all(128 <= s["max_new"] <= 384 for s in specs[8:])


def test_open_count_covers_the_horizon():
    assert traffic.open_count({"rate_per_s": 5.0}, 45.0) >= \
        math.ceil(5 * 45)
