"""The reduction of a trace: union of intervals, gaps, shares, breakdown."""

from __future__ import annotations

import pytest

from avbench.harness import readers, trace
from avbench.harness.trace import WINDOW, Trace


def test_union_counts_overlap_once():
    iv = [(0, 10), (5, 15), (20, 30), (25, 26), (40, 50)]
    assert trace.union_length(iv, 0, 100) == 15 + 10 + 10
    assert trace.merge(iv, 0, 100) == [(0, 15), (20, 30), (40, 50)]


def test_union_clips_to_the_window():
    assert trace.union_length([(-5, 5), (95, 120)], 0, 100) == 10
    assert trace.union_length([(200, 300)], 0, 100) == 0


def test_gaps_are_the_uncovered_stretches():
    assert trace.gaps([(10, 20), (15, 30), (50, 60)], 0, 100) == [(0, 10), (30, 50), (60, 100)]
    assert trace.gaps([], 0, 10) == [(0, 10)]


def _trace(device, host=(), spans=()):
    return Trace(list(device), list(host), [(WINDOW, 0, 1000)] + list(spans))


def test_idle_share_of_two_overlapping_streams():
    # two streams overlap on [200, 300): busy is 600 ns of 1000, not 700
    t = _trace([("k1", 0, 300), ("k2", 200, 500), ("copy", 700, 800)])
    assert t.busy_s() == pytest.approx(600e-9)
    assert t.idle_share() == pytest.approx(0.4)
    assert readers.idle_share({"trace": t}) == pytest.approx(40.0)


def test_nothing_to_read_gives_nothing():
    assert readers.idle_share({"trace": None}) is None
    assert _trace([]).idle_share() is None
    assert readers.mfu({"samples_per_s": None}) is None
    assert readers.roofline({"trace": None}, "avbench.batch", ("k",), lambda n: 1.0) is None


def test_kernel_time_inside_spans():
    t = _trace([("gru_fwd_kernel", 10, 30), ("gru_fwd_kernel", 60, 70), ("other", 15, 40),
                ("gru_fwd_kernel", 900, 950)],
               spans=[("avbench.batch.B8", 0, 50), ("avbench.batch.B4", 55, 80),
                      ("avbench.batch.B2", 990, 1100)])  # the last ends past the window
    spans = t.spans_named("avbench.batch")
    assert [s[0] for s in spans] == ["avbench.batch.B8", "avbench.batch.B4"]
    assert t.kernel_ns(("gru_fwd",), spans) == 20 + 10
    share = readers.roofline({"trace": t}, "avbench.batch", ("gru_fwd",),
                             lambda name: readers.span_number(name, "B") * 1e-9)
    assert share == pytest.approx(100.0 * (8 + 4) / 30)


def test_breakdown_names_gaps_by_the_innermost_host_event():
    t = _trace([("k1", 0, 400), ("k2", 600, 1000)],
               host=[("aten::outer", 300, 900), ("cudaStreamSynchronize", 420, 580)],
               spans=[("avbench.train_call.S16", 0, 1000)])
    b = t.breakdown()
    assert b["device_ops"][0] == ["k1", 400e-9] or b["device_ops"][0] == ["k2", 400e-9]
    assert b["idle_gaps"] == [["cudaStreamSynchronize", 200e-9]]


def test_mfu():
    cfg = {"family": "pytorch", "frames": 75, "img_height": 50, "img_width": 100,
           "conv_channels": [32, 64, 96], "conv_kernels": [[3, 5, 5], [3, 5, 5], [3, 3, 3]],
           "hidden_dim": 256, "num_gru_layers": 2, "outputs": 39, "peak_dtype": "bfloat16"}
    assert readers.mfu({"samples_per_s": 1000.0, "config": cfg}) == pytest.approx(
        100 * 1000 * 119.689e9 / 989e12, rel=1e-5)


def test_span_number():
    assert readers.span_number("avbench.train_call.S16", "S") == 16
    with pytest.raises(ValueError):
        readers.span_number("avbench.train_call", "S")
