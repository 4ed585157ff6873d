"""The reading of the program's layer marks (`harness/marks.py`) on
synthetic traces, and the per-layer metric files that read them."""

from __future__ import annotations

import pytest

from avbench.harness import marks, spec
from avbench.harness.trace import WINDOW, Trace

MARKED = ("gather_ms.train", "conv1_ms.train", "conv2_ms.train", "conv3_ms.train",
          "bigru_ms.train", "bilstm_ms.train", "bilstm_kernels.train", "head_ctc_ms.train",
          "update_ms.train")


def _trace(device, lo=0, hi=10_000):
    return Trace(list(device), [], [(WINDOW, lo, hi)])


def _m(span, at):
    return (f"avs_mark__{span}", at, at + 1)


def _step(t0, conv2=(100, 300), lstm=3):
    """One step's events from t0: marks, and kernels of known lengths."""
    ev = [_m("gather", t0), ("index_select_kernel", t0 + 2, t0 + 12),
          _m("conv1_fwd", t0 + 20), ("conv1_pool_kernel", t0 + 21, t0 + 41),
          _m("conv2_fwd", t0 + 50), ("sm80_xmma_fprop", t0 + 51, t0 + 51 + conv2[0]),
          _m("lstm1_fwd", t0 + 200)]
    ev += [(f"lstm_step_{i}", t0 + 201 + 2 * i, t0 + 202 + 2 * i) for i in range(lstm)]
    ev += [("Memcpy DtoD (Device -> Device)", t0 + 210, t0 + 215),
           _m("head_ctc_fwd", t0 + 220), ("sgemm", t0 + 221, t0 + 231),
           _m("head_ctc_bwd", t0 + 240), ("ctc_loss_backward", t0 + 241, t0 + 251),
           _m("lstm1_bwd", t0 + 260), ("lstm_bwd", t0 + 261, t0 + 271),
           _m("conv2_bwd", t0 + 280), ("sm80_xmma_dgrad", t0 + 281, t0 + 281 + conv2[1]),
           _m("conv1_bwd", t0 + 600), ("conv1_pool_bwd_kernel", t0 + 601, t0 + 631),
           _m("update", t0 + 640), ("multi_tensor_apply", t0 + 641, t0 + 661),
           _m("tail", t0 + 670), ("Memset (Device)", t0 + 671, t0 + 673)]
    return ev


def test_each_event_goes_to_the_latest_mark():
    t = _trace(_step(1000) + _step(2000))
    steps = marks.whole_steps(t)
    assert steps.n == 2
    assert steps.ns["conv2_fwd"] == 2 * (1 + 100)  # the mark's own time with its span
    assert steps.ns["conv2_bwd"] == 2 * (1 + 300)
    assert steps.ns["lstm1_fwd"] == 2 * (1 + 3 + 5)  # the copy is device time too
    assert steps.ns["tail"] == 2 * (1 + 2)
    assert marks.layer_ms({"trace": t}, marks.named("conv2_fwd", "conv2_bwd")) == \
        pytest.approx(402e-6)
    busy = sum(b - a for _, a, b in t.device)
    assert sum(steps.ns.values()) == busy


def test_only_whole_steps_count():
    # a step cut by the window's start (its gather before the window), one
    # whole step, and a last step that never reached its tail
    cut = [e for e in _step(0) if e[1] >= 500]
    last = [e for e in _step(2000) if e[1] < 2300]
    t = _trace(cut + _step(1000) + last, lo=500)
    steps = marks.whole_steps(t)
    assert steps.n == 1
    assert steps.ns["conv2_bwd"] == 1 + 300  # only the whole step's
    # with a later gather the unfinished step is whole up to it
    t2 = _trace(_step(1000) + last + [_m("gather", 2500)])
    assert marks.whole_steps(t2).n == 2


def test_a_kernel_before_the_first_mark_goes_to_no_span():
    t = _trace([("plan_copy", 10, 60), ("lr_fill", 70, 71)] + _step(100))
    steps = marks.whole_steps(t)
    assert steps.n == 1
    assert sum(steps.ns.values()) == sum(b - a for _, a, b in _step(100))


def test_no_marks_read_nothing():
    t = _trace([("k1", 0, 300), ("k2", 400, 500)])
    assert marks.whole_steps(t) is None
    assert marks.layer_ms({"trace": t}, marks.named("gather")) is None
    assert marks.layer_ms({"trace": None}, marks.named("gather")) is None
    for name in MARKED:
        assert spec.metric(name).read({"trace": t}) is None


def test_a_span_the_step_lacks_reads_nothing():
    t = _trace(_step(1000))
    assert marks.layer_ms({"trace": t}, marks.layer("gru")) is None
    assert spec.metric("bigru_ms.train").read({"trace": t}) is None


def test_bilstm_kernels_counts_kernels_per_step():
    t = _trace(_step(1000, lstm=7) + _step(2000, lstm=7) + _step(3000, lstm=7))
    # seven step kernels and one backward kernel per step; the copy not counted
    assert marks.layer_kernels({"trace": t}, marks.layer("lstm")) == 8
    assert spec.metric("bilstm_kernels.train").read({"trace": t}) == 8
    assert spec.metric("bilstm_ms.train").read({"trace": t}) == pytest.approx(
        (1 + 7 + 5 + 1 + 10) / 1e6)


def test_layer_prefixes_take_every_layer_and_no_other():
    take = marks.layer("gru")
    assert [s for s in ("gru1_fwd", "gru2_bwd", "gru12_fwd", "grux_fwd", "gru1_fwd_x",
                        "conv1_fwd", "gather") if take(s)] == ["gru1_fwd", "gru2_bwd", "gru12_fwd"]


def test_mark_names_read_as_the_profiler_gives_them():
    assert marks.mark_of("avs_mark__conv2_bwd") == "conv2_bwd"
    assert marks.mark_of("void avs_mark__head_ctc_fwd()") == "head_ctc_fwd"
    assert marks.mark_of("conv1_pool_bf16_kernel") is None


@pytest.mark.parametrize("name", MARKED)
def test_each_metric_file_agrees_with_its_entry(name):
    bench = spec.benchmark()
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    mod = spec.metric(name)
    assert (mod.LAYER, mod.MOVES, mod.SOURCE) == (entry["layer"], entry["moves"],
                                                  entry["source"])
    assert entry["source"] == "program_span" and entry["better"] == "lower"
    reported = {w["name"] for w in bench["workloads"]}
    assert set(entry["workloads"]) <= reported
