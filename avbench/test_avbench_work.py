"""The yardstick's arithmetic: FLOPs of a clip and the kernels' least times."""

from __future__ import annotations

import math

import pytest

from avbench.harness import spec, work

MS = 1e-3


def test_lipnet_flops_per_clip():
    cfg = spec.config("lipnet")
    assert work.forward_flops(cfg) / 1e9 == pytest.approx(39.896, abs=5e-4)
    assert work.train_flops(cfg) / 1e9 == pytest.approx(119.689, abs=5e-4)


def test_tf_family_flops_from_its_layer_equations():
    cfg = spec.config("lipnet_tf")
    T = 75
    convs = (2 * T * 46 * 140 * 128 * 1 * 27       # conv1 at 46x140
             + 2 * T * 23 * 70 * 256 * 128 * 27    # conv2 at 23x70
             + 2 * T * 11 * 35 * 64 * 256 * 27)    # conv3 at 11x35
    feat = 64 * 5 * 17
    lstm = sum(2 * (2 * T * d * 4 * 256 + 2 * T * 256 * 4 * 256) for d in (feat, 512, 512))
    dense = 2 * T * 512 * 512 * 2 + 2 * T * 512 * 32
    assert work.forward_flops(cfg) == convs + lstm + dense
    assert work.train_flops(cfg) / 1e9 == pytest.approx(734.6, abs=0.1)
    assert (2 * T * 23 * 70 * 256 * 128 * 27) / 1e9 == pytest.approx(213.7, abs=0.05)


def test_peaks_by_dtype():
    assert work.peak_flops("bfloat16") == 989e12
    assert work.peak_flops("float32") == 495e12  # never the 67 of the CUDA cores
    with pytest.raises(ValueError):
        work.peak_flops("float64")


def test_conv1_counts_against_the_smoke_bounds():
    # K1-bf16 at B=8: 0.0161 ms by bytes (PERF.md §6)
    b, ops = work.conv1_fwd_work(8, 75, 50, 100, 32, 75, 2)
    assert b / work.HBM_BYTES_PER_S / MS == pytest.approx(0.0161, abs=5e-5)
    assert work.bound_s(b, ops, "bfloat16") == b / work.HBM_BYTES_PER_S
    # K1 float32: 0.2178 ms by operations at 67 TFLOP/s
    b, ops = work.conv1_fwd_work(8, 75, 50, 100, 32, 75, 4)
    assert ops / 67e12 / MS == pytest.approx(0.2178, abs=5e-5)
    # K4-bf16: 0.0177 ms by operations with the data's routed products; the
    # count without them is the bytes' 0.0161, below it
    b, ops = work.conv1_bwd_work(8, 75, 50, 100, 32, 75, 2)
    assert work.bound_s(b, ops, "bfloat16") / MS == pytest.approx(0.0161, abs=5e-5)
    assert work.bound_s(b, ops, "bfloat16") / MS < 0.0177


def test_gru_counts_against_the_smoke_bounds():
    b, ops = work.gru_fwd_work(8, 75, 256)
    assert ops / 67e12 / MS == pytest.approx(0.0071, abs=5e-5)   # K2's row
    assert b / 1e6 == pytest.approx(6.49, abs=0.005)             # K2-bf16's bytes
    assert b / work.HBM_BYTES_PER_S / MS == pytest.approx(0.0019, abs=5e-5)
    b, ops = work.gru_bwd_work(8, 75, 256)
    assert ops / 67e12 / MS == pytest.approx(0.0213, abs=5e-5)   # K3's row


def test_shares_stay_below_one_at_the_peaks():
    # a kernel can never beat its own bound: the least time is at least the
    # bytes over the bandwidth and the operations over the peak
    for B in (1, 8, 128):
        for w, dt in ((work.conv1_fwd_work(B, 75, 50, 100, 32, 75, 2), "bfloat16"),
                      (work.gru_fwd_work(B, 75, 256), "float32")):
            t = work.bound_s(*w, dt)
            assert t >= w[0] / work.HBM_BYTES_PER_S and t >= w[1] / work.peak_flops(dt)
            assert math.isfinite(t) and t > 0
