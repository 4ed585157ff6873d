"""gru_bwd_roofline.train: K3 (the BiGRU recurrence's backward, kernels
named `gru_bwd`) in the traced plan calls, in %. Work per step: one launch
per BiGRU layer over the batch (`harness/work.gru_bwd_work`) at the float32
rate of 495 TFLOP/s or HBM bandwidth, the larger."""

from avbench.harness import readers, work

LAYER = "BiGRU"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
PATTERNS = ("gru_bwd",)


def step_bound_s(cfg, B):
    w = work.gru_bwd_work(B, cfg["frames"], cfg["hidden_dim"])
    return cfg["num_gru_layers"] * work.bound_s(*w, "float32")


def read(readings):
    cfg, B = readings["config"], readings.get("batch")
    return readers.roofline(
        readings, readings.get("step_span", "-"), PATTERNS,
        lambda name: readers.span_number(name, "S") * step_bound_s(cfg, B))
