"""gru_fwd_roofline.train: K2 (the BiGRU recurrence, both directions in one
launch, kernels named `gru_fwd`) in the traced plan calls, in %. Work per
step: one launch per BiGRU layer over the batch (`harness/work.gru_fwd_work`:
gi, w_hh, b_hh read and h written in float32; the recurrent product and the
gates) at the float32 rate of 495 TFLOP/s or HBM bandwidth, the larger."""

from avbench.harness import readers, work

LAYER = "BiGRU"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
PATTERNS = ("gru_fwd",)


def step_bound_s(cfg, B):
    w = work.gru_fwd_work(B, cfg["frames"], cfg["hidden_dim"])
    return cfg["num_gru_layers"] * work.bound_s(*w, "float32")


def read(readings):
    cfg, B = readings["config"], readings.get("batch")
    return readers.roofline(
        readings, readings.get("step_span", "-"), PATTERNS,
        lambda name: readers.span_number(name, "S") * step_bound_s(cfg, B))
