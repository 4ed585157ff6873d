"""conv1_bwd_roofline.train: K4-bf16 (conv1's weight gradient, the kernels
named `conv1_pool_bwd`) in the traced plan calls, in %. Work per step: one
launch over the batch (`harness/work.conv1_bwd_work`: clips, pooled
cotangent and weights in bf16, dW and db in float32; the recomputed
forward's operations, the data-dependent routed products left out) at the
bf16 peak or HBM bandwidth, the larger."""

import math

from avbench.harness import readers, work

LAYER = "conv stack"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
PATTERNS = ("conv1_pool_bwd",)


def step_bound_s(cfg, B):
    w = work.conv1_bwd_work(B, cfg["frames"], cfg["img_height"], cfg["img_width"],
                            cfg["conv_channels"][0], math.prod(cfg["conv_kernels"][0]), 2)
    return work.bound_s(*w, "bfloat16")


def read(readings):
    cfg, B = readings["config"], readings.get("batch")
    return readers.roofline(
        readings, readings.get("step_span", "-"), PATTERNS,
        lambda name: readers.span_number(name, "S") * step_bound_s(cfg, B))
