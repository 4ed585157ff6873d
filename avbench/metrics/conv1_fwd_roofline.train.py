"""conv1_fwd_roofline.train: K1-bf16 (conv1 + ReLU + pool, the kernels
named `conv1_pool_bf16_kernel`) in the traced plan calls, in %. Work per
step: one launch over the batch (`harness/work.conv1_fwd_work`: the clips,
weights and pooled map in bf16 bytes; 75 FMAs, the bias and a pool compare
per pre-pool value) at the bf16 peak or HBM bandwidth, the larger."""

import math

from avbench.harness import readers, work

LAYER = "conv stack"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"
PATTERNS = ("conv1_pool_bf16_kernel",)


def step_bound_s(cfg, B):
    w = work.conv1_fwd_work(B, cfg["frames"], cfg["img_height"], cfg["img_width"],
                            cfg["conv_channels"][0], math.prod(cfg["conv_kernels"][0]), 2)
    return work.bound_s(*w, "bfloat16")


def read(readings):
    cfg, B = readings["config"], readings.get("batch")
    return readers.roofline(
        readings, readings.get("step_span", "-"), PATTERNS,
        lambda name: readers.span_number(name, "S") * step_bound_s(cfg, B))
