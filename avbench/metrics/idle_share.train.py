"""idle_share.train: 1 - (the union of device kernel, copy and set
intervals) / (the traced window) over `traced_calls` plan calls traced
after the training window, in %."""

from avbench.harness import readers

LAYER = "device"
MOVES = "train_samples_per_s"
SOURCE = "device_trace"


def read(readings):
    return readers.idle_share(readings)
