"""mfu.train: the training window's samples per second times the useful
FLOPs of a sample (`harness/work.train_flops`: LipNet 119.689 GFLOP per
clip, the TF family 734.6), over the H100's dense peak for the
configuration's dtype (bf16 989 TFLOP/s; float32 495, the TF32 tensor-core
rate that float32-faithful products cannot pass), in %."""

from avbench.harness import readers

LAYER = "model step"
MOVES = "train_samples_per_s"
SOURCE = "host_clock"


def read(readings):
    return readers.mfu(readings)
