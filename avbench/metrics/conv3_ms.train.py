"""conv3_ms.train: device ms per training step in conv3's spans, forward and
backward, LipNet's dropout after it and the flatten to (B, T, C*h*w) with it
(`conv3_fwd`, `conv3_bwd`; `harness/marks.py`)."""

from avbench.harness import marks

LAYER = "conv stack"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.named("conv3_fwd", "conv3_bwd"))
