"""conv2_ms.train: device ms per training step in conv2's spans, forward and
backward, LipNet's dropout after it with it (`conv2_fwd`, `conv2_bwd`;
`harness/marks.py`)."""

from avbench.harness import marks

LAYER = "conv stack"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.named("conv2_fwd", "conv2_bwd"))
