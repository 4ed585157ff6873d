"""conv1_ms.train: device ms per training step in conv1's spans, forward and
backward, LipNet's dropout after it with it (`conv1_fwd`, `conv1_bwd`;
`harness/marks.py`)."""

from avbench.harness import marks

LAYER = "conv stack"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.named("conv1_fwd", "conv1_bwd"))
