"""gather_ms.train: device ms per training step in the program's `gather`
span (the plan row, the clips' gather from the device cache, their labels
and lengths), over the traced window's whole steps (`harness/marks.py`)."""

from avbench.harness import marks

LAYER = "data feed (cache gather)"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.named("gather"))
