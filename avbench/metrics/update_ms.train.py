"""update_ms.train: device ms per training step in the `update` span (the
global-norm clip and Adam; `harness/marks.py`)."""

from avbench.harness import marks

LAYER = "optimizer"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.named("update"))
