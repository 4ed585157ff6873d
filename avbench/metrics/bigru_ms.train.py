"""bigru_ms.train: device ms per training step in the BiGRU layers' spans,
forward and backward (`gru<i>_fwd`, `gru<i>_bwd`: input projections, K2, K3,
the dropout after each; `harness/marks.py`)."""

from avbench.harness import marks

LAYER = "BiGRU"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.layer("gru"))
