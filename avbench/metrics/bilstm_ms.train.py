"""bilstm_ms.train: device ms per training step in the BiLSTM layers' spans,
forward and backward (`lstm<i>_fwd`, `lstm<i>_bwd`: the step loop and its
backward, the dropout after each; `harness/marks.py`)."""

from avbench.harness import marks

LAYER = "BiLSTM"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.layer("lstm"))
