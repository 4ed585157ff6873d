"""bilstm_kernels.train: device kernels per training step in the BiLSTM
layers' spans (copies and sets not counted; `harness/marks.py`): the launches
the step loop costs. A count: every replay of the graph runs the same."""

from avbench.harness import marks

LAYER = "BiLSTM"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_kernels(readings, marks.layer("lstm"))
