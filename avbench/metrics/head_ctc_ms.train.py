"""head_ctc_ms.train: device ms per training step in the head's spans,
forward and backward (`head_ctc_fwd`, `head_ctc_bwd`: LipNet's Linear, the
TF family's three Dense layers, log_softmax and the CTC loss;
`harness/marks.py`)."""

from avbench.harness import marks

LAYER = "head and CTC"
MOVES = "train_samples_per_s"
SOURCE = "program_span"


def read(readings):
    return marks.layer_ms(readings, marks.named("head_ctc_fwd", "head_ctc_bwd"))
