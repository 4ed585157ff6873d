"""CTC loss with the reference's reduction semantics (port of `avsync/ops/ctc.py`).

The reference trains with `nn.CTCLoss(blank=0, reduction='mean',
zero_infinity=True)` on (T, B, V) log-softmax outputs (`trainer.py:24,53-61`):
each sequence's negative log-likelihood is divided by its target length,
then averaged over the batch; sequences with no valid alignment give 0. The
JAX package rebuilds that on top of optax; here it is the library call
itself (the JAX package computes it outside any Pallas kernel too), behind
the JAX function's batch-major signature.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ctc_loss_mean(log_probs: torch.Tensor, labels: torch.Tensor,
                  label_lengths: torch.Tensor,
                  input_lengths: Optional[torch.Tensor] = None,
                  blank_id: int = 0) -> torch.Tensor:
    """Mean CTC loss: log_probs (B, T, V), labels (B, L) 0-padded, label
    lengths (B,), input lengths (B,) defaulting to T. Returns a scalar."""
    B, T, _ = log_probs.shape
    if input_lengths is None:
        input_lengths = torch.full((B,), T, dtype=torch.long)
    return F.ctc_loss(log_probs.transpose(0, 1), labels.long(), input_lengths.long(),
                      label_lengths.long(), blank=blank_id, reduction="mean",
                      zero_infinity=True)
