"""Misalignment-detector head in PyTorch (port of `avsync/models/detector.py`).

The reference's `MisalignmentDetector` (`misalignment_detection_train.py:
237-250`): Linear(input_dim -> hidden) -> ReLU -> Dropout(0.3) ->
Linear(hidden -> 1), squeezed logits, under the reference's `Sequential`
key names `classifier.0.*` / `classifier.3.*`, so a reference `.pth` loads
as it is. Default input_dim = 2 * 6912 visual + 2 * 20 audio statistics
= 13,864, with the visual statistics in (C, H, W) order as the reference's
(the JAX package's are (H, W, C): `compat.detector_params_from_jax` permutes
fc1's columns).

Both Linears are initialised like nn.Linear (uniform +-1/sqrt(fan_in)) from
an explicit generator, and dropout draws its mask from the generator the
caller passes to `forward`, never the global RNG. The products are plain
`F.linear` (cuBLAS), as the JAX package leaves them to XLA; callers run them
with TF32 off (`train.lipnet_trainer.fp32_step`).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from avsync_torch.models.lipnet import Linear


class MisalignmentDetector(nn.Module):
    """(N, input_dim) features -> (N,) logits."""

    def __init__(self, input_dim: int = 13864, hidden_dim: int = 256, dropout: float = 0.3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dropout = float(dropout)
        self.classifier = nn.Sequential(
            Linear(input_dim, hidden_dim, generator=generator),
            nn.ReLU(),
            nn.Dropout(self.dropout),  # holds the key layout; forward draws its own mask
            Linear(hidden_dim, 1, generator=generator),
        )

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """`train=True` applies inverted dropout with a mask from `generator`
        (a torch.Generator on the model's device)."""
        h = F.relu(self.classifier[0](x))
        if train and self.dropout > 0.0:
            if generator is None:
                raise ValueError("training with dropout needs an explicit torch.Generator")
            keep = torch.rand(h.shape, generator=generator, device=h.device) >= self.dropout
            h = h * keep.to(h.dtype) * (1.0 / (1.0 - self.dropout))
        return self.classifier[3](h).squeeze(-1)
