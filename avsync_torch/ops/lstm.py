"""(Bi)directional LSTM with the standard cell (port of `avsync/ops/lstm.py`),
the TF-family LipNet's sequence model (Keras `Bidirectional(LSTM(256))`,
`train.py:522-531`):

    i = sigmoid(x W_ii + b_ii + h W_hi + b_hi)
    f = sigmoid(x W_if + b_if + h W_hf + b_hf)
    g = tanh   (x W_ig + b_ig + h W_hg + b_hg)
    o = sigmoid(x W_io + b_io + h W_ho + b_ho)
    c' = f * c + i * g ;  h' = o * tanh(c')

Gate order i, f, g, o along 4H; zero initial (h, c). As in the JAX package,
the input projection for all timesteps is one matmul outside the recurrence
(with both biases folded in), and the recurrence is a plain step loop: the
JAX package runs it as a `lax.scan`, which no Pallas kernel replaces. Each
step is one batched matmul-add into the step's slice of the projection,
then the gates, for every direction at once; autograd differentiates the
loop. The loop reads no host value, so a train step that runs it can be
captured in a CUDA graph.

bf16 compute (`compute_dtype`, `ops/precision.py`), as the JAX `lstm_scan`
(`avsync/ops/lstm.py:57-75`): the projection takes bf16 x and weight_ih and
sums in float32, and each step's product takes h and w_hh rounded to bf16;
the gates, the cell and the carry stay float32.

Weights are torch's (`nn.LSTM`'s layout): weight_ih (4H, D), weight_hh
(4H, H). Under tensor parallelism (`tp`, `parallel/mesh.TensorParallel`)
they are this rank's block of gate rows: its slice of the projection is
computed, then the projection and w_hh are gathered whole before the loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from avsync_torch.ops.precision import linear_f32, rounded


class LSTMWeights(NamedTuple):
    """One direction, torch layout, gate order [i, f, g, o]."""

    weight_ih: torch.Tensor  # (4H, D)
    weight_hh: torch.Tensor  # (4H, H)
    bias_ih: torch.Tensor  # (4H,)
    bias_hh: torch.Tensor  # (4H,)


def _recurrence(gi: torch.Tensor, w_hh: torch.Tensor,
                dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """gi (T, N, B, 4H) input projections of N directions, each already in
    the order its recurrence walks; w_hh (N, H, 4H) -> h (T, N, B, H) in
    that order; `dt` rounds h and w_hh in each step's product."""
    T, N, B, _ = gi.shape
    H = w_hh.shape[1]
    w_hh = rounded(w_hh, dt)
    h = gi.new_zeros(N, B, H)
    c = gi.new_zeros(N, B, H)
    hs = []
    for t in range(T):
        gates = torch.baddbmm(gi[t], rounded(h, dt), w_hh)
        sig = torch.sigmoid(gates)
        i, f, o = sig[..., :H], sig[..., H:2 * H], sig[..., 3 * H:]
        c = torch.addcmul(f * c, i, torch.tanh(gates[..., 2 * H:3 * H]))
        h = o * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs)


def _run(x: torch.Tensor, weights: Sequence[LSTMWeights],
         reverse: Sequence[bool], tp=None, dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T, D) through each direction -> (B, T, N*H) float32, the
    directions' outputs concatenated in order, each at its own timestep."""
    if tp is not None:
        x = tp.enter(x)
    gis = []
    for w, rev in zip(weights, reverse):
        gi = linear_f32(x, w.weight_ih, w.bias_ih + w.bias_hh, dt)
        if tp is not None:
            gi = tp.gather(gi, -1)
        gi = gi.transpose(0, 1)  # (T, B, 4H)
        gis.append(gi.flip(0) if rev else gi)
    if tp is not None:
        weights = [w._replace(weight_hh=tp.gather(w.weight_hh, 0)) for w in weights]
    w_hh = torch.stack([w.weight_hh.t() for w in weights])
    hs = _recurrence(torch.stack(gis, dim=1), w_hh, dt)  # (T, N, B, H)
    outs = [hs[:, n].flip(0) if rev else hs[:, n] for n, rev in enumerate(reverse)]
    return torch.cat(outs, dim=-1).transpose(0, 1)


def lstm_scan(w: LSTMWeights, x: torch.Tensor, reverse: bool = False,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T, D) -> (B, T, H); `reverse` walks T backwards and writes each
    output at its own timestep, as `lax.scan(reverse=True)`."""
    return _run(x, [w], [reverse], dt=compute_dtype)


def bilstm(fwd: LSTMWeights, bwd: LSTMWeights, x: torch.Tensor, tp=None,
           compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bidirectional LSTM: (B, T, D) -> (B, T, 2H) = [forward | backward],
    both directions stepped together."""
    return _run(x, [fwd, bwd], [False, True], tp, compute_dtype)
