"""Bidirectional GRU with torch-GRU cell semantics (port of `avsync/ops/gru.py`).

Same structure as the JAX package:

  * the input projection for ALL timesteps is hoisted out of the recurrence
    as one large (B*T, D) x (D, 3H) product per direction
    (`ops/precision.linear_f32`, a plain matmul outside any kernel, as the
    JAX package leaves it to XLA);
  * the recurrence runs either in the hand-written CUDA kernels
    (`use_kernel=True`, `ModelConfig.use_pallas_gru`): `BiGRURecurrence`, an
    autograd Function whose forward is K2 and whose backward is K3, both
    directions in one launch each, as the JAX package's `custom_vjp` around
    `pallas_gru_scan`/`pallas_gru_bwd` (`avsync/ops/gru.py:133-175`); or in
    the plain step loop, differentiated by autograd.
  * the input projection stays outside the Function, so its gradients
    (dx, dW_ih, db_ih) are autograd's, as they are XLA's in the JAX package.

Weights here are torch's: weight_ih (3H, D), weight_hh (3H, H), gate order
[r, z, n]. The kernel wrapper takes the JAX right-multiply layout, which is
the transpose view of torch's — no copy.

bf16 compute (`compute_dtype`, `ops/precision.py`): gi is the JAX package's,
bf16 x times bf16 weight_ih summed and kept in float32, plus the float32
bias (`avsync/ops/gru.py:75-83,119-128`). The kernels' recurrence is float32
whatever the dtype, as the JAX Pallas kernels are, so K2 and K3 run
unchanged on it. The plain loop follows `gru_scan`: each step's product
takes h and w_hh rounded to bf16 (`avsync/ops/gru.py:76,89`). The int8
forward under bf16 runs `gru_scan` itself (`avsync/ops/quant.py:292-296`),
so it asks for that rounding by `recurrence_dtype`, which the kernel path
takes as K2's bf16-operand instantiation (forward only).

Under tensor parallelism (`tp`, `parallel/mesh.TensorParallel`) the weights
are this rank's block of gate rows: the input projection computes its slice
of gi, and gi, w_hh and b_hh are gathered whole before the recurrence.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from avsync_torch.ops.cuda.gru import (bigru_recurrence, bigru_recurrence_bf16,
                                       bigru_recurrence_bwd, gru_recurrence_ref)
from avsync_torch.ops.precision import linear_f32


class GRUWeights(NamedTuple):
    """One direction, torch layout."""

    weight_ih: torch.Tensor  # (3H, D)
    weight_hh: torch.Tensor  # (3H, H)
    bias_ih: torch.Tensor  # (3H,)
    bias_hh: torch.Tensor  # (3H,)


def input_projection(x: torch.Tensor, w: GRUWeights,
                     compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(B, T, D) -> gi (B, T, 3H) = x @ weight_ih^T + bias_ih, float32 (from
    operands rounded to `compute_dtype`)."""
    return linear_f32(x, w.weight_ih, w.bias_ih, compute_dtype)


class BiGRURecurrence(torch.autograd.Function):
    """Both directions' recurrences: forward K2, backward K3 (their plain
    versions on the CPU). Inputs (gi_f, gi_b, w_hh_f, w_hh_b, b_hh_f, b_hh_b)
    in the JAX right-multiply layout (a torch weight_hh enters as its `.t()`
    view); output (B, T, 2H). The residuals are the JAX package's: gi, out,
    w_hh and b_hh; the backward recomputes the gates."""

    @staticmethod
    def forward(ctx, gi_f, gi_b, w_hh_f, w_hh_b, b_hh_f, b_hh_b):
        out = bigru_recurrence(gi_f, gi_b, w_hh_f, w_hh_b, b_hh_f, b_hh_b)
        ctx.save_for_backward(gi_f, gi_b, out, w_hh_f, w_hh_b, b_hh_f, b_hh_b)
        return out

    @staticmethod
    def backward(ctx, g):
        gi_f, gi_b, out, w_hh_f, w_hh_b, b_hh_f, b_hh_b = ctx.saved_tensors
        return bigru_recurrence_bwd(gi_f, gi_b, out, g.contiguous(), w_hh_f, w_hh_b,
                                    b_hh_f, b_hh_b)


def bigru(x: torch.Tensor, fwd: GRUWeights, bwd: GRUWeights,
          use_kernel: bool = False, tp=None,
          compute_dtype: Optional[torch.dtype] = None,
          recurrence_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Bidirectional GRU: (B, T, D) -> (B, T, 2H) = [forward | backward],
    float32; with `tp` the weights are row shards, gathered as the module
    says; `compute_dtype` bf16 rounds as the module says. `recurrence_dtype`
    bf16 rounds h and w_hh in each step's product on either path (the
    kernel path then runs forward only); None leaves the kernels float32
    and the plain loop at `compute_dtype`."""
    if tp is not None:
        x = tp.enter(x)
    gi_f = input_projection(x, fwd, compute_dtype)
    gi_b = input_projection(x, bwd, compute_dtype)
    if tp is not None:
        gi_f, gi_b = tp.gather(gi_f, -1), tp.gather(gi_b, -1)
        fwd, bwd = (w._replace(weight_hh=tp.gather(w.weight_hh, 0),
                               bias_hh=tp.gather(w.bias_hh, 0)) for w in (fwd, bwd))
    if use_kernel and recurrence_dtype is not None:
        return bigru_recurrence_bf16(gi_f, gi_b, fwd.weight_hh.t(), bwd.weight_hh.t(),
                                     fwd.bias_hh, bwd.bias_hh)
    if use_kernel:
        return BiGRURecurrence.apply(gi_f, gi_b, fwd.weight_hh.t(), bwd.weight_hh.t(),
                                     fwd.bias_hh, bwd.bias_hh)
    dt = recurrence_dtype or compute_dtype
    return torch.cat([
        gru_recurrence_ref(gi_f, fwd.weight_hh.t(), fwd.bias_hh, False, compute_dtype=dt),
        gru_recurrence_ref(gi_b, bwd.weight_hh.t(), bwd.bias_hh, True, compute_dtype=dt),
    ], dim=-1)
