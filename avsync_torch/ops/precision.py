"""Where the bf16 compute mode rounds (`ModelConfig.compute_dtype`, the JAX
package's `compute_dtype="bfloat16"`).

Parameters, gradients and the optimizer's state stay float32; what rounds to
bf16 is the operands of the large products, and some of their outputs:

  * `linear_f32`: the JAX package's `einsum(x.astype(dt), w.astype(dt),
    preferred_element_type=float32)`, the GRU and LSTM input projections and
    the recurrences' step products of the plain loops. The operands are
    rounded to bf16 and widened again, so the products are exact and the
    sums float32, whatever the device (TF32 is off in the steps' scopes); a
    bf16 `F.linear` would round the output, which the JAX package keeps in
    float32;
  * `dense`: Flax's `nn.Dense(dtype=dt)`, the heads: bf16 in, bf16 out,
    with the bias rounded to bf16 and added after the product's rounding.

float32 compute is `dt=None`: every function is then its plain float32 form.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    """`ModelConfig.compute_dtype` -> the dtype the model rounds to (None:
    float32 throughout)."""
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype={name!r}: use 'float32' or 'bfloat16'")
    return COMPUTE_DTYPES[name]


def rounded(x: torch.Tensor, dt: Optional[torch.dtype]) -> torch.Tensor:
    """x rounded to dt and widened back to float32 (x itself when dt is None)."""
    return x if dt is None else x.to(dt).float()


def linear_f32(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
               dt: Optional[torch.dtype]) -> torch.Tensor:
    """x @ weight^T + bias in float32, from operands rounded to dt."""
    return F.linear(rounded(x, dt), rounded(weight, dt), bias)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dt: Optional[torch.dtype]) -> torch.Tensor:
    """F.linear in dt: operands and output rounded to dt, the bias added in dt
    after the product (float32 when dt is None)."""
    if dt is None:
        return F.linear(x, weight, bias)
    return F.linear(x.to(dt), weight.to(dt)) + bias.to(dt)
