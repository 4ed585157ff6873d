"""SAME-padded Conv3D and MaxPool3D(1,2,2) (port of `avsync/ops/conv.py`).

The port keeps PyTorch's NCDHW layout inside the model: (B, C, T, H, W)
activations and (O, I, kt, kh, kw) weights, which is also the reference
checkpoint layout. These blocks are plain convolutions that the JAX package
leaves to XLA outside any Pallas kernel; here they go to `F.conv3d` /
`F.max_pool3d`. Float32 convolutions run in full fp32: cuDNN would use TF32
by default, so each call turns TF32 off for its own scope.

A block computes in its input's dtype. In bf16 it is the JAX package's
`conv3d(x, kernel, bias, compute_dtype=bf16, preferred_dtype=bf16)`: the
weight is rounded to bf16, the convolution sums in float32 and rounds its
output to bf16 once, then the bias, rounded to bf16, is added in bf16. The
bias is added after the convolution, not passed into `F.conv3d`, which would
add it before the rounding.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F


def fp32_convs():
    """Context in which cuDNN convolutions run in full fp32 (TF32 off); the
    other cuDNN flags keep their current values."""
    cudnn = torch.backends.cudnn
    return cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                       deterministic=cudnn.deterministic, allow_tf32=False)


@contextlib.contextmanager
def fp32_step() -> Iterator[None]:
    """TF32 off for cuDNN and cuBLAS while the block runs (a step's forward
    AND backward), and cuBLAS's bf16 products reduced in float32 (its
    default lets them reduce in bf16; the JAX package accumulates in
    float32); the previous flags come back after."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_tf32 = False
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        with fp32_convs():
            yield
    finally:
        matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction = prev


@contextlib.contextmanager
def train_scope() -> Iterator[None]:
    """The trainers' step scope: `fp32_step`, and cuDNN's deterministic
    algorithms with its autotuner off. cuDNN's default backward of conv2 and
    conv3 on the H100 sums with atomics, so two runs of the same steps
    part from the second step; a data-parallel run is held bit for bit
    against its own loop, which needs every rank's gradients reproducible.
    The previous flags come back after. Serving and export keep
    `fp32_step` alone."""
    cudnn = torch.backends.cudnn
    prev = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with fp32_step():
            yield
    finally:
        cudnn.deterministic, cudnn.benchmark = prev


def conv3d(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor | None = None) -> torch.Tensor:
    """NCDHW stride-1 conv3d with symmetric SAME padding (k-1)//2 for odd
    kernels — torch's `padding=(1,2,2)` / `(1,1,1)` in the reference."""
    kt, kh, kw = weight.shape[2:]
    with fp32_convs():
        return F.conv3d(x, weight, bias, padding=((kt - 1) // 2, (kh - 1) // 2,
                                                  (kw - 1) // 2))


def max_pool3d(x: torch.Tensor,
               window: Tuple[int, int, int] = (1, 2, 2)) -> torch.Tensor:
    """NCDHW max pool, VALID, stride = window: 50x100 -> 25x50 -> 12x25 -> 6x12."""
    return F.max_pool3d(x, window)


def conv_relu_pool(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None) -> torch.Tensor:
    """One LipNet block: Conv3D -> ReLU -> MaxPool3D(1,2,2), NCDHW, in x's
    dtype (bf16 rounded as the module says)."""
    if x.dtype != torch.bfloat16:
        return max_pool3d(F.relu(conv3d(x, weight, bias)))
    y = conv3d(x, weight.to(x.dtype))
    if bias is not None:
        y = y + bias.to(x.dtype).view(-1, 1, 1, 1)
    return max_pool3d(F.relu(y))
