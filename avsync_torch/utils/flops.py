"""Analytic FLOP model of the LipNet train step (port of
`avsync/utils/flops.py`): the useful model FLOPs behind an MFU figure.

Counts multiply-accumulates as 2 FLOPs: convolutions, the GRU projections
and recurrences, and the output layer. Elementwise work, pooling, softmax
and the CTC recursion are negligible next to the conv stack and are not
counted. The backward is the usual 2x forward (one product each for dx and
dw), so a train step is 3x the forward; rematerialised recompute is
overhead, not useful work, and is not counted.
"""

from __future__ import annotations

from typing import Tuple

from avsync_torch.config import ModelConfig

# NVIDIA's H100 SXM data sheet: dense fp32 outside the tensor cores, at the
# 700 W power limit (the rate chip_smoke.py's bounds use). A datasheet
# figure, not a measurement.
H100_FP32_PEAK_FLOPS = 67e12


def conv_stack_flops(cfg: ModelConfig, T: int, H: int, W: int, in_ch: int = 1) -> int:
    """Forward FLOPs of the conv stack for one clip (SAME conv + (1,2,2) pool)."""
    total = 0
    c_in = in_ch
    h, w = H, W
    for ch, (kt, kh, kw) in zip(cfg.conv_channels, cfg.conv_kernels):
        total += 2 * T * h * w * ch * (c_in * kt * kh * kw)
        c_in = ch
        h, w = h // 2, w // 2
    return total


def gru_stack_flops(cfg: ModelConfig, T: int, feat_dim: int) -> int:
    """Forward FLOPs of the stacked BiGRU for one clip."""
    total = 0
    hdim = cfg.hidden_dim
    d = feat_dim
    for _ in range(cfg.num_gru_layers):
        per_dir = 2 * T * d * 3 * hdim + 2 * T * hdim * 3 * hdim
        total += 2 * per_dir  # both directions
        d = 2 * hdim
    return total


def lipnet_forward_flops(cfg: ModelConfig, T: int = 75, H: int = 50, W: int = 100) -> int:
    """Forward FLOPs of the whole LipNet for one clip."""
    h, w = H, W
    for _ in cfg.conv_channels:
        h, w = h // 2, w // 2
    feat = cfg.conv_channels[-1] * h * w
    fc = 2 * T * (2 * cfg.hidden_dim) * cfg.vocab_size
    return conv_stack_flops(cfg, T, H, W) + gru_stack_flops(cfg, T, feat) + fc


def lipnet_train_flops(cfg: ModelConfig, T: int = 75, H: int = 50, W: int = 100) -> int:
    """Useful FLOPs of one train step for one clip (forward + backward = 3x)."""
    return 3 * lipnet_forward_flops(cfg, T, H, W)


def h100_peak_flops() -> float:
    """The H100 SXM's dense fp32 peak (the port computes in fp32)."""
    return H100_FP32_PEAK_FLOPS


def mfu(clips_per_sec: float, cfg: ModelConfig,
        shape: Tuple[int, int, int] = (75, 50, 100)) -> float:
    """Model FLOPs utilisation of one H100 at `clips_per_sec` train clips."""
    T, H, W = shape
    return clips_per_sec * lipnet_train_flops(cfg, T, H, W) / h100_peak_flops()
