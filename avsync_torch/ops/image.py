"""Device-side frame preprocessing on tensors (port of `avsync/ops/image.py`).

Heuristic mouth crop (rows [0.6H, H) x cols [0.3W, 0.7W)), bilinear resize
with cv2's INTER_LINEAR half-pixel convention, /255, and the TF stack's
per-clip standardization. Everything runs on the device the frames are on.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _linear_coords(out_size: int, in_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """cv2 INTER_LINEAR sampling: src = (dst + 0.5) * in/out - 0.5, edge
    pixels replicated by clamping the indices, weight 0 where src < 0."""
    scale = in_size / out_size
    src = (np.arange(out_size) + 0.5) * scale - 0.5
    x0 = np.floor(src).astype(np.int64)
    frac = (src - x0).astype(np.float32)
    frac = np.where(x0 < 0, 0.0, frac).astype(np.float32)
    x0c = np.clip(x0, 0, in_size - 1)
    x1c = np.clip(x0 + 1, 0, in_size - 1)
    return x0c, x1c, frac


def resize_coords(in_hw: Tuple[int, int], out_hw: Tuple[int, int],
                  device=None) -> Tuple[torch.Tensor, ...]:
    """(y0, y1, fy, x0, x1, fx) of a bilinear resize from in_hw to out_hw, as
    tensors on `device` (an exported program holds them as buffers)."""
    (H, W), (h, w) = in_hw, out_hw
    return tuple(torch.as_tensor(a, device=device)
                 for a in (*_linear_coords(h, H), *_linear_coords(w, W)))


def resize_bilinear(frames: torch.Tensor, out_hw: Tuple[int, int],
                    coords: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """Bilinear resize of (..., H, W) float frames to (..., h, w); `coords`
    are `resize_coords((H, W), out_hw)`, made here when not given."""
    if coords is None:
        coords = resize_coords(frames.shape[-2:], out_hw, frames.device)
    y0, y1, fy, x0, x1, fx = coords
    fy = fy[:, None]  # (h, 1)
    rows0 = frames[..., y0, :]
    rows1 = frames[..., y1, :]
    top = rows0[..., x0] * (1 - fx) + rows0[..., x1] * fx
    bot = rows1[..., x0] * (1 - fx) + rows1[..., x1] * fx
    return top * (1 - fy) + bot * fy


def mouth_crop(frames: torch.Tensor,
               crop: Tuple[float, float, float] = (0.6, 0.3, 0.7)) -> torch.Tensor:
    """Heuristic mouth ROI: rows [row0*H, H), cols [c0*W, c1*W)."""
    H, W = frames.shape[-2], frames.shape[-1]
    r0, c0, c1 = int(H * crop[0]), int(W * crop[1]), int(W * crop[2])
    return frames[..., r0:, c0:c1]


def crop_hw(in_hw: Tuple[int, int],
            crop: Tuple[float, float, float] = (0.6, 0.3, 0.7)) -> Tuple[int, int]:
    """(rows, cols) that `mouth_crop` keeps of an (H, W) frame."""
    H, W = in_hw
    return H - int(H * crop[0]), int(W * crop[2]) - int(W * crop[1])


def preprocess_clips(frames: torch.Tensor, out_hw: Tuple[int, int] = (50, 100),
                     crop: Tuple[float, float, float] = (0.6, 0.3, 0.7),
                     normalize: bool = True,
                     coords: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """(B, T, H, W) raw gray frames (0..255) -> (B, T, h, w, 1) float32:
    crop -> bilinear resize (`coords`: `resize_coords(crop_hw((H, W)),
    out_hw)`, made when not given) -> /255 -> channel dim."""
    x = resize_bilinear(mouth_crop(frames.float(), crop), out_hw, coords)
    if normalize:
        x = x * (1.0 / 255.0)
    return x[..., None]


def standardize_clips(clips: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Per-clip (mean, population std) standardization over all but the
    batch axis."""
    dims = tuple(range(1, clips.ndim))
    mean = clips.mean(dim=dims, keepdim=True)
    std = clips.std(dim=dims, keepdim=True, correction=0)
    return (clips - mean) / std.clamp_min(1e-8 if eps == 0.0 else eps)
