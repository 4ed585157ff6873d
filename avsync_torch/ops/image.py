"""Device-side frame preprocessing on tensors (port of `avsync/ops/image.py`).

BT.601 gray conversion, heuristic mouth crop (rows [0.6H, H) x cols
[0.3W, 0.7W)), bilinear resize with cv2's INTER_LINEAR half-pixel
convention and INTER_AREA's box average, /255, the TF stack's per-clip
standardization, zero-padding or truncating the time axis, the crop +
resize of per-frame boxes (`crop_resize_boxes`) and the temporal-variance
mouth box (`variance_mouth_boxes`). Everything runs on the device the
frames are on.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch


# ITU-R BT.601 luma weights, as cv2.cvtColor's BGR2GRAY / RGB2GRAY
_LUMA_RGB = (0.299, 0.587, 0.114)


def rgb_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB -> (...) gray with BT.601 weights."""
    r, g, b = frames[..., 0], frames[..., 1], frames[..., 2]
    return _LUMA_RGB[0] * r + _LUMA_RGB[1] * g + _LUMA_RGB[2] * b


def bgr_to_gray(frames: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR -> (...) gray with BT.601 weights."""
    return rgb_to_gray(frames.flip(-1))


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


def pad_or_truncate_time(clips: torch.Tensor,
                         max_len: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, ...) -> ((B, max_len, ...) zero-padded at the tail or
    truncated, (B,) int32 valid lengths), as `dataset.py:245-251`."""
    B, T = clips.shape[:2]
    if T >= max_len:
        out = clips[:, :max_len]
    else:
        out = torch.cat([clips, clips.new_zeros((B, max_len - T) + tuple(clips.shape[2:]))], 1)
    return out, torch.full((B,), min(T, max_len), dtype=torch.int32, device=clips.device)


def resize_area(frames: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_AREA for integer downscale factors (the box average; the TF
    stack resizes with it, `train.py:252`) of (..., H, W) float frames;
    other factors fall back to `resize_bilinear`."""
    (H, W), (h, w) = frames.shape[-2:], out_hw
    if H % h or W % w:
        return resize_bilinear(frames, out_hw)
    return frames.reshape(*frames.shape[:-2], h, H // h, w, W // w).mean(dim=(-3, -1))


def true_div(t: torch.Tensor, n: float) -> torch.Tensor:
    """t / n with IEEE division's rounding on every device. PyTorch's CUDA
    division by a Python scalar multiplies by the scalar's reciprocal, which
    can differ in the last bit; the ROI's boxes must be the same on the card
    as on the CPU (and in the JAX package)."""
    return t / torch.full((), n, dtype=t.dtype, device=t.device)


def crop_resize_boxes(frames: torch.Tensor, boxes: torch.Tensor,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """Crop + bilinear resize of each frame to its own normalized box.

    frames: (..., H, W) float; boxes: (..., 4) as (y0, y1, x0, x1) in [0, 1]
    (the detector's per-frame boxes, or one box per clip broadcast over its
    frames). Each frame is sampled on an out_hw grid spanning its box with
    cv2's half-pixel convention, so a full-frame box reproduces
    `resize_bilinear`."""
    H, W = frames.shape[-2], frames.shape[-1]
    h, w = out_hw
    lead = frames.shape[:-2]
    x = frames.reshape(-1, H, W)
    b = boxes.reshape(-1, 4).to(x.dtype)
    y0, y1, x0, x1 = b[:, 0:1], b[:, 1:2], b[:, 2:3], b[:, 3:4]
    bh = (y1 - y0) * H
    bw = (x1 - x0) * W
    sy = (torch.arange(h, device=x.device, dtype=x.dtype) + 0.5) * true_div(bh, h) - 0.5 + y0 * H
    sx = (torch.arange(w, device=x.device, dtype=x.dtype) + 0.5) * true_div(bw, w) - 0.5 + x0 * W
    yf, xf = torch.floor(sy), torch.floor(sx)  # (N, h), (N, w)
    fy = torch.where(yf < 0, 0.0, sy - yf)[:, :, None]
    fx = torch.where(xf < 0, 0.0, sx - xf)[:, None, :]
    yi, xi = yf.long(), xf.long()
    yi0, yi1 = yi.clamp(0, H - 1), (yi + 1).clamp(0, H - 1)
    xi0, xi1 = xi.clamp(0, W - 1), (xi + 1).clamp(0, W - 1)
    n = torch.arange(x.shape[0], device=x.device)[:, None]
    r0, r1 = x[n, yi0], x[n, yi1]  # (N, h, W)
    c0 = xi0[:, None, :].expand(-1, h, -1)
    c1 = xi1[:, None, :].expand(-1, h, -1)
    top = r0.gather(2, c0) * (1 - fx) + r0.gather(2, c1) * fx
    bot = r1.gather(2, c0) * (1 - fx) + r1.gather(2, c1) * fx
    return (top * (1 - fy) + bot * fy).reshape(*lead, h, w)


def variance_mouth_boxes(clips: torch.Tensor, box_frac: Tuple[float, float] = (0.35, 0.45),
                         lower_half_only: bool = True) -> torch.Tensor:
    """One normalized (y0, y1, x0, x1) mouth box per clip from temporal
    variance, on the device: (B, T, H, W) -> (B, 4).

    Per-pixel population variance over time, summed over every box of
    box_frac of the frame through an integral image, restricted to boxes
    centred in the lower half, and the first maximum taken. The variance is
    float32, as the JAX package computes it; the integral image is float64:
    at 288x360 its float32 values reach ~1e8, where one rounding step (8)
    is near the gap between neighbouring boxes' sums, and the card's
    parallel cumsum rounds in another order than the CPU's, so float32 would
    let the same frames give another box on the card."""
    B, T, H, W = clips.shape
    bh = max(2, int(H * box_frac[0]))
    bw = max(2, int(W * box_frac[1]))
    var = clips.float().var(dim=1, correction=0)  # (B, H, W), as jnp.var
    ii = var.double().cumsum(1).cumsum(2)
    ii = torch.nn.functional.pad(ii, (1, 0, 1, 0))  # a zero row on top, a zero column left
    nh, nw = H - bh + 1, W - bw + 1
    score = (ii[:, bh:bh + nh, bw:bw + nw] - ii[:, bh:bh + nh, :nw]
             - ii[:, :nh, bw:bw + nw] + ii[:, :nh, :nw])  # sum of var in the box at (y, x)
    if lower_half_only:
        rows = torch.arange(nh, device=clips.device)[:, None]
        score = torch.where(rows + bh // 2 >= H // 2, score, -torch.inf)
    idx = score.reshape(B, -1).argmax(dim=1)  # the first maximum, as jnp.argmax
    y = (idx // nw).float()
    x = (idx % nw).float()
    return torch.stack([true_div(y, H), true_div(y + bh, H), true_div(x, W),
                        true_div(x + bw, W)], dim=-1)
