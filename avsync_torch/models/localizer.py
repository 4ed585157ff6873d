"""Learned mouth-ROI localizer (port of `avsync/models/localizer.py`).

A ~7k-parameter conv box regressor that stands in for dlib's landmarks on
the device, batched over clips: the input is a clip's temporal mean frame,
resized to a fixed 48x96; the output is one normalized (y0, y1, x0, x1)
mouth box per clip, which `ops.image.crop_resize_boxes` crops. Selected
with DataConfig.roi_mode = "model".

The weight bundle (`localizer_weights.npz`) is the JAX package's file
layout, so one file serves both packages: flat keys `conv1/kernel` ...
`fc2/bias`, conv kernels HWIO, dense kernels (in, out), float32.
`save_params` writes it and `load_bundled_params` reads it into the port's
state dict. The bundled file is trained on the synthetic corpus, where the
mouth box is known by construction; `train/localizer_trainer.py` (and
`scripts/torch_train_localizer.py`) retrains it. Training uses the plain
`MouthLocalizer`, whose weights are parameters; loading for inference
freezes them into buffers (`frozen`), as an exported program holds them.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from avsync_torch.ops.image import resize_bilinear, true_div

# Fixed network input geometry (H, W): clips are resized here before the net.
NET_HW: Tuple[int, int] = (48, 96)

WEIGHTS_FILE = os.path.join(os.path.dirname(__file__), "localizer_weights.npz")


def same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """Flax's "SAME" padding of an NCHW input for a k x k conv of stride s:
    total max((ceil(n / s) - 1) * s + k - n, 0) per axis, the smaller half
    first, so a stride-2 3x3 conv on an even size pads (0, 1), not (1, 1)."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):  # F.pad lists the last axis first
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


def center_size_to_box(cy, cx, bh, bw) -> torch.Tensor:
    """(center, size) -> clipped normalized (y0, y1, x0, x1)."""
    return torch.stack([(cy - bh / 2).clamp(0.0, 1.0), (cy + bh / 2).clamp(0.0, 1.0),
                        (cx - bw / 2).clamp(0.0, 1.0), (cx + bw / 2).clamp(0.0, 1.0)], dim=-1)


def decode_box(raw: torch.Tensor) -> torch.Tensor:
    """(..., 4) raw logits -> a valid normalized box through (centre, size):
    cy, cx in (0, 1), height and width in (0.05, 0.95), clipped to the
    frame."""
    s = torch.sigmoid(raw)
    return center_size_to_box(s[..., 0], s[..., 1], 0.05 + 0.9 * s[..., 2],
                              0.05 + 0.9 * s[..., 3])


def iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of (..., 4) (y0, y1, x0, x1) boxes; the union is
    floored at 1e-9."""
    iy = (torch.minimum(a[..., 1], b[..., 1]) - torch.maximum(a[..., 0], b[..., 0])).clamp_min(0.0)
    ix = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 2], b[..., 2])).clamp_min(0.0)
    inter = iy * ix

    def area(z):
        return (z[..., 1] - z[..., 0]).clamp_min(0.0) * (z[..., 3] - z[..., 2]).clamp_min(0.0)

    return inter / (area(a) + area(b) - inter).clamp_min(1e-9)


class MouthLocalizer(nn.Module):
    """(B, 1, 48, 96) float32 in [0, 1] -> (B, 4) normalized (y0, y1, x0, x1).

    Soft-argmax head: a one-channel heatmap over the last conv grid gives
    the box centre as an attention-weighted expectation; the box size comes
    from the attention-pooled features."""

    def __init__(self, widths: Sequence[int] = (8, 16, 32), dense_dim: int = 32):
        super().__init__()
        c_in = 1
        for i, w in enumerate(widths):
            setattr(self, f"conv{i + 1}", nn.Conv2d(c_in, w, 3, stride=2))
            c_in = w
        self.n_convs = len(widths)
        self.heat = nn.Conv2d(c_in, 1, 1)
        self.fc1 = nn.Linear(c_in, dense_dim)
        self.fc2 = nn.Linear(dense_dim, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_convs):
            x = F.relu(getattr(self, f"conv{i + 1}")(same_pad(x, 3, 2)))
        B, _, gh, gw = x.shape
        p = torch.softmax(self.heat(x).reshape(B, gh * gw), dim=-1).reshape(B, gh, gw)
        # normalized cell-centre coordinates of the feature grid
        ys = true_div(torch.arange(gh, device=x.device, dtype=x.dtype) + 0.5, gh)
        xs = true_div(torch.arange(gw, device=x.device, dtype=x.dtype) + 0.5, gw)
        cy = torch.einsum("bhw,h->b", p, ys)
        cx = torch.einsum("bhw,w->b", p, xs)
        pooled = torch.einsum("bhw,bchw->bc", p, x)  # attention pooling
        size_raw = self.fc2(F.relu(self.fc1(pooled)))
        bh = 0.05 + 0.9 * torch.sigmoid(size_raw[:, 0])
        bw = 0.05 + 0.9 * torch.sigmoid(size_raw[:, 1])
        return center_size_to_box(cy, cx, bh, bw)


def frozen(module: nn.Module) -> nn.Module:
    """`module` with each parameter moved into a buffer of the same name
    (the same state dict; an exported program holds them as buffers)."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            del mod._parameters[name]
            mod.register_buffer(name, None if p is None else p.detach())
    return module


def load_localizer(state, device=None) -> MouthLocalizer:
    """An eval-mode, frozen localizer holding `state` (the port's layout)."""
    model = frozen(MouthLocalizer())
    model.load_state_dict(state)
    return model.to(device).eval()


def save_params(state_dict, path: str = WEIGHTS_FILE) -> None:
    """Write the port's state dict as the JAX package's bundle (flat keys
    `conv1/kernel` ..., HWIO kernels, (in, out) dense kernels, float32)."""
    from avsync_torch.compat import localizer_params_to_jax

    np.savez(path, **{f"{layer}/{kind}": a
                      for layer, leaves in localizer_params_to_jax(state_dict).items()
                      for kind, a in leaves.items()})


def load_bundled_params(path: str = WEIGHTS_FILE) -> Dict[str, torch.Tensor]:
    """The bundle at `path` as the port's float32 state dict. Raises
    FileNotFoundError when it is missing."""
    from avsync_torch.compat import localizer_params_from_jax

    with np.load(path) as z:
        return localizer_params_from_jax({k: z[k] for k in z.files})


def load_bundled_or_none(device=None, path: str = WEIGHTS_FILE) -> Optional[MouthLocalizer]:
    """The bundled localizer on `device`, or None with a warning when the
    bundle is missing: roi_mode='model' then takes the heuristic crop. The
    one definition of that policy, shared by training, serving and export."""
    try:
        state = load_bundled_params(path)
    except FileNotFoundError:
        warnings.warn("localizer weight bundle missing; roi_mode='model' falls back to the "
                      "heuristic crop")
        return None
    return load_localizer(state, device)


def net_frames(frames: torch.Tensor,
               coords: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """(B, H, W) float frames in [0, 255] or [0, 1] -> (B, 48, 96) net input:
    each frame scaled by its own max, resized to NET_HW. `coords`:
    `ops.image.resize_coords((H, W), NET_HW)`, made here when not given."""
    x = frames / frames.amax(dim=(1, 2), keepdim=True).clamp_min(1e-6)
    return resize_bilinear(x, NET_HW, coords)


def localize_frames(model: MouthLocalizer, frames: torch.Tensor,
                    coords: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """(B, H, W) float frames in [0, 255] or [0, 1] -> (B, 4) boxes."""
    return model(net_frames(frames, coords)[:, None])


def localize_clip_boxes(model: MouthLocalizer, clips: torch.Tensor,
                        coords: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """(B, T, H, W) float -> (B, 4): one box per clip from its temporal mean
    frame (the statistic the bundled weights were trained on)."""
    return localize_frames(model, clips.mean(dim=1), coords)


def gate_boxes(clips: torch.Tensor, boxes: torch.Tensor, fallback: torch.Tensor,
               threshold: float = 1.0) -> torch.Tensor:
    """Per clip, `boxes` where the box's interior mean temporal variance is
    at least `threshold` x the frame-wide mean, else `fallback` (the
    heuristic crop fractions): a mouth box captures above-average motion.

    Padded tail frames (exactly zero, appended when a clip is shorter than
    max_video_length) are left out of the variance; with them, the content-
    to-black step dominates and the gate compares brightness, not motion.

    clips: (B, T, H, W) float; boxes: (B, 4); fallback: (4,)."""
    w = (clips != 0).any(dim=3).any(dim=2).to(clips.dtype)[:, :, None, None]  # valid frames
    n = w.sum(dim=1).clamp_min(1.0)  # (B, 1, 1)
    mean = (clips * w).sum(dim=1) / n
    motion = (((clips - mean[:, None]) ** 2) * w).sum(dim=1) / n  # (B, H, W)
    _, H, W = motion.shape
    yy = true_div(torch.arange(H, device=clips.device, dtype=motion.dtype) + 0.5, H)
    xx = true_div(torch.arange(W, device=clips.device, dtype=motion.dtype) + 0.5, W)
    inside = ((yy[None, :, None] >= boxes[:, 0, None, None])
              & (yy[None, :, None] < boxes[:, 1, None, None])
              & (xx[None, None, :] >= boxes[:, 2, None, None])
              & (xx[None, None, :] < boxes[:, 3, None, None]))
    area = inside.sum(dim=(1, 2)).clamp_min(1)
    inbox = (motion * inside).sum(dim=(1, 2)) / area
    ok = inbox >= threshold * motion.mean(dim=(1, 2))
    return torch.where(ok[:, None], boxes, fallback[None, :].to(boxes.dtype))
