"""Serving API: load a checkpoint once, predict many times (port of the
LipNet half of `avsync/predictor.py`).

`LipReader` turns (T, H, W) frames or `.npy` clips into transcripts with
greedy CTC. It runs on the card unless the caller passes `device="cpu"`;
with `device=None` and no GPU it raises instead of falling back. Ported so
far: the heuristic mouth ROI for native-size frames and the pre-cropped
path; not yet the detector/variance/model ROI modes, int8 or a mesh.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence

import numpy as np
import torch

from avsync_torch import text as textlib
from avsync_torch.compat import conv_shape_for, lipnet_params_from_jax, load_pth
from avsync_torch.config import AvsyncConfig
from avsync_torch.models.lipnet import LipNet
from avsync_torch.ops import image as imglib


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None; raises when None and there is no GPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def pad_frames(frames: np.ndarray, cfg: AvsyncConfig) -> np.ndarray:
    """Host pad/truncate (T, H, W) raw frames to max_video_length, keeping
    the dtype (uint8 stays uint8; the float cast happens on the device)."""
    max_len = cfg.data.max_video_length
    frames = np.asarray(frames)
    if frames.shape[0] >= max_len:
        return frames[:max_len]
    pad = np.zeros((max_len - frames.shape[0],) + frames.shape[1:], frames.dtype)
    return np.concatenate([frames, pad], axis=0)


def preprocess(frames: torch.Tensor, cfg: AvsyncConfig) -> torch.Tensor:
    """(B, T, H, W) raw frames on the device -> (B, T, h, w, 1) float32 model
    input: the heuristic mouth crop + resize for native-size frames, plain
    /255 for pre-cropped ones, then per-clip standardization if configured."""
    d = cfg.data
    target = (d.img_height, d.img_width)
    if tuple(frames.shape[2:]) != target:
        if d.roi_mode != "heuristic":
            raise NotImplementedError(
                f"roi_mode={d.roi_mode!r}: only the heuristic ROI is ported")
        out = imglib.preprocess_clips(frames, out_hw=target, crop=d.mouth_crop)
    else:
        out = (frames.float() * (1.0 / 255.0))[..., None]
    return imglib.standardize_clips(out) if d.standardize_clips else out


def prepare_clip(frames: np.ndarray, cfg: AvsyncConfig,
                 device: torch.device) -> torch.Tensor:
    """(T, H, W) uint8/float frames -> (1, max_len, h, w, 1) model input:
    pad the raw frames first (as training does), then preprocess on device."""
    x = torch.as_tensor(pad_frames(frames, cfg)[None]).to(device)
    return preprocess(x, cfg)


class LipReader:
    """Greedy-CTC lipreading from LipNet weights.

    Weights come from `checkpoint` (a reference `.pth`, either layout) or
    `params`: a state dict in the port's (reference) layout, or the JAX
    package's nested param dict, which goes through the weight bridge.
    """

    def __init__(self, checkpoint: Optional[str] = None,
                 params: Optional[Mapping] = None,
                 config: Optional[AvsyncConfig] = None, device=None):
        self.cfg = config or AvsyncConfig()
        self.device = resolve_device(device)
        if self.cfg.data.roi_mode != "heuristic":
            raise NotImplementedError(
                f"roi_mode={self.cfg.data.roi_mode!r}: only the heuristic ROI is ported")
        if (checkpoint is None) == (params is None):
            raise ValueError("pass exactly one of checkpoint= or params=")
        m = self.cfg.model
        if checkpoint is not None:
            state = load_pth(checkpoint)
        elif "conv1.weight" in params:
            state = params
        else:
            state = lipnet_params_from_jax(
                params, num_conv=len(m.conv_channels), num_gru=m.num_gru_layers,
                conv_shape=conv_shape_for(self.cfg))
        d = self.cfg.data
        self.model = LipNet(m, img_hw=(d.img_height, d.img_width),
                            generator=torch.Generator())
        self.model.load_state_dict(state)
        self.model.to(self.device).eval()

    def _prepare(self, frames: np.ndarray) -> torch.Tensor:
        return prepare_clip(frames, self.cfg, self.device)

    def prepare_raw(self, frames: np.ndarray):
        """Host half of the raw serving transport: (T, H, W) frames -> a
        payload tuple (frames (1, T, H, W),), dtype kept (uint8 ships 4x
        fewer bytes than float32). `preprocess_device` is the device half."""
        return (pad_frames(frames, self.cfg)[None],)

    def preprocess_device(self, frames, boxes=None) -> torch.Tensor:
        """(B, T, H, W) raw frames -> (B, T, h, w, 1) model input on the device."""
        if boxes is not None:
            raise NotImplementedError("detector boxes: the detector ROI is not ported")
        return preprocess(torch.as_tensor(frames).to(self.device), self.cfg)

    def _logprobs(self, clips: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return self.model(clips.to(self.device))

    def _decode(self, log_probs) -> List[str]:
        return textlib.decode_batch(log_probs)

    def predict_frames(self, frames: np.ndarray) -> str:
        return self._decode(self._logprobs(self._prepare(frames)))[0]

    def _load(self, video_path: str) -> np.ndarray:
        from avsync_torch.data.video import decode_video_gray

        frames = decode_video_gray(video_path, max_frames=self.cfg.data.max_video_length)
        if frames.size == 0:
            raise ValueError(f"no frames decoded from {video_path}")
        return frames

    def predict(self, video_path: str) -> str:
        return self.predict_frames(self._load(video_path))

    def predict_batch(self, video_paths: Sequence[str]) -> List[str]:
        """Batched path: decode every clip on the host, one upload, one batched
        preprocess, one forward, one decode. Clips of differing geometry are
        preprocessed one by one and then batched."""
        rows = [self.prepare_raw(self._load(p))[0] for p in video_paths]
        if len({(r.shape, r.dtype.str) for r in rows}) == 1:
            clips = self.preprocess_device(np.concatenate(rows, axis=0))
        else:
            clips = torch.cat([preprocess(torch.as_tensor(r).to(self.device), self.cfg)
                               for r in rows], dim=0)
        return self._decode(self._logprobs(clips))
