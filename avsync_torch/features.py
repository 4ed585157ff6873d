"""Batched audio-visual features of the misalignment detector (port of
`avsync/features.py`).

The reference builds one clip's features at a time
(`misalignment_detection_train.py:147-208`): the frozen LipNet conv stack's
embeddings -> (mean, std) over time (13,824 dims, the same for every shift
of the clip's audio), plus the MFCC (mean, std) of the possibly shifted
audio (40 dims). Here a `FeatureBank` holds every clip's visual statistics
and padded audio as tensors on the device, built in one batched pass; a
training step then gathers (clip, shift) pairs and computes their audio
statistics on the device (`gather_features`).

The port's visual statistics come in (C, H, W) order, as the reference's;
the JAX package's in (H, W, C).
"""

from __future__ import annotations

import os
import tempfile
import zipfile
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from avsync_torch.config import AudioConfig, AvsyncConfig
from avsync_torch.models.lipnet import LipNet
from avsync_torch.ops import audio as audiolib
from avsync_torch.ops.conv import fp32_step


def visual_stats(model: LipNet, clips: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, 1) clips -> (B, 2*conv_dim) concat(mean, unbiased std)
    over time of the frozen conv features (`misalignment_detection_train.py:
    157-165`; the std's divisor is max(T-1, 1))."""
    emb = model.conv_features(clips)  # (B, T, D), (C, H, W) order
    mean = emb.mean(dim=1)
    T = emb.shape[1]
    var = ((emb - mean[:, None, :]) ** 2).sum(dim=1) / max(T - 1, 1)
    return torch.cat([mean, var.sqrt()], dim=-1)


class FeatureBank(NamedTuple):
    """Per-clip tensors on the device. The assembled feature width is
    visual.shape[1] + 2 * n_mfcc (13,864 at the reference geometry)."""

    visual: torch.Tensor  # (N, 2*conv_dim) float32
    audio: torch.Tensor  # (N, max_audio_samples) float32, zero-padded
    audio_lengths: torch.Tensor  # (N,) int32
    fps: torch.Tensor  # (N,) float32


def build_feature_bank(model: LipNet, clips_iter: Iterable, audio_list: Sequence[np.ndarray],
                       fps_list: Sequence[float], cfg: AvsyncConfig) -> FeatureBank:
    """The bank of N clips, on the model's device. `clips_iter` yields (B, T,
    H, W, 1) clip batches (or `LipNetBatcher` batches) whose concatenation
    covers the N clips in order; a zero-padded last batch is cut off at N.
    `audio_list` / `fps_list`: each clip's mono audio at the configured rate
    and its fps."""
    device = next(model.parameters()).device
    parts = []
    with fp32_step(), torch.inference_mode():
        for batch in clips_iter:
            clips = batch["video"] if isinstance(batch, dict) else batch
            parts.append(visual_stats(model, clips.to(device)))
    N = len(audio_list)
    S = cfg.audio.max_audio_samples
    buf = np.zeros((N, S), np.float32)
    lengths = np.zeros((N,), np.int32)
    for i, a in enumerate(audio_list):
        a = np.asarray(a, np.float32)[:S]
        buf[i, :len(a)] = a
        lengths[i] = len(a)
    return FeatureBank(
        visual=torch.cat(parts, dim=0)[:N].contiguous(),
        audio=torch.from_numpy(buf).to(device),
        audio_lengths=torch.from_numpy(lengths).to(device),
        fps=torch.from_numpy(np.asarray(fps_list, np.float32)).to(device))


def save_feature_bank(path: str, bank: FeatureBank, key: str) -> None:
    """Persist a bank to `.npz` with its validity key, through a temporary
    file renamed into place (a crash never leaves half a bank)."""
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, key=np.asarray(key),
                     **{name: t.detach().cpu().numpy() for name, t in bank._asdict().items()})
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_feature_bank(path: str, key: str, device=None) -> Optional[FeatureBank]:
    """The saved bank if present and its key matches, on `device`; else None
    (also for a corrupt or partial file)."""
    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            if str(z["key"]) != key:
                return None
            return FeatureBank(**{name: torch.from_numpy(z[name]).to(device)
                                  for name in FeatureBank._fields})
    except (OSError, ValueError, KeyError, zipfile.BadZipFile):
        return None


def gather_features(bank: FeatureBank, video_idx: torch.Tensor, shift_frames: torch.Tensor,
                    audio_cfg: AudioConfig) -> torch.Tensor:
    """(clip index, shift) pairs -> (M, 2*conv_dim + 2*n_mfcc) features on
    the device (`build_feature`, `misalignment_detection_train.py:199-208`)."""
    idx = video_idx.to(device=bank.visual.device, dtype=torch.int64)
    astats = audiolib.shifted_audio_stats(bank.audio[idx], bank.audio_lengths[idx],
                                          shift_frames.to(bank.visual.device), bank.fps[idx],
                                          audio_cfg)
    return torch.cat([bank.visual[idx], astats], dim=-1)


def sample_shift_labels(n_videos: int, max_shift_frames: int, num_negatives: int,
                        rng: np.random.Generator, shuffle: bool = True):
    """Shift-contrastive plan for one epoch (`misalignment_detection_train.py:
    218-234`): every clip once at shift 0 (label 1) and `num_negatives` times
    at shift +-uniform{1..max} (label 0). The same numpy draws as the JAX
    package, so the same arrays for the same generator state.

    Returns (video_idx int32, shift_frames int32, labels float32), each of
    length n_videos * (1 + num_negatives)."""
    reps = 1 + num_negatives
    video_idx = np.repeat(np.arange(n_videos), reps)
    shifts = np.zeros(n_videos * reps, np.int32)
    labels = np.zeros(n_videos * reps, np.float32)
    labels[::reps] = 1.0
    neg_mask = labels == 0.0
    n_neg = int(neg_mask.sum())
    mag = rng.integers(1, max(1, max_shift_frames) + 1, size=n_neg)
    sign = rng.choice([-1, 1], size=n_neg)
    shifts[neg_mask] = (mag * sign).astype(np.int32)
    if shuffle:
        order = rng.permutation(len(video_idx))
        video_idx, shifts, labels = video_idx[order], shifts[order], labels[order]
    return video_idx.astype(np.int32), shifts, labels
