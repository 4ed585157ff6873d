"""Host-side clip and audio decode (port of `avsync/data/video.py`).

`.npy` clips follow the reference's preprocessed-data convention. Container
files (GRID's `.mpg`, `.mp4`, `.avi`) decode through the port's C++ libav
ingest (`avsync_torch.ingest.native`), built at first use; where it cannot
be built they go through cv2, imported only then, and where neither exists
they raise. A clip's audio is its sibling `.wav`, else the container's audio
stream, else silence with a warning.
"""

from __future__ import annotations

import os
import warnings
import wave
from typing import Optional, Tuple

import numpy as np

from avsync_torch.ingest import native


def _cv2(video_path: str):
    """cv2, for a container when the native ingest is unavailable."""
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError(
            f"{video_path}: no container decoder: the native ingest is unavailable "
            f"({native.why_unavailable()}) and cv2 does not import ({e})") from e
    return cv2


def decode_video_gray(video_path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Decode a clip to (T, H, W) uint8 gray frames.

    `.npy` clips are already cropped, with values in [0, 1] or [0, 255];
    they return as uint8 0..255 (the device preprocess re-normalizes).
    Containers go through the native ingest, else cv2."""
    if video_path.endswith(".npy"):
        frames = np.load(video_path)
        if frames.dtype != np.uint8:
            if frames.size and frames.max() <= 1.0:
                frames = frames * 255.0
            frames = np.clip(frames, 0, 255).astype(np.uint8)
        if max_frames is not None:
            frames = frames[:max_frames]
        return frames
    if native.available():
        return native.decode_video_gray(video_path, max_frames)
    cv2 = _cv2(video_path)
    cap = cv2.VideoCapture(video_path)
    frames = []
    try:
        while max_frames is None or len(frames) < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY) if frame.ndim == 3 else frame)
    finally:
        cap.release()
    return np.stack(frames) if frames else np.zeros((0, 0, 0), np.uint8)


def get_video_fps(video_path: str, fallback: float = 25.0) -> float:
    """FPS of a clip (`misalignment_detection_train.py:91-97`): the
    container's, or the fallback for a `.npy` clip or a container that
    states none."""
    if video_path.endswith(".npy"):
        return fallback
    if native.available():
        fps = native.get_fps(video_path)
    else:
        cv2 = _cv2(video_path)
        cap = cv2.VideoCapture(video_path)
        fps = cap.get(cv2.CAP_PROP_FPS)
        cap.release()
    return fps if fps and fps > 1e-3 else fallback


def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """Stdlib WAV reader -> (mono float32 in [-1, 1], sample_rate); PCM 8/16/
    32-bit and float32 WAVs."""
    with wave.open(path, "rb") as w:
        sr, n, ch, width = w.getframerate(), w.getnframes(), w.getnchannels(), w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        # int32 PCM or float32: the wave module hides the format tag, so sniff
        # (float32 PCM stays within a few units of 1)
        as_f = np.frombuffer(raw, dtype="<f4")
        if np.all(np.isfinite(as_f)) and np.abs(as_f).max(initial=0.0) <= 64.0:
            data = as_f.astype(np.float32)
        else:
            data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width} in {path}")
    if ch > 1:
        data = data.reshape(-1, ch).mean(axis=1)
    return data, sr


def save_wav(path: str, data: np.ndarray, sr: int) -> None:
    """PCM16 mono WAV writer."""
    pcm16 = (np.clip(np.asarray(data, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())


def load_audio_for_video(video_path: str, fallback_sr: int = 16000) -> Tuple[np.ndarray, int]:
    """Audio of a clip, in this order: its sibling `.wav` (same basename),
    the container's audio stream through the native ingest, else silence at
    `fallback_sr` with a warning (a `.npy` clip, an undecodable container, or
    no ingest)."""
    wav_path = os.path.splitext(video_path)[0] + ".wav"
    if os.path.exists(wav_path):
        return load_wav(wav_path)
    if not video_path.endswith(".npy") and native.available():
        try:
            return native.decode_audio(video_path)
        except RuntimeError:
            pass  # undecodable container: silence, as below
    warnings.warn(f"no audio source for {video_path} (no sibling .wav, no decodable audio "
                  "stream); returning silence")
    return np.zeros(0, np.float32), fallback_sr


def decode_frames(video_path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """(T, H, W) uint8 frames of a clip; raises for a clip with none."""
    frames = decode_video_gray(video_path, max_frames=max_frames)
    if frames.size == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    return frames


def decode_av(video_path: str, cfg) -> Tuple[np.ndarray, np.ndarray, float]:
    """(frames, mono audio at the configured rate, fps) of a clip on the
    host, as an `AvsyncConfig` sets them (frame count, sample rate, the fps
    of a clip that carries none)."""
    from avsync_torch.ops.audio import resample_host

    frames = decode_frames(video_path, cfg.data.max_video_length)
    audio, sr = load_audio_for_video(video_path, cfg.audio.sample_rate)
    if sr != cfg.audio.sample_rate:
        audio = resample_host(audio, sr, cfg.audio.sample_rate)
    return frames, audio, get_video_fps(video_path, cfg.detector.default_fps)
