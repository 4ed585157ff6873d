"""Host-side clip decode (port of the `.npy` branch of `avsync/data/video.py`).

Container decode (mp4/mpg through the C++ libav ingest) is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def decode_video_gray(video_path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """Load a `.npy` clip as (T, H, W) uint8 gray frames.

    Follows the reference's preprocessed-data convention: already cropped
    clips with values in [0, 1] or [0, 255]; returned as uint8 0..255 (the
    device preprocess re-normalizes)."""
    if not video_path.endswith(".npy"):
        raise NotImplementedError(
            f"{video_path}: only .npy clips are supported so far (container "
            "decode is not ported yet)")
    frames = np.load(video_path)
    if frames.dtype != np.uint8:
        if frames.size and frames.max() <= 1.0:
            frames = frames * 255.0
        frames = np.clip(frames, 0, 255).astype(np.uint8)
    if max_frames is not None:
        frames = frames[:max_frames]
    return frames
