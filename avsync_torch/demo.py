"""Demo export: annotated aligned and misaligned copies of a clip with the
detector's scores (port of `avsync/demo.py`).

Reference behaviour (`misalignment_detection_demo.py:212-278`): the score
drawn as green text on every frame, optionally upscaled, written as
`aligned_demo.*` / `misaligned_demo.*` with the (shifted) audio track. Where
the port's native ingest is built (`avsync_torch/ingest`: libav with
libx264 and AAC), each copy is one `.mp4` with its audio muxed in; where it
is not (no libav development files, as on a machine without them), each is
a cv2.VideoWriter video beside a lossless `.wav`. That choice is the
build's, as in the JAX package, not a fallback from a failure.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from avsync_torch.ops import audio_ref


def annotate_frames(frames: np.ndarray, text: str, scale: int = 1) -> np.ndarray:
    """`text` in green at the top left of every frame (uint8 (T, H, W) gray
    or (T, H, W, 3) BGR) -> (T, H*scale, W*scale, 3) BGR, nearest-neighbour
    upscaled first (`annotate_frame_rgb`, `misalignment_detection_demo.py:
    212-215`)."""
    import cv2

    out = []
    for f in frames:
        f = cv2.cvtColor(f, cv2.COLOR_GRAY2BGR) if f.ndim == 2 else f.copy()
        if scale != 1:
            f = cv2.resize(f, (f.shape[1] * scale, f.shape[0] * scale),
                           interpolation=cv2.INTER_NEAREST)
        cv2.putText(f, text, (8, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.6, (0, 255, 0), 2)
        out.append(f)
    return np.stack(out)


def write_video(path: str, frames: np.ndarray, fps: float = 25.0) -> str:
    """Write (T, H, W, 3) BGR (or (T, H, W) gray) uint8 frames with cv2: an
    `.mp4` path as mp4v, anything else as an MJPG `.avi` (and an `.mp4`
    the build cannot open also as `.avi`). Returns the path written."""
    import cv2

    if frames.ndim == 3:
        frames = np.stack([cv2.cvtColor(f, cv2.COLOR_GRAY2BGR) for f in frames])
    h, w = frames.shape[1:3]
    if path.endswith(".mp4"):
        fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    else:
        if not path.endswith(".avi"):
            path = os.path.splitext(path)[0] + ".avi"
        fourcc = cv2.VideoWriter_fourcc(*"MJPG")
    vw = cv2.VideoWriter(path, fourcc, fps, (w, h))
    if not vw.isOpened():
        path = os.path.splitext(path)[0] + ".avi"
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    for f in frames:
        vw.write(f)
    vw.release()
    return path


def export_demo(video_frames: np.ndarray, audio: np.ndarray, sample_rate: int, fps: float,
                shift_frames: int, aligned_score: float, misaligned_score: float,
                out_dir: str, scale: int = 1) -> Tuple[str, str]:
    """Write `aligned_demo` and `misaligned_demo` into out_dir (`export_demo`,
    `misalignment_detection_demo.py:241-278`): the aligned copy keeps the
    clip's audio, the misaligned one carries it zero-fill shifted by
    `shift_frames` (`build_shifted_audio_clip`, `:218-228`). Returns the two
    video paths."""
    from avsync_torch.data.video import save_wav
    from avsync_torch.ingest import native

    os.makedirs(out_dir, exist_ok=True)
    aligned = annotate_frames(video_frames, f"aligned score={aligned_score:.3f}", scale)
    mis = annotate_frames(video_frames, f"misaligned (shift {shift_frames:+d}) "
                                        f"score={misaligned_score:.3f}", scale)
    shifted = (audio_ref.shift_audio(audio, shift_frames, fps, sample_rate)
               if audio.size else audio)
    if native.available():  # one container each, the audio muxed in
        p1 = os.path.join(out_dir, "aligned_demo.mp4")
        p2 = os.path.join(out_dir, "misaligned_demo.mp4")
        native.mux_mp4(p1, aligned, fps, audio, sample_rate)
        native.mux_mp4(p2, mis, fps, shifted, sample_rate)
        return p1, p2
    p1 = write_video(os.path.join(out_dir, "aligned_demo.mp4"), aligned, fps)
    p2 = write_video(os.path.join(out_dir, "misaligned_demo.mp4"), mis, fps)
    if audio.size:
        save_wav(os.path.join(out_dir, "aligned_demo.wav"), audio, sample_rate)
        save_wav(os.path.join(out_dir, "misaligned_demo.wav"), shifted, sample_rate)
    return p1, p2
