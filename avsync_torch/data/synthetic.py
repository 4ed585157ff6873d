"""Deterministic synthetic GRID-style corpus for tests and demos (port of
`avsync/data/synthetic.py`: numpy only, the same draws, so the same seed
writes the same bytes).

The reference fabricates labels when discovery fails
(`utils.py:141-177` create_dummy_alignments, interactive). This module is
that idea made deterministic and complete: it writes a miniature corpus —
video clips (either preprocessed .npy mouth crops or full-frame clips),
GRID-format .align transcripts, and sibling .wav audio whose envelope is
correlated with the video so the misalignment task is learnable — in any of
the three reference layouts (standard / mixed / flat).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from avsync_torch.data.video import save_wav

GRID_PHRASES: Tuple[str, ...] = (
    "bin blue at f nine please",
    "lay red at j two now",
    "place white by a four soon",
    "set green in x eight again",
    "bin blue at l three please",
    "lay red by r zero now",
    "place white at u five soon",
    "set green by b six again",
)


def make_clip(
    rng: np.random.Generator,
    n_frames: int = 75,
    height: int = 50,
    width: int = 100,
    fps: float = 25.0,
    sample_rate: int = 16000,
    mouth_center: Tuple[float, float] | None = None,
    mouth_scale: float = 1.0,
    phrase: str | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """One audio-visual clip: (T, H, W) uint8 video + float32 audio.

    A bright "mouth" ellipse opens/closes with a per-clip envelope; the audio
    is a tone amplitude-modulated by the SAME envelope, so visual/audio
    statistics are correlated when aligned and decorrelated when the audio is
    shifted (zeros swept in).

    With `phrase` given, the envelope is DERIVED from the phrase's character
    sequence (each character drives a distinct mouth-opening level over its
    frames) — video -> text is then actually learnable, so lipreading
    WER/CER on this corpus measures learning, not chance. Without it, the
    envelope is a random sinusoid (the original behavior; same RNG stream).

    mouth_center (normalized (cy, cx), default lower-middle (0.75, 0.5)) and
    mouth_scale vary the mouth geometry for localizer training.
    """
    t = np.arange(n_frames) / fps
    if phrase is None:
        f_env = rng.uniform(1.0, 3.0)
        phase = rng.uniform(0, 2 * np.pi)
        envelope = 0.5 + 0.5 * np.sin(2 * np.pi * f_env * t + phase)  # (T,)
    else:
        envelope = phrase_envelope(phrase, n_frames)
        # tiny per-clip jitter so clips of the same phrase are not bit-equal
        envelope = np.clip(
            envelope + 0.03 * rng.standard_normal(n_frames), 0.0, 1.0
        )

    yy, xx = np.mgrid[0:height, 0:width]
    ncy, ncx = mouth_center if mouth_center is not None else (0.75, 0.5)
    cy, cx = height * ncy, width * ncx
    # ellipse radii scale with the frame so geometry-agnostic callers work
    unit = mouth_scale * min(height / 50.0, width / 100.0)
    video = np.empty((n_frames, height, width), np.uint8)
    bg = rng.integers(30, 60)
    for i in range(n_frames):
        ry = (3.0 + 8.0 * envelope[i]) * unit
        rx = (12.0 + 6.0 * envelope[i]) * unit
        mouth = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        frame = np.full((height, width), bg, np.float32)
        frame += 10.0 * rng.standard_normal((height, width))
        frame[mouth] = 180.0 + 40.0 * envelope[i]
        video[i] = np.clip(frame, 0, 255).astype(np.uint8)

    n_samples = int(n_frames / fps * sample_rate)
    ta = np.arange(n_samples) / sample_rate
    if phrase is None:
        env_audio = 0.5 + 0.5 * np.sin(2 * np.pi * f_env * ta + phase)
    else:
        env_audio = np.interp(ta * fps, np.arange(n_frames), envelope)
    tone = rng.uniform(200.0, 600.0)
    audio = (env_audio * np.sin(2 * np.pi * tone * ta)).astype(np.float32) * 0.7
    audio += 0.01 * rng.standard_normal(n_samples).astype(np.float32)
    return video, audio


def phrase_envelope(phrase: str, n_frames: int) -> np.ndarray:
    """Character-driven mouth-opening envelope, time-aligned with the .align
    layout `_write_align` produces (sil 1/8 | words evenly spaced | sil).

    Each character maps to a distinct opening level, held over its share of
    the word's frames and lightly smoothed — so a video model can actually
    read the transcript back out (the lipreading task is learnable, unlike a
    random envelope)."""
    env = np.full(n_frames, 0.05)
    words = phrase.split()
    sil = n_frames // 8
    span = (n_frames - 2 * sil) // max(len(words), 1)
    charset = "abcdefghijklmnopqrstuvwxyz0123456789"
    t0 = sil
    for w in words:
        per = max(span // max(len(w), 1), 1)
        for i, c in enumerate(w):
            lo = t0 + i * per
            hi = min(t0 + (i + 1) * per, n_frames) if i < len(w) - 1 else min(
                t0 + span, n_frames
            )
            lvl = 0.2 + 0.75 * (max(charset.find(c), 0) / 35.0)
            env[lo:hi] = lvl
        t0 += span
    return np.convolve(env, [0.25, 0.5, 0.25], mode="same")


def mouth_box(
    mouth_center: Tuple[float, float],
    mouth_scale: float,
    height: int,
    width: int,
    pad: float = 0.02,
) -> np.ndarray:
    """Ground-truth normalized (y0, y1, x0, x1) box covering the mouth's
    maximum open extent (envelope = 1) for `make_clip` geometry."""
    cy, cx = mouth_center
    unit = mouth_scale * min(height / 50.0, width / 100.0)
    ry = 11.0 * unit / height + pad
    rx = 18.0 * unit / width + pad
    return np.array(
        [
            max(0.0, cy - ry),
            min(1.0, cy + ry),
            max(0.0, cx - rx),
            min(1.0, cx + rx),
        ],
        np.float32,
    )


def make_localizer_batch(
    rng: np.random.Generator,
    batch: int = 64,
    height: int = 200,
    width: int = 400,
    n_frames: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """(B, H, W) f32 temporal-mean frames + (B, 4) ground-truth boxes, with
    randomized mouth centers/scales — the localizer's training distribution
    (inference also feeds clip mean frames, `models.localizer`;
    `train.localizer_trainer` trains on them)."""
    frames = np.empty((batch, height, width), np.float32)
    boxes = np.empty((batch, 4), np.float32)
    for b in range(batch):
        center = (rng.uniform(0.45, 0.88), rng.uniform(0.25, 0.75))
        scale = rng.uniform(0.7, 1.6)
        video, _ = make_clip(
            rng, n_frames=n_frames, height=height, width=width,
            mouth_center=center, mouth_scale=scale,
        )
        frames[b] = video.astype(np.float32).mean(0)
        boxes[b] = mouth_box(center, scale, height, width)
    return frames, boxes


def write_corpus(
    root: str,
    n_speakers: int = 2,
    clips_per_speaker: int = 3,
    layout: str = "flat",
    preprocessed: bool = True,
    n_frames: int = 75,
    height: int = 50,
    width: int = 100,
    seed: int = 0,
    with_audio: bool = True,
) -> List[str]:
    """Write the corpus; returns the speaker directory names.

    layout: 'flat' (videos+aligns side by side), 'standard' (video/+align/),
    'mixed' (videos in root, aligns in align/). preprocessed=True writes
    .npy mouth-crop clips (the reference's processed-data path,
    `dataset.py:186-198`); False writes full frames as .npy at 4x the crop
    geometry so the device crop path has something to chew on.
    """
    rng = np.random.default_rng(seed)
    speakers = []
    for s in range(1, n_speakers + 1):
        speaker = f"s{s}"
        speakers.append(speaker)
        sdir = os.path.join(root, speaker)
        if layout == "standard":
            vdir = os.path.join(sdir, "video")
            adir = os.path.join(sdir, "align")
        elif layout == "mixed":
            vdir = sdir
            adir = os.path.join(sdir, "align")
        else:
            vdir = adir = sdir
        os.makedirs(vdir, exist_ok=True)
        os.makedirs(adir, exist_ok=True)

        for c in range(clips_per_speaker):
            name = f"clip{c:02d}"
            phrase = GRID_PHRASES[(s * clips_per_speaker + c) % len(GRID_PHRASES)]
            if preprocessed:
                video, audio = make_clip(
                    rng, n_frames, height, width, phrase=phrase
                )
            else:
                video, audio = make_clip(
                    rng, n_frames, height * 4, width * 4, phrase=phrase
                )
            np.save(os.path.join(vdir, name + ".npy"), video)
            _write_align(os.path.join(adir, name + ".align"), phrase, n_frames)
            if with_audio:
                save_wav(os.path.join(vdir, name + ".wav"), audio, 16000)
    return speakers


def _write_align(path: str, phrase: str, n_frames: int) -> None:
    """GRID-format align file: sil + evenly spaced words + sil, in the
    25 kHz-tick convention real GRID uses (1000 ticks per frame @ 25 fps)."""
    words = phrase.split()
    total = n_frames * 1000
    sil = total // 8
    span = (total - 2 * sil) // max(len(words), 1)
    lines = [f"0 {sil} sil"]
    t = sil
    for w in words:
        lines.append(f"{t} {t + span} {w}")
        t += span
    lines.append(f"{t} {total} sil")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
