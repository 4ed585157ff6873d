"""GRID corpus discovery and sample management (the port's own copy of
`avsync/data/grid.py`).

Reproduces the reference's three dataset layouts (`dataset.py:48-126`):
  1. standard:  <root>/<speaker>/video/*.mpg + <root>/<speaker>/align/*.align
  2. mixed:     <root>/<speaker>/*.mpg + <root>/<speaker>/align/*.align
  3. flat:      <root>/<speaker>/{*.mpg|*.npy, *.align|*.txt} side by side
plus the structure probing / speaker discovery of `utils.py:179-265` and
`misalignment_detection_train.py:379` (speakers = dirs starting with 's'),
and both split policies: the PyTorch stack's 70/15/15 *speaker* split
(`main.py:63-77`) and the detector's 70/15/15 *video* split
(`misalignment_detection_train.py:393-397`).
"""

from __future__ import annotations

import copy
import os
import random
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from avsync_torch import text as textlib

# The reference admits .npy (preprocessed clips) only in the flat layout
# (`dataset.py:103` vs `:64`); both packages accept it in every layout so
# preprocessed corpora can keep the standard directory structure.
VIDEO_EXTS = (".mpg", ".mp4", ".avi", ".mov", ".npy")
VIDEO_EXTS_FLAT = VIDEO_EXTS
ALIGN_EXTS = (".align", ".txt")


def _find_align(align_dir: str, base: str) -> Optional[str]:
    for ext in ALIGN_EXTS:
        p = os.path.join(align_dir, base + ext)
        if os.path.exists(p):
            return p
    return None


def discover_samples(
    data_path: str, speakers: Sequence[str]
) -> List[Tuple[str, str]]:
    """(video_path, align_path) pairs for the given speakers, all 3 layouts."""
    samples: List[Tuple[str, str]] = []
    for speaker in speakers:
        sp = os.path.join(data_path, speaker)
        if not os.path.isdir(sp):
            continue
        video_dir = os.path.join(sp, "video")
        align_dir = os.path.join(sp, "align")
        if os.path.isdir(video_dir) and os.path.isdir(align_dir):
            for f in sorted(os.listdir(video_dir)):
                if f.endswith(VIDEO_EXTS):
                    a = _find_align(align_dir, os.path.splitext(f)[0])
                    if a:
                        samples.append((os.path.join(video_dir, f), a))
        elif os.path.isdir(align_dir):
            for f in sorted(os.listdir(sp)):
                if f.endswith(VIDEO_EXTS):
                    a = _find_align(align_dir, os.path.splitext(f)[0])
                    if a:
                        samples.append((os.path.join(sp, f), a))
        else:
            files = sorted(os.listdir(sp))
            vids: Dict[str, str] = {}
            texts: Dict[str, str] = {}
            for f in files:
                base, ext = os.path.splitext(f)
                if ext in VIDEO_EXTS_FLAT:
                    vids[base] = os.path.join(sp, f)
                elif ext in ALIGN_EXTS:
                    texts[base] = os.path.join(sp, f)
            for base, v in vids.items():
                if base in texts:
                    samples.append((v, texts[base]))
    return samples


def discover_speakers(data_path: str) -> List[str]:
    """Speaker dirs starting with 's' (`misalignment_detection_train.py:379`)."""
    if not os.path.isdir(data_path):
        return []
    return sorted(
        d
        for d in os.listdir(data_path)
        if d.startswith("s") and os.path.isdir(os.path.join(data_path, d))
    )


def check_data_structure(data_path: str) -> List[str]:
    """Probe the dataset layout; returns speaker dirs that have usable pairs
    (`utils.py:179-265`, without the interactive dummy-creation prompt)."""
    if not os.path.isdir(data_path):
        return []
    usable = []
    for item in sorted(os.listdir(data_path)):
        p = os.path.join(data_path, item)
        if not os.path.isdir(p):
            continue
        if discover_samples(data_path, [item]):
            usable.append(item)
    return usable


def split_speakers(
    speakers: Sequence[str], fractions=(0.7, 0.15, 0.15)
) -> Tuple[List[str], List[str], List[str]]:
    """Deterministic ordered speaker split (`main.py:63-77`: slices of the
    sorted speaker list, no shuffle)."""
    speakers = list(speakers)
    n = len(speakers)
    n_train = int(n * fractions[0])
    n_val = int(n * fractions[1])
    train = speakers[:n_train]
    val = speakers[n_train : n_train + n_val]
    test = speakers[n_train + n_val :]
    if not val and train:
        val = [train[-1]]
    if not test and train:
        test = [train[-1]]
    return train, val, test


def split_videos(
    video_paths: Sequence[str], seed: int = 42, fractions=(0.7, 0.15)
) -> Tuple[List[str], List[str], List[str]]:
    """Shuffled 70/15/15 video split with a seeded RNG
    (`misalignment_detection_train.py:393-397`)."""
    paths = list(video_paths)
    random.Random(seed).shuffle(paths)
    n = len(paths)
    a, b = int(n * fractions[0]), int(n * (fractions[0] + fractions[1]))
    return paths[:a], paths[a:b], paths[b:]


@dataclass
class GridSample:
    video_path: str
    align_path: str
    text: str


class GridDataSource:
    """Sample discovery + label parsing for a set of speakers.

    Decoding/preprocessing live elsewhere (avsync_torch.data.video host
    decode, avsync_torch.ops.image device preprocessing) — this class only
    knows paths and transcripts, so it stays cheap to construct.
    """

    def __init__(
        self,
        data_path: str,
        speakers: Optional[Sequence[str]] = None,
        exclude: Sequence[str] = (),
    ):
        self.data_path = data_path
        self.speakers = (
            list(speakers) if speakers is not None else discover_speakers(data_path)
        )
        excl = set(exclude)
        self.samples = [
            GridSample(v, a, textlib.load_align_file(a))
            for v, a in discover_samples(data_path, self.speakers)
            if os.path.splitext(os.path.basename(v))[0] not in excl
        ]

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def video_paths(self) -> List[str]:
        return [s.video_path for s in self.samples]

    def subset(self, video_paths: Sequence[str]) -> "GridDataSource":
        """A source over `video_paths` (clips of this one), in that order."""
        by_path = {s.video_path: s for s in self.samples}
        sub = copy.copy(self)
        sub.samples = [by_path[p] for p in video_paths]
        return sub

    def labels_batch(
        self,
        indices: Sequence[int],
        max_label_length: int,
        vocab: str = "pytorch",
    ):
        """Padded label indices + lengths for a set of samples. vocab selects
        the encoding: 'pytorch' (blank=0, `dataset.py:38-46`) or 'tf'
        (StringLookup with OOV=0, blank-last, `train.py:106-121`)."""
        import numpy as np

        B = len(indices)
        labels = np.zeros((B, max_label_length), np.int32)
        lengths = np.zeros((B,), np.int32)
        for i, idx in enumerate(indices):
            t = self.samples[idx].text
            if vocab == "tf":
                ids = textlib.tf_text_to_indices(t, max_label_length)
            else:
                ids = textlib.text_to_indices(t)[:max_label_length]
            labels[i, : len(ids)] = ids
            lengths[i] = len(ids)
        return labels, lengths
