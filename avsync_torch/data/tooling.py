"""Data-structure repair/discovery tooling (port of `avsync/data/tooling.py`;
`utils.py:90-265` parity).

  * `find_alignment_files` — probe sibling/parent directories for alignment
    folders when a corpus has videos but no transcripts.
  * `create_dummy_alignments` — fabricate plain-text transcripts (the 8
    canned GRID phrases) so a pipeline can be exercised without real labels;
    deterministic here (seeded) unlike the reference's bare random.choice.
  * `check_data_structure_interactive` — the reference's interactive repair
    flow (`utils.py:250-254`): when no usable speaker dirs are found, offer
    to create dummy alignments (gated behind `assume_yes` for scripted use).

For richer synthetic fixtures (video+audio+aligns), use avsync_torch.data.synthetic.
"""

from __future__ import annotations

import os
import random
from typing import List, Optional

from avsync_torch.data.grid import check_data_structure

GRID_PHRASES = (
    "bin blue at f nine please",
    "lay red at j two now",
    "place white by a four soon",
    "set green in x eight again",
    "bin blue at l three please",
    "lay red by r zero now",
    "place white at u five soon",
    "set green by b six again",
)

VIDEO_SUFFIXES = (".mpg", ".mp4", ".avi", ".mov", ".npy")


def find_alignment_files(data_path: str, verbose: bool = True) -> Optional[str]:
    """Search common sibling locations for alignment directories
    (`utils.py:90-139`). Returns the first hit or None."""
    parent = os.path.dirname(os.path.abspath(data_path))
    candidates = []
    for name in ("align", "alignments", "transcriptions", "labels", "text"):
        candidates.append(os.path.join(parent, name))
    for d in sorted(os.listdir(data_path)) if os.path.isdir(data_path) else []:
        speaker_id = d.replace("_processed", "")
        candidates += [
            os.path.join(parent, "align", speaker_id),
            os.path.join(parent, speaker_id, "align"),
            os.path.join(data_path, speaker_id, "align"),
        ]
    for c in candidates:
        if os.path.isdir(c):
            if verbose:
                print(f"Found potential alignment directory: {c}")
            return c
    return None


def create_dummy_alignments(
    data_path: str,
    per_speaker: int = 10,
    seed: int = 0,
) -> int:
    """Write `.txt` transcripts next to the first N videos of each speaker
    dir (`utils.py:141-177`). Returns the number of files created."""
    rng = random.Random(seed)
    created = 0
    for d in sorted(os.listdir(data_path)):
        sp = os.path.join(data_path, d)
        if not os.path.isdir(sp):
            continue
        vids = sorted(
            f for f in os.listdir(sp) if f.endswith(VIDEO_SUFFIXES)
        )
        for v in vids[:per_speaker]:
            base = os.path.splitext(v)[0]
            out = os.path.join(sp, base + ".txt")
            if os.path.exists(out):
                continue
            with open(out, "w") as f:
                f.write(rng.choice(GRID_PHRASES))
            created += 1
    return created


def check_data_structure_interactive(
    data_path: str, assume_yes: Optional[bool] = None
) -> List[str]:
    """check_data_structure + the reference's dummy-alignment repair offer
    (`utils.py:250-265`). assume_yes=None prompts on a TTY; True/False
    decides non-interactively."""
    speakers = check_data_structure(data_path)
    if speakers:
        return speakers
    print(f"WARNING: no directories with both video and text files under {data_path}")
    find_alignment_files(data_path)
    if assume_yes is None:
        try:
            answer = input(
                "Do you want to create dummy alignment files for testing? (yes/no): "
            )
            assume_yes = answer.strip().lower() in ("yes", "y")
        except EOFError:
            assume_yes = False
    if assume_yes:
        n = create_dummy_alignments(data_path)
        print(f"Created {n} dummy alignment files for testing")
        return check_data_structure(data_path)
    return []
