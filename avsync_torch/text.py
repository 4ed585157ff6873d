"""Vocabulary and greedy CTC decoding on tensors (port of `avsync/text.py`).

  * 37-character GRID charset with blank=0 and <pad>=38;
  * text -> label indices (unknown characters -> <pad>);
  * `.align` / plain-transcript parsing with sil/sp removal;
  * greedy CTC decode: argmax -> drop repeats -> drop blanks -> left-pack,
    batched and fixed-shape, on whatever device the log-probs live on;
  * `decode_batch` renders the packed indices to strings on the host, or
    runs CTC prefix beam search there (`beam_width > 1`, `ops/beam.py`);
  * the TF family's vocabulary (30 characters, OOV 0, blank last = 31) and
    its decode `tf_decode_batch`; `family_decoder` picks a family's decode.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

CHARACTERS: str = "abcdefghijklmnopqrstuvwxyz0123456789 "
BLANK_ID: int = 0
PAD_ID: int = len(CHARACTERS) + 1  # 38
VOCAB_SIZE: int = len(CHARACTERS) + 2  # 39: blank + 37 chars + <pad>

CHAR_TO_IDX = {c: i + 1 for i, c in enumerate(CHARACTERS)}
CHAR_TO_IDX["<blank>"] = BLANK_ID
CHAR_TO_IDX["<pad>"] = PAD_ID
IDX_TO_CHAR = {i: c for c, i in CHAR_TO_IDX.items()}


def text_to_indices(text: str) -> np.ndarray:
    """Map text to label indices; unknown characters map to <pad>
    (`dataset.py:164-174`)."""
    return np.array([CHAR_TO_IDX.get(ch, PAD_ID) for ch in text], dtype=np.int32)


def indices_to_text(indices: Sequence[int]) -> str:
    """Map indices back to text, skipping blank, pad and unknown ids."""
    out = []
    for idx in indices:
        idx = int(idx)
        if idx == BLANK_ID or idx == PAD_ID:
            continue
        ch = IDX_TO_CHAR.get(idx)
        if ch is not None and len(ch) == 1:
            out.append(ch)
    return "".join(out)


def parse_align_text(content: str) -> str:
    """GRID `.align` content or a plain transcript -> sentence: a first line
    without digits is a plain transcript; otherwise each line's third token
    is a word, `sil`/`sp` are removed by substring replacement (as the
    reference does) and the result is lowercased."""
    first_line = content.split("\n")[0]
    if not any(ch.isdigit() for ch in first_line):
        return content.strip().lower()
    words: List[str] = []
    for line in content.strip().split("\n"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) >= 3:
            words.append(parts[2])
        elif len(parts) == 1:
            words.append(parts[0])
    return " ".join(words).replace("sil", "").replace("sp", "").strip().lower()


def load_align_file(path: str) -> str:
    with open(path) as f:
        return parse_align_text(f.read())


def ctc_greedy_decode(
    log_probs: torch.Tensor, blank_id: int = BLANK_ID
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, V) log-probs (or logits) -> (decoded (B, T) int64 left-packed
    and padded with blank_id, lengths (B,))."""
    pred = log_probs.argmax(dim=-1)  # (B, T)
    prev = torch.cat(
        [torch.full_like(pred[:, :1], blank_id), pred[:, :-1]], dim=1
    )
    keep = (pred != prev) & (pred != blank_id)
    B, T = pred.shape
    # position of each kept symbol = number of kept symbols before it;
    # dropped symbols go to an overflow column T that is cut off
    pos = torch.where(keep, keep.cumsum(dim=1) - 1, torch.full_like(pred, T))
    out = torch.full((B, T + 1), blank_id, dtype=pred.dtype, device=pred.device)
    out.scatter_(1, pos, torch.where(keep, pred, torch.full_like(pred, blank_id)))
    return out[:, :T], keep.sum(dim=1)


def decode_batch(log_probs, blank_id: int = BLANK_ID,
                 beam_width: int = 0) -> List[str]:
    """Decode (B, T, V) log-probs (tensor or array) to strings: greedy, or
    prefix beam search over the character alphabet for beam_width > 1
    (`ops.beam`, on the host)."""
    if beam_width and beam_width > 1:
        from avsync_torch.ops.beam import ctc_beam_search_batch

        lp = log_probs.detach().cpu().numpy() if torch.is_tensor(log_probs) else log_probs
        prefixes = ctc_beam_search_batch(np.asarray(lp), beam_width, blank_id,
                                         valid_ids=range(1, len(CHARACTERS) + 1))
        return [indices_to_text(p) for p in prefixes]
    decoded, lengths = ctc_greedy_decode(torch.as_tensor(log_probs), blank_id)
    decoded = decoded.cpu().numpy()
    lengths = lengths.cpu().numpy()
    return [indices_to_text(decoded[b, : int(lengths[b])])
            for b in range(decoded.shape[0])]


def decode_prediction(log_probs) -> str:
    """One (T, V) sequence of log-probs (tensor or array) -> its greedy
    transcript (`utils.py:8-36`)."""
    return decode_batch(torch.as_tensor(log_probs)[None])[0]


# ---------------------------------------------------------------------------
# TF-family vocabulary (`train.py:106-121`)
# ---------------------------------------------------------------------------
# The Keras stack's StringLookup over "abc...z'?! " with an OOV token at
# index 0; the model's head is vocabulary_size() + 1 = 32 wide, and the CTC
# blank is its LAST unit (the ctc_batch_cost convention), not 0.

TF_CHARACTERS: str = "abcdefghijklmnopqrstuvwxyz'?! "
TF_VOCAB_SIZE: int = len(TF_CHARACTERS) + 1  # 31: OOV (0) + 30 characters
TF_BLANK_ID: int = TF_VOCAB_SIZE  # 31, the last unit of the 32-way head

TF_CHAR_TO_IDX = {c: i + 1 for i, c in enumerate(TF_CHARACTERS)}
TF_IDX_TO_CHAR = {i + 1: c for i, c in enumerate(TF_CHARACTERS)}


def tf_text_to_indices(text: str, max_len: int = 40) -> np.ndarray:
    """char_to_num with the 40-character cap (`train.py:300-305`); unknown
    characters map to the OOV id 0."""
    ids = [TF_CHAR_TO_IDX.get(ch, 0) for ch in text][:max_len]
    return np.array(ids, dtype=np.int32)


def tf_indices_to_text(indices: Sequence[int]) -> str:
    """num_to_char join; OOV and blank render as '' (`train.py:596-602`)."""
    return "".join(TF_IDX_TO_CHAR.get(int(i), "") for i in indices)


def tf_decode_batch(log_probs, beam_width: int = 0) -> List[str]:
    """Decode (B, T, 32) blank-last log-probs to strings (`train.py:582-584,
    874-876`): greedy at blank 31, or prefix beam search over the 30
    characters for beam_width > 1 (the reference decodes greedily only)."""
    if beam_width and beam_width > 1:
        from avsync_torch.ops.beam import ctc_beam_search_batch

        lp = log_probs.detach().cpu().numpy() if torch.is_tensor(log_probs) else log_probs
        prefixes = ctc_beam_search_batch(np.asarray(lp), beam_width, TF_BLANK_ID,
                                         valid_ids=range(1, TF_VOCAB_SIZE))
        return [tf_indices_to_text(p) for p in prefixes]
    decoded, lengths = ctc_greedy_decode(torch.as_tensor(log_probs), TF_BLANK_ID)
    decoded = decoded.cpu().numpy()
    lengths = lengths.cpu().numpy()
    return [tf_indices_to_text(decoded[b, : int(lengths[b])])
            for b in range(decoded.shape[0])]


def family_decoder(family: str):
    """The decode of a model family's log-probs: `tf_decode_batch` for 'tf'
    (blank-last, 32-way), else `decode_batch` (blank 0, 39-way); both take
    (log_probs, beam_width=0)."""
    return tf_decode_batch if family == "tf" else decode_batch
