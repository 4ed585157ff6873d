"""Transcript metrics: CER, WER and exact-match accuracy (port of the host
half of `avsync/eval.py`).

`calculate_cer`/`calculate_wer` follow the reference (`train.py:945-993`):
Levenshtein distance normalised by the target's length, and for an empty
target 1.0 if the prediction is non-empty, else 0.0.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance, two-row dynamic programme."""
    m, n = len(a), len(b)
    if m == 0:
        return n
    if n == 0:
        return m
    prev = list(range(n + 1))
    for i in range(1, m + 1):
        cur = [i] + [0] * n
        ai = a[i - 1]
        for j in range(1, n + 1):
            cost = 0 if ai == b[j - 1] else 1
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, prev[j - 1] + cost)
        prev = cur
    return prev[n]


def calculate_cer(prediction: str, target: str) -> float:
    """Character error rate (`train.py:945-967`)."""
    if len(target) == 0:
        return 1.0 if len(prediction) > 0 else 0.0
    return edit_distance(prediction, target) / len(target)


def calculate_wer(prediction: str, target: str) -> float:
    """Word error rate (`train.py:970-993`)."""
    pred_words, target_words = prediction.split(), target.split()
    if len(target_words) == 0:
        return 1.0 if len(pred_words) > 0 else 0.0
    return edit_distance(pred_words, target_words) / len(target_words)


def evaluate_transcripts(predictions: List[str], targets: List[str]) -> dict:
    """Mean CER/WER and exact-match accuracy over decoded transcripts, as the
    TF stack's test() reports them (`train.py:916-942`)."""
    cers = [calculate_cer(p, t) for p, t in zip(predictions, targets)]
    wers = [calculate_wer(p, t) for p, t in zip(predictions, targets)]
    exact = [p == t for p, t in zip(predictions, targets)]
    n = max(len(predictions), 1)
    return {
        "cer": float(np.mean(cers)) if cers else 0.0,
        "wer": float(np.mean(wers)) if wers else 0.0,
        "accuracy": float(np.sum(exact)) / n,
        "num_samples": len(predictions),
    }
