"""Transcript and detector metrics (port of `avsync/eval.py`): CER, WER and
exact-match accuracy on the host; the batched edit distance and its rates on
the device; AUROC, accuracy at 0.5 and ROC points.

`calculate_cer`/`calculate_wer` follow the reference (`train.py:945-993`):
Levenshtein distance normalised by the target's length, and for an empty
target 1.0 if the prediction is non-empty, else 0.0. `levenshtein_batch` /
`cer_wer_batch` are the same over padded id sequences, batched in tensors on
whatever device they lie on (plain torch: the JAX package's is a `lax.scan`,
no Pallas kernel). `auroc` is the Mann-Whitney statistic with average ranks,
as the JAX package computes it, here in float64 numpy.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def auroc(labels, scores) -> float:
    """ROC-AUC via the Mann-Whitney statistic with average ranks (tie-correct,
    as sklearn.roc_auc_score); NaN when one class is absent
    (`misalignment_detection_train.py:276-279`)."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    scores = np.asarray(scores, np.float64).reshape(-1)
    n_pos = float(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    sorted_s = np.sort(scores)
    ranks = (np.searchsorted(sorted_s, scores, "left")
             + np.searchsorted(sorted_s, scores, "right") + 1) / 2.0
    return (float(np.sum(ranks * labels)) - n_pos * (n_pos + 1.0) / 2.0) / (n_pos * n_neg)


def binary_accuracy(labels, scores, threshold: float = 0.5) -> float:
    """accuracy_score(labels, probs > 0.5) (`misalignment_detection_train.py:274-275`)."""
    labels = np.asarray(labels, np.float64).reshape(-1)
    scores = np.asarray(scores, np.float64).reshape(-1)
    return float(np.sum((scores > threshold) == labels) / max(len(labels), 1))


def roc_curve(labels, scores) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROC points (fpr, tpr, thresholds) for plotting
    (`misalignment_detection_train.py:283-296`); thresholds are the distinct
    scores in decreasing order, sklearn-style, after a sentinel above them."""
    labels = np.asarray(labels).astype(np.float64)
    scores = np.asarray(scores).astype(np.float64)
    order = np.argsort(-scores, kind="stable")
    labels, scores = labels[order], scores[order]
    distinct = np.r_[np.where(np.diff(scores))[0], len(scores) - 1]
    tps = np.cumsum(labels)[distinct]
    fps = (distinct + 1) - tps
    n_pos = labels.sum()
    n_neg = len(labels) - n_pos
    return (np.r_[0.0, fps / max(n_neg, 1)], np.r_[0.0, tps / max(n_pos, 1)],
            np.r_[scores[distinct][0] + 1.0, scores[distinct]])


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


# ---------------------------------------------------------------------------
# batched edit distance on the device (`avsync/eval.py:66-119`)
# ---------------------------------------------------------------------------

def levenshtein_batch(pred: torch.Tensor, pred_len: torch.Tensor, tgt: torch.Tensor,
                      tgt_len: torch.Tensor) -> torch.Tensor:
    """Levenshtein distances of padded int sequences: pred (B, P), tgt (B, L),
    their lengths (B,) -> (B,) int32, on the inputs' device.

    The loop walks the prediction's positions carrying the (B, L+1) row of
    the dynamic programme, as the JAX function's scan. Its inner scan over
    the target, new[k] = min(c[k], new[k-1] + 1) with c[0] = i and c[k] =
    min(row[k] + 1, row[k-1] + sub[k-1]), is new[k] = k + min over m <= k of
    (c[m] - m): one cumulative minimum. A position past a row's pred_len
    keeps that row; row 0 is min(k, tgt_len), as the JAX function's."""
    B, P = pred.shape
    L = tgt.shape[1]
    dev = pred.device
    k = torch.arange(L + 1, device=dev, dtype=torch.int32)
    tgt_len = tgt_len.to(dev).long()
    pred_len = pred_len.to(dev)
    row = torch.minimum(k[None, :], tgt_len[:, None].int())
    for i in range(1, P + 1):
        sub = (tgt != pred[:, i - 1:i]).int()
        c = torch.cat([torch.full((B, 1), i, device=dev, dtype=torch.int32),
                       torch.minimum(row[:, 1:] + 1, row[:, :-1] + sub)], dim=1)
        new = torch.cummin(c - k, dim=1).values + k
        row = torch.where((i <= pred_len)[:, None], new, row)
    return row.gather(1, tgt_len[:, None])[:, 0]


def cer_wer_batch(pred: torch.Tensor, pred_len: torch.Tensor, tgt: torch.Tensor,
                  tgt_len: torch.Tensor) -> torch.Tensor:
    """Edit distance over the target's length, float32 (B,): characters for
    CER when the ids are characters, words for WER when they are words. An
    empty target gives 1.0 for a non-empty prediction, else 0.0."""
    d = levenshtein_batch(pred, pred_len, tgt, tgt_len).float()
    tgt_len = tgt_len.to(d.device)
    rate = d / torch.clamp(tgt_len.float(), min=1.0)
    return torch.where(tgt_len == 0, (pred_len.to(d.device) > 0).float(), rate)
