"""One generator of every cell's inputs, driven by the cell's file and the
seed: GRID sentences and their labels, synthetic clips made on the device,
the training plans' index slices and the service's open-loop arrivals.

The same seed gives the same inputs. Sizes and arrival gaps are the same
for every seed; the seed changes which clips, which sentences and in what
order.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

# GRID's six-word grammar (Cooke et al. 2006): command, colour, preposition,
# letter (no w), digit, adverb.
GRID_WORDS = (
    ("bin", "lay", "place", "set"),
    ("blue", "green", "red", "white"),
    ("at", "by", "in", "with"),
    tuple("abcdefghijklmnopqrstuvxyz"),
    ("zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine"),
    ("again", "now", "please", "soon"),
)


def grid_sentences(n: int, rng: np.random.Generator) -> List[str]:
    picks = [rng.integers(0, len(words), n) for words in GRID_WORDS]
    return [" ".join(words[p[i]] for words, p in zip(GRID_WORDS, picks)) for i in range(n)]


def encode_labels(cfg: dict, sentences: List[str]) -> Dict[str, np.ndarray]:
    """(n, max_label_length) int32 ids in the configuration's charset (1-based,
    0-padded) and (n,) int32 lengths."""
    idx = {c: i + 1 for i, c in enumerate(cfg["charset"])}
    L = cfg["max_label_length"]
    labels = np.zeros((len(sentences), L), np.int32)
    lengths = np.zeros((len(sentences),), np.int32)
    for i, s in enumerate(sentences):
        ids = [idx[c] for c in s][:L]
        labels[i, :len(ids)] = ids
        lengths[i] = len(ids)
    return {"labels": labels, "lengths": lengths}


def seed_of(seed: int, stream: int) -> int:
    """A generator seed for one of the run's independent streams."""
    return (int(seed) * 1_000_003 + 7919 * stream) % (1 << 62)


def uint8_clips(n: int, clip_elems: int, seed: int, device, stream: int,
                chunk: int = 1024):
    """Yield (start, (rows, clip_elems) uint8) synthetic frames made on the
    device from the seed, a chunk at a time."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, stream))
    for lo in range(0, n, chunk):
        rows = min(chunk, n - lo)
        yield lo, torch.empty((rows, clip_elems), dtype=torch.uint8,
                              device=device).random_(0, 256, generator=gen)


def standardize(x: torch.Tensor) -> torch.Tensor:
    """Per-row standardization: mean 0, population std 1."""
    mean = x.mean(dim=1, keepdim=True)
    return (x - mean) / x.std(dim=1, keepdim=True, correction=0).clamp_min(1e-8)


def train_corpus(cfg: dict, cell: dict, seed: int, device) -> dict:
    """The device cache of the cell's corpus: 'video' (N, T*H*W) uint8 crops
    (the PyTorch family: the cache of exact k/255 values) or float32 clips
    standardized per clip (the TF family), 'labels' (N, L) and 'lengths'
    (N,) int64 on the device, and their host copies."""
    N = cell["corpus_clips"]
    D = cfg["frames"] * cfg["img_height"] * cfg["img_width"]
    if cfg.get("standardize_clips"):
        video = torch.empty((N, D), dtype=torch.float32, device=device)
        for lo, u8 in uint8_clips(N, D, seed, device, stream=1, chunk=256):
            video[lo:lo + u8.shape[0]] = standardize(u8.float() * (1.0 / 255.0))
            del u8
    else:
        video = torch.empty((N, D), dtype=torch.uint8, device=device)
        for lo, u8 in uint8_clips(N, D, seed, device, stream=1):
            video[lo:lo + u8.shape[0]] = u8
            del u8
    lab = encode_labels(cfg, grid_sentences(N, np.random.default_rng(seed_of(seed, 2))))
    return {"video": video, "u8": video.dtype == torch.uint8,
            "labels": lab["labels"], "lengths": lab["lengths"],
            "labels_dev": torch.from_numpy(lab["labels"]).long().to(device),
            "lengths_dev": torch.from_numpy(lab["lengths"]).long().to(device)}


def clip_rows(cfg: dict, corpus: dict, rows: np.ndarray) -> torch.Tensor:
    """(n, T, H, W, 1) float32 model inputs of cached rows, as the cache's
    gather gives them: uint8 * (1/255), or the float32 clips."""
    x = corpus["video"].index_select(0, torch.as_tensor(rows, device=corpus["video"].device).long())
    x = x.float() * (1.0 / 255.0) if corpus["u8"] else x.float()
    return x.view(-1, cfg["frames"], cfg["img_height"], cfg["img_width"], 1)


class PlanFeed:
    """Consecutive slices of one seeded shuffle of the corpus (a new
    shuffle from the next stream when one runs out): every row of a run
    differs from the others until the corpus is used up."""

    def __init__(self, n: int, batch: int, seed: int):
        self.n, self.batch, self.seed = n, batch, seed
        self.epoch, self.at = 0, 0
        self.order = self._shuffle()

    def _shuffle(self) -> np.ndarray:
        return np.random.default_rng(seed_of(self.seed, 100 + self.epoch)).permutation(self.n)

    def take(self, steps: int) -> np.ndarray:
        """(steps, batch) int32 indices."""
        need = steps * self.batch
        if self.at + need > self.n:
            self.epoch += 1
            self.order, self.at = self._shuffle(), 0
        out = self.order[self.at:self.at + need].reshape(steps, self.batch)
        self.at += need
        return out.astype(np.int32)


def clip_pool(cfg: dict, cell: dict, seed: int, device) -> np.ndarray:
    """(pool, T, H, W) uint8 request clips made on the device, on the host."""
    T, H, W = cfg["frames"], cfg["img_height"], cfg["img_width"]
    n = cell["pool_clips"]
    out = np.empty((n, T, H, W), np.uint8)
    for lo, u8 in uint8_clips(n, T * H * W, seed, device, stream=3, chunk=256):
        out[lo:lo + u8.shape[0]] = u8.view(-1, T, H, W).cpu().numpy()
    return out


def arrivals(cell: dict, rate: float, seconds: float, seed: int) -> Dict[str, np.ndarray]:
    """An open-loop Poisson schedule at `rate` over `seconds`: the gaps are
    the exponential distribution's quantiles at (i + 0.5) / n for the
    n = rate * seconds requests, so every seed offers the same gaps, in an
    order and with clips drawn from the seed. 'due' (n,) seconds from the
    window's start, 'clip' (n,) pool indices."""
    n = max(1, int(round(rate * seconds)))
    q = (np.arange(n) + 0.5) / n
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(seed_of(seed, 4))
    gaps = rng.permutation(gaps)
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    due *= seconds / max(due[-1] + gaps[-1], 1e-9)  # the last gap ends the window
    return {"due": due, "clip": rng.integers(0, cell["pool_clips"], n)}


def sample(n: int, k: int, seed: int) -> np.ndarray:
    """k of n indices drawn from the seed, sorted."""
    rng = np.random.default_rng(seed_of(seed, 5))
    return np.sort(rng.choice(n, size=min(k, n), replace=False))


def quantile(values, q: float) -> float:
    """Nearest-rank quantile (q in [0, 1]); infinite values count."""
    v = np.sort(np.asarray(values, np.float64))
    if v.size == 0:
        return math.nan
    return float(v[max(0, math.ceil(q * v.size) - 1)])
