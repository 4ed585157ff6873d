"""Batching and device feed for LipNet training (port of the streamed path of
`avsync/data/pipeline.py`).

  * the host only decodes `.npy` clips to (T, H, W) uint8 on
    `DataConfig.loader_threads` threads and pads them to max_video_length;
  * a background thread prefetches batches, so decode overlaps device steps;
  * the uint8 frames are uploaded as they are (4x fewer bytes than float32)
    and preprocessed on the device by `predictor.preprocess`: /255 for
    pre-cropped clips, the heuristic mouth crop + resize for native frames.

Same order and contents as the JAX package's `LipNetBatcher` with
`device_cache="off"`: `np.random.default_rng(seed).shuffle` of the sample
indices, `drop_last`, and for `drop_last=False` a last batch zero-padded
(with sample 0's labels) whose `valid` counts the real clips. The device
cache and the whole-epoch scan plan are not ported yet: `device_cache` is
read and treated as "off".
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, Iterator, Optional

import numpy as np
import torch

from avsync_torch.config import AvsyncConfig
from avsync_torch.data.grid import GridDataSource
from avsync_torch.data.video import decode_video_gray
from avsync_torch.predictor import preprocess, resolve_device


def prefetch(iterator: Iterable, size: int = 2) -> Iterator:
    """Run `iterator` on a background thread, `size` items ahead.

    Closing the returned generator early stops the worker and closes the
    source iterator, so its `finally` blocks (the decode pool's shutdown)
    run now rather than at garbage collection. An exception in the worker
    is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=size)
    sentinel = object()
    err: list = []
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            err.append(e)
        finally:
            try:
                close = getattr(iterator, "close", None)
                if close is not None:
                    close()
            finally:
                put(sentinel)  # the consumer never waits on a dead worker

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a worker parked on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5.0)


class LipNetBatcher:
    """Epoch iterators of batches for LipNetTrainer:
    {'video': (B, T, h, w, 1) float32 on the device, 'labels': (B, L) int32,
    'label_lengths': (B,) int32, 'valid': int} (labels stay numpy)."""

    def __init__(self, source: GridDataSource, config: AvsyncConfig, device=None):
        self.source = source
        self.cfg = config
        self.device = resolve_device(device)

    def _decode_clip(self, video_path: str) -> np.ndarray:
        d = self.cfg.data
        frames = decode_video_gray(video_path, max_frames=d.max_video_length)
        T = frames.shape[0]
        if T == 0:
            return np.zeros((d.max_video_length, d.img_height, d.img_width), np.uint8)
        if T < d.max_video_length:
            pad = np.zeros((d.max_video_length - T,) + frames.shape[1:], np.uint8)
            frames = np.concatenate([frames, pad], axis=0)
        return frames

    def _raw_batches(self, batch_size: Optional[int], shuffle: bool, seed: int,
                     drop_last: bool, prefetch_size: int) -> Iterator[Dict]:
        """Prefetched host batches: {'raw' uint8 (B, T, H, W), 'labels',
        'label_lengths', 'valid'}."""
        d = self.cfg.data
        B = batch_size or d.batch_size
        n = len(self.source)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)

        def batches():
            pool = ThreadPoolExecutor(max_workers=max(1, int(d.loader_threads)))
            try:
                for i in range(0, n, B):
                    idx = order[i:i + B]
                    valid = len(idx)
                    if valid < B:
                        if drop_last:
                            return
                        idx = np.concatenate([idx, np.zeros(B - valid, np.int64)])
                    raws = np.stack(list(pool.map(
                        lambda j: self._decode_clip(self.source.samples[j].video_path), idx)))
                    labels, lengths = self.source.labels_batch(
                        list(idx), d.max_label_length, vocab=self.cfg.model.family)
                    yield {"raw": raws, "labels": labels, "label_lengths": lengths,
                           "valid": valid}
            finally:
                pool.shutdown(wait=False)

        return prefetch(batches(), prefetch_size)

    def epoch(self, batch_size: Optional[int] = None, shuffle: bool = True, seed: int = 0,
              drop_last: bool = True, prefetch_size: int = 2) -> Iterator[Dict]:
        """Yield batches with the video preprocessed on the device.

        drop_last=True keeps every batch the same shape; eval paths use
        drop_last=False, where the final partial batch is zero-padded and
        'valid' counts its real samples."""
        gen = self._raw_batches(batch_size, shuffle, seed, drop_last, prefetch_size)
        try:
            for hb in gen:
                raw = torch.from_numpy(hb["raw"]).to(self.device)
                yield {"video": preprocess(raw, self.cfg), "labels": hb["labels"],
                       "label_lengths": hb["label_lengths"], "valid": hb["valid"]}
        finally:
            gen.close()  # stop the prefetch worker and the decode pool now

    def first_batch(self, **epoch_kwargs) -> Dict:
        """One batch, with the epoch generator (and its prefetch worker and
        decode pool) closed — for quick_test and template draws."""
        epoch_kwargs.setdefault("shuffle", False)
        epoch_kwargs.setdefault("drop_last", False)
        gen = self.epoch(**epoch_kwargs)
        try:
            return next(gen)
        finally:
            gen.close()
