"""Serving: dynamic batching in front of a LipReader or a
MisalignmentScorer (port of the services of `avsync/serving.py`).

`ServingStats` and `DynamicBatcher` are the port's own copies of the JAX
package's (which are framework-free); `TranscribeService` and
`SyncScoreService` are the torch counterparts. A single worker thread owns
all inference: concurrent requests coalesce into batches, padded with zero
rows to power-of-two buckets. The HTTP daemon is not ported yet.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from dataclasses import dataclass
from queue import Empty, Queue
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from avsync_torch.predictor import decode_av

__all__ = ["DynamicBatcher", "ServingStats", "SyncScoreService", "TranscribeService"]


class ServingStats:
    """Thread-safe request/batch counters + latency percentiles over the last
    `window` requests (bounded: a long-lived server must not grow)."""

    def __init__(self, window: int = 4096):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batch_sizes: Counter = Counter()
        self._latencies: deque = deque(maxlen=window)
        self.started = time.time()

    def record_batch(self, n_real: int, n_padded: int,
                     latencies_s: Sequence[float]) -> None:
        with self._lock:
            self.requests += n_real
            self.batch_sizes[n_padded] += 1
            self._latencies.extend(latencies_s)

    def record_error(self, n: int = 1) -> None:
        with self._lock:
            self.errors += n

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self._latencies)
            out = {
                "requests": self.requests,
                "errors": self.errors,
                "uptime_s": round(time.time() - self.started, 1),
                "batches": dict(sorted(self.batch_sizes.items())),
            }
            if lat:
                def pct(p):
                    return round(lat[min(len(lat) - 1, int(p * (len(lat) - 1)))] * 1e3, 2)

                out["latency_ms"] = {
                    "p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99),
                    "max": round(lat[-1] * 1e3, 2),
                }
            return out


@dataclass
class _Item:
    payload: tuple  # one request row: tuple of arrays, each shape (1, ...)
    single: bool  # submit() got a bare array (unwrap before infer_fn)
    future: Future
    t_enqueue: float


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


class DynamicBatcher:
    """Coalesces concurrent `submit` calls into batched `infer_fn` calls.

    infer_fn: (B, ...) stacked array (or tuple of arrays) -> sequence of
    >= B per-row results. The batch opens at the first request and closes
    after `max_wait_ms` or at `max_batch` rows; rows of one payload
    arity/geometry/dtype batch together, padded with zeros to power-of-two
    buckets.
    """

    def __init__(self, infer_fn: Callable[[Any], Sequence[Any]],
                 max_batch: int = 8, max_wait_ms: float = 10.0,
                 stats: Optional[ServingStats] = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self._infer_fn = infer_fn
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.stats = stats or ServingStats()
        self._queue: Queue = Queue()
        self._stop = threading.Event()
        # orders submit's stop-check + put against close(), so no Future is
        # enqueued after the worker has drained and exited
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, name="avsync-torch-batcher",
                                        daemon=True)
        self._worker.start()

    def submit(self, row) -> Future:
        """Enqueue one request row (a (1, ...) array or a tuple of them)."""
        single = not isinstance(row, tuple)
        payload = (np.asarray(row),) if single else tuple(np.asarray(p) for p in row)
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            self._queue.put(_Item(payload, single, fut, time.perf_counter()))
        return fut

    def infer(self, row, timeout: Optional[float] = None) -> Any:
        return self.submit(row).result(timeout=timeout)

    def close(self) -> None:
        """Drain the queue, then stop the worker; later submits raise."""
        with self._submit_lock:
            self._stop.set()
        self._worker.join(timeout=30.0)

    def _collect(self) -> List[_Item]:
        try:
            first = self._queue.get(timeout=0.05)
        except Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except Empty:
                break
        return batch

    def _run(self) -> None:
        while not (self._stop.is_set() and self._queue.empty()):
            batch = self._collect()
            if not batch:
                continue
            groups: Dict[tuple, List[_Item]] = {}
            for it in batch:
                key = (it.single,) + tuple((p.shape[1:], str(p.dtype)) for p in it.payload)
                groups.setdefault(key, []).append(it)
            for items in groups.values():
                self._run_group(items)
            # an idle worker must not pin the last batch's payloads
            batch = items = it = None  # noqa: F841
            groups.clear()

    def _run_group(self, batch: List[_Item]) -> None:
        n = len(batch)
        target = _bucket(n, self.max_batch)
        parts = []
        for j in range(len(batch[0].payload)):
            rows = np.concatenate([it.payload[j] for it in batch], axis=0)
            if target > n:
                pad = np.zeros((target - n,) + rows.shape[1:], rows.dtype)
                rows = np.concatenate([rows, pad], axis=0)
            parts.append(rows)
        arg = parts[0] if batch[0].single else tuple(parts)
        try:
            results = self._infer_fn(arg)
        except Exception as e:  # noqa: BLE001 — the worker must survive; fan out
            self.stats.record_error(n)
            for it in batch:
                it.future.set_exception(e)
            return
        done = time.perf_counter()
        for it, res in zip(batch, results):
            it.future.set_result(res)
        self.stats.record_batch(n, target, [done - it.t_enqueue for it in batch])


class TranscribeService:
    """A `predictor.LipReader` behind a DynamicBatcher.

    Transports:
      * 'raw' (default): request threads only pad on the host; uint8 frames
        ship as they are and the worker preprocesses each BATCH on the
        device before the forward;
      * 'f32': request threads run the full preprocess per request and ship
        the float32 model-input row back through the host (for comparison).
    Both compute the same results.
    """

    def __init__(self, reader, max_batch: int = 8, max_wait_ms: float = 10.0,
                 stats: Optional[ServingStats] = None, transport: str = "raw"):
        if transport not in ("raw", "f32"):
            raise ValueError(f"unknown transport: {transport!r}")
        self.reader = reader
        self.stats = stats or ServingStats()
        self.transport = transport

        if transport == "raw":
            def infer(payload) -> Sequence[str]:
                return reader._decode(reader._logprobs(reader.preprocess_device(payload[0])))
        else:
            def infer(rows: np.ndarray) -> Sequence[str]:
                return reader._decode(reader._logprobs(torch.as_tensor(rows)))

        self.batcher = DynamicBatcher(infer, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms, stats=self.stats)

    def _payload(self, frames: np.ndarray):
        if self.transport == "raw":
            return self.reader.prepare_raw(frames)
        return self.reader._prepare(frames).cpu().numpy()

    def transcribe_frames(self, frames: np.ndarray,
                          timeout: Optional[float] = None) -> str:
        return self.batcher.infer(self._payload(frames), timeout=timeout)

    def warmup(self, frames: Optional[np.ndarray] = None) -> None:
        """Run one batch per power-of-two bucket through the infer path
        before taking traffic (kernel builds, cuDNN plans and allocator
        growth happen here instead of in the first requests). Call before
        serving starts: it runs on the caller's thread."""
        d = self.reader.cfg.data
        if frames is None:
            frames = np.zeros((d.max_video_length, d.img_height, d.img_width), np.uint8)
        part = self._payload(frames)
        parts = part if isinstance(part, tuple) else (part,)
        b = 1
        while True:
            stacked = tuple(np.concatenate([p] * b, axis=0) for p in parts)
            self.batcher._infer_fn(stacked if self.transport == "raw" else stacked[0])
            if b >= self.batcher.max_batch:
                return
            b = min(2 * b, self.batcher.max_batch)

    def close(self) -> None:
        self.batcher.close()


class SyncScoreService:
    """A `predictor.MisalignmentScorer` behind a DynamicBatcher.

    Concurrent (clip, audio, fps, shifts) requests coalesce into one device
    pass per batch (`MisalignmentScorer.score_payload_batch`): uint8 frames
    are preprocessed per batch on the device and the visual features never
    visit the host. Requests batch with those of the same frame geometry
    and shift count; others run as their own groups. Rows the batcher pads
    carry audio length 0 and fps 0, and give finite probabilities that
    nobody reads.
    """

    def __init__(self, scorer, max_batch: int = 8, max_wait_ms: float = 10.0,
                 stats: Optional[ServingStats] = None):
        self.scorer = scorer
        self.stats = stats or ServingStats()
        self.batcher = DynamicBatcher(scorer.score_payload_batch, max_batch=max_batch,
                                      max_wait_ms=max_wait_ms, stats=self.stats)

    def score_arrays(self, frames, audio, fps, shifts=(0,),
                     timeout: Optional[float] = None) -> np.ndarray:
        payload = self.scorer.prepare_raw(frames, audio, fps, tuple(shifts))
        return self.batcher.infer(payload, timeout=timeout)

    def warmup(self, shifts=(0,), frames: Optional[np.ndarray] = None,
               audio: Optional[np.ndarray] = None, fps: float = 25.0) -> None:
        """Run every power-of-two bucket once before traffic, for the shift
        count (and optionally the frame geometry) the clients will send.
        Call before serving starts: it runs on the caller's thread."""
        d = self.scorer.cfg.data
        if frames is None:
            frames = np.zeros((d.max_video_length, d.img_height, d.img_width), np.uint8)
        if audio is None:
            audio = np.zeros(1024, np.float32)
        parts = self.scorer.prepare_raw(frames, audio, fps, tuple(shifts))
        b = 1
        while True:
            self.scorer.score_payload_batch(tuple(np.concatenate([p] * b, axis=0)
                                                  for p in parts))
            if b >= self.batcher.max_batch:
                return
            b = min(2 * b, self.batcher.max_batch)

    def score_path(self, video_path: str, shifts=(0,),
                   timeout: Optional[float] = None) -> np.ndarray:
        """Sync probabilities of a `.npy` clip and its sibling `.wav`."""
        frames, audio, fps = decode_av(video_path, self.scorer.cfg)
        return self.score_arrays(frames, audio, fps, shifts, timeout=timeout)

    def close(self) -> None:
        self.batcher.close()
