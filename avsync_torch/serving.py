"""Serving: dynamic batching and the HTTP daemon in front of a LipReader, a
MisalignmentScorer or their exported artifacts (port of `avsync/serving.py`).

    predictor.LipReader / MisalignmentScorer, or export.load_exported(...)
        -> DynamicBatcher   (concurrent requests coalesce into batches)
        -> AvsyncServer     (`python -m avsync_torch.cli serve`: stdlib HTTP)

`ServingStats` and `DynamicBatcher` are the port's own copies of the JAX
package's (which are framework-free). A single worker thread owns all
inference: it alone touches the card, on the default stream of the device
the reader or artifact lives on, so a kernel's launch error reaches the
request as a 500. Handler threads only pad on the host and wait on a
Future. Batches are padded with zero rows to power-of-two buckets.

This module imports no model code: `serve --artifact` runs an exported
program with torch and the kernel operators alone.
"""

from __future__ import annotations

import io
import json
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from queue import Empty, Queue
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from avsync_torch.data.video import decode_av, decode_frames

__all__ = ["ArtifactSyncScoreService", "ArtifactTranscribeService", "AvsyncServer",
           "DynamicBatcher", "ServingStats", "SyncScoreService", "TranscribeService"]


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
    task: Optional[Callable[[], Any]] = None  # a call to run on the worker, not a row


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

    def call_on_worker(self, fn: Callable[[], Any], timeout: Optional[float] = None) -> Any:
        """fn() run on the worker thread between batches; its result. Warm-up
        goes this way: cuBLAS and cuDNN keep their handles per thread, so a
        warm-up on another thread leaves the worker's first batch cold."""
        fut: Future = Future()
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            self._queue.put(_Item((), False, fut, time.perf_counter(), task=fn))
        return fut.result(timeout=timeout)

    def warm_buckets(self, run_batch: Callable[[int], Any]) -> None:
        """run_batch(b) for every power-of-two bucket b up to max_batch, on
        the worker thread (kernel builds, cuDNN plans, per-thread handles and
        allocator growth happen here instead of in the first requests)."""
        def warm():
            b = 1
            while True:
                run_batch(b)
                if b >= self.max_batch:
                    return
                b = min(2 * b, self.max_batch)

        self.call_on_worker(warm)

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
                if it.task is not None:
                    self._run_task(it)
                    continue
                key = (it.single,) + tuple((p.shape[1:], str(p.dtype)) for p in it.payload)
                groups.setdefault(key, []).append(it)
            for items in groups.values():
                self._run_group(items)
            # an idle worker must not pin the last batch's payloads
            batch = items = it = None  # noqa: F841
            groups.clear()

    @staticmethod
    def _run_task(item: _Item) -> None:
        try:
            item.future.set_result(item.task())
        except Exception as e:  # noqa: BLE001 — the worker must survive
            item.future.set_exception(e)

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
      * 'raw' (default): request threads only pad on the host (and run the
        cascade under roi_mode 'detector': its boxes ride with the frames);
        uint8 frames ship as they are and the worker preprocesses each BATCH
        on the device before the forward;
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
            def infer(payload) -> Sequence[str]:  # (frames[, detector boxes])
                return reader._decode(reader._logprobs(reader.preprocess_device(*payload)))
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

    def transcribe_path(self, video_path: str, timeout: Optional[float] = None) -> str:
        frames = decode_frames(video_path, self.reader.cfg.data.max_video_length)
        return self.transcribe_frames(frames, timeout=timeout)

    def warmup(self, frames: Optional[np.ndarray] = None) -> None:
        """Run one batch per power-of-two bucket through the infer path, on
        the batcher's worker, before taking traffic."""
        d = self.reader.cfg.data
        if frames is None:
            frames = np.zeros((d.max_video_length, d.img_height, d.img_width), np.uint8)
        part = self._payload(frames)
        parts = part if isinstance(part, tuple) else (part,)

        def run(b):
            stacked = tuple(np.concatenate([p] * b, axis=0) for p in parts)
            self.batcher._infer_fn(stacked if self.transport == "raw" else stacked[0])

        # _warming keeps an uncalibrated int8 reader from adopting these
        # dummy frames as its calibration set: the first real batch
        # calibrates it (a caller's example frames stay non-binding too)
        self.reader._warming = True
        try:
            self.batcher.warm_buckets(run)
        finally:
            self.reader._warming = False

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
        """Run every power-of-two bucket once before traffic, on the
        batcher's worker, for the shift count (and optionally the frame
        geometry) the clients will send."""
        d = self.scorer.cfg.data
        if frames is None:
            frames = np.zeros((d.max_video_length, d.img_height, d.img_width), np.uint8)
        if audio is None:
            audio = np.zeros(1024, np.float32)
        parts = self.scorer.prepare_raw(frames, audio, fps, tuple(shifts))
        self.batcher.warm_buckets(lambda b: self.scorer.score_payload_batch(
            tuple(np.concatenate([p] * b, axis=0) for p in parts)))

    def score_path(self, video_path: str, shifts=(0,),
                   timeout: Optional[float] = None) -> np.ndarray:
        """Sync probabilities of a clip (`.npy` or a container) and its
        audio (a sibling `.wav`, else the container's stream)."""
        frames, audio, fps = decode_av(video_path, self.scorer.cfg)
        return self.score_arrays(frames, audio, fps, shifts, timeout=timeout)

    def close(self) -> None:
        self.batcher.close()


# ---------------------------------------------------------------------------
# exported artifacts behind a batcher (`serve --artifact`)
# ---------------------------------------------------------------------------


def _load_artifact(artifact, kind: str):
    from avsync_torch.export import load_exported

    if isinstance(artifact, str):
        artifact = load_exported(artifact)
    if artifact.meta.get("kind", "transcriber") != kind:
        raise ValueError(f"not a {kind} artifact: kind={artifact.meta.get('kind')!r}")
    return artifact


class ArtifactTranscribeService:
    """An `ExportedTranscriber` behind a DynamicBatcher: the serving host
    needs the artifact and torch with the kernel operators, no checkpoint
    and no model code. Preprocess, forward and greedy decode run inside the
    program; handler threads only check and pad uint8 rows. A static-bucket
    artifact clamps `max_batch` to its largest bucket, so the batcher never
    forms a batch it has no program for. The same endpoints as
    `TranscribeService`."""

    def __init__(self, artifact, max_batch: int = 8, max_wait_ms: float = 10.0,
                 stats: Optional[ServingStats] = None):
        self.artifact = artifact = _load_artifact(artifact, "transcriber")
        if artifact.batch_sizes:
            max_batch = min(max_batch, max(artifact.batch_sizes))
        self.stats = stats or ServingStats()

        def infer(payload) -> Sequence[str]:
            return artifact.transcribe(payload[0])

        self.batcher = DynamicBatcher(infer, max_batch=max_batch, max_wait_ms=max_wait_ms,
                                      stats=self.stats)

    def transcribe_frames(self, frames: np.ndarray, timeout: Optional[float] = None) -> str:
        # one clip per request: the batcher gives each submitted row one
        # result, so a (B, T, H, W) upload would answer with clip 0 and hand
        # the other clips' transcripts to whichever requests batched with it
        frames = np.asarray(frames)
        if frames.ndim != 3:
            raise ValueError(f"one (T, H, W) clip per request, got shape {frames.shape}: for "
                             "client-side batches use the artifact's own batched `call`")
        return self.batcher.infer((self.artifact.prepare_rows(frames),), timeout=timeout)

    def transcribe_path(self, video_path: str, timeout: Optional[float] = None) -> str:
        frames = decode_frames(video_path, self.artifact.meta["frame_shape"][0])
        return self.transcribe_frames(frames, timeout=timeout)

    def warmup(self) -> None:
        """Run every power-of-two bucket once before traffic, on the
        batcher's worker."""
        T, H, W = self.artifact.meta["frame_shape"]
        self.batcher.warm_buckets(
            lambda b: self.artifact.transcribe(np.zeros((b, T, H, W), np.uint8)))

    def close(self) -> None:
        self.batcher.close()


class ArtifactSyncScoreService:
    """An `ExportedSyncScorer` behind a DynamicBatcher, the /v1/sync_score
    counterpart of `ArtifactTranscribeService`. Requests with the artifact's
    shift count batch together; the shift values are per-row inputs."""

    def __init__(self, artifact, max_batch: int = 8, max_wait_ms: float = 10.0,
                 stats: Optional[ServingStats] = None):
        from avsync_torch.config import AvsyncConfig

        self.artifact = artifact = _load_artifact(artifact, "sync_scorer")
        if artifact.batch_sizes:
            max_batch = min(max_batch, max(artifact.batch_sizes))
        # the artifact embeds its AvsyncConfig: score_path's decode reads it
        # (its max_video_length is the artifact's T)
        self.cfg = AvsyncConfig.from_dict(artifact.meta["config"])
        self.stats = stats or ServingStats()

        def infer(payload) -> Sequence[np.ndarray]:
            return list(artifact.call(*payload))

        self.batcher = DynamicBatcher(infer, max_batch=max_batch, max_wait_ms=max_wait_ms,
                                      stats=self.stats)

    def score_arrays(self, frames, audio, fps: float, shifts=(0,),
                     timeout: Optional[float] = None) -> np.ndarray:
        return self.batcher.infer(self.artifact.prepare_row(frames, audio, fps, shifts),
                                  timeout=timeout)

    def score_path(self, video_path: str, shifts=(0,),
                   timeout: Optional[float] = None) -> np.ndarray:
        frames, audio, fps = decode_av(video_path, self.cfg)
        return self.score_arrays(frames, audio, fps, shifts, timeout=timeout)

    def warmup(self) -> None:
        T, H, W = self.artifact.meta["frame_shape"]
        S, K = self.artifact.meta["max_audio_samples"], self.artifact.meta["num_shifts"]
        self.batcher.warm_buckets(lambda b: self.artifact.call(
            np.zeros((b, T, H, W), np.uint8), np.zeros((b, S), np.float32),
            np.full((b,), S, np.int32), np.full((b,), 25.0, np.float32),
            np.zeros((b, K), np.int32)))

    def close(self) -> None:
        self.batcher.close()


# ---------------------------------------------------------------------------
# the HTTP daemon
# ---------------------------------------------------------------------------


class _BadRequest(ValueError):
    """A request refused before its body was read (size or header faults)."""

    def __init__(self, message: str, status: int = 400, drain: int = 0):
        super().__init__(message)
        self.status = status
        self.drain = drain  # claimed body bytes left unread (0 if unknown)


def _make_handler(server: "AvsyncServer"):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: D102 — no per-request stderr line
            pass

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _body(self) -> bytes:
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                raise _BadRequest("malformed Content-Length header") from None
            if n < 0:
                raise _BadRequest("malformed Content-Length header")
            if n > server.max_body_bytes:
                raise _BadRequest(f"request body {n} bytes exceeds the server limit "
                                  f"({server.max_body_bytes}); split the batch",
                                  status=413, drain=n)
            return self.rfile.read(n) if n else b""

        def _lingering_drain(self, n: int, limit: int = 64 << 20, chunk: int = 1 << 20) -> None:
            """Discard up to min(n, limit) unread body bytes under a socket
            timeout, so the client can read the response: closing with data
            still queued emits RST on Linux, which can destroy the client's
            unread response. Never reads past the claimed body."""
            remaining = min(n, limit)
            if remaining <= 0:
                return
            try:
                self.connection.settimeout(5.0)
                while remaining > 0:
                    data = self.rfile.read(min(chunk, remaining))
                    if not data:
                        return
                    remaining -= len(data)
            except OSError:
                pass

        def _refuse(self, code: int, message: str, unread: int) -> None:
            """Answer, drain what the client is still sending, close."""
            self._send(code, {"error": message})
            try:
                self.wfile.flush()
            except OSError:
                pass
            self._lingering_drain(unread)
            self.close_connection = True

        def do_GET(self):  # noqa: N802
            if self.path == "/healthz":
                # a readiness probe on a kept-alive connection sees the drain
                if server._draining:
                    self._send(503, {"status": "draining"})
                else:
                    self._send(200, {"status": "ok"})
            elif self.path == "/v1/stats":
                self._send(200, server.stats_snapshot())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            # once shutdown() begins, a kept-alive connection starts no new
            # work (new connections are refused: the listen socket is closed)
            if not server._begin_request():
                try:
                    claimed = max(0, int(self.headers.get("Content-Length", 0)))
                except (TypeError, ValueError):
                    claimed = 0
                self._refuse(503, "server is draining", claimed)
                return
            try:
                self._do_post_tracked()
            finally:
                server._end_request()

        def _do_post_tracked(self):
            # read the body in full: on HTTP/1.1 keep-alive an unread body
            # would be parsed as the next request line
            try:
                body = self._body()
            except _BadRequest as e:
                self._refuse(e.status, str(e), e.drain)
                return
            try:
                if self.path == "/v1/transcribe":
                    self._transcribe(body)
                elif self.path == "/v1/sync_score":
                    self._sync_score(body)
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
            except ValueError as e:
                self._send(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — the daemon must not die
                self._send(500, {"error": f"{type(e).__name__}: {e}"})

        def _transcribe(self, body: bytes):
            svc = server.transcriber
            if svc is None:
                self._send(503, {"error": "no lipnet checkpoint loaded"})
                return
            t0 = time.perf_counter()
            if self.headers.get("Content-Type", "").startswith("application/x-npy"):
                text = svc.transcribe_frames(np.load(io.BytesIO(body), allow_pickle=False))
            else:
                path = json.loads(body or "{}").get("video_path")
                if not path:
                    raise ValueError("POST application/x-npy frame bytes or JSON "
                                     "{'video_path': ...}")
                text = svc.transcribe_path(path)
            self._send(200, {"transcript": text,
                             "latency_ms": round((time.perf_counter() - t0) * 1e3, 2)})

        def _sync_score(self, body: bytes):
            svc = server.scorer
            if svc is None:
                self._send(503, {"error": "no detector checkpoint loaded"})
                return
            t0 = time.perf_counter()
            if self.headers.get("Content-Type", "").startswith("application/x-npz"):
                with np.load(io.BytesIO(body), allow_pickle=False) as z:
                    if "frames" not in z or "audio" not in z:
                        raise ValueError("npz needs 'frames' and 'audio' (optional 'fps', "
                                         "'shifts')")
                    frames, audio = z["frames"], z["audio"]
                    fps = float(z["fps"]) if "fps" in z else 25.0
                    shifts = [int(s) for s in z["shifts"]] if "shifts" in z else [0]
                probs = svc.score_arrays(frames, audio, fps, tuple(shifts))
            else:
                req = json.loads(body or "{}")
                path = req.get("video_path")
                if not path:
                    raise ValueError("POST application/x-npz {frames, audio[, fps, shifts]} or "
                                     "JSON {'video_path': ..., 'shifts': [...]}")
                shifts = tuple(int(s) for s in req.get("shifts", [0]))
                probs = svc.score_path(path, shifts)
            self._send(200, {"shifts": list(shifts),
                             "sync_probs": [round(float(p), 6) for p in probs],
                             "latency_ms": round((time.perf_counter() - t0) * 1e3, 2)})

    return Handler


class _HTTPServer(ThreadingHTTPServer):
    # the listen backlog: socketserver's default of 5 overflows when a few
    # dozen clients connect at once, and each client past it waits ~1 s for
    # its SYN to be sent again, or is reset
    request_queue_size = 128


class AvsyncServer:
    """The `serve` daemon: a ThreadingHTTPServer in front of the services.

      GET  /healthz         liveness (503 {"status": "draining"} once
                            shutdown has begun)
      GET  /v1/stats        request counters, batch-size histogram,
                            latency percentiles
      POST /v1/transcribe   application/x-npy (T, H, W) frame bytes, or
                            JSON {"video_path": ...}
      POST /v1/sync_score   application/x-npz {frames, audio[, fps,
                            shifts]}, or JSON {"video_path": ..., "shifts": [...]}

    A body larger than `max_body_bytes` gets 413 before it is read.
    """

    def __init__(self, transcriber=None, scorer=None, host: str = "127.0.0.1",
                 port: int = 8777, max_body_bytes: int = 256 * 1024 * 1024):
        if transcriber is None and scorer is None:
            raise ValueError("need at least one service")
        self.transcriber = transcriber
        self.scorer = scorer
        self.max_body_bytes = int(max_body_bytes)
        self._httpd = _HTTPServer((host, port), _make_handler(self))
        self._thread: Optional[threading.Thread] = None
        self._inflight = 0  # POSTs being answered
        self._inflight_cv = threading.Condition()
        self._draining = False

    def _begin_request(self) -> bool:
        with self._inflight_cv:
            if self._draining:
                return False
            self._inflight += 1
            return True

    def _end_request(self) -> None:
        with self._inflight_cv:
            self._inflight -= 1
            if self._inflight == 0:
                self._inflight_cv.notify_all()

    @property
    def address(self) -> tuple:
        """(host, port) bound; the port the OS chose when given port 0."""
        return self._httpd.server_address

    def stats_snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        if self.transcriber is not None:
            out["transcribe"] = self.transcriber.stats.snapshot()
            out["transcribe"]["max_batch"] = self.transcriber.batcher.max_batch
        if self.scorer is not None:
            out["sync_score"] = self.scorer.stats.snapshot()
        return out

    def start(self) -> None:
        """Serve on a background thread (tests, embedding)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever, name="avsync-http",
                                        daemon=True)
        self._thread.start()

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self, drain_timeout: float = 30.0) -> None:
        """Graceful drain, in this order: (1) the accept loop stops and the
        listen socket closes, so a new connection is refused at once (a load
        balancer retries elsewhere) instead of waiting in the backlog; (2)
        kept-alive connections get 503 for new requests while the requests
        in flight finish, for at most `drain_timeout` seconds on the
        monotonic clock (a request stuck past it is abandoned); (3) the
        handler sockets close and the batchers stop (each drains its queue,
        so every accepted Future resolves)."""
        self._httpd.shutdown()
        try:
            self._httpd.socket.close()
        except OSError:
            pass
        with self._inflight_cv:
            self._draining = True
            deadline = time.monotonic() + drain_timeout
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._inflight_cv.wait(remaining)
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
        for svc in (self.transcriber, self.scorer):
            if svc is not None:
                svc.close()
