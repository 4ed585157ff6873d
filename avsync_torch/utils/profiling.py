"""Step timing, profiler traces and metric logs (port of
`avsync/utils/profiling.py`).

  * `StepTimer` — per-step wall timing with warm-up exclusion and p50/p95
    summaries. The host clock measures the enqueue unless the caller waits
    for the device inside the timed region (the trainers read a loss).
  * `trace` — a `torch.profiler` trace of CPU and CUDA activity written into
    a directory as a Chrome trace (`trace.json`; chrome://tracing,
    Perfetto). Where the profiler cannot start it warns and runs the block
    untraced, as the JAX package's does.
  * `MetricsWriter` — append-only JSONL of scalar metrics per step or epoch.
  * `span`, `spans` — the program's own spans: `(name, start_ns, end_ns,
    parent, thread, attrs)` in a bounded ring in memory (`RING_SIZE`, the
    oldest dropped first), thread-safe and independent of the profiler.
    While the profiler records on the calling thread, a span is also a
    `record_function` range of the same name, so it sits on the trace's
    clock beside the device events. Names start with `avsync_torch.`.
  * `mark`, `mark_backward` — device marks that a CUDA graph keeps. A
    replay runs no Python, so a host range opened around a captured step
    is not around its replayed kernels; the layer boundaries of the
    training step are kernels instead: one empty kernel per name that
    `csrc/span_mark.cu` lists (`avs_mark__<name with . as _>`; the code
    that places the marks owns the list, and a test keeps the two equal).
    Each mark opens a span on its stream that lasts until the next mark:
    a trace of a replay is split by layer by giving each device event to
    the latest mark before it. A mark launches nothing on the CPU; on both
    it appends `avsync_torch.mark.<name>` to a ring of marks of its own
    (`marks()`, so that marks never push the spans out) while Python runs
    (eager steps and a capture), never in a replay.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import json
import os
import re
import threading
import time
import warnings
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import torch


class StepTimer:
    def __init__(self, warmup: int = 1):
        self.warmup = warmup
        self._all: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._all.append(time.perf_counter() - self._t0)

    @property
    def times(self) -> List[float]:
        return self._all[self.warmup:]

    def summary(self) -> Dict[str, float]:
        ts = sorted(self.times)
        if not ts:
            return {"steps": 0}
        n = len(ts)
        return {
            "steps": n,
            "mean_s": sum(ts) / n,
            "p50_s": ts[n // 2],
            "p95_s": ts[min(n - 1, int(n * 0.95))],
            "total_s": sum(self._all),
        }


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block into `log_dir/trace.json` (CUDA
    activity too where a card is present). Where the profiler cannot start
    or stop, a warning, and the block runs untraced."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        os.makedirs(log_dir, exist_ok=True)
        prof = profile(activities=activities)
        prof.__enter__()
    except (RuntimeError, OSError) as e:  # a build or platform without the profiler
        warnings.warn(f"torch.profiler unavailable ({e}); tracing disabled")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
            except (RuntimeError, OSError) as e:
                warnings.warn(f"profiler trace not written: {e}")


class MetricsWriter:
    """Append-only JSONL metrics log: one {step, tag: value, ...} per line."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self._f = open(path, "a")

    def write(self, step: int, **scalars: Any) -> None:
        rec: Dict[str, Any] = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    @staticmethod
    def read(path: str) -> List[Dict[str, Any]]:
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]


# -- the program's spans -----------------------------------------------------

# Spans (and, in a ring of their own, marks) kept; the oldest are dropped first.
RING_SIZE = 1 << 14
MARK_PREFIX = "avsync_torch.mark."
MARK_SOURCE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "csrc", "span_mark.cu")


@functools.lru_cache(maxsize=None)
def mark_ids() -> Dict[str, int]:
    """Each device mark's kernel suffix (`conv2_bwd`) to its id: the order
    of `csrc/span_mark.cu`'s `AVS_SPAN_MARKS` list, which its C entry
    indexes."""
    with open(MARK_SOURCE) as f:
        src = f.read()
    listed = src[src.index("#define AVS_SPAN_MARKS(X)"):src.index("#define AVS_DEFINE_MARK")]
    return {name: i for i, name in enumerate(re.findall(r"X\((\w+)\)", listed))}


def mark_kernel(name: str) -> str:
    """The kernel that marks span `name` on the device."""
    return "avs_mark__" + name.replace(".", "_")


class Span(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns
    end_ns: int  # a mark's: its start (a mark has no length on the host)
    parent: Optional[str]  # the innermost open span of the thread, or None
    thread: int
    attrs: Dict[str, Any]


class SpanRecorder:
    """Bounded rings of spans and of marks, shared by threads."""

    def __init__(self, size: int = RING_SIZE):
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._marks: collections.deque = collections.deque(maxlen=size)
        self._lock = threading.Lock()
        self._local = threading.local()

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def current(self) -> Optional[str]:
        """The innermost span open on the calling thread."""
        stack = self._stack()
        return stack[-1] if stack else None

    def add(self, span: Span) -> None:
        with self._lock:
            self._ring.append(span)

    def spans(self) -> List[Span]:
        with self._lock:
            return list(self._ring)

    def marks(self) -> List[Span]:
        with self._lock:
            return list(self._marks)

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[None]:
        stack = self._stack()
        parent = stack[-1] if stack else None
        stack.append(name)
        rf = torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else None
        if rf is not None:
            rf.__enter__()
        start = time.perf_counter_ns()
        try:
            yield
        finally:
            end = time.perf_counter_ns()
            if rf is not None:
                rf.__exit__(None, None, None)
            stack.pop()
            self.add(Span(name, start, end, parent, threading.get_ident(), attrs))

    def mark(self, name: str, device, parent: Optional[str] = None) -> None:
        """Mark `name` on `device`'s current stream (nothing on the CPU),
        and in the ring of marks under `parent`, by default the calling
        thread's innermost span."""
        mark_id = mark_ids()[name.replace(".", "_")]
        device = torch.device(device)
        if device.type == "cuda":
            _launch_mark(mark_id, name, device)
        now = time.perf_counter_ns()
        span = Span(MARK_PREFIX + name, now, now, parent if parent is not None
                    else self.current(), threading.get_ident(), {})
        with self._lock:
            self._marks.append(span)


def _launch_mark(mark_id: int, name: str, device: torch.device) -> None:
    from avsync_torch.ops.cuda import build

    index = device.index if device.index is not None else torch.cuda.current_device()
    fn = build.function("span_mark", "avs_span_mark",
                        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(mark_id, index, torch.cuda.current_stream(index).cuda_stream)
    build.check("span_mark", err, f"span mark {name}")


# The process's recorder: what `span`, `spans`, `marks`, `mark` and
# `mark_backward` use (a test may put a fresh one in its place).
RECORDER = SpanRecorder()


def span(name: str, **attrs):
    """A context manager recording the block as span `name` with `attrs`."""
    return RECORDER.span(name, **attrs)


def spans() -> List[Span]:
    """The spans in the ring, oldest first."""
    return RECORDER.spans()


def marks() -> List[Span]:
    """The marks in their ring, oldest first."""
    return RECORDER.marks()


def mark(name: str, device) -> None:
    """Device mark `name` (a kernel of `csrc/span_mark.cu`; KeyError for
    another name) on `device`'s current stream: an empty kernel on the
    card, a CUDA graph captured around it keeps it; nothing on the CPU.
    Recorded in the ring of marks either way."""
    RECORDER.mark(name, device)


class _BackwardMark(torch.autograd.Function):
    """Identity whose backward first marks the layer whose gradient follows."""

    @staticmethod
    def forward(ctx, x, name, parent):
        ctx.name, ctx.parent = name, parent
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        RECORDER.mark(ctx.name, grad.device, ctx.parent)
        return grad, None, None


def mark_backward(x: torch.Tensor, name: str) -> torch.Tensor:
    """A view of `x` (no copy) whose gradient, when the backward reaches it,
    first marks `name` on the gradient's stream: the kernels of the layers
    before `x` then fall after that mark in stream order. The mark's parent
    in the ring is the span open where the forward ran."""
    return _BackwardMark.apply(x, name, RECORDER.current())
