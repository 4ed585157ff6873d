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
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional


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
    import torch
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
