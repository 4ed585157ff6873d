"""What the per-layer metrics' files share: the reading of a run's trace,
counters and window into shares. A reader that finds nothing to read
returns None, and the metric is left out of the run's line."""

from __future__ import annotations

import re
from typing import Callable, Optional

from avbench.harness import work


def mfu(readings: dict) -> Optional[float]:
    """The window's samples per second times the useful FLOPs of a sample,
    over the H100's dense peak for the configuration's dtype, in %."""
    rate = readings.get("samples_per_s")
    if not rate:
        return None
    cfg = readings["config"]
    return 100.0 * rate * work.train_flops(cfg) / work.peak_flops(cfg["peak_dtype"])


def idle_share(readings: dict) -> Optional[float]:
    """1 - (the union of device intervals) / (the traced window), in %."""
    trace = readings.get("trace")
    share = trace.idle_share() if trace is not None else None
    return None if share is None else 100.0 * share


def roofline(readings: dict, span_prefix: str, patterns,
             bound_of_span: Callable) -> Optional[float]:
    """The least time of the kernel's work over its measured time, in %:
    over the harness spans named `span_prefix` wholly inside the traced
    window, the sum of `bound_of_span(name)` (seconds) over the summed
    durations of the device events matching `patterns` that start in them."""
    trace = readings.get("trace")
    if trace is None:
        return None
    spans = trace.spans_named(span_prefix)
    ns = trace.kernel_ns(patterns, spans) if spans else 0
    if ns <= 0:
        return None
    return 100.0 * sum(bound_of_span(name) for name, _, _ in spans) / (ns / 1e9)


def span_number(name: str, letter: str) -> int:
    """The count a span's name carries after `.<letter>`: S steps, B rows."""
    m = re.search(rf"\.{letter}(\d+)$", name)
    if m is None:
        raise ValueError(f"span {name!r} carries no {letter} count")
    return int(m.group(1))
