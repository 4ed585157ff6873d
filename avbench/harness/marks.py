"""Device time by layer of the training step, from the program's marks.

The program marks the layer boundaries of its training step with empty
kernels named `avs_mark__<span>` (`avsync_torch`'s `utils/profiling.mark`),
which a CUDA graph replays with the step. In the traced window's device
events, sorted by start, each event (kernel, copy or set; a mark's own time
too) belongs to the latest mark before it. A step
runs from a `gather` mark to the next one; the window's last step counts if
it reached its `tail` mark (the events after it, such as the loss read,
stay in its tail). Events before the window's first `gather` belong to no
whole step and are left out. A trace with no mark gives None.
"""

from __future__ import annotations

import re
import weakref
from collections import defaultdict
from typing import Callable, Dict, NamedTuple, Optional

MARK = re.compile(r"avs_mark__([A-Za-z0-9_]+)")
STEP, TAIL = "gather", "tail"


class Steps(NamedTuple):
    """Whole steps of a window: their number, and each span's device ns and
    kernels (copies and sets not counted) summed over them."""

    n: int
    ns: Dict[str, int]
    kernels: Dict[str, int]


def mark_of(name: str) -> Optional[str]:
    """The span a device event's name marks (its `.` written as `_`), or
    None for any other event."""
    m = MARK.search(name)
    return m.group(1) if m else None


def whole_steps(trace) -> Optional[Steps]:
    """The window's whole steps, or None where it holds none."""
    events = sorted((e for e in trace.device if trace.lo <= e[1] < trace.hi),
                    key=lambda e: e[1])
    steps, span, cur = [], None, None
    for name, a, b in events:
        m = mark_of(name)
        if m is not None:
            span = m
            if m == STEP:
                cur = {"ns": defaultdict(int), "kernels": defaultdict(int), "tail": False}
                steps.append(cur)
            elif m == TAIL and cur is not None:
                cur["tail"] = True
        if cur is None:
            continue
        cur["ns"][span] += b - a
        if m is None and not name.startswith(("Memcpy", "Memset")):
            cur["kernels"][span] += 1
    whole = [s for i, s in enumerate(steps) if i + 1 < len(steps) or s["tail"]]
    if not whole:
        return None
    ns: Dict[str, int] = defaultdict(int)
    kernels: Dict[str, int] = defaultdict(int)
    for s in whole:
        for k, v in s["ns"].items():
            ns[k] += v
        for k, v in s["kernels"].items():
            kernels[k] += v
    return Steps(len(whole), dict(ns), dict(kernels))


_steps_of: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def steps_of(readings: dict) -> Optional[Steps]:
    """`whole_steps` of the run's trace, worked out once per trace."""
    trace = readings.get("trace")
    if trace is None:
        return None
    if trace not in _steps_of:
        _steps_of[trace] = whole_steps(trace)
    return _steps_of[trace]


def layer_ms(readings: dict, spans: Callable[[str], bool]) -> Optional[float]:
    """Device ms per whole step in the spans that `spans(name)` takes;
    None without marks or without such a span."""
    steps = steps_of(readings)
    if steps is None:
        return None
    got = [v for k, v in steps.ns.items() if spans(k)]
    return sum(got) / steps.n / 1e6 if got else None


def layer_kernels(readings: dict, spans: Callable[[str], bool]) -> Optional[float]:
    """Device kernels per whole step in the spans that `spans(name)` takes."""
    steps = steps_of(readings)
    if steps is None:
        return None
    got = [v for k, v in steps.kernels.items() if spans(k)]
    return sum(got) / steps.n if got else None


def named(*names: str) -> Callable[[str], bool]:
    return lambda span: span in names


def layer(prefix: str) -> Callable[[str], bool]:
    """The spans of the layers named `prefix<digits>`, forward and backward."""
    pattern = re.compile(rf"{prefix}\d+_(fwd|bwd)$")
    return lambda span: pattern.match(span) is not None

