"""A traced slice of a run and what is read from it.

`capture` runs a warm-up part and an active part under `torch.profiler`
(CPU and CUDA activities; the tracer's start-up loses a short window's first
kernels, so the warm-up part is recorded and dropped) and keeps the active
part's events: device events (kernels, copies and sets, without user
annotations), the host's events and the harness's own spans (`span`,
names starting with "avbench."). The active part is the span WINDOW.

Busy time is the union of the device intervals inside the window, so work
that overlaps on two streams counts once; the idle share is one minus busy
over the window.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "avbench.window"
Interval = Tuple[int, int]


def span(name: str):
    """A harness span around a call into the program (a no-op unless the
    profiler runs)."""
    import torch

    return torch.profiler.record_function(name)


def merge(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The union of intervals clipped to [lo, hi], as sorted disjoint ones."""
    out: List[List[int]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(intervals: Iterable[Interval], lo: int, hi: int) -> int:
    return sum(b - a for a, b in merge(intervals, lo, hi))


def gaps(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The stretches of [lo, hi] that no interval covers."""
    out, at = [], lo
    for a, b in merge(intervals, lo, hi):
        if a > at:
            out.append((at, a))
        at = max(at, b)
    if hi > at:
        out.append((at, hi))
    return out


class Trace:
    """Events in ns on the profiler's clock: `device` (name, start, end),
    `host` (name, start, end) and `spans` (name, start, end)."""

    def __init__(self, device, host, spans):
        self.device = device
        self.host = host
        self.spans = spans
        win = [s for s in spans if s[0] == WINDOW]
        if not win:
            raise RuntimeError("the traced slice has no window span")
        self.lo, self.hi = win[-1][1], win[-1][2]

    @classmethod
    def from_events(cls, events) -> "Trace":
        """From the profiler's kineto events (ns), or an older profiler's
        FunctionEvents (us)."""
        import torch

        device, host, spans = [], [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in events:
            if callable(getattr(e, "start_ns", None)):
                name, dtype, start, dur = e.name(), e.device_type(), e.start_ns(), e.duration_ns()
                user = e.is_user_annotation()
            else:
                name, dtype = e.name, e.device_type
                start, dur = int(e.time_range.start * 1000), int(e.time_range.elapsed_us() * 1000)
                user = bool(getattr(e, "is_user_annotation", False))
            end = start + max(int(dur), 0)
            if dtype == cuda:
                if not user:
                    device.append((name, start, end))
            elif name.startswith("avbench."):
                spans.append((name, start, end))
            else:
                host.append((name, start, end))
        return cls(device, host, spans)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e9

    def busy_s(self) -> float:
        return union_length(((a, b) for _, a, b in self.device), self.lo, self.hi) / 1e9

    def idle_share(self) -> Optional[float]:
        if self.hi <= self.lo or not self.device:
            return None
        return max(0.0, 1.0 - self.busy_s() / self.window_s)

    def spans_named(self, prefix: str) -> List[Tuple[str, int, int]]:
        """The harness spans whose name starts with `prefix`, wholly inside
        the window."""
        return [s for s in self.spans if s[0].startswith(prefix)
                and s[1] >= self.lo and s[2] <= self.hi]

    def kernel_ns(self, patterns: Sequence[str], within: Sequence[Tuple[str, int, int]]) -> int:
        """Summed durations of device events whose name holds one of
        `patterns` and that start inside one of the spans `within`."""
        bounds = merge(((a, b) for _, a, b in within), self.lo, self.hi)
        starts = [a for a, _ in bounds]
        total = 0
        for name, a, b in self.device:
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a < bounds[i][1] and any(p in name for p in patterns):
                total += b - a
        return total

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time in the window, and the
        idle gaps summed by what the host was doing (the innermost host
        event at the gap's middle, else the harness span there)."""
        ops: Dict[str, int] = defaultdict(int)
        for name, a, b in self.device:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                ops[name] += b - a
        idle: Dict[str, int] = defaultdict(int)
        events = sorted(self.host + [s for s in self.spans if s[0] != WINDOW],
                        key=lambda e: e[1])
        active: List[Tuple[str, int, int]] = []
        j = 0
        for a, b in gaps(((x, y) for _, x, y in self.device), self.lo, self.hi):
            mid = (a + b) // 2
            while j < len(events) and events[j][1] <= mid:
                active.append(events[j])
                j += 1
            active = [e for e in active if e[2] > mid]
            host = [e for e in active if not e[0].startswith("avbench.")]
            around = host or active
            name = min(around, key=lambda e: e[2] - e[1])[0] if around else "host idle"
            idle[name] += b - a

        def top_of(d):
            return [[k[:200], v / 1e9] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(ops), "idle_gaps": top_of(idle)}


def _events(prof) -> list:
    try:
        return list(prof.profiler.kineto_results.events())
    except AttributeError:
        return list(prof.events())


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (CUPTI's
    set-up, which holds the interpreter for a while) falls outside a window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.cuda.synchronize()


def capture(warm: Callable[[], None], active: Callable[[], None],
            on: Optional[Callable[[Callable[[], None]], None]] = None) -> Trace:
    """Run warm() then active() under the profiler; the Trace of active().
    The profiler records the host events of the thread that starts it, so
    `on(fn)` runs its steps on the thread whose host work is to be seen
    (a service's worker); by default on this one."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    run = on or (lambda fn: fn())
    got: list = []
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=1, active=1),
                   on_trace_ready=lambda p: got.append(_events(p)))
    window = span(WINDOW)

    def begin():
        torch.cuda.synchronize()
        prof.step()
        window.__enter__()

    def end():
        torch.cuda.synchronize()
        window.__exit__(None, None, None)
        prof.step()

    run(lambda: (torch.cuda.synchronize(), prof.__enter__()))
    try:
        warm()
        run(begin)
        active()
        run(end)
    finally:
        run(lambda: prof.__exit__(None, None, None))
    if not got:
        raise RuntimeError("the profiler returned no trace")
    return Trace.from_events(got[0])
