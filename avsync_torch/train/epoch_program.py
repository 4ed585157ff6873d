"""Whole-epoch programs of the trainers: one step captured in a CUDA graph
and replayed over the epoch's (S, B) plan (the port's counterpart of the
JAX package's `lax.scan` over the train and eval steps).

A program owns the plan's static device buffers, a step counter on the
device and the per-step outputs; the step it runs picks row `counter` of
the plan, does its work, writes its outputs at `counter` and adds one, all
on the device, so a graph of it needs no host value and reads no batch
from the host. On the card the first run of a program runs `WARMUP_STEPS`
real steps eagerly on the program's stream (they initialise what a capture
may not: Adam's state, library handles and workspaces, FFT plans, the
kernels' builds and tables), captures the step, then replays it for the
rest of the epoch; later epochs only replay. A capture that fails raises:
nothing falls back to the loop. On the CPU, and where the caller asks for
it, the same step runs as an eager loop, so the two can be held against
each other bit for bit (the trainers' step scope makes cuDNN deterministic).

A data-parallel step is split at its gradient all-reduce, which a CUDA graph
cannot hold when the collective is gloo's (a host round trip): `body` (the
forward and backward into the reducer's flat buffer) and `finish` (the
update after the reduction) are captured as two graphs, and `reduce` runs
eagerly between their replays. On the CPU the three run in a loop: one code
path either way.

Spans (`utils.profiling.span`): `avsync_torch.train.warmup_step` around each
eager step before a capture, `avsync_torch.train.capture` around the
capture, and `avsync_torch.train.replay` around the replays.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from avsync_torch.utils import profiling

# Eager steps on a new program's stream before its capture.
WARMUP_STEPS = 2


def fingerprint(*groups) -> tuple:
    """The storage addresses of every tensor in `groups` (tensors, lists of
    tensors, optimizers with their rates and state): what a captured graph
    has baked in. Another set (a resumed optimizer, a rebuilt cache or
    bank) needs a new capture."""
    out = []
    for g in groups:
        if isinstance(g, torch.optim.Optimizer):
            for group in g.param_groups:
                out += [p.data_ptr() for p in group["params"]]
                if isinstance(group["lr"], torch.Tensor):
                    out.append(group["lr"].data_ptr())
            for st in g.state.values():
                out += [v.data_ptr() for v in st.values() if isinstance(v, torch.Tensor)]
        elif isinstance(g, torch.Tensor):
            out.append(g.data_ptr())
        else:
            out += [t.data_ptr() for t in g]
    return tuple(out)


class EpochProgram:
    """Static buffers (`buffers[name]`, allocated once), the step counter
    and, on the card, the graph and the stream it was captured on."""

    def __init__(self, device: torch.device, buffers: Dict[str, torch.Tensor]):
        self.device = device
        self.buffers = buffers
        self.counter = torch.zeros((1,), dtype=torch.long, device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.finish_graph: Optional[torch.cuda.CUDAGraph] = None  # a split step's update
        self.stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        self.fingerprint: Optional[tuple] = None

    def row(self, name: str) -> torch.Tensor:
        """Row `counter` of the (S, ...) plan buffer `name`."""
        buf = self.buffers[name]
        return buf.index_select(0, self.counter).view(buf.shape[1:])

    def put(self, name: str, value: torch.Tensor) -> None:
        """`value` into row `counter` of the (S, ...) output buffer `name`."""
        buf = self.buffers[name]
        buf.index_copy_(0, self.counter, value.reshape(1, *buf.shape[1:]))

    def run(self, steps: int, body: Callable[[], None], before: Callable[[], None],
            graph_ok: bool, key: Callable[[], tuple],
            zero_grad: Optional[Callable[[], None]] = None,
            generator: Optional[torch.Generator] = None,
            reduce: Optional[Callable[[], None]] = None,
            finish: Optional[Callable[[], None]] = None) -> None:
        """`steps` steps of `body` from plan row 0. `before()` runs ahead of
        every step on the host (the dropout reseed); `zero_grad`, ahead of
        every eager step and of the capture, sets the gradients to None, so
        the captured backward writes its own. `graph_ok` False runs the
        eager loop. `key()` is the fingerprint of what the step reads and
        writes, taken at the capture (after the warm-up has made Adam's
        state) and compared on every later run; `generator` is registered
        with the graph, so each replay reads its seed and offset. With
        `reduce` and `finish` a step is body, reduce, finish: two graphs with
        the eager reduction between them."""
        parts = (body,) if reduce is None else (body, reduce, finish)
        self.counter.zero_()
        if not graph_ok:
            for _ in range(steps):
                self._eager(parts, before, zero_grad)
            return
        if self.graph is not None and self.fingerprint != key():
            self.graph = None
        done = 0
        if self.graph is None:
            done = min(WARMUP_STEPS, steps)
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                for _ in range(done):
                    with profiling.span("avsync_torch.train.warmup_step"):
                        self._eager(parts, before, zero_grad)
            current.wait_stream(self.stream)
            if done < steps:
                with profiling.span("avsync_torch.train.capture"):
                    if zero_grad is not None:
                        zero_grad()
                    graph = torch.cuda.CUDAGraph()
                    if generator is not None:
                        graph.register_generator_state(generator)
                    with torch.cuda.graph(graph, stream=self.stream,
                                          capture_error_mode="thread_local"):
                        body()
                    self.graph, self.fingerprint = graph, key()
                    if finish is not None:
                        self.finish_graph = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(self.finish_graph, stream=self.stream,
                                              capture_error_mode="thread_local"):
                            finish()
        if done < steps:
            with profiling.span("avsync_torch.train.replay"):
                for _ in range(done, steps):
                    before()
                    self.graph.replay()
                    if reduce is not None:
                        reduce()
                        self.finish_graph.replay()

    @staticmethod
    def _eager(parts, before, zero_grad) -> None:
        before()
        if zero_grad is not None:
            zero_grad()
        for part in parts:
            part()
