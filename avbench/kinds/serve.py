"""A serving cell: `TranscribeService` over a live `LipReader` in process,
transport 'raw', under an open-loop Poisson load at the cell's fixed rate.

One client thread submits each request when it is due (a uint8 clip from
the cell's pool, `LipReader.prepare_raw` then the batcher's `submit`, as
`transcribe_frames` does without blocking); a request's latency runs from
when it was due until its transcript is back. After the window closes the
harness waits up to a minute for the answers still out: a late answer is
late, one that never comes is failed. Then the plain reference checks the
service's answers and its log-probs: a sample of the answered requests
drawn from the seed (each transcript's gap), and the batches the worker
ran that the seed picked for the check (the log-probs of their rows, taken
where the program computes them).
"""

from __future__ import annotations

import gc
import math
import threading
import time
from functools import partial

import numpy as np
import torch

from avbench.harness import compare, reference, traffic
from avbench.harness.program import program_config
from avbench.harness.trace import capture, span, warm_profiler

BATCH_SPAN = "avbench.batch"
LATE_WAIT_S = 60.0


class Setup:
    """A warmed service over the benchmark's weights, and the request pool."""

    def __init__(self, ctx, quantize=None, keep_share: float = 0.0, traced: bool = False):
        from avsync_torch.predictor import LipReader
        from avsync_torch.serving import TranscribeService

        cfg, cell, dev = ctx.config, ctx.cell, ctx.device
        self.cfg, self.cell, self.dev = cfg, cell, dev
        self.params = reference.init_params(cfg, traffic.seed_of(ctx.seed, 0), dev)
        acfg = program_config(cfg, cell["max_batch"], ctx.seed % (1 << 40))
        self.pool = traffic.clip_pool(cfg, cell, ctx.seed, dev)
        calib = list(self.pool[:cell["max_batch"]]) if quantize else None
        self.reader = LipReader(params=self.params, config=acfg, device=dev, quantize=quantize,
                                calibration_frames=calib)
        self.service = TranscribeService(self.reader, max_batch=cell["max_batch"],
                                         max_wait_ms=cell["max_wait_ms"], transport="raw")
        # a span around each batch the worker runs (the batcher takes its
        # infer function at construction and has no other hook), and the
        # frames and log-probs of the batches drawn for the check
        infer, logprobs = self.service.batcher._infer_fn, self.reader._logprobs
        self.kept, self.keep_share = [], 0.0
        self._draw = np.random.default_rng(traffic.seed_of(ctx.seed, 6))
        self._frames = None

        def spanned(payload):
            rows = payload[0] if isinstance(payload, tuple) else payload
            keep = len(self.kept) < cell["check_batches"] and self._draw.random() < self.keep_share
            self._frames = rows if keep else None
            with span(f"{BATCH_SPAN}.B{rows.shape[0]}"):
                return infer(payload)

        def kept_logprobs(clips):
            lp = logprobs(clips)
            if self._frames is not None:
                self.kept.append((self._frames, lp))
            return lp

        self.service.batcher._infer_fn = spanned
        self.reader._logprobs = kept_logprobs
        self.service.warmup(self.pool[0])
        if traced:
            self.service.batcher.call_on_worker(warm_profiler)
        self.keep_share = keep_share

    def counters(self) -> tuple:
        st = self.service.stats.snapshot()
        return st["requests"], sum(st["batches"].values())

    def close(self) -> None:
        self.service.close()
        self.service = self.reader = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def drive(su: Setup, sched: dict, seconds: float, traced=None) -> dict:
    """Offer `sched` (`traffic.arrivals`) over a window of `seconds`; with
    `traced` = (start, warm, active) seconds, trace that slice of it."""
    n = len(sched["due"])
    done = np.full(n, np.nan)
    late = np.zeros(n)
    texts = [None] * n
    errors = [None] * n
    t0 = time.perf_counter() + 0.05
    batcher, prepare, pool = su.service.batcher, su.reader.prepare_raw, su.pool

    def finished(i, fut):
        done[i] = time.perf_counter()
        exc = fut.exception()
        if exc is not None:
            errors[i] = repr(exc)
        else:
            texts[i] = fut.result()

    def client():
        for i in range(n):
            due = t0 + sched["due"][i]
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            fut = batcher.submit(prepare(pool[sched["clip"][i]]))
            late[i] = time.perf_counter() - due
            fut.add_done_callback(partial(finished, i))

    thread = threading.Thread(target=client, name="avbench-client")
    thread.start()
    trace = None
    if traced is not None:
        start, warm, active = traced
        time.sleep(max(0.0, t0 + start - time.perf_counter()))
        trace = capture(lambda: time.sleep(warm), lambda: time.sleep(active),
                        on=su.service.batcher.call_on_worker)
    thread.join()
    t_end = t0 + seconds
    time.sleep(max(0.0, t_end - time.perf_counter()))
    queue_at_end = int(np.sum(~(done <= t_end)))
    deadline = t_end + LATE_WAIT_S
    while np.isnan(done).any() and time.perf_counter() < deadline:
        time.sleep(0.01)
    lat = done - (t0 + sched["due"])
    failed = [i for i in range(n) if texts[i] is None]
    lat[failed] = math.inf
    return {"n": n, "latency_s": lat, "texts": texts, "errors": errors, "failed": len(failed),
            "answered_in_window": int(np.sum(done <= t_end)), "queue_at_end": queue_at_end,
            "late_p99_ms": traffic.quantile(late, 0.99) * 1e3, "trace": trace}


def served_gap(su: Setup, sched: dict, got: dict, k: int, seed: int, logprobs_of) -> float:
    """The widest transcript gap over k answered requests drawn from the
    seed; `logprobs_of(clips)` gives the reference's log-probs."""
    answered = [i for i in range(got["n"]) if got["texts"][i] is not None]
    if not answered:
        return math.inf
    pick = [answered[j] for j in traffic.sample(len(answered), k, seed)]
    clips = sorted({int(sched["clip"][i]) for i in pick})
    frames = torch.from_numpy(su.pool[clips]).to(su.dev)
    lp = logprobs_of(reference.model_input(su.cfg, frames)).cpu().numpy()
    row = {c: r for r, c in enumerate(clips)}
    return max(reference.transcript_gap(su.cfg, lp[row[int(sched["clip"][i])]], got["texts"][i])
               for i in pick)


def kept_readings(su: Setup) -> dict:
    """Over every row and frame of the kept batches: the widest gap of the
    token the program's log-probs put first under the reference's, and the
    largest difference of a log-prob from the reference's."""
    if not su.kept:
        return {"logprob_gap": math.inf, "logprob_err": math.inf}
    frames = np.concatenate([f for f, _ in su.kept])
    got = torch.cat([lp.float().to(su.dev) for _, lp in su.kept])
    want = reference.logprobs(su.cfg, su.params,
                              reference.model_input(su.cfg, torch.from_numpy(frames).to(su.dev)))
    return {"logprob_gap": compare.token_gap(want, got),
            "logprob_err": compare.logprob_err(want, got)}


def run(ctx) -> dict:
    cell = ctx.cell
    rate = float(cell["rate_per_s"])
    expected_batches = rate * ctx.seconds / cell["max_batch"]
    su = Setup(ctx, keep_share=min(1.0, cell["check_batches"] / max(expected_batches, 1.0)),
               traced=ctx.trace)
    sched = traffic.arrivals(cell, rate, ctx.seconds, ctx.seed)
    before = su.counters()
    setup_s = ctx.since_start()
    traced = None
    if ctx.trace:
        traced = (cell["traced_start_share"] * ctx.seconds, 0.5, cell["traced_seconds"])
    got = drive(su, sched, ctx.seconds, traced)
    after = su.counters()
    memory_peak = ctx.memory_peak()
    su.close()

    gap = served_gap(su, sched, got, cell["check_requests"], ctx.seed,
                     lambda x: reference.logprobs(ctx.config, su.params, x))
    readings = dict(kept_readings(su), served_gap=gap)
    requests, batches = after[0] - before[0], after[1] - before[1]
    return {
        "e2e": {"serve_p95_ms": traffic.quantile(got["latency_s"], 0.95) * 1e3,
                "serve_requests_per_s": got["answered_in_window"] / ctx.seconds,
                "setup_s": setup_s},
        "readings": {"trace": got["trace"], "batch_span": BATCH_SPAN,
                     "requests_per_s": got["answered_in_window"] / ctx.seconds,
                     "max_batch": cell["max_batch"], "requests": requests, "batches": batches},
        "attempted": got["n"], "failed": got["failed"],
        "checks": [compare.Check(k, readings[k], float(v)) for k, v in cell["limits"].items()],
        "memory_peak": memory_peak, "trace": got["trace"],
        "log": {"rate_per_s": rate, "queue_at_end": got["queue_at_end"],
                "client_late_p99_ms": got["late_p99_ms"],
                "p50_ms": traffic.quantile(got["latency_s"], 0.5) * 1e3,
                "kept_rows": sum(len(f) for f, _ in su.kept), "readings": readings,
                "errors": [e for e in got["errors"] if e][:3]},
    }
