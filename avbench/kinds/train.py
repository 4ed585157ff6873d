"""A training cell: `LipNetTrainer.train_epoch_scanned` called again and
again on (S, B) plans in `LipNetBatcher.scan_plan`'s layout over a device
cache made from the seed.

Set-up builds one trainer state around the benchmark's seeded weights and
drives its first steps through the window's own entry and feed: a plan of
one step (its Adam state then holds the first clipped gradient) and a plan
of `check_steps - 1` steps (the program's warm-up steps, its capture and a
replay), on rows that all differ. Then one plan of S steps captures the
window's program. The window replays S-step plans until `--seconds` have
passed; a traced run then traces `traced_calls` more plans. Once the window
has closed and the program's state is freed, the plain reference follows
the checked steps from the same weights and rows.
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from avbench.harness import compare, reference, traffic
from avbench.harness.program import program_config
from avbench.harness.trace import capture, span

CALL_SPAN = "avbench.train_call"


class _StepLosses:
    """The trainer's metrics writer: each step's loss by step number."""

    def __init__(self):
        self.loss = {}

    def write(self, step, **values):
        self.loss[int(step)] = float(values["loss"])


class _Corpus:
    """A corpus of n clips that live only in the device cache."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n


class Setup:
    """The program's trainer state over the cell's device cache."""

    def __init__(self, ctx):
        from avsync_torch.data.pipeline import LipNetBatcher
        from avsync_torch.models import make_lipnet
        from avsync_torch.train.lipnet_trainer import LipNetTrainer
        from avsync_torch.utils.logging import Logger

        cfg, cell, dev = ctx.config, ctx.cell, ctx.device
        self.cfg, self.cell, self.dev = cfg, cell, dev
        self.B, self.S = cell["batch"], cell["steps_per_call"]
        self.train_seed = ctx.seed % (1 << 40)
        acfg = program_config(cfg, self.B, self.train_seed)
        self.params = reference.init_params(cfg, traffic.seed_of(ctx.seed, 0), dev)
        self.corpus = traffic.train_corpus(cfg, cell, ctx.seed, dev)
        N = cell["corpus_clips"]
        model = make_lipnet(acfg.model, (cfg["img_height"], cfg["img_width"]),
                            generator=torch.Generator().manual_seed(0)).to(dev)
        model.load_state_dict(self.params)
        self.trainer = LipNetTrainer(acfg, device=dev, log=Logger(None, console=False))
        self.state = self.trainer.init_state(model)
        self.batcher = LipNetBatcher(_Corpus(N), acfg, device=dev)
        # the program has no public door for a cache made on the device:
        # the fields `warm_device_cache` fills, in its layout
        c = self.corpus
        self.batcher._device_cache = {
            "video": c["video"], "n_cached": N, "u8": c["u8"],
            "clip_shape": (cfg["frames"], cfg["img_height"], cfg["img_width"], 1),
            "dtype": str(c["video"].dtype).replace("torch.", ""),
            "labels": c["labels"], "label_lengths": c["lengths"],
            "labels_dev": c["labels_dev"], "lengths_dev": c["lengths_dev"]}
        self.feed = traffic.PlanFeed(N, self.B, ctx.seed)

    def plan(self, idx: np.ndarray) -> dict:
        c = self.corpus
        return {"video": c["video"], "gather": self.batcher.gather, "labels": c["labels_dev"],
                "lengths": c["lengths_dev"], "idx": idx}

    def call(self, idx: np.ndarray, writer=None) -> float:
        """One call of the window's entry on plan `idx`; its mean loss (the
        call ends with the program's read of its losses)."""
        with span(f"{CALL_SPAN}.S{idx.shape[0]}"):
            _, loss = self.trainer.train_epoch_scanned(self.state, self.plan(idx),
                                                       metrics_writer=writer)
        return loss

    def checked_steps(self) -> dict:
        """The first steps through the entry; what the reference compares."""
        n = self.cell["check_steps"]
        rec = _StepLosses()
        opt = self.state.optimizer
        named = list(self.state.model.named_parameters())
        rows = [self.feed.take(1), self.feed.take(n - 1)]
        self.call(rows[0], rec)
        beta1 = opt.param_groups[0]["betas"][0]
        # an optimizer that took no step holds no state: it got nothing
        first_grad = {k: (opt.state[p]["exp_avg"] / (1.0 - beta1)).detach().clone()
                      if "exp_avg" in opt.state[p] else torch.zeros_like(p) for k, p in named}
        self.call(rows[1], rec)
        after = {k: p.detach().clone() for k, p in named}
        idx = np.concatenate([r.reshape(-1) for r in rows])
        return {"losses": [rec.loss[s] for s in range(1, n + 1)], "first_grad": first_grad,
                "params": after, "rows": idx,
                "video": self.corpus["video"].index_select(
                    0, torch.as_tensor(idx, device=self.dev).long())}

    def free(self) -> None:
        self.trainer = self.state = self.batcher = None
        self.corpus["video"] = None
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def reference_batches(cfg: dict, B: int, checked: dict, corpus: dict) -> list:
    """The checked steps' batches for the reference: the same rows, inputs
    as the cache's gather gives them, the same labels."""
    video = checked["video"]
    x = video.float() * (1.0 / 255.0) if video.dtype == torch.uint8 else video.float()
    x = x.view(-1, cfg["frames"], cfg["img_height"], cfg["img_width"], 1)
    rows = checked["rows"]
    labels = torch.from_numpy(corpus["labels"][rows]).to(x.device)
    lengths = torch.from_numpy(corpus["lengths"][rows]).to(x.device)
    return [{"video": x[lo:lo + B], "labels": labels[lo:lo + B], "lengths": lengths[lo:lo + B]}
            for lo in range(0, x.shape[0], B)]


def reference_inputs(ctx) -> tuple:
    """(weights, the checked steps' batches, the dropout seed) of a run of
    this cell and seed, made as the run makes them, without the program."""
    cfg, cell = ctx.config, ctx.cell
    B, n = cell["batch"], cell["check_steps"]
    params = reference.init_params(cfg, traffic.seed_of(ctx.seed, 0), ctx.device)
    corpus = traffic.train_corpus(cfg, cell, ctx.seed, ctx.device)
    feed = traffic.PlanFeed(cell["corpus_clips"], B, ctx.seed)
    rows = np.concatenate([feed.take(1).reshape(-1), feed.take(n - 1).reshape(-1)])
    checked = {"rows": rows, "video": corpus["video"].index_select(
        0, torch.as_tensor(rows, device=ctx.device).long())}
    corpus["video"] = None
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return params, reference_batches(cfg, B, checked, corpus), ctx.seed % (1 << 40)


def run(ctx) -> dict:
    su = Setup(ctx)
    checked = su.checked_steps()
    su.call(su.feed.take(su.S))  # captures the window's program
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = ctx.since_start()

    losses, ends = [], []
    t0 = time.perf_counter()
    while True:
        losses.append(su.call(su.feed.take(su.S)))
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= ctx.seconds:
            break
    elapsed, calls = ends[-1], len(ends)
    samples_per_s = calls * su.S * su.B / elapsed

    trace = None
    if ctx.trace:
        k = ctx.cell["traced_calls"]
        trace = capture(lambda: su.call(su.feed.take(su.S)),
                        lambda: [su.call(su.feed.take(su.S)) for _ in range(k)])
    memory_peak = ctx.memory_peak()

    su.free()
    ref = reference.train_steps(ctx.config, su.params,
                                reference_batches(ctx.config, su.B, checked, su.corpus),
                                su.train_seed, block_rows=ctx.cell["reference_block_rows"])
    readings = compare.train_readings(su.params, checked, ref)
    checks = compare.train_checks(ctx.cell["limits"], readings)
    checks.append(compare.Check("window_losses_finite",
                                float(sum(not math.isfinite(v) for v in losses)), 0.0))
    return {
        "e2e": {"train_samples_per_s": samples_per_s, "setup_s": setup_s},
        "readings": {"samples_per_s": samples_per_s, "trace": trace,
                     "step_span": CALL_SPAN, "batch": su.B, "steps_per_call": su.S},
        "attempted": calls * su.S, "failed": su.S * sum(not math.isfinite(v) for v in losses),
        "checks": checks, "memory_peak": memory_peak, "trace": trace,
        "log": {"window_s": elapsed, "calls": calls, "call_ends_s": ends, "loss_first": losses[0],
                "loss_last": losses[-1], "readings": readings},
    }
