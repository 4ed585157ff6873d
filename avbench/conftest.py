"""Fixtures of the benchmark's own CPU tests (`python -m pytest avbench`):
the cells at a tiny width, run on the CPU through the harness."""

from __future__ import annotations

import copy
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CONFIG = dict(frames=16, img_height=16, img_width=32, conv_channels=[2, 3, 4],
                   hidden_dim=8, max_label_length=6)
TINY_TRAIN = dict(batch=4, steps_per_call=3, check_steps=4, corpus_clips=64,
                  reference_block_rows=2)
# serving cells of the kind `kinds/serve.py` drives, at a tiny width (the
# benchmark has none yet: PERF.md, Open questions)
SERVE_CELLS = {
    name: {"config": config, "kind": "serve", "traffic": "poisson", "why": "a test cell",
           "max_batch": 4, "max_wait_ms": 10, "pool_clips": 16, "rate_per_s": 20,
           "check_requests": 8, "check_batches": 4, "traced_start_share": 0.4,
           "traced_seconds": 0.5, "control": control,
           "limits": {"served_gap": 0.02, "logprob_err": 1e-3}}
    for name, config, control in (("lipnet.serve", "lipnet", {"program_quantize": "int8"}),
                                  ("lipnet_tf.serve", "lipnet_tf", {"precision": "tf32"}))}
SERVE_METRICS = [
    {"name": "serve_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
     "source": "host_clock", "workloads": list(SERVE_CELLS)},
    {"name": "serve_requests_per_s", "unit": "requests/s", "better": "higher", "bound": 0.25,
     "source": "host_clock", "workloads": list(SERVE_CELLS)}]


@pytest.fixture
def tiny(monkeypatch):
    """The benchmark's configurations and cells at a tiny width, in float32
    unless a test sets `tiny.dtype`; returns a runner of one cell on the CPU
    that gives the run's exit code and its last line."""
    from avbench.harness import spec

    bench = spec.benchmark()
    configs = {n: dict(spec.config(n), **TINY_CONFIG) for n in ("lipnet", "lipnet_tf")}
    cells = {w["name"]: dict(spec.workload(w["name"]), **TINY_TRAIN) for w in bench["workloads"]}
    cells.update(copy.deepcopy(SERVE_CELLS))
    bench["workloads"] += [{"name": n, "config": c["config"], "traffic": c["traffic"], "chips": 1,
                            "why": c["why"]} for n, c in SERVE_CELLS.items()]
    bench["end_to_end"] += SERVE_METRICS

    class Runner:
        dtype = "float32"

        def config(self, name):
            return dict(copy.deepcopy(configs[name]), compute_dtype=self.dtype)

        def cell(self, name):
            return copy.deepcopy(cells[name])

        def __call__(self, name, seed=2147483659, seconds=1.0):
            import avbench.run as run

            out = io.StringIO()
            with redirect_stdout(out):
                rc = run.main(["--workload", name, "--seed", str(seed), "--seconds",
                               str(seconds), "--trace", "0"], device="cpu")
            lines = out.getvalue().strip().splitlines()
            return rc, (json.loads(lines[-1]) if lines else None)

    runner = Runner()
    monkeypatch.setattr(spec, "config", runner.config)
    monkeypatch.setattr(spec, "workload", runner.cell)
    monkeypatch.setattr(spec, "benchmark", lambda root=None: copy.deepcopy(bench))
    return runner
