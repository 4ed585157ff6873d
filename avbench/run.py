"""Run one cell of the benchmark once.

    python3 avbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds `BENCHMARK.json`, `avbench/` and the
program (`avsync_torch`). Needs as many CUDA devices as the cell asks for;
without them it exits 3 and prints no result. The last line of standard
output is the run's result, one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` a `breakdown`, and last `checks`,
each number compared with its limit; the same checks are the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _process_start() -> float:
    """The wall-clock time this process started (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "avsync")


def forbidden_modules() -> list:
    """Top-level names in sys.modules, compared whole, that the benchmark's
    process must not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a kind's `run` gets: the cell, its configuration and the run's
    arguments, the device, and the clocks."""

    def __init__(self, args, entry: dict, cell: dict, config: dict, device):
        self.entry, self.cell, self.config = entry, cell, config
        self.seed, self.seconds, self.trace = args.seed, float(args.seconds), bool(args.trace)
        self.device = device

    @staticmethod
    def since_start() -> float:
        return time.time() - T_START

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))


def _number(x: float):
    """A reading for the JSON line: a number, or null where it is not finite
    (standard error shows it as it is)."""
    return x if math.isfinite(x) else None


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def per_layer(bench: dict, name: str, readings: dict) -> dict:
    """The cell's per-layer metrics that found something to read."""
    from avbench.harness import spec

    out = {}
    for m in spec.metrics_of(bench, name, "per_layer"):
        mod = spec.metric(m["name"])
        if (mod.LAYER, mod.MOVES, mod.SOURCE) != (m["layer"], m["moves"], m["source"]):
            raise spec.SpecError(f"metrics/{m['name']}.py disagrees with BENCHMARK.json")
        value = mod.read(readings)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None, device=None) -> int:
    """One run; `device` given (a test on the CPU) skips the look for cards."""
    args = parse(argv)
    from avbench.harness import spec

    bench = spec.benchmark()
    entry = spec.workload_entry(bench, args.workload)
    cell = spec.workload(args.workload)
    if cell["config"] != entry["config"]:
        raise spec.SpecError(f"workloads/{args.workload}.json names config {cell['config']!r}, "
                             f"BENCHMARK.json {entry['config']!r}")
    config = spec.config(entry["config"])

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"avbench: {args.workload} needs {entry['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    ctx = Context(args, entry, cell, config, device)
    out = spec.kind(cell["kind"]).run(ctx)

    found = forbidden_modules()
    if found:
        print(f"avbench: the process holds {', '.join(found)}", file=sys.stderr)
        return 4

    if args.trace:
        readings = dict(out["readings"], config=config, cell=cell)
        metrics = per_layer(bench, args.workload, readings)
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in spec.metrics_of(bench, args.workload, "end_to_end")}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": int(entry["chips"]), "memory_peak_bytes": int(out["memory_peak"])}
    result = {"correct": None, "attempted": int(out["attempted"]), "failed": int(out["failed"]),
              "metrics": metrics, "device": dev}
    trace = out.get("trace")
    if args.trace and trace is not None:
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
        result["breakdown"] = trace.breakdown()
    checks = out["checks"]
    result["correct"] = bool(all(c.ok for c in checks) and out["failed"] == 0)
    result["checks"] = {c.name: {"value": _number(c.value), "limit": c.limit} for c in checks}
    print(json.dumps({"log": out.get("log", {})}), file=sys.stderr)
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
