"""Find a serving cell's knee: offer a list of fixed rates in turn to one
warmed service and report, for each, what the cell's window would see.

    python3 avbench/sweep.py --workload <name> --seed <n> --seconds <s> --rates r1,r2,...

For each rate: an untraced open-loop window of `--seconds` (the answered
rate, `serve_p95_ms`, the p95 of the window's first and last quarter of
requests, the queue at the window's end, how late the client ran), then a
short traced window at the same rate for the device's idle share. One JSON
line per rate. The knee is the highest rate at which the answered rate
keeps within 2% of the offered rate and the queue does not grow over the
window; a cell's fixed rate is 0.8 of it, written into its file by hand.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from avbench.harness import spec, traffic
    from avbench.kinds import serve

    if not torch.cuda.is_available():
        print("avbench sweep: no CUDA device", file=sys.stderr)
        return 3

    class Ctx:
        cell = spec.workload(args.workload)
        config = spec.config(cell["config"])
        seed = args.seed
        device = torch.device("cuda", 0)

    su = serve.Setup(Ctx)
    for k, rate in enumerate(float(r) for r in args.rates.split(",")):
        sched = traffic.arrivals(Ctx.cell, rate, args.seconds, args.seed + k)
        got = serve.drive(su, sched, args.seconds)
        lat = got["latency_s"]
        q = len(lat) // 4
        short = traffic.arrivals(Ctx.cell, rate, 2.5, args.seed + 1000 + k)
        traced = serve.drive(su, short, 2.5, traced=(0.5, 0.3, 1.5))["trace"]
        print(json.dumps({
            "workload": args.workload, "offered_per_s": rate,
            "answered_per_s": got["answered_in_window"] / args.seconds,
            "serve_p95_ms": traffic.quantile(lat, 0.95) * 1e3,
            "p50_ms": traffic.quantile(lat, 0.5) * 1e3,
            "p95_first_quarter_ms": traffic.quantile(lat[:q], 0.95) * 1e3,
            "p95_last_quarter_ms": traffic.quantile(lat[-q:], 0.95) * 1e3,
            "queue_at_end": got["queue_at_end"], "failed": got["failed"],
            "client_late_p99_ms": got["late_p99_ms"],
            "idle_share": traced.idle_share(), "requests": int(np.size(lat))}), flush=True)
    su.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
