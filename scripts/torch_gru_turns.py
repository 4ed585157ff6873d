#!/usr/bin/env python3
"""K2 (`avsync_torch/csrc/gru_fwd.cu`, both directions) of this tree against
another tree's, in turns on one card.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_gru_turns.py --parent build/parent [--turns 2]

Each turn is a fresh process that builds its tree's kernel (into that
tree's build/) and times one launch at B=8, T=75, H=256 (CUDA events,
warm-up first, median of 20, five times); the turns run parent, this tree,
this tree, parent (repeated --turns / 2 times), so drift on the card falls
on both alike. Prints each turn's medians and, last, one JSON line with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TIMER = r"""
import json, statistics, sys
sys.path.insert(0, sys.argv[1])
import torch
from avsync_torch.ops.cuda import gru
dev = torch.device("cuda", 0)
g = torch.Generator().manual_seed(2)
B, T, H = 8, 75, 256
k = H ** -0.5
gis = [torch.randn(B, T, 3 * H, generator=g).to(dev) for _ in range(2)]
ws = [((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev) for _ in range(2)]
bs = [((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev) for _ in range(2)]
run = lambda: gru._launch(tuple(gis), tuple(ws), tuple(bs), 0b10)
meds = []
for _ in range(5):
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    times = []
    for _ in range(20):
        a = torch.cuda.Event(enable_timing=True); b = torch.cuda.Event(enable_timing=True)
        a.record(); run(); b.record(); b.synchronize()
        times.append(a.elapsed_time(b))
    meds.append(statistics.median(times))
print(json.dumps(meds))
"""


def turn(tree: str) -> list:
    out = subprocess.run([sys.executable, "-c", TIMER, os.path.abspath(tree)], check=True,
                         capture_output=True, text=True, cwd=tree).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="an unpacked tree of the other commit")
    ap.add_argument("--turns", type=int, default=2, help="pairs of (parent, this) turns")
    args = ap.parse_args()
    rows = {"parent": [], "this": []}
    order = []
    for i in range(args.turns):
        order += ["parent", "this"] if i % 2 == 0 else ["this", "parent"]
    for who in order:
        meds = turn(args.parent if who == "parent" else ROOT)
        rows[who] += meds
        print(f"{who}: K2 both directions B=8 T=75 H=256 ms per launch, medians of 20: "
              f"{[round(m, 4) for m in meds]}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, **{k: statistics.median(v) for k, v in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
