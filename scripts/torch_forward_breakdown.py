#!/usr/bin/env python3
"""Where the time of the port's LipNet forward goes, on one GPU.

    python3 scripts/torch_forward_breakdown.py [--out breakdown.json]

At the full default width (conv 32/64/96, BiGRU 256 x2, 50x100 crops, T=75)
with seeded random weights, for batch sizes 1 and 8:
  * forward time with both kernel flags on and with both off (the plain
    path), CUDA events, warm-up first, median of 20;
  * one served batch end to end on the host clock: uint8 upload, device
    preprocess, forward, greedy decode to strings (median of 20);
  * with both flags on, a torch.profiler trace of 10 forwards at B=8: device
    time per kernel name, summed per forward, and the device's idle share of
    the profiled wall time.
Needs a GPU; prints one JSON object (and writes it to --out if given).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import seeded_jax_layout_params

    from avsync_torch.config import AvsyncConfig, ModelConfig
    from avsync_torch.predictor import LipReader

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    kernels_cfg = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True))
    plain_cfg = AvsyncConfig()
    params = seeded_jax_layout_params(kernels_cfg, seed=0)
    readers = {"kernels": LipReader(params=params, config=kernels_cfg, device=dev),
               "plain": LipReader(params=params, config=plain_cfg, device=dev)}
    r = np.random.default_rng(0)
    out = {"card": card, "torch": torch.__version__, "forward_ms": {}, "served_batch_ms": {}}

    def events_ms(fn, iters=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(iters):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return statistics.median(ts)

    for B in (1, 8):
        frames = r.integers(0, 256, (B, 75, 50, 100), dtype=np.uint8)
        for name, reader in readers.items():
            x = reader.preprocess_device(frames)
            out["forward_ms"][f"{name}_B{B}"] = events_ms(lambda: reader._logprobs(x))

            def served():
                t0 = time.perf_counter()
                reader._decode(reader._logprobs(reader.preprocess_device(frames)))
                return (time.perf_counter() - t0) * 1e3

            for _ in range(3):
                served()
            out["served_batch_ms"][f"{name}_B{B}"] = statistics.median(
                served() for _ in range(20))

    reader = readers["kernels"]
    x = reader.preprocess_device(r.integers(0, 256, (8, 75, 50, 100), dtype=np.uint8))
    for _ in range(3):
        reader._logprobs(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = 10
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            reader._logprobs(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel = {}
    for evt in prof.events():
        # device work only: a user annotation (e.g. "Optimizer.step#Adam.step")
        # is a range on the device's timeline, not a kernel
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            dur_ms = evt.time_range.elapsed_us() / 1e3
            per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + dur_ms / n
    busy = sum(per_kernel.values())
    out["profile_B8"] = {
        "forwards": n,
        "wall_ms_per_forward": wall_ms / n,
        "device_busy_ms_per_forward": busy,
        "device_idle_share": max(0.0, 1.0 - busy / (wall_ms / n)),
        "kernels_ms_per_forward": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])),
    }
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
