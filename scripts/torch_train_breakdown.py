#!/usr/bin/env python3
"""Where the time of the port's LipNet train step goes, on one GPU.

    python3 scripts/torch_train_breakdown.py [--out train_breakdown.json]

At the full default width (conv 32/64/96, BiGRU 256 x2, 50x100 crops, T=75,
B=8, dropout 0.5 as configured) with seeded random weights and a random
batch (uint8 frames through the device preprocess, GRID-length labels):
  * train step time (`train_step`: forward, CTC loss, backward, clipping,
    Adam) with both kernel flags on and with both off (the plain path),
    CUDA events, warm-up first, median of 20 (5 for the plain path);
  * with both flags on, a torch.profiler trace of 10 steps: device time per
    kernel name per step, and the device's idle share of the profiled wall
    time.
Needs a GPU; prints one JSON object (and writes it to --out if given).
"""

from __future__ import annotations

import argparse
import dataclasses
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
    from chip_smoke import seeded_jax_layout_params

    from avsync_torch.compat import lipnet_params_from_jax
    from avsync_torch.config import AvsyncConfig, ModelConfig
    from avsync_torch.models.lipnet import LipNet
    from avsync_torch.predictor import preprocess
    from avsync_torch.train.lipnet_trainer import make_optimizer, train_step

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True))
    state = lipnet_params_from_jax(seeded_jax_layout_params(cfg, seed=0))
    r = np.random.default_rng(0)
    B = 8
    frames = torch.from_numpy(r.integers(0, 256, (B, 75, 50, 100), dtype=np.uint8)).to(dev)
    lengths = r.integers(20, 31, B)
    labels = np.zeros((B, 40), np.int64)
    for i, n in enumerate(lengths):
        labels[i, :n] = r.integers(1, 38, n)
    batch = {"video": preprocess(frames, cfg), "labels": torch.from_numpy(labels).to(dev),
             "label_lengths": torch.from_numpy(lengths)}
    gen = torch.Generator(device=dev)

    def step_fn(model, opt):
        def run():
            gen.manual_seed(0)
            return train_step(model, opt, batch, 0.0, gen)
        return run

    def events_ms(fn, iters):
        for _ in range(2):
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

    out = {"card": card, "torch": torch.__version__, "batch": B, "train_step_ms": {}}
    models = {}
    for name, mcfg in (("kernels", cfg.model),
                       ("plain", dataclasses.replace(cfg.model, use_pallas_gru=False,
                                                     fused_conv_pool=False))):
        m = LipNet(mcfg, generator=torch.Generator())
        m.load_state_dict(state)
        m.to(dev)
        # lr 0: Adam runs its update, the weights stay, every step is alike
        models[name] = step_fn(m, make_optimizer(m.parameters(), 0.0))
        out["train_step_ms"][name] = events_ms(models[name], 20 if name == "kernels" else 5)

    run = models["kernels"]
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    n = 10
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run()
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
        "steps": n,
        "wall_ms_per_step": wall_ms / n,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / (wall_ms / n)),
        "kernels_ms_per_step": dict(sorted(per_kernel.items(), key=lambda kv: -kv[1])),
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
