#!/usr/bin/env python3
"""Where the time of the port's misalignment detector goes, on one GPU.

    python3 scripts/torch_detector_breakdown.py [--out detector_breakdown.json]

At full width with seeded random weights (numpy draws in the JAX layout,
through the weight bridges) and random data, on both paths (kernel flags on:
`AudioConfig.use_pallas` -> K5, and for the scorer `fused_conv_pool` -> K1;
both off: the plain compositions):
  * one detector train step at B=32 (`detector_train_step`: gather 32
    (clip, shift) pairs from a 64-clip bank on the device, shift -> power
    spectrogram -> MFCC statistics, detector forward and backward, Adam);
  * one scorer batch of 8 requests x 5 shifts (`MisalignmentScorer.
    score_payload_batch`: uint8 50x100 frames, preprocess, conv visual
    statistics, MFCC statistics of 40 rows, detector, probabilities back
    on the host).
Each is timed with CUDA events (warm-up first, median of 20) and profiled
with torch.profiler over 10 runs: device time per kernel name per run, busy
time, and the device's idle share of the profiled wall time. Needs a GPU;
prints one JSON object (and writes it to --out if given).
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

TOP = 15  # kernel names listed per profile; the rest are summed


def events_ms(fn, iters: int = 20) -> float:
    import torch

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


def profile(fn, n: int = 10) -> dict:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    per_kernel: dict = {}
    launches = 0
    for evt in prof.events():
        # device work only: a user annotation (e.g. "Optimizer.step#Adam.step")
        # is a range on the device's timeline, not a kernel
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            ms = evt.time_range.elapsed_us() / 1e3 / n
            per_kernel[evt.name] = per_kernel.get(evt.name, 0.0) + ms
            launches += 1
    busy = sum(per_kernel.values())
    ranked = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    top = dict(ranked[:TOP])
    if len(ranked) > TOP:
        top[f"other ({len(ranked) - TOP} names)"] = sum(v for _, v in ranked[TOP:])
    return {"runs": n, "wall_ms_per_run": wall_ms / n, "device_busy_ms_per_run": busy,
            "device_idle_share": max(0.0, 1.0 - busy / (wall_ms / n)),
            "device_ops_per_run": launches / n, "kernels_ms_per_run": top}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    from chip_smoke import (DET_SHIFTS, seeded_jax_layout_detector_params,
                            seeded_jax_layout_params, syllable_audio)

    from avsync_torch.config import AudioConfig, AvsyncConfig, ModelConfig
    from avsync_torch.features import FeatureBank, sample_shift_labels
    from avsync_torch.models.detector import MisalignmentDetector
    from avsync_torch.predictor import MisalignmentScorer
    from avsync_torch.train.detector_trainer import detector_train_step, make_detector_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg = AvsyncConfig(model=ModelConfig(fused_conv_pool=True), audio=AudioConfig(use_pallas=True))
    paths = {"kernels": cfg, "plain": AvsyncConfig()}
    r = np.random.default_rng(0)
    out = {"card": card, "torch": torch.__version__}

    # detector train step, B=32, from a 64-clip bank of 3 s clips
    n_clips, B, dim = 64, cfg.detector.batch_size, 2 * 6912 + 2 * cfg.audio.n_mfcc
    bank = FeatureBank(
        visual=torch.from_numpy(r.random((n_clips, dim - 40), np.float32)).to(dev),
        audio=torch.from_numpy(np.stack([syllable_audio(r, 48000)
                                         for _ in range(n_clips)])).to(dev),
        audio_lengths=torch.full((n_clips,), 48000, dtype=torch.int32, device=dev),
        fps=torch.full((n_clips,), 25.0, device=dev))
    vi, sh, lb = (torch.from_numpy(a[:B]).to(dev) for a in sample_shift_labels(
        n_clips, cfg.detector.max_shift_frames, 1, r))
    w = torch.ones(B, device=dev)
    det = cfg.detector
    out["train_step_B32"] = {}
    for name, c in paths.items():
        model = MisalignmentDetector(dim, det.hidden_dim, det.dropout,
                                     generator=torch.Generator().manual_seed(0)).to(dev)
        # lr 0: Adam runs its update, the weights stay, every step is alike
        opt = make_detector_optimizer(model.parameters(), 0.0, det.weight_decay)
        gen = torch.Generator(device=dev)

        def step(model=model, opt=opt, c=c, gen=gen):
            return detector_train_step(model, opt, bank, vi, sh, lb, w, c.audio,
                                       gen.manual_seed(0))

        out["train_step_B32"][name] = {"ms": events_ms(step), "profile": profile(step)}

    # scorer batch, 8 requests x 5 shifts
    lip = seeded_jax_layout_params(cfg, seed=0)
    det_params = seeded_jax_layout_detector_params(dim, det.hidden_dim, seed=1)
    frames = r.integers(0, 256, (8, 75, 50, 100), dtype=np.uint8)
    audio = np.stack([syllable_audio(r, 48000) for _ in range(8)])
    payload = (frames, audio, np.full(8, 48000, np.int32), np.full(8, 25.0, np.float32),
               np.tile(np.asarray(DET_SHIFTS, np.int32), (8, 1)))
    out["scorer_batch_8x5"] = {}
    for name, c in paths.items():
        scorer = MisalignmentScorer(config=c, device=dev, detector_params=det_params,
                                    lipnet_params=lip)

        def score(scorer=scorer):
            return scorer.score_payload_batch(payload)

        out["scorer_batch_8x5"][name] = {"ms": events_ms(score), "profile": profile(score)}

    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
