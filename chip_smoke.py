#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. card: nvidia-smi name and power limit, torch/CUDA versions, TF32 flags
     (both set off: the port computes in full fp32) and cuBLAS's bf16
     reduced-precision reduction (set off: bf16 products sum in f32);
  2. build: nvcc builds every kernel of the serving, training, detector and
     int8 serving paths from avsync_torch/csrc/ (one process per source,
     started together);
  3. kernels: each LipNet kernel (K1 conv1_pool, K2 gru_fwd, K3 gru_bwd, K4
     conv1_pool_bwd) against its plain PyTorch version on the card, at the
     main paths' shapes, at the batch sizes users train at (B = 16, 32 and
     128, full width) and at odd ones (K1 at its tile's edges, K2/K3 at
     every rows-per-cluster choice, at H = 264 and 512 through the generic
     instantiation and at H = 20 through the wrapper's padding), with the
     tolerance beside the max error; K1 equal to its plain version bit for
     bit at B=8 and 128, and for K1-K4 a repeat launch that must give the
     same bits (at B=8 and B=128); K1 and K4 also at the TF stack's conv1
     (B=8, T=75, 46x140, 3x3x3, 128 channels: a 7 x 35 tile, four channel
     groups in K4) and a ragged 50x138 at 100 channels, K1 bit for bit,
     K4 within its tolerance and bit-identical on a repeat;
     then kernel / plain / library times (CUDA events, warm-up first, median
     of 20 runs; K1 also at B=1, K2/K3 per step and once at H = 512) and the
     bound (least time the card could take: bytes over 3.35 TB/s or fp32
     operations over 67 TFLOP/s);
  4. serving slice: LipReader + TranscribeService at the full default width
     with both kernel flags on and seeded random weights (numpy draw in the
     JAX package's layout, through the weight bridge); 64 concurrent
     requests from 16 threads, half native 288x360 frames (heuristic mouth
     crop), half 50x100 crops. The four launch counters are zeroed just
     before and read just after; each batch must launch conv1_pool once and
     gru_fwd once per BiGRU layer, and no backward kernel. Log-probs are held
     against the same reader with both flags off (plain path, on the card);
  5. training slice: a GRID-layout corpus of (75, 50, 100) uint8 clips
     (and 3 s of audio each) from the port's `write_corpus`; `cli train` at
     full width with both kernel flags on for 2 epochs with a checkpoint (the
     second epoch over the device cache, as an epoch program), `--resume
     auto --device_cache on --remat --profile_dir` for a third (an epoch
     program with rematerialised blocks, traced), `cli test`; the counters
     zeroed before and checked after against the eager steps and captures
     taken;
     one step of the kernel path against the plain path (loss and every
     gradient); TF32 read from inside train_step's backward; the loss falling
     over 20 steps on one repeated batch; the train step's time on both paths;
  6. K5 mel_stats (a cluster of CTAs per clip) against its plain version at
     the detector's shapes (B = 1, 8, 32, 40, 512 at F=121, K=1025, M=128,
     C=20, n_valid 0, 1, 2, partial, F), on long audio (B=8 at F = 401 and
     1201) and odd shapes, a repeat launch bit-identical, a clip's row equal
     bit for bit at B = 1, 32 and 512, the wrapper's shared-memory count
     against the kernel's, and its times at B = 32 (a train step), 40 (a
     scorer batch of 8 x 5 shifts) and 512 (an eval chunk) at F=121 and at
     B=8, F=401, beside the plain version, the `use_pallas=False`
     composition and the bound;
  7. detector serving slice: MisalignmentScorer + SyncScoreService at full
     width with conv1's and the MFCC stage's kernel flags on, seeded random
     LipNet and detector weights through both bridges; 32 requests from 16
     threads with shifts (-10, -5, 0, 5, 10), half native frames, half crops,
     audio lengths from 0 to 48,000. Each batch must launch conv1_pool and
     mel_stats once and no GRU or backward kernel; probabilities held against
     the same scorer with both flags off, audio statistics against the XLA
     path;
  8. detector training slice: the training slice's corpus (with a sibling
     .wav per clip, following the mouth) and its trained LipNet; `cli
     misalign-train` (full batches through the epoch programs) for 2 epochs
     with a snapshot each, `cli misalign-eval` over shifts 5..20, launch
     counts against the banks, steps, eval batches and sweep rows; one
     detector step of the kernel path against the plain path; the loss
     falling over 20 steps on one repeated batch; the step's time on both
     paths;
  9. epoch programs: both trainers' whole-epoch CUDA-graph programs at full
     width against their eager loops from the same weights (LipNet B=8 over
     a fully cached 64-clip corpus from the port's `write_corpus`, S=8, at
     dropout 0 and 0.5; the detector B=32 over a 256-clip bank, train and
     eval): parameters, Adam state, losses, gradient norms and
     probabilities equal bit for bit; steps/s, wall and host ms per step
     and the device's idle share of each path; the kernels the replays
     launched, counted by name in a torch.profiler trace of a replayed
     epoch (a replay passes through no wrapper, so the counters see only
     the warm-up steps and the capture);
  10. serving daemon and artifacts, at full width with the seeded weights of
     phases 4 and 7 written as `.pth` through the bridges and the three
     serving kernel flags on: a. `cli export` on the card of a transcriber
     with static buckets 1, 2, 4, 8 (50x100 crops), one with a symbolic
     batch (288x360 frames, the heuristic ROI embedded) and a sync scorer
     with K = 5 shifts, export and load seconds; b. `cli serve --checkpoint
     --detector_checkpoint --port 0 --warmup --max_batch 8` as a child
     process: 64 /v1/transcribe requests (half native 288x360 frames, half
     50x100 crops) and 32 /v1/sync_score requests (audio 0 to 48,000
     samples) from 16 threads, transcripts equal to an in-process LipReader's
     (near ties aside), probabilities within 1e-4 of an in-process
     MisalignmentScorer's, batches of more than one row in /v1/stats, 400,
     404 and 413, then SIGTERM with requests in flight: each answers 200 and
     the process exits 0; c. `serve --artifact` (the static transcriber and
     the sync scorer) under the same load and checks, its requests all
     50x100 crops (an artifact takes the one geometry it was exported at; a
     288x360 request must get 400), and `ExportedTranscriber.call` log-probs
     of the static and the symbolic artifact within 1e-4 of the live
     reader's at B = 1, 3 and 8; d. in-process daemons, live and artifact,
     with the counters zeroed before and read after: per transcribe batch
     conv1_pool once and gru_fwd once per BiGRU layer, per sync batch
     conv1_pool and mel_stats once, no backward kernel; a profiler trace of
     one artifact call names K1 and K2, and K1 and K5; e. p50/p99 latency
     and clips/s of both loads, the first request's latency after
     --warmup, an artifact call against the live path at B = 1 and 8 (CUDA
     events); f. `cli test --beam 4` and `--beam 0` on phase 5's corpus and
     checkpoint (--beam 0 repeats phase 5's results);
  11. int8 serving: a. Q1 int8_conv_pool against its plain version, equal
     bit for bit (torch.equal), in each of its contracts (f32 or int8 in,
     f32 or int8 out), at LipNet's three conv blocks at full width (B = 1,
     8, 32: the frames per CTA differ) and at odd geometries (Cin = 1, 3,
     12, 16, 48, 64; odd H or W; a pooled row wider than any tile; T below
     the kernel's depth; exact-half ties; the largest accumulators), a
     repeat launch equal too; b. kernel, plain, library (im2col gather +
     `torch._int_mm` + the same dequant, ReLU and pool, held equal to Q1)
     and f32 cuDNN times per block at B=8 (CUDA events), each block in the
     contract the int8 forward gives it (conv1 f32 -> int8, conv2 int8 ->
     int8, conv3 int8 -> f32) beside its f32-contract time, and the bounds
     (int8 operations over 1,979 TOPS or the bytes the contract moves over
     3.35 TB/s); c. `cli quantize` on phase 5's corpus and checkpoint, `cli test
     --quantize int8` beside phase 5's f32 results, `cli infer --quantize
     int8` against a fresh int8 reader; d. `cli serve --quantize int8
     --qscales --warmup` (phase 10's weights, scales from `cli quantize`) as a
     child process under phase 10's 64 crops: transcripts equal an in-process
     int8 LipReader's on the same scales, p50/p99 and clips/s beside phase
     10's f32 daemon, SIGTERM drain; launches through an in-process int8
     daemon: per batch Q1 three times, K2 twice, K1 and the backward kernels
     never; e. the full-width int8 forward against the f32 forward at B=8
     within the JAX package's bounds (mean |d log-prob| < 0.05, argmax
     agreement >= 0.95), equal bit for bit to the same forward through
     three f32-contract launches (no int8 hand-off), both forwards' times,
     and a profiler trace of one int8 forward: Q1 three times, K2 twice, no
     other convolution and no separate quantize kernel;
  12. the front end, from GRID-size container files to the model input: a.
     the libav ingest's state (`ingest: built in X s (libavformat V)`, or
     `ingest: unavailable: <why>`; a failed build where pkg-config finds
     libav fails the run); 8 native 288x360 T=75 clips from the port's
     synthetic module (mouth at a known box) written as .mp4 with their
     audio through the port's mux (without the ingest: MJPG .avi through
     cv2, decoded by cv2) and as .npy, decoded back, ms per clip of each; b. TranscribeService at full width (K1, K2 on) over the 8 clips
     in each ROI mode (heuristic, variance, model, detector), the counters
     zeroed before and read after: per batch K1 once and K2 once per BiGRU
     layer; the boxes on the card equal the CPU's from the same frames (the
     localizer's within 1e-5, the gate's choice equal), their IoU with the
     known box; log-probs against the plain path (phase 4's tolerance); the
     ROI program's time per B=8 batch beside the forward's (CUDA events);
     c. `cli train` for 1 epoch on a native 288x360 corpus (.mp4 with the
     ingest) with --roi_mode variance --roi_host --device_cache on: K3 and
     K4 launch, the host crop's ms per batch, the device cache holds uint8
     crops; d. with the ingest, a sync request on an .mp4 scored with its
     own AAC audio: K1 and K5 once, probabilities against the plain path;
     without it, an MJPG .avi through cv2 with its sibling .wav; e. an
     exported artifact with the variance ROI embedded against the live
     reader at B = 1 and 8 (1e-4);
  13. the TF-family LipNet at its full default width (75 x 46 x 140
     standardized crops, conv 128/256/64 3x3x3, BiLSTM 256 x3, Dense 512 x2,
     32 outputs), seeded weights through `compat.tflipnet_params_from_jax`:
     a. Q1 at the TF stack's three blocks equal to its plain version bit for
     bit in every contract at B = 1 and 8 (a repeat too), their times at B=8
     beside the plain version, im2col + `_int_mm` and cuDNN f32, and the
     bounds; b. the f32 forward at B=8 on the card against the same module
     on the CPU (1e-4), its time and the BiLSTM stack's share of its device
     time from a profiler trace; c. `cli train --model_family tf` for 2
     epochs on a 56-clip 46x140 corpus (the second an epoch program), the
     snapshot naming the family, no hand kernel launched; the epoch program
     against the eager loop under `cudnn.deterministic` (bit for bit), steps/s
     and the idle share of both paths; d. `cli test`, `infer`, `quantize`,
     `test --quantize int8`, `infer --quantize int8` from that snapshot (every
     transcript in the TF alphabet); the int8 forward at B=8 within the JAX
     bounds of the f32 one, equal to three f32-contract launches, traced: Q1
     three times, no other convolution; e. `cli serve --model_family tf`,
     f32 and `--quantize int8 --qscales`, as child processes under 16 crops
     (transcripts equal in-process readers', SIGTERM drains), Q1 three times
     per batch through an in-process int8 daemon (the counters zeroed before,
     read after), `cli export` of the TF transcriber (seconds, bytes) against
     the live reader at B = 1 and 8 (1e-4); f. the same seeded weights under
     `fused_conv_pool` (conv1 on K1/K4) against the cuDNN route: the forward
     at B=8 (1e-4; K1 once), two epochs of the epoch program against the
     eager loop bit for bit (K1 and K4 once per eager step and capture, the
     first step's loss and gradient norm within 1e-5), `cli quantize`'s
     scales, `cli serve` as a child process (transcripts equal the cuDNN
     reader's) and an in-process daemon (K1 once per batch), `cli export`
     (1e-4 of the cuDNN reader at B = 1 and 8, K1 once per call);
  14. multi-device, at full width from phase 4's seeded weights, dropout 0,
     the ranks started by `parallel.multihost.spawn` (explicit rank, world
     and port; gloo when they share one card, NCCL with a card each; the
     route, world size and card count printed first): a. two eager runs of
     the default trainer, 3 steps, equal bits; b. DP (2, 1) at global B=16:
     after each of 3 steps the ranks' parameters equal bit for bit, K1 x1,
     K2 x2, K3 x2, K4 x1 per rank and step, losses within 1e-5 and
     parameters within 6 lr of one process on the same 16 rows, the step's
     wall ms per rank and the gradient all-reduce's ms; c. TP (1, 2) against
     DP (losses 1e-5, gathered parameters 6 lr, the sharded leaves' Adam
     moments half the rows); d. the DP epoch program (graph, all-reduce,
     graph) against the DP loop over 4 steps from a cached corpus, bit for
     bit; e. `cp_gru_recurrence` over 3 ranks (75 = 3 x 25, B=8, H=256)
     through K2 with h0 against K2 over the whole sequence, bit for bit, K2
     with no h0 against h0 = zeros; f. `cli train --distributed` as 2
     processes with torchrun's variables on phase 5's corpus, rank 0's
     snapshot through a one-process `cli test`; `serve --dp 2`'s reader on
     two cards (or why not); the deterministic graph step beside PERF.md's;
  15. bf16 compute (`--compute_dtype bfloat16`) at full width: a. K1-bf16
     equal to its plain version bit for bit at B = 8 and 128, K4-bf16's
     float32 sums within K4_TOL of its plain version's, a repeat of each the
     same bits; both timed at B=8 beside the f32 kernels, cuDNN's bf16 block
     and its autograd backward and the bf16 bound (989 TFLOP/s or the
     bytes); b. the bf16 forward at B=8 (phase 4's seeded weights, K1-bf16
     once, K2 twice) against the same module in bf16 on the CPU and the f32
     forward on the card (mean |d log-prob| < 0.05, argmax agreement >=
     0.95), both timed; c. `cli train --compute_dtype bfloat16` for 2 epochs
     on phase 5's corpus (the second an epoch program over the device cache),
     K1-K4 counted; the bf16 epoch program against its eager loop under
     cudnn.deterministic bit for bit on phase 9's corpus, steps/s and the
     idle share beside phase 9's f32 graph, K1-bf16, K4-bf16, K2 and K3
     counted by profiler name in a replayed epoch traced after a warm-up
     one (at least S, S, 2S, 2S, as phase 9 requires of the f32 replays);
     the loss falling over 20 steps; d. `cli test`, `infer`, `serve` (a
     child process under 16 crops, transcripts equal an in-process bf16
     reader's, SIGTERM drains) and `export` (the artifact against the live
     bf16 reader at B = 1 and 8) in bf16, and `test --quantize int8` on the
     bf16 snapshot; e. `misalign-train` (1 epoch) and `misalign-eval` with
     bf16 conv features (K1-bf16 and K5 launch), the sync scorer bf16 vs
     f32 (0.05); f. the TFLipNet class's bf16 forward at B=8 on phase 13's
     trained snapshot against the f32 forward the CLI builds under a bf16
     config (the bounds of b), timed, and 2 epochs of `cli train
     --model_family tf --compute_dtype bfloat16 --device_cache on`: a
     float32 model (parameters and log-probs) reading a bf16 cache, as the
     JAX CLI's TF commands compute in float32;
  16. int8 serving under bf16 compute, and the card's CLI defaults: a. Q1's
     bf16 epilogue (the kernel's bf16 flag) equal to its plain version
     bit for bit in each contract (f32 or int8 in, bf16 or int8 out) at
     LipNet's blocks (B = 1, 8, 32) and the TF stack's (B=8), a repeat
     equal; the three LipNet blocks at B=8 in their chain contracts timed
     beside f32 Q1, the plain version, im2col + `_int_mm` + the bf16
     epilogue and the bound; b. K2 with bf16 operands (the kernel's bf16 flag)
     at B=8, T=75, H=256: each step within K2_TOL of the plain version's
     step from the kernel's previous state, its whole-sequence distance
     beside the plain version's own card-vs-CPU distance, a repeat equal,
     timed beside f32 K2, the bound and a bf16 `torch.nn.GRU`; c. the
     int8-bf16 LipNet forward at full width (phase 4's weights, B=8):
     Q1-bf16 three times, K2-bf16 twice, nothing else; within the JAX
     int8 bounds of the bf16 forward and of the same forward on the CPU;
     the int8 hand-off equal to three bf16-contract blocks; timed beside the
     f32 int8 forward; d. `quantize` (phase 11's float32 scales),
     `test`/`infer --quantize int8` and `serve --quantize int8 --qscales`
     (a child process under 16 crops, SIGTERM drains) under
     `--compute_dtype bfloat16` on phase 5's checkpoint, launches per batch
     through an in-process daemon (Q1-bf16 x3, K2-bf16 x2); the TF family's
     commands and daemon on phase 13's snapshot, whose model is float32
     (float32 Q1 x3, no Q1-bf16, no K2); e. `cli test` with no dtype flag
     and no --config runs bf16 on the card (K1-bf16 by profiler name, no
     float32 K1), `--compute_dtype float32` and a float32 `--config` win;
     `cli test --model_family tf` with neither builds the float32 TF model
     (its JSON equal to `--compute_dtype float32`'s);
  17. the last JAX surfaces: a. K3 from an initial state h0 with its
     gradient dh0 (B=8, T=75, H=256, both directions) within K3_TOL /
     K3_SUM_TOL of its plain version, a repeat the same bits, the call
     without h0 equal to h0 = zeros bit for bit, both timed in turns beside
     phase 3's K3; b. the context-parallel chain's backward over 2 ranks
     sharing the card (B=8, T=74 = 2 x 37, H=256): dgi, dw_hh and db_hh
     (reduced over the ranks) against K3 over the whole sequence, the
     forward equal to K2's bit for bit, K2 and K3 once per rank and K3 from
     h0 on rank 1; c. `cli misalign-demo` on a 2-speaker corpus with phases 4
     and 7's seeded weights: no failed speaker, every file decodes to the
     clip's frames, the scores within 1e-4 of the in-process
     MisalignmentScorer's; d. `cli test` over those 2 ranks (f32 and
     `--quantize int8`) on phase 5's corpus and checkpoint: the JSON equal to
     the one-rank command's; e. `eval.cer_wer_batch` on the card equal to the
     CPU's;
  18. the mouth localizer's training (roi_mode='model''s weights): a. the
     JAX script's dataset (2,048 synthetic frames, host numpy) and 1500
     steps at B=128 on the card (`train.localizer_trainer`), into the
     smoke's workdir (never the repo's bundle): dataset and training
     seconds, steps/s, the final validation IoU; a warm step's wall ms, its
     device busy ms, idle share and kernels from a trace; b. one step on the card
     against the CPU from the same parameters, batch and augmentation draws
     (loss 1e-5 relative, each gradient 1e-3 of its largest magnitude); c.
     two 50-step runs from one seed, equal bits; d. the JAX package's
     accuracy gates (tests/test_localizer.py:54-123) on the card-trained
     weights, the bundled weights' figures beside them: a failed gate fails
     the smoke; e. the retrained bundle through `load_bundled_or_none(path=)`
     and roi_mode='model''s `make_roi_crop_fn` on phase 12's native clips:
     boxes card vs CPU within ROI_BOX_ATOL, the gate's choices equal;
  19. the kernels: a text line with the state of every TPU kernel of the
     JAX package (and Q1), and one JSON line with the measured numbers
     (launches from the training slices, the serving slices', the daemons',
     the graph replays', the front end's, the TF int8 daemon's and a DP
     rank's step beside them; Q1's times at the TF blocks; K1's and K4's
     bf16 instantiations as rows of their own, their launches from phase
     15's bf16 training, forward and detector runs; Q1's bf16 epilogue and
     K2's bf16-operand instantiation as rows of their own, their launches
     from phase 16's int8-bf16 daemon; K3 from h0 as a row of its own, its
     launches from phase 17's CP backward);
  20. the card's name/power line, then the status JSON as the last line.

The phases before 15 pass `--compute_dtype float32` to every command: the
card's CLI default is bf16 without `--config`.

Exits with 2 and prints no result without a GPU or outside a checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOPS = 67e12  # H100 SXM, fp32 outside the tensor cores

K1_TOL = dict(atol=1e-4, rtol=1e-4)  # tests/test_pallas_convpool.py
K2_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_pallas_gru.py
K3_TOL = dict(atol=1e-5, rtol=1e-4)  # dgi: tests/test_pallas_gru.py
# dW_hh, db_hh: sums over B*T = 600 (row, step) terms, in another order than
# the plain version's per-step matmuls
K3_SUM_TOL = dict(atol=1e-4, rtol=1e-4)
# K4's dW, db: sums over up to B*T*H/2*W/2 = 750,000 routed positions; the
# JAX package's own tolerance for this gradient (tests/test_pallas_convpool.py)
K4_TOL = dict(atol=1e-3, rtol=1e-4)
LIB_TOL = dict(atol=1e-4, rtol=1e-4)  # sanity check of a library yardstick
# cuDNN's wgrad sums each tap over all 6,000,000 pre-pool positions at B=8
# (zeros included) in its own order: a sanity check, not a kernel check
LIB_WGRAD_TOL = dict(atol=1e-2, rtol=1e-4)
SLICE_ATOL = 1e-4  # log-probs, kernel path vs plain path on the card
# the float32 phases' commands: without --config the card's CLI default is bf16
F32 = ["--compute_dtype", "float32"]
# one train step, kernel path vs plain path: loss to 1e-5 relative; each
# gradient to 1e-3 of its largest magnitude (fp32 sums over up to 10^6
# terms in another order, through two 75-step recurrences)
STEP_LOSS_RTOL, STEP_GRAD_RTOL = 1e-5, 1e-3
OVERFIT_LR, OVERFIT_STEPS = 1e-3, 20  # the repeated-batch check
K5_TOL = dict(atol=1e-4, rtol=1e-5)  # tests/test_pallas_mfcc.py:31
PROB_ATOL = 1e-4  # sync probabilities, kernel path vs plain path on the card
DET_SHIFTS = (-10, -5, 0, 5, 10)  # the detector serving slice's shifts per request
MAX_BATCH = 8  # the slice's TranscribeService(max_batch=8)
BUCKETS = (1, 2, 4, 8)  # the padded batch sizes it can form
# batch sizes users train LipNet at (`--batch_size 32`, the JAX bench's 128)
TRAIN_BATCHES = (16, 32, 128)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in ms with its launches queued behind a
    device-side spin (`torch.cuda._sleep`, ~0.5 ms), so the events time the
    device's work and not the host's launch: `time_ms` starts its clock when
    the device is idle, so it also holds the wrapper's host cost, which
    grows as the process accumulates threads and state."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(got, want, tol, what):
    import torch

    torch.cuda.synchronize()
    err = (got - want).abs().max().item() if got.numel() else 0.0
    ok = torch.allclose(got, want, **tol)
    print(f"  {what}: max_abs_err={err:.3e} tol(atol={tol['atol']}, rtol={tol['rtol']}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok or not torch.isfinite(got).all():
        raise SystemExit(f"kernel check failed: {what}")
    return err


# ---------------------------------------------------------------------------
# 3. kernels
# ---------------------------------------------------------------------------

# K1's and K4's extra cases beyond LipNet's: the TF stack's conv1 at its
# training shape (B=8, T=75, 46 x 140, 3x3x3, 128 channels) and a ragged
# frame (25 x 69 pooled) at 100 channels
TF_CONV1_SHAPES = [(8, 75, 46, 140, (3, 3, 3), 128), (2, 5, 50, 138, (3, 3, 3), 100)]


def check_conv1_pool(dev):
    import torch
    import torch.nn.functional as F

    from avsync_torch.ops.conv import fp32_convs
    from avsync_torch.ops.cuda import convpool

    g = torch.Generator(device="cpu").manual_seed(1)
    print("conv1_pool (K1) vs conv1_pool_ref:", flush=True)
    errs = []
    # every batch bucket the slice's TranscribeService(max_batch=8) can form,
    # at the serving shape, then odd shapes and the generic (untemplated)
    # path, then the tile's edges: a 27 x 51 pooled frame the 5 x 51 tile
    # does not divide, C = 20 and 9, a 100-wide pooled frame (two column
    # tiles), 77 frames against 52 chunks; then the TF stack's conv1 (a 7 x
    # 35 tile of its 23 x 70 frame, 128 channels) and a ragged 25 x 69 frame
    # at 100 channels
    shapes = [(B, 75, 50, 100, (3, 5, 5), 32) for B in BUCKETS + TRAIN_BATCHES]
    shapes += [(3, 7, 10, 18, (3, 3, 3), 5), (2, 4, 12, 70, (1, 3, 5), 7),
               (1, 1, 2, 2, (3, 5, 5), 32), (2, 5, 54, 102, (3, 5, 5), 32),
               (1, 3, 50, 100, (3, 5, 5), 20), (1, 3, 50, 100, (3, 5, 5), 9),
               (1, 2, 20, 200, (3, 5, 5), 9), (7, 11, 50, 100, (3, 5, 5), 32)]
    shapes += TF_CONV1_SHAPES
    for B, T, H, W, k, C in shapes:
        x = torch.rand(B, T, H, W, 1, generator=g).to(dev)
        bound = 1.0 / (k[0] * k[1] * k[2]) ** 0.5
        w = ((torch.rand(*k, 1, C, generator=g) * 2 - 1) * bound).to(dev)
        b = ((torch.rand(C, generator=g) * 2 - 1) * bound).to(dev)
        want = convpool.conv1_pool_ref(x, w, b)
        got = convpool.conv1_pool_fused(x, w, b)
        errs.append(max_err(got, want, K1_TOL,
                            f"B={B} T={T} {H}x{W} k={k} C={C} (B,T,H,W,C) layout"))
        x_n = x.permute(0, 4, 1, 2, 3)
        w_n = w.permute(4, 3, 0, 1, 2).contiguous()
        got_n = convpool.conv1_pool_block(x_n, w_n, b)
        errs.append(max_err(got_n, want.permute(0, 4, 1, 2, 3), K1_TOL,
                            f"B={B} T={T} {H}x{W} k={k} C={C} NCDHW layout"))
        if (B, T, H, W, C) in ((8, 75, 50, 100, 32), (128, 75, 50, 100, 32)) or C > 32:
            what = f"B={B} T={T} {H}x{W} C={C}"
            same_bits([got_n], [convpool.conv1_pool_block(x_n, w_n, b)], what)
            # the same fmaf chain per pre-pool value as the plain version
            if not (torch.equal(got_n, want.permute(0, 4, 1, 2, 3)) and torch.equal(got, want)):
                raise SystemExit(f"kernel check failed: K1 at {what} differs from its plain "
                                 "version in some bit")
            print(f"  {what}: equal to the plain version bit for bit in both layouts",
                  flush=True)
        del want, got, got_n

    # times at the serving path's shape: B=8, T=75, 50x100, C=32, k=(3,5,5)
    B, T, H, W, C = 8, 75, 50, 100, 32
    x = torch.rand(B, T, H, W, 1, generator=g).to(dev)
    w = ((torch.rand(3, 5, 5, 1, C, generator=g) * 2 - 1) * 0.115).to(dev)
    b = ((torch.rand(C, generator=g) * 2 - 1) * 0.115).to(dev)
    x_n, w_n = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()

    def library():
        with fp32_convs():
            return F.max_pool3d(F.relu(F.conv3d(x_n, w_n, b, padding=(1, 2, 2))), (1, 2, 2))

    max_err(library(), convpool.conv1_pool_block(x_n, w_n, b), LIB_TOL,
            "library conv3d+relu+pool vs kernel (yardstick sanity)")
    ms = time_ms(lambda: convpool.conv1_pool_block(x_n, w_n, b))
    plain = time_ms(lambda: convpool.conv1_pool_ref(x, w, b))
    lib_ms = time_ms(library)
    x1_n = x_n[:1]  # the serving path's smallest bucket
    ms_b1 = time_ms(lambda: convpool.conv1_pool_block(x1_n, w_n, b))
    n_pre = B * T * H * W * C
    n_bytes = 4 * (B * T * H * W + w.numel() + C + B * T * (H // 2) * (W // 2) * C)
    n_ops = n_pre * (2 * 75 + 2)  # 75 FMAs, bias add, pool compare per pre-pool value
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"  B=8 T=75 50x100 C=32: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.2f} GFLOP); B=1: kernel_ms={ms_b1:.4f}", flush=True)
    return dict(name="conv1_pool", route="cuda", source="avsync_torch/csrc/conv1_pool.cu",
                replaces="avsync/ops/pallas/convpool.py:100", max_abs_err=max(errs),
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                ms_B1=ms_b1, shape="B=8 T=75 50x100 C=32 k=3x5x5")


def check_gru(dev):
    import torch

    from avsync_torch.models.lipnet import BiGRU
    from avsync_torch.ops.cuda import gru

    g = torch.Generator(device="cpu").manual_seed(2)

    def case(B, T, H):
        k = 1.0 / H ** 0.5
        gi = torch.randn(B, T, 3 * H, generator=g).to(dev)
        w = ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev)
        b = ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)
        return gi, w, b

    print("gru_fwd (K2) vs gru_recurrence_ref:", flush=True)
    errs = []
    # the serving buckets, then ragged batch tiles and every rows-per-cluster
    # choice, then the generic kernel (H > 256) and a padded H (20 -> 24)
    shapes = [(B, 75, 256) for B in BUCKETS + (3, 5, 7, 9) + TRAIN_BATCHES]
    for B, T, H in shapes + [(12, 9, 256), (2, 5, 8), (9, 6, 40), (3, 7, 264), (5, 6, 512),
                             (3, 8, 20)]:
        gf, wf, bf = case(B, T, H)
        gb, wb, bb = case(B, T, H)
        want = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False),
                          gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
        got = gru.bigru_recurrence(gf, gb, wf, wb, bf, bb)
        errs.append(max_err(got, want, K2_TOL, f"both directions B={B} T={T} H={H}"))
        if (B, T) in ((8, 75), (128, 75)):
            same_bits([got], [gru.bigru_recurrence(gf, gb, wf, wb, bf, bb)], f"B={B} T={T} H={H}")
    for B, T, H in [(8, 1, 256), (8, 7, 256), (1, 75, 256)]:
        gi, w, b = case(B, T, H)
        for rev in (False, True):
            errs.append(max_err(gru.gru_recurrence(gi, w, b, rev),
                                gru.gru_recurrence_ref(gi, w, b, rev), K2_TOL,
                                f"{'reverse' if rev else 'forward'} B={B} T={T} H={H}"))
    gi, w, b = case(4, 6, 256)
    errs.append(max_err(gru.gru_recurrence(gi, w.t().contiguous().t(), b),
                        gru.gru_recurrence_ref(gi, w, b), K2_TOL,
                        "strided (transposed torch-layout) w_hh B=4 T=6 H=256"))

    # times at the serving path's shape: one BiGRU layer, B=8, T=75, H=256;
    # the kernel alone also at B=1, the serving path's smallest bucket
    B, T, H, D = 8, 75, 256, 6912
    gf, wf, bf = case(1, T, H)
    gb, wb, bb = case(1, T, H)
    ms_b1 = time_ms(lambda: gru.bigru_recurrence(gf, gb, wf, wb, bf, bb))
    gf, wf, bf = case(B, T, H)
    gb, wb, bb = case(B, T, H)
    ms = time_ms(lambda: gru.bigru_recurrence(gf, gb, wf, wb, bf, bb))
    ms_queued = queued_ms(lambda: gru.bigru_recurrence(gf, gb, wf, wb, bf, bb))
    plain = time_ms(lambda: (gru.gru_recurrence_ref(gf, wf, bf, False),
                             gru.gru_recurrence_ref(gb, wb, bb, True)))
    layer = BiGRU(D, H, use_kernel=True, generator=torch.Generator().manual_seed(3)).to(dev)
    cudnn = torch.nn.GRU(D, H, batch_first=True, bidirectional=True).to(dev)
    cudnn.load_state_dict(layer.state_dict())
    x = torch.randn(B, T, D, generator=g).to(dev)
    with torch.inference_mode():
        max_err(layer(x), cudnn(x)[0], LIB_TOL,
                "BiGRU layer (matmuls + kernel) vs torch.nn.GRU (yardstick sanity)")
        layer_ms = time_ms(lambda: layer(x))
        lib_ms = time_ms(lambda: cudnn(x))
    n_bytes = 4 * 2 * (B * T * 3 * H + H * 3 * H + 3 * H + B * T * H)
    n_ops = 2 * (2 * B * T * H * 3 * H + 12 * B * T * H)  # h W_hh, then the gates
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"  both directions B=8 T=75 H=256: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"bound_ms={bms:.4f} ({by}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP) "
          f"per_step_us={ms / T * 1e3:.2f} (launch queued behind a spin: {ms_queued:.4f}); "
          f"B=1: kernel_ms={ms_b1:.4f} "
          f"per_step_us={ms_b1 / T * 1e3:.2f}", flush=True)
    print(f"  BiGRU layer D=6912: port (2 matmuls + kernel) layer_ms={layer_ms:.4f} "
          f"torch.nn.GRU library_ms={lib_ms:.4f}", flush=True)
    # the generic kernel, once, at H = 512 (correctness first: not tuned)
    gf, wf, bf = case(B, T, 512)
    gb, wb, bb = case(B, T, 512)
    ms_h512 = time_ms(lambda: gru.bigru_recurrence(gf, gb, wf, wb, bf, bb), iters=3, warmup=1)
    print(f"  generic kernel, both directions B=8 T=75 H=512: kernel_ms={ms_h512:.4f}",
          flush=True)
    return dict(name="gru_fwd", route="cuda", source="avsync_torch/csrc/gru_fwd.cu",
                replaces="avsync/ops/pallas/gru.py:357", max_abs_err=max(errs),
                ms=ms, queued_ms=ms_queued, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib_ms, layer_ms=layer_ms, shape="both directions B=8 T=75 H=256",
                per_step_us=ms / T * 1e3, ms_B1=ms_b1, per_step_us_B1=ms_b1 / T * 1e3,
                ms_H512=ms_h512,
                library_note="library_ms and layer_ms time the whole BiGRU layer "
                             "(D=6912): torch.nn.GRU vs the port's matmuls + kernel")


def same_bits(first, second, what):
    """A second launch on the same inputs must give the same bits (no float
    atomics: every sum is taken in a fixed order)."""
    import torch

    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(first, second)):
        raise SystemExit(f"kernel check failed: {what}: a repeat launch differs")
    print(f"  {what}: repeat launch bit-identical", flush=True)


def check_gru_bwd(dev):
    import torch

    from avsync_torch.models.lipnet import BiGRU
    from avsync_torch.ops.cuda import gru

    g = torch.Generator(device="cpu").manual_seed(4)

    def case(B, T, H):
        k = 1.0 / H ** 0.5
        args = []
        for _ in range(2):  # forward, backward direction
            args += [torch.randn(B, T, 3 * H, generator=g).to(dev),
                     ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev),
                     ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)]
        gf, wf, bf, gb, wb, bb = args
        out = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False),
                         gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
        cot = torch.randn(B, T, 2 * H, generator=g).to(dev)
        return (gf, gb, out, cot, wf, wb, bf, bb), H

    def plain(args, H):
        gf, gb, out, cot, wf, wb, bf, bb = args
        f = gru.gru_recurrence_bwd_ref(gf, out[..., :H], cot[..., :H], wf, bf, False)
        b = gru.gru_recurrence_bwd_ref(gb, out[..., H:], cot[..., H:], wb, bb, True)
        return f[0], b[0], f[1], b[1], f[2], b[2]

    print("gru_bwd (K3) vs gru_recurrence_bwd_ref:", flush=True)
    errs = []
    # the buckets, ragged batch tiles and every rows-per-cluster choice, short
    # T, then the generic chain (H > 256) and a padded H (20 -> 24)
    shapes = [(B, 75, 256) for B in BUCKETS + (3, 5, 7, 9, 12) + TRAIN_BATCHES]
    for B, T, H in shapes + [(8, 1, 256), (8, 7, 256), (2, 5, 8), (3, 7, 264), (5, 6, 512),
                             (3, 8, 20)]:
        args, H = case(B, T, H)
        got = gru.bigru_recurrence_bwd(*args)
        for i, want in enumerate(plain(args, H)):
            what = ("dgi", "dgi", "dw_hh", "dw_hh", "db_hh", "db_hh")[i]
            errs.append(max_err(got[i], want, K3_TOL if i < 2 else K3_SUM_TOL,
                                f"{what} {'fwd' if i % 2 == 0 else 'rev'} B={B} T={T} H={H}"))
        if (B, T) in ((8, 75), (16, 75), (128, 75)):
            same_bits(got, gru.bigru_recurrence_bwd(*args), f"B={B} T={T} H={H}")

    # times at the training path's shape: one BiGRU layer, B=8, T=75, H=256
    B, T, H, D = 8, 75, 256, 6912
    args, _ = case(B, T, H)
    ms = time_ms(lambda: gru.bigru_recurrence_bwd(*args))
    ms_q = queued_ms(lambda: gru.bigru_recurrence_bwd(*args))
    plain_ms = time_ms(lambda: plain(args, H), iters=5, warmup=1)
    layer = BiGRU(D, H, use_kernel=True, generator=torch.Generator().manual_seed(5)).to(dev)
    cudnn = torch.nn.GRU(D, H, batch_first=True, bidirectional=True).to(dev)
    cudnn.load_state_dict(layer.state_dict())
    x = torch.randn(B, T, D, generator=g).to(dev).requires_grad_()
    cot = torch.randn(B, T, 2 * H, generator=g).to(dev)
    y_port, y_lib = layer(x), cudnn(x)[0]
    max_err(y_port, y_lib, LIB_TOL, "BiGRU layer vs torch.nn.GRU forward (yardstick sanity)")
    ins_port, ins_lib = [x, *layer.parameters()], [x, *cudnn.parameters()]
    gp = torch.autograd.grad(y_port, ins_port, cot, retain_graph=True)
    gl = torch.autograd.grad(y_lib, ins_lib, cot, retain_graph=True)
    max_err(gp[0], gl[0], LIB_TOL, "BiGRU layer vs torch.nn.GRU dx (yardstick sanity)")
    layer_ms = time_ms(lambda: torch.autograd.grad(y_port, ins_port, cot, retain_graph=True))
    lib_ms = time_ms(lambda: torch.autograd.grad(y_lib, ins_lib, cot, retain_graph=True))
    # each direction: gi, out, g, w_hh, b_hh read once; dgi, dw_hh, db_hh written once
    n_bytes = 4 * 2 * (B * T * 3 * H + 2 * B * T * H + H * 3 * H + 3 * H
                       + B * T * 3 * H + H * 3 * H + 3 * H)
    # each direction: three (B*T, H) x (H, 3H)-shaped products (gh recompute,
    # dgh W_hh^T, dW_hh) and about 30 operations of gate math per (row, step, unit)
    n_ops = 2 * (3 * 2 * B * T * H * 3 * H + 30 * B * T * H)
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"  both directions B=8 T=75 H=256: kernel_ms={ms:.4f} (queued {ms_q:.4f}) "
          f"plain_ms={plain_ms:.4f} bound_ms={bms:.4f} ({by}: {n_bytes / 1e6:.2f} MB, "
          f"{n_ops / 1e9:.3f} GFLOP) per_step_us={ms / T * 1e3:.2f}", flush=True)
    print(f"  BiGRU layer backward D=6912: port (matmuls + kernel) layer_ms={layer_ms:.4f} "
          f"torch.nn.GRU library_ms={lib_ms:.4f}", flush=True)
    # the generic chain, once, at H = 512 (correctness first: not tuned)
    args512, _ = case(B, T, 512)
    ms_h512 = time_ms(lambda: gru.bigru_recurrence_bwd(*args512), iters=3, warmup=1)
    print(f"  generic chain, both directions B=8 T=75 H=512: kernel_ms={ms_h512:.4f}",
          flush=True)
    return dict(name="gru_bwd", route="cuda", source="avsync_torch/csrc/gru_bwd.cu",
                replaces="avsync/ops/pallas/gru.py:276", max_abs_err=max(errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                queued_ms=ms_q, layer_ms=layer_ms, shape="both directions B=8 T=75 H=256",
                per_step_us=ms / T * 1e3, ms_H512=ms_h512,
                library_note="library_ms and layer_ms time the whole BiGRU layer's "
                             "backward (D=6912, dx and every weight): torch.nn.GRU vs "
                             "the port's matmuls + kernel")


def check_conv1_pool_bwd(dev):
    import torch
    import torch.nn.functional as F

    from avsync_torch.ops.conv import fp32_convs
    from avsync_torch.ops.cuda import convpool

    g = torch.Generator(device="cpu").manual_seed(6)

    def case(B, T, H, W, k, C):
        bound = 1.0 / (k[0] * k[1] * k[2]) ** 0.5
        x = torch.rand(B, T, H, W, 1, generator=g).to(dev)
        w = ((torch.rand(*k, 1, C, generator=g) * 2 - 1) * bound).to(dev)
        b = ((torch.rand(C, generator=g) * 2 - 1) * bound).to(dev)
        cot = torch.randn(B, T, H // 2, W // 2, C, generator=g).to(dev)
        return x, w, b, cot

    print("conv1_pool_bwd (K4) vs conv1_pool_bwd_ref:", flush=True)
    errs = []
    # at B=128 a frame chunk's running sum takes ~185 frames (12 at B=8)
    shapes = [(B, 75, 50, 100, (3, 5, 5), 32) for B in BUCKETS + TRAIN_BATCHES]
    shapes += [(3, 7, 10, 18, (3, 3, 3), 5), (2, 4, 12, 70, (1, 3, 5), 7),
               (1, 1, 2, 2, (3, 5, 5), 32),
               # a pooled frame (27 x 51) the tile does not divide; 77 frames
               # against 52 chunks; C < 32 at full width; columns past one tile
               (2, 5, 54, 102, (3, 5, 5), 32), (7, 11, 50, 100, (3, 5, 5), 32),
               (1, 3, 50, 100, (3, 5, 5), 20), (1, 2, 20, 200, (3, 5, 5), 9)]
    # the TF stack's conv1 (four channel groups over a 7 x 35 tile, PS = 8 at
    # 27 taps) and a ragged frame whose last group holds 4 channels
    shapes += TF_CONV1_SHAPES
    for B, T, H, W, k, C in shapes:
        x, w, b, cot = case(B, T, H, W, k, C)
        want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
        got = convpool.conv1_pool_bwd(x, w, b, cot)
        for name, a, r in zip(("dkernel", "dbias"), got, want):
            errs.append(max_err(a, r, K4_TOL, f"{name} B={B} T={T} {H}x{W} k={k} C={C}"))
        got_n = convpool.conv1_pool_block_bwd(x.permute(0, 4, 1, 2, 3),
                                              w.permute(4, 3, 0, 1, 2).contiguous(), b,
                                              cot.permute(0, 4, 1, 2, 3))
        errs.append(max_err(got_n[0], want[0].permute(4, 3, 0, 1, 2), K4_TOL,
                            f"dweight B={B} T={T} {H}x{W} k={k} C={C} NCDHW layout"))
        if (B in (8, 128) and T == 75) or C > 32:
            same_bits(got, convpool.conv1_pool_bwd(x, w, b, cot), f"B={B} T={T} {H}x{W} C={C}")
        if B == 128:  # kernel and plain version against float64 sums on the same routing
            f64 = [torch.zeros_like(r, dtype=torch.float64) for r in want]
            for i in range(0, B, 16):
                for acc, part in zip(f64, convpool.conv1_pool_bwd_ref(
                        x[i:i + 16], w, b, cot[i:i + 16], sum_dtype=torch.float64)):
                    acc += part
            for name, a, r, ref in zip(("dkernel", "dbias"), got, want, f64):
                max_err(a.double(), ref, K4_TOL, f"{name} B={B}: kernel vs float64 sums")
                max_err(r.double(), ref, K4_TOL, f"{name} B={B}: plain version vs float64 sums")
        del want, got, got_n
    # the tie case: constant input, every interior pool window a 4-way tie;
    # the gradient goes to the first window position
    x = torch.ones(1, 3, 4, 4, 1, device=dev)
    w = (torch.rand(3, 3, 3, 1, 2, generator=g) - 0.2).to(dev)
    b = torch.rand(2, generator=g).to(dev)
    cot = 2 * convpool.conv1_pool_ref(x, w, b)
    for name, a, r in zip(("dkernel", "dbias"), convpool.conv1_pool_bwd(x, w, b, cot),
                          convpool.conv1_pool_bwd_ref(x, w, b, cot)):
        errs.append(max_err(a, r, K4_TOL, f"{name} tie case (constant input)"))
    # near ties: input 1 + 1e-7 noise and weights of one sign put the four
    # pre-pool values of most windows within a few ulp; on a cotangent that
    # is nonzero only where K1 pooled a positive value, db is its channel
    # sum exactly when K4 routes where the forward pooled
    x = (1.0 + 1e-7 * torch.rand(2, 6, 50, 100, 1, generator=g)).to(dev)
    w = (0.01 + 0.001 * torch.rand(3, 5, 5, 1, 32, generator=g)).to(dev)
    b = (torch.rand(32, generator=g) - 0.6).to(dev)
    pooled = convpool.conv1_pool_fused(x, w, b)
    cot = torch.randn(2, 6, 25, 50, 32, generator=g).to(dev) * (pooled > 0)
    got = convpool.conv1_pool_bwd(x, w, b, cot)
    for name, a, r in zip(("dkernel", "dbias"), got, convpool.conv1_pool_bwd_ref(x, w, b, cot)):
        errs.append(max_err(a, r, K4_TOL, f"{name} near-tie case"))
    errs.append(max_err(got[1], cot.sum(dim=(0, 1, 2, 3)), K4_TOL,
                        "dbias near-tie case vs the cotangent's sum where K1 > 0 (routing)"))

    # times at the training path's shape: B=8, T=75, 50x100, C=32, k=(3,5,5)
    B, T, H, W, C, taps = 8, 75, 50, 100, 32, 75
    x, w, b, cot = case(B, T, H, W, (3, 5, 5), C)
    x_n, w_n = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
    cot_n = cot.permute(0, 4, 1, 2, 3)
    ms = time_ms(lambda: convpool.conv1_pool_block_bwd(x_n, w_n, b, cot_n))
    plain_ms = time_ms(lambda: convpool.conv1_pool_bwd_ref(x, w, b, cot), iters=5, warmup=1)
    wl, bl = w_n.clone().requires_grad_(), b.clone().requires_grad_()
    with fp32_convs():
        y_lib = F.max_pool3d(F.relu(F.conv3d(x_n, wl, bl, padding=(1, 2, 2))), (1, 2, 2))

    def library():
        with fp32_convs():
            return torch.autograd.grad(y_lib, (wl, bl), cot_n, retain_graph=True)

    lib = library()
    max_err(lib[0], convpool.conv1_pool_block_bwd(x_n, w_n, b, cot_n)[0], LIB_WGRAD_TOL,
            "library wgrad of conv3d+relu+pool vs kernel (yardstick sanity)")
    lib_ms = time_ms(library)
    # the routed positions are this run's data: pooled values whose max
    # pre-activation is > 0 (the others route nothing)
    routed = int((convpool.conv1_pool_ref(x, w, b) > 0).sum().item())
    n_pre = B * T * H * W * C
    n_ops = n_pre * (2 * taps + 2) + routed * (2 * taps + 1)
    n_bytes = 4 * (B * T * H * W + B * T * (H // 2) * (W // 2) * C + 2 * (taps * C + C))
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"  B=8 T=75 50x100 C=32: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.2f} GFLOP; {routed} of {B * T * (H // 2) * (W // 2) * C} "
          f"pooled values routed)", flush=True)
    return dict(name="conv1_pool_bwd", route="cuda",
                source="avsync_torch/csrc/conv1_pool_bwd.cu",
                replaces="avsync/ops/pallas/convpool.py:244", max_abs_err=max(errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                shape="B=8 T=75 50x100 C=32 k=3x5x5",
                library_note="library_ms: torch.autograd.grad of cuDNN "
                             "max_pool3d(relu(conv3d)) w.r.t. (w, b), TF32 off, graph "
                             "built once")


# ---------------------------------------------------------------------------
# 4. slice
# ---------------------------------------------------------------------------

def seeded_jax_layout_params(cfg, seed: int):
    """LipNet weights as the JAX package lays them out, drawn with numpy."""
    import numpy as np

    r = np.random.default_rng(seed)
    m = cfg.model
    params = {}
    cin, h, w = 1, cfg.data.img_height, cfg.data.img_width
    for i, (ch, k) in enumerate(zip(m.conv_channels, m.conv_kernels)):
        fan_in = cin * k[0] * k[1] * k[2]
        params[f"conv{i + 1}"] = {
            "kernel": r.normal(0, fan_in ** -0.5, (*k, cin, ch)).astype(np.float32),
            "bias": r.normal(0, 0.01, (ch,)).astype(np.float32),
        }
        cin, h, w = ch, h // 2, w // 2
    dim, H = cin * h * w, m.hidden_dim
    for gidx in range(m.num_gru_layers):
        layer = {}
        for name in ("fwd", "bwd"):
            for pname, shape in (("w_ih", (dim, 3 * H)), ("w_hh", (H, 3 * H)),
                                 ("b_ih", (3 * H,)), ("b_hh", (3 * H,))):
                layer[f"{pname}_{name}"] = r.uniform(-H ** -0.5, H ** -0.5, shape).astype(
                    np.float32)
        params[f"gru{gidx + 1}"] = layer
        dim = 2 * H
    params["fc"] = {"kernel": r.uniform(-dim ** -0.5, dim ** -0.5, (dim, m.vocab_size)).astype(
        np.float32), "bias": np.zeros(m.vocab_size, np.float32)}
    return params


def run_slice(dev):
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
    from avsync_torch.predictor import LipReader
    from avsync_torch.serving import TranscribeService

    cfg = AvsyncConfig(data=DataConfig(), model=ModelConfig(use_pallas_gru=True,
                                                            fused_conv_pool=True))
    plain_cfg = dataclasses.replace(cfg, model=ModelConfig())
    params = seeded_jax_layout_params(cfg, seed=0)
    reader = LipReader(params=params, config=cfg, device=dev)
    plain = LipReader(params=params, config=plain_cfg, device=dev)
    if not (reader.model.conv1.fused and reader.model.gru1.use_kernel):
        raise SystemExit("the slice's reader does not route through both kernels")
    svc = TranscribeService(reader, max_batch=MAX_BATCH, max_wait_ms=5.0)
    t0 = time.perf_counter()
    svc.warmup()
    svc.warmup(np.zeros((75, 288, 360), np.uint8))
    torch.cuda.synchronize()
    print(f"slice: full width (conv 32/64/96, BiGRU 256 x2, 50x100, T=75), "
          f"warmup {time.perf_counter() - t0:.2f} s", flush=True)

    r = np.random.default_rng(7)
    n_req, n_threads = 64, 16
    clips = [r.integers(0, 256, (75, 288, 360), dtype=np.uint8) if i % 2 == 0
             else r.integers(0, 256, (75, 50, 100), dtype=np.uint8) for i in range(n_req)]
    answers = [None] * n_req
    errors = []

    def client(tid):
        try:
            for i in range(tid, n_req, n_threads):
                answers[i] = svc.transcribe_frames(clips[i], timeout=300)
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    zero_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    got = counts()
    k1, k2 = got["conv1_pool"], got["gru_fwd"]
    if errors or any(t.is_alive() for t in threads) or any(a is None for a in answers):
        raise SystemExit(f"serving failed: {errors}")
    stats = svc.stats.snapshot()
    svc.close()
    n_batches = sum(stats["batches"].values())
    n_layers = cfg.model.num_gru_layers
    print(f"  requests={stats['requests']} threads={n_threads} batches={stats['batches']} "
          f"p50_ms={stats['latency_ms']['p50']} p99_ms={stats['latency_ms']['p99']} "
          f"clips_per_s={n_req / wall:.2f} wall_s={wall:.3f}", flush=True)
    print(f"  launches: conv1_pool={k1} (expected {n_batches}), gru_fwd={k2} "
          f"(expected {n_layers * n_batches}), gru_bwd={got['gru_bwd']} and "
          f"conv1_pool_bwd={got['conv1_pool_bwd']} (expected 0: serving runs no backward)",
          flush=True)
    if (stats["requests"] != n_req or k1 != n_batches or k2 != n_layers * n_batches
            or got["gru_bwd"] or got["conv1_pool_bwd"] or got["mel_stats"]):
        raise SystemExit("launch counts do not match the batches served")
    if not set(stats["batches"]) <= set(BUCKETS):
        raise SystemExit(f"a batch size outside the checked buckets {BUCKETS}")

    # against the plain path on the card, same clips, same batched preprocess
    worst, near_ties = 0.0, []
    for start in (0, 1):
        frames = np.stack([clips[i] for i in range(start, n_req, 2)])
        for lo in range(0, len(frames), 8):
            x = reader.preprocess_device(frames[lo:lo + 8])
            lp_k = reader._logprobs(x)
            lp_p = plain._logprobs(x)
            torch.cuda.synchronize()
            if lp_k.shape != (x.shape[0], 75, 39) or not torch.isfinite(lp_k).all():
                raise SystemExit(f"bad log-probs {tuple(lp_k.shape)}")
            worst = max(worst, (lp_k - lp_p).abs().max().item())
            top2 = lp_p.topk(2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
            texts_k, texts_p = reader._decode(lp_k), plain._decode(lp_p)
            for j in range(x.shape[0]):
                i = start + 2 * (lo + j)
                if texts_k[j] != answers[i]:
                    raise SystemExit(f"request {i}: service answer differs from the reader")
                if texts_k[j] != texts_p[j]:
                    frames_close = np.nonzero(margin[j] < 2 * SLICE_ATOL)[0].tolist()
                    if not frames_close:
                        raise SystemExit(f"request {i}: kernel and plain transcripts differ")
                    near_ties.append((i, frames_close))
    print(f"  log-probs kernel path vs plain path: max_abs_err={worst:.3e} "
          f"(tol {SLICE_ATOL}) {'ok' if worst <= SLICE_ATOL else 'FAIL'}; "
          f"transcripts equal except near-ties: {near_ties}", flush=True)
    if worst > SLICE_ATOL:
        raise SystemExit("kernel path disagrees with the plain path")
    print(f"  sample transcripts: {answers[0]!r} (native), {answers[1]!r} (crop)", flush=True)
    return k1, k2


# ---------------------------------------------------------------------------
# 5. training slice
# ---------------------------------------------------------------------------

def syllable_audio(r, n: int):
    """n samples of noise under a syllable-rate envelope (2-5 Hz), numpy."""
    import numpy as np

    t = np.arange(n) / 16000.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * r.uniform(2.0, 5.0) * t + r.uniform(0, 2 * np.pi))
    return (0.3 * env ** 2 * r.standard_normal(n)).astype(np.float32)


def write_grid_corpus(root: str, n_speakers: int, clips: int, seed: int):
    """A GRID-layout corpus (<root>/sN/video/*.npy + *.wav, <root>/sN/align/)
    from the port's `write_corpus`: (75, 50, 100) uint8 mouth crops whose
    mouth opens with a per-phrase envelope, GRID-grammar transcripts, and a
    sibling 3 s, 16 kHz .wav per clip whose amplitude follows the same
    envelope, so a detector can learn the alignment."""
    from avsync_torch.data.synthetic import write_corpus

    write_corpus(root, n_speakers=n_speakers, clips_per_speaker=clips, layout="standard",
                 seed=seed)


def program_wrapper_calls(S: int, runs: int) -> int:
    """Wrapper calls of an epoch program of S steps run `runs` times (one
    trainer): its first run takes WARMUP_STEPS eager steps and, when steps
    remain, one capture; later runs only replay. With no step left for a
    capture every run is eager."""
    from avsync_torch.train.epoch_program import WARMUP_STEPS

    warm = min(WARMUP_STEPS, S)
    return warm + 1 if S > warm else S * runs


def counts():
    from avsync_torch.ops.cuda import convpool, gru, mfcc

    return {"conv1_pool": convpool.launches, "gru_fwd": gru.launches,
            "gru_bwd": gru.bwd_launches, "conv1_pool_bwd": convpool.bwd_launches,
            "mel_stats": mfcc.launches}


def zero_counts():
    from avsync_torch.ops.cuda import convpool, gru, mfcc, quantconv

    convpool.launches = convpool.bwd_launches = gru.launches = gru.bwd_launches = 0
    gru.bwd_h0_launches = 0
    mfcc.launches = quantconv.launches = quantconv.bf16_launches = gru.bf16_launches = 0


def run_training(dev, workdir: str):
    """The port's `cli train` at full width with both kernel flags on: two
    epochs and a checkpoint, `--resume auto` for a third, then `cli test`.
    Then one step of the kernel path against the plain path, TF32 seen from
    inside a backward, the loss falling on one repeated batch, and the train
    step's time on both paths."""
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.config import AvsyncConfig, ModelConfig, TrainConfig
    from avsync_torch.data.grid import GridDataSource, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.models.lipnet import LipNet
    from avsync_torch.ops.ctc import ctc_loss_mean
    from avsync_torch.train.epoch_program import WARMUP_STEPS
    from avsync_torch.ops.conv import fp32_step
    from avsync_torch.train.lipnet_trainer import (device_batch, make_optimizer,
                                                   train_step)

    data, ck = os.path.join(workdir, "grid"), os.path.join(workdir, "ckpt")
    n_speakers, clips = 7, 8  # split 4 / 1 / 2 speakers: 4 train batches of 8
    t0 = time.perf_counter()
    write_grid_corpus(data, n_speakers, clips, seed=11)
    cfg = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True),
                       train=TrainConfig(checkpoint_every=2, seed=0))
    cfg_path = os.path.join(workdir, "config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    train_sp, val_sp, test_sp = split_speakers([f"s{s}" for s in range(1, n_speakers + 1)],
                                               cfg.data.split)
    n_train, n_val, n_test = (len(sp) * clips for sp in (train_sp, val_sp, test_sp))
    steps_per_epoch = n_train // cfg.data.batch_size
    val_b, test_b = (-(-n // cfg.data.batch_size) for n in (n_val, n_test))
    print(f"training slice: full width (conv 32/64/96, BiGRU 256 x2, 50x100, T=75, B=8), "
          f"both kernel flags on; corpus of {n_speakers * clips} clips written in "
          f"{time.perf_counter() - t0:.2f} s (train {train_sp}, val {val_sp}, test {test_sp})",
          flush=True)
    common = ["--data_path", data, "--config", cfg_path, *F32]
    results = os.path.join(workdir, "results.json")
    zero_counts()
    t0 = time.perf_counter()
    prof = os.path.join(workdir, "prof")
    rc = [cli.main(["train", *common, "--epochs", "2", "--checkpoint_dir", ck]),
          cli.main(["train", *common, "--epochs", "3", "--checkpoint_dir", ck,
                    "--resume", "auto", "--device_cache", "on", "--remat",
                    "--profile_dir", prof]),
          cli.main(["test", *common, "--checkpoint", ck, "--output", results])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    if rc != [0, 0, 0]:
        raise SystemExit(f"cli train/resume/test returned {rc}")
    steps = 3 * steps_per_epoch
    # epoch 1 streams: eager steps. Epoch 2 finds the corpus in the device
    # cache ('auto', second epoch) and epoch 3 (the resumed process, 'on')
    # too: each runs as an epoch program, its first steps eager, one capture
    # (the wrappers run once while the graph records), the rest replays,
    # which pass through no wrapper. With --remat each eager step or capture
    # runs the forward kernels twice (the backward recomputes them).
    plain = steps_per_epoch + program_wrapper_calls(steps_per_epoch, 1)
    remat = program_wrapper_calls(steps_per_epoch, 1)
    forwards = 3 * val_b + 3 * test_b  # validation per epoch, a test pass per command
    want = {"conv1_pool": plain + 2 * remat + forwards,
            "gru_fwd": 2 * (plain + 2 * remat + forwards),
            "gru_bwd": 2 * (plain + remat), "conv1_pool_bwd": plain + remat, "mel_stats": 0}
    replays = 2 * (steps_per_epoch - min(WARMUP_STEPS, steps_per_epoch))
    print(f"  train 2 epochs + resume 1 (--device_cache on --remat --profile_dir) + test: "
          f"wall_s={wall:.2f}, {steps} train steps ({replays} of them graph replays), "
          f"{forwards} eval forwards", flush=True)
    print(f"  launches: {got} (expected {want}: per eager train step or capture conv1_pool "
          f"1, gru_fwd 2, gru_bwd 2 (each also runs its reduction kernel), conv1_pool_bwd 1, "
          f"the forward's twice with remat; per eval forward conv1_pool 1, gru_fwd 2)",
          flush=True)
    traced_files = sorted(os.listdir(prof)) if os.path.isdir(prof) else []
    print(f"  profiler trace of the resumed epoch: {traced_files}", flush=True)
    if traced_files != ["trace.json"] or os.path.getsize(os.path.join(prof, "trace.json")) == 0:
        raise SystemExit("--profile_dir wrote no trace")
    if got != want:
        raise SystemExit("training launch counts do not match the steps taken")
    with open(os.path.join(ck, "history.json")) as f:
        hist = json.load(f)
    with open(results) as f:
        res = json.load(f)
    snaps = sorted(n for n in os.listdir(ck) if n.startswith("epoch_"))
    print(f"  history loss={hist['loss']} val_loss={hist['val_loss']} "
          f"epoch_seconds={hist['epoch_seconds']}; snapshots {snaps}; test {res}", flush=True)
    if (len(hist["loss"]) != 3 or not np.all(np.isfinite(hist["loss"] + hist["val_loss"]))
            or snaps != ["epoch_2.pth", "epoch_3.pth", "epoch_4.pth"]
            or res["num_samples"] != n_test or not 0.0 <= res["cer"] < float("inf")):
        raise SystemExit("training run left the wrong history, snapshots or results")

    # one step, kernel path vs plain path: same weights, same batch, dropout 0
    batcher = LipNetBatcher(GridDataSource(data, train_sp), cfg, device=dev)
    batch = device_batch(batcher.first_batch(), dev)
    fast_cfg = dataclasses.replace(cfg.model, dropout_rate=0.0)
    fast = LipNet(fast_cfg, generator=torch.Generator().manual_seed(1)).to(dev)
    plain = LipNet(dataclasses.replace(fast_cfg, use_pallas_gru=False, fused_conv_pool=False),
                   generator=torch.Generator()).to(dev)
    plain.load_state_dict(fast.state_dict())
    losses, grads = [], []
    for m in (fast, plain):
        with fp32_step():
            loss = ctc_loss_mean(m(batch["video"], train=True), batch["labels"],
                                 batch["label_lengths"])
            loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad for n, p in m.named_parameters()})
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = 0.0
    for name, want_g in grads[1].items():
        got_g = grads[0][name]
        if got_g is None or not torch.isfinite(got_g).all():
            raise SystemExit(f"kernel path left {name} without a finite gradient")
        worst = max(worst, ((got_g - want_g).abs().max() / want_g.abs().max()).item())
    print(f"  one step, kernel path vs plain path: loss {losses[0]:.6f} vs {losses[1]:.6f} "
          f"(rel err {loss_err:.2e}, tol {STEP_LOSS_RTOL}); every gradient: max err / "
          f"max |grad| = {worst:.2e} (tol {STEP_GRAD_RTOL}) over {len(grads[1])} "
          f"parameters", flush=True)
    if loss_err > STEP_LOSS_RTOL or worst > STEP_GRAD_RTOL:
        raise SystemExit("kernel path's step disagrees with the plain path's")

    # TF32 as seen from inside train_step's backward, with both process-wide
    # flags switched on first: the step's own scope must turn them off
    seen = []

    def on_conv2_output(mod, inp, out):
        out.register_hook(lambda g: seen.append((torch.backends.cuda.matmul.allow_tf32,
                                                 torch.backends.cudnn.allow_tf32)))

    hook = fast.conv2.register_forward_hook(on_conv2_output)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    opt = make_optimizer(fast.parameters(), OVERFIT_LR)
    first = train_step(fast, opt, batch, OVERFIT_LR)[0].item()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    hook.remove()
    print(f"  tf32 inside train_step's backward (process flags set True before): "
          f"matmul={seen[0][0]} cudnn={seen[0][1]}", flush=True)
    if seen != [(False, False)]:
        raise SystemExit("TF32 was on inside the backward")

    # the loss falls on one repeated batch
    for _ in range(OVERFIT_STEPS - 2):
        train_step(fast, opt, batch, OVERFIT_LR)
    last = train_step(fast, opt, batch, OVERFIT_LR)[0].item()
    print(f"  repeated batch, lr {OVERFIT_LR}, {OVERFIT_STEPS} steps: loss {first:.4f} -> "
          f"{last:.4f}", flush=True)
    if not last < first:
        raise SystemExit("the loss did not fall over the repeated batch")

    # train step time at B=8 (lr 0: the update runs, the weights stay)
    step_ms = {}
    for name, m in (("kernel_path", fast), ("plain_path", plain)):
        o = make_optimizer(m.parameters(), 0.0)
        step_ms[name] = time_ms(lambda: train_step(m, o, batch, 0.0),
                                iters=10 if name == "kernel_path" else 3, warmup=2)
    print(f"  train step B=8 T=75 (CUDA events, median): kernel_path_ms="
          f"{step_ms['kernel_path']:.3f} plain_path_ms={step_ms['plain_path']:.3f}", flush=True)
    return got


# ---------------------------------------------------------------------------
# 6. K5 and the detector slices
# ---------------------------------------------------------------------------

def check_mel_stats(dev):
    import ctypes

    import numpy as np
    import torch

    from avsync_torch.config import AudioConfig
    from avsync_torch.ops import audio, audio_ref
    from avsync_torch.ops.cuda import build, mfcc

    g = torch.Generator(device="cpu").manual_seed(12)
    cfg = AudioConfig()
    hop, S = cfg.hop_length, cfg.max_audio_samples
    melT, dctT, _ = audio.device_constants(cfg, dev)
    F, K, M, C = 121, 1025, 128, 20
    band = int(mfcc._band_table(melT)[1].sum().item())  # the band sums' terms
    nnz = int((melT != 0).sum().item())

    def spectra(n):
        """Power spectrograms of noise clips whose lengths give n valid frames."""
        lengths = torch.where(n > 0, (n - 1) * hop, 0).to(torch.int32)
        x = (torch.rand(len(n), S, generator=g) - 0.5) * (torch.arange(S)[None, :]
                                                           < lengths[:, None])
        return audio.power_spectrogram(x.to(dev), cfg), lengths.to(dev)

    def random_power(B, F, K):  # ~100 dB of spread, so the top_db clamp bites
        return (torch.rand(B, F, K, generator=g) ** 8
                * 10.0 ** (torch.rand(B, F, 1, generator=g) * 9 - 6)).to(dev)

    def cycle(B, F):  # n_valid 0, 1, 2, a partial count, F
        return torch.tensor([(0, 1, 2, F // 2 + 3, F)[i % 5] for i in range(B)],
                            dtype=torch.int32)

    smem_fn = build.function("mel_stats", "avs_mel_stats_smem", [ctypes.c_int] * 6)
    grids = {}
    half = mfcc.SHARED_SM_SLAB_ROWS
    for f in (1, 21, 121, 401, 1201):
        cs, R, sr, nbuf = mfcc.cluster_grid(f, K, M, C)
        for slab in ((sr, nbuf), (half, 2 if R > half else 1)):
            if smem_fn(K, M, C, R, *slab) != mfcc.shared_memory_bytes(K, M, C, R, *slab):
                raise SystemExit(f"K5 shared memory at F={f}: the wrapper's count differs "
                                 "from the kernel's")
        grids[f] = (cs, R, sr, nbuf, mfcc.shared_memory_bytes(K, M, C, R, sr, nbuf))
    print(f"mel_stats (K5) vs mel_stats_ref (filterbank: {nnz} nonzeros of {K * M}, "
          f"bands of {band} bins in all); (CTAs per clip, rows per CTA, slab rows, slab "
          f"buffers, shared bytes) by F: {grids} ({half}-row slabs when a launch has more "
          f"CTAs than SMs); F up to {mfcc.max_frames(K, M, C)}:", flush=True)
    errs = []
    for B in (1, 8, 32, 40, 512):
        n = cycle(B, F)
        power, _ = spectra(n)
        n = n.to(dev)
        got = mfcc.mel_stats(power, n, melT, dctT)
        errs.append(max_err(got, mfcc.mel_stats_ref(power, n, melT, dctT), K5_TOL,
                            f"B={B} F={F} K={K} M={M} C={C} n_valid 0/1/2/{F // 2 + 3}/{F}"))
        if B == 32:
            same_bits([got], [mfcc.mel_stats(power, n, melT, dctT)], f"B={B} F={F}")
        if B == 512:  # a clip's bits alone, in a train step's batch, in an eval chunk
            part = mfcc.mel_stats(power[:32], n[:32], melT, dctT)
            ones = [mfcc.mel_stats(power[i:i + 1], n[i:i + 1], melT, dctT) for i in range(32)]
            torch.cuda.synchronize()
            if not (torch.equal(part, got[:32])
                    and all(torch.equal(o[0], got[i]) for i, o in enumerate(ones))):
                raise SystemExit("kernel check failed: K5's bits of a clip depend on its batch")
            print("  clips 0-31 of B=512 equal to the same clips at B=32 and B=1 bit for bit",
                  flush=True)
    mel8k = torch.from_numpy(audio_ref.mel_filterbank(8000, 256, 40).astype(np.float32).T.copy())
    dct13 = torch.from_numpy(audio_ref.dct_ortho_matrix(13, 40).astype(np.float32).T.copy())
    odd = [("F=21 K=129 M=40 C=13", random_power(5, 21, 129), cycle(5, 21), mel8k, dct13),
           ("F=21 K=129 M=40 C=13 dense random melT", random_power(5, 21, 129), cycle(5, 21),
            torch.rand(129, 40, generator=g) * 0.05, dct13),
           ("F=1 K=1025 M=128 C=20", random_power(3, 1, K),
            torch.tensor([0, 1, 1], dtype=torch.int32), melT, dctT)]
    # long audio, which the one-CTA-per-clip design refused (F >= 366): 10 s
    # and 30 s of 16 kHz at hop 400
    odd += [(f"B=8 F={f} K={K} M={M} C={C} n_valid 0/1/2/{f // 2 + 3}/{f}",
             random_power(8, f, K), cycle(8, f), melT, dctT) for f in (401, 1201)]
    for what, power, n, mT, dT in odd:
        n, mT, dT = n.to(dev), mT.to(dev), dT.to(dev)
        got = mfcc.mel_stats(power, n, mT, dT)
        errs.append(max_err(got, mfcc.mel_stats_ref(power, n, mT, dT), K5_TOL, what))
        if what.startswith("B=8"):
            same_bits([got], [mfcc.mel_stats(power, n, mT, dT)], what.split(" K=")[0])

    # times with every frame valid: the train step (B=32), a scorer batch of 8
    # requests x 5 shifts (40), the eval sweep's chunk (512), all 3 s clips;
    # and B=8 clips of 10 s (F=401)
    times = {}
    for B, f in ((32, F), (40, F), (512, F), (8, 401)):
        n = torch.full((B,), f, dtype=torch.int32, device=dev)
        if f == F:
            power, lengths = spectra(n.cpu())
        else:
            power, lengths = random_power(B, f, K), (n - 1) * hop
        out = mfcc.mel_stats(power, n, melT, dctT)
        max_err(audio.stats_from_power(power, lengths, cfg), out, K5_TOL,
                f"B={B} F={f}: use_pallas=False composition vs kernel (yardstick sanity)")
        ms = time_ms(lambda: mfcc.mel_stats(power, n, melT, dctT))
        plain = time_ms(lambda: mfcc.mel_stats_ref(power, n, melT, dctT))
        lib = time_ms(lambda: audio.stats_from_power(power, lengths, cfg))
        rows = B * f
        n_bytes = 4 * (B * f * K + B + M * C + B * 2 * C) + 4 * (band + 3 * M)
        n_ops = 2 * rows * (band + M * C) + 3 * rows * M + 4 * rows * C
        dense = 2 * rows * (K * M + M * C)
        bms, by = bound_ms(n_bytes, n_ops)
        times[(B, f)] = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by)
        print(f"  B={B} F={f}: kernel_ms={ms:.4f} plain_ms={plain:.4f} library_ms={lib:.4f} "
              f"bound_ms={bms:.4f} ({by}: {n_bytes / 1e6:.2f} MB, banded {n_ops / 1e9:.4f} "
              f"GFLOP, dense {dense / 1e9:.3f} GFLOP)", flush=True)
    return dict(name="mel_stats", route="cuda", source="avsync_torch/csrc/mel_stats.cu",
                replaces="avsync/ops/pallas/mfcc.py:60", max_abs_err=max(errs),
                **times[(32, F)], shape="B=32 F=121 K=1025 M=128 C=20 (a detector train step)",
                times_B40=times[(40, F)], times_B512=times[(512, F)],
                times_B8_F401=times[(8, 401)],
                library_note="library_ms: the use_pallas=False composition from the same "
                             "power (ops/audio.stats_from_power: cuBLAS fp32 einsums + torch "
                             "elementwise and reductions); no single PyTorch call computes "
                             "this function")


def seeded_jax_layout_detector_params(input_dim: int, hidden: int, seed: int):
    """Detector weights as the JAX package lays them out, drawn with numpy
    (uniform +-1/sqrt(fan_in), as nn.Linear)."""
    import numpy as np

    r = np.random.default_rng(seed)
    b1, b2 = input_dim ** -0.5, hidden ** -0.5
    return {"fc1": {"kernel": r.uniform(-b1, b1, (input_dim, hidden)).astype(np.float32),
                    "bias": r.uniform(-b1, b1, hidden).astype(np.float32)},
            "fc2": {"kernel": r.uniform(-b2, b2, (hidden, 1)).astype(np.float32),
                    "bias": r.uniform(-b2, b2, 1).astype(np.float32)}}


def run_detector_serving(dev):
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch.config import AudioConfig, AvsyncConfig, ModelConfig
    from avsync_torch.ops.audio import shifted_audio_stats
    from avsync_torch.predictor import MisalignmentScorer
    from avsync_torch.serving import SyncScoreService

    cfg = AvsyncConfig(model=ModelConfig(fused_conv_pool=True), audio=AudioConfig(use_pallas=True))
    plain_cfg = AvsyncConfig()
    lip = seeded_jax_layout_params(cfg, seed=0)
    det = seeded_jax_layout_detector_params(2 * 6912 + 40, 256, seed=1)
    scorer = MisalignmentScorer(config=cfg, device=dev, detector_params=det, lipnet_params=lip)
    plain = MisalignmentScorer(config=plain_cfg, device=dev, detector_params=det,
                               lipnet_params=lip)
    if not scorer.lipnet.conv1.fused or plain.lipnet.conv1.fused:
        raise SystemExit("the detector slice's scorers do not route conv1 as configured")
    svc = SyncScoreService(scorer, max_batch=MAX_BATCH, max_wait_ms=5.0)
    t0 = time.perf_counter()
    svc.warmup(DET_SHIFTS)
    svc.warmup(DET_SHIFTS, frames=np.zeros((75, 288, 360), np.uint8))
    torch.cuda.synchronize()
    print(f"detector serving slice: full width (conv 32/64/96, 50x100, T=75; detector "
          f"13864 -> 256 -> 1; MFCC 16 kHz, 48000 samples, 121 frames), shifts {DET_SHIFTS}, "
          f"warmup {time.perf_counter() - t0:.2f} s", flush=True)

    r = np.random.default_rng(8)
    n_req, n_threads = 32, 16
    clips = [r.integers(0, 256, (75, 288, 360), dtype=np.uint8) if i % 2 == 0
             else r.integers(0, 256, (75, 50, 100), dtype=np.uint8) for i in range(n_req)]
    lengths = r.integers(1, 48001, n_req)
    lengths[0], lengths[1] = 0, 48000
    audios = [syllable_audio(r, int(n)) for n in lengths]
    answers = [None] * n_req
    errors = []

    def client(tid):
        try:
            for i in range(tid, n_req, n_threads):
                answers[i] = svc.score_arrays(clips[i], audios[i], 25.0, DET_SHIFTS, timeout=300)
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(repr(e))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
    zero_counts()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    got = counts()
    if errors or any(t.is_alive() for t in threads) or any(a is None for a in answers):
        raise SystemExit(f"detector serving failed: {errors}")
    stats = svc.stats.snapshot()
    svc.close()
    n_batches = sum(stats["batches"].values())
    print(f"  requests={stats['requests']} threads={n_threads} batches={stats['batches']} "
          f"p50_ms={stats['latency_ms']['p50']} p99_ms={stats['latency_ms']['p99']} "
          f"requests_per_s={n_req / wall:.2f} wall_s={wall:.3f}", flush=True)
    print(f"  launches: {got} (expected conv1_pool and mel_stats {n_batches} each, one per "
          f"batch; no GRU or backward kernel)", flush=True)
    if (stats["requests"] != n_req or got["conv1_pool"] != n_batches
            or got["mel_stats"] != n_batches
            or got["gru_fwd"] or got["gru_bwd"] or got["conv1_pool_bwd"]):
        raise SystemExit("detector serving launch counts do not match the batches served")
    if not set(stats["batches"]) <= set(BUCKETS):
        raise SystemExit(f"a batch size outside the checked buckets {BUCKETS}")

    worst = 0.0
    for i in range(n_req):
        a = np.asarray(answers[i])
        want = plain.score_arrays(clips[i], audios[i], 25.0, DET_SHIFTS)
        if a.shape != (len(DET_SHIFTS),) or not np.isfinite(a).all():
            raise SystemExit(f"request {i}: bad probabilities {a}")
        worst = max(worst, float(np.abs(a - want).max()))
    print(f"  probabilities kernel path vs plain path: max_abs_err={worst:.3e} "
          f"(tol {PROB_ATOL}) {'ok' if worst <= PROB_ATOL else 'FAIL'}", flush=True)
    if worst > PROB_ATOL:
        raise SystemExit("the detector's kernel path disagrees with its plain path")
    buf = np.zeros((n_req, 48000), np.float32)
    for i, a in enumerate(audios):
        buf[i, :len(a)] = a
    K = len(DET_SHIFTS)
    rows = (torch.from_numpy(buf).to(dev).repeat_interleave(K, 0),
            torch.from_numpy(lengths.astype(np.int32)).to(dev).repeat_interleave(K),
            torch.tensor(DET_SHIFTS * n_req, dtype=torch.int32, device=dev),
            torch.full((n_req * K,), 25.0, device=dev))
    with torch.inference_mode():
        max_err(shifted_audio_stats(*rows, cfg.audio),
                shifted_audio_stats(*rows, dataclasses.replace(cfg.audio, use_pallas=False)),
                K5_TOL, f"audio statistics of the {n_req * K} served (clip, shift) rows, "
                        "K5 vs the XLA path")
    print(f"  sample probabilities: {np.round(answers[0], 4).tolist()} (no audio), "
          f"{np.round(answers[1], 4).tolist()} (48000 samples)", flush=True)
    return got


def run_detector_training(dev, workdir: str):
    """The port's `cli misalign-train` at full width with conv1's and the
    MFCC stage's kernel flags, on the training slice's corpus and its trained
    LipNet, then `cli misalign-eval`; then one detector step of the kernel
    path against the plain path, the loss falling on one repeated batch, and
    the detector step's time on both paths."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.config import (AudioConfig, AvsyncConfig, DetectorConfig, ModelConfig,
                                     TrainConfig)
    from avsync_torch.data.grid import GridDataSource, split_videos
    from avsync_torch.features import gather_features, sample_shift_labels
    from avsync_torch.models.detector import MisalignmentDetector
    from avsync_torch.ops.conv import fp32_step
    from avsync_torch.predictor import load_lipnet, lipnet_state
    from avsync_torch.train.detector_trainer import (detector_train_step, make_detector_optimizer,
                                                     weighted_bce)

    data, ck = os.path.join(workdir, "grid"), os.path.join(workdir, "ckpt")
    det_path, logs = os.path.join(workdir, "detector.pth"), os.path.join(workdir, "det_logs")
    sweep_json = os.path.join(workdir, "sweep.json")
    cfg = AvsyncConfig(model=ModelConfig(fused_conv_pool=True), audio=AudioConfig(use_pallas=True),
                       detector=DetectorConfig(epochs=2), train=TrainConfig(seed=0))
    cfg_path = os.path.join(workdir, "detector_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    src = GridDataSource(data)
    paths = src.video_paths
    train_p, val_p, test_p = split_videos(paths, seed=cfg.train.seed)
    bsz, det = cfg.data.batch_size, cfg.detector
    plan = 1 + det.num_negative_samples  # plan entries per clip
    bank_batches = sum(math.ceil(len(p) / bsz) for p in (train_p, val_p, test_p, paths))

    def epoch_calls(n: int, runs: int) -> int:
        # full batches through the epoch program, a ragged tail as its own step
        S, tail = divmod(plan * n, det.batch_size)
        return (program_wrapper_calls(S, runs) if S else 0) + runs * (tail > 0)

    steps = det.epochs * math.ceil(plan * len(train_p) / det.batch_size)
    evals = (det.epochs * math.ceil(plan * len(val_p) / det.batch_size)
             + math.ceil(plan * len(test_p) / det.batch_size))
    wrapped = (epoch_calls(len(train_p), det.epochs) + epoch_calls(len(val_p), det.epochs)
               + epoch_calls(len(test_p), 1))
    sweep_rows = math.ceil(len(paths) / cli._SWEEP_CLIP_CHUNK) * (1 + 16)
    print(f"detector training slice: full width, {len(paths)} clips with audio "
          f"(train {len(train_p)}, val {len(val_p)}, test {len(test_p)}), the LipNet trained "
          f"above, batch {det.batch_size}, {det.epochs} epochs", flush=True)
    common = ["--data_path", data, "--config", cfg_path, "--checkpoint", ck,
              "--detector_checkpoint", det_path, *F32]
    zero_counts()
    t0 = time.perf_counter()
    rc = [cli.main(["misalign-train", *common, "--log_dir", logs, "--save_every", "1"]),
          cli.main(["misalign-eval", *common, "--min_shift", "5", "--max_shift", "20",
                    "--output", sweep_json])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    if rc != [0, 0]:
        raise SystemExit(f"cli misalign-train/misalign-eval returned {rc}")
    want = {"conv1_pool": bank_batches, "gru_fwd": 0, "gru_bwd": 0, "conv1_pool_bwd": 0,
            "mel_stats": wrapped + sweep_rows}
    print(f"  misalign-train + misalign-eval: wall_s={wall:.2f}; launches {got} (expected "
          f"{want}: conv1_pool once per bank batch of {bsz} clips ({bank_batches}), mel_stats "
          f"once per sweep row ({sweep_rows}) and per eager step or capture of the {steps} "
          f"train steps and {evals} eval batches ({wrapped}; the epoch programs' replays "
          f"pass through no wrapper)", flush=True)
    if got != want:
        raise SystemExit("detector launch counts do not match what the commands ran")
    (run,) = os.listdir(logs)
    written = sorted(os.listdir(os.path.join(logs, run)))
    with open(sweep_json) as f:
        sweep = json.load(f)
    aurocs = list(sweep["auroc_by_shift"].values()) + [sweep["overall_auroc"]]
    print(f"  log folder {written}; sweep over {sweep['num_clips']} clips: overall AUROC "
          f"{sweep['overall_auroc']:.4f} (the LipNet trained above, a 2-epoch detector, "
          f"synthetic clips whose audio follows the mouth: a check of the path, not of "
          f"accuracy)", flush=True)
    if (not {"checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth", "detector.pth"} <= set(written)
            or sweep["num_clips"] != len(paths) or len(sweep["auroc_by_shift"]) != 16
            or not all(np.isfinite(aurocs))):
        raise SystemExit("the detector run left the wrong snapshots or sweep")

    # one step, kernel path vs plain path: same weights, same batch, dropout 0
    lipnet = load_lipnet(cfg, lipnet_state(cfg, ck), dev)
    bank = cli._build_bank(cfg, src, lipnet, train_p, dev)
    vi, sh, lb = (torch.from_numpy(a[:det.batch_size]).to(dev) for a in sample_shift_labels(
        len(train_p), det.max_shift_frames, det.num_negative_samples, np.random.default_rng(0)))
    w = torch.ones(len(vi), device=dev)
    dim = bank.visual.shape[1] + 2 * cfg.audio.n_mfcc
    model = MisalignmentDetector(dim, det.hidden_dim, 0.0,
                                 generator=torch.Generator().manual_seed(2)).to(dev)
    plain_audio = dataclasses.replace(cfg.audio, use_pallas=False)
    losses, grads = [], []
    for audio_cfg in (cfg.audio, plain_audio):
        model.zero_grad(set_to_none=True)
        with fp32_step():
            with torch.no_grad():
                feats = gather_features(bank, vi, sh, audio_cfg)
            loss = weighted_bce(model(feats), lb, w)
            loss.backward()
        losses.append(loss.item())
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    loss_err = abs(losses[0] - losses[1]) / abs(losses[1])
    worst = max(((grads[0][n] - g).abs().max() / g.abs().max()).item()
                for n, g in grads[1].items())
    print(f"  one detector step B={det.batch_size}, kernel path vs plain path: loss "
          f"{losses[0]:.6f} vs {losses[1]:.6f} (rel err {loss_err:.2e}, tol {STEP_LOSS_RTOL}); "
          f"every gradient: max err / max |grad| = {worst:.2e} (tol {STEP_GRAD_RTOL})",
          flush=True)
    if loss_err > STEP_LOSS_RTOL or worst > STEP_GRAD_RTOL:
        raise SystemExit("the detector step's kernel path disagrees with its plain path")

    opt = make_detector_optimizer(model.parameters(), OVERFIT_LR, det.weight_decay)
    first = detector_train_step(model, opt, bank, vi, sh, lb, w, cfg.audio)[0].item()
    for _ in range(OVERFIT_STEPS - 2):
        detector_train_step(model, opt, bank, vi, sh, lb, w, cfg.audio)
    last = detector_train_step(model, opt, bank, vi, sh, lb, w, cfg.audio)[0].item()
    print(f"  repeated batch, lr {OVERFIT_LR}, {OVERFIT_STEPS} steps: loss {first:.4f} -> "
          f"{last:.4f}", flush=True)
    if not last < first:
        raise SystemExit("the detector's loss did not fall over the repeated batch")

    step_ms = {}  # lr 0: the update runs, the weights stay
    for name, audio_cfg in (("kernel_path", cfg.audio), ("plain_path", plain_audio)):
        m = MisalignmentDetector(dim, det.hidden_dim, det.dropout,
                                 generator=torch.Generator().manual_seed(3)).to(dev)
        o = make_detector_optimizer(m.parameters(), 0.0, det.weight_decay)
        gen = torch.Generator(device=dev)
        step_ms[name] = time_ms(lambda: detector_train_step(m, o, bank, vi, sh, lb, w, audio_cfg,
                                                            gen.manual_seed(0)))
    print(f"  detector train step B={det.batch_size} (CUDA events, median of 20): "
          f"kernel_path_ms={step_ms['kernel_path']:.4f} "
          f"plain_path_ms={step_ms['plain_path']:.4f}", flush=True)
    return got


# ---------------------------------------------------------------------------
# 9. epoch programs (CUDA graphs of the trainers' steps)
# ---------------------------------------------------------------------------

# profiler kernel names of each wrapper's launch (one match per launch: K3's
# chain kernel stands for its four, K4's main kernel for its two)
KERNEL_NAMES = {"conv1_pool": "conv1_pool_kernel", "gru_fwd": "gru_fwd",
                "gru_bwd": "gru_bwd_chain", "conv1_pool_bwd": "conv1_pool_bwd_kernel",
                "mel_stats": "mel_stats_kernel"}
# K1's and K4's bf16 kernels (csrc/conv1_mma.cuh's tensor-core recompute)
BF16_KERNEL_NAMES = {"conv1_pool_bf16": "conv1_pool_bf16_kernel",
                     "conv1_pool_bwd_bf16": "conv1_pool_bwd_bf16_kernel"}


class StepLog:
    """A metrics writer keeping (step, loss, grad_norm) rows."""

    def __init__(self):
        self.rows = []

    def write(self, step, **m):
        self.rows.append((step, m["loss"], m["grad_norm"]))


def timed_before(trainer):
    """Wrap the trainer's per-step dropout reseed, which runs on the host
    ahead of every step (eager or replay): the gaps between its calls are
    the host's time per step."""
    stamps = []
    inner = trainer._step_generator

    def hook(step):
        stamps.append(time.perf_counter())
        return inner(step)

    trainer._step_generator = hook
    return stamps


def traced(fn, complete=None):
    """Run fn() under torch.profiler: (result, wall ms, device busy ms,
    {wrapper: kernels of its name}, all kernel names). A trace with no
    device event at all, or one that `complete` (`has_kernels`) finds short
    of kernels, is taken again (`retraced`)."""
    import torch

    def once():
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        return (out, wall), [(e.name, e.time_range.start, e.time_range.elapsed_us(),
                              bool(getattr(e, "is_user_annotation", False)))
                             for e in prof.events()
                             if e.device_type == torch.autograd.DeviceType.CUDA]

    (out, wall), events = retraced(once, "traced", complete)
    busy, names = kernel_names(events)
    found = {k: sum(n for name, n in names.items() if pat in name)
             for k, pat in KERNEL_NAMES.items()}
    return out, wall, busy, found, names


def retraced(take, what, complete=None):
    """take() -> (result, device events); a trace that holds no device event
    at all (torch.profiler has returned none on a healthy run) is taken once
    more, and a second empty one fails naming the profiler, not a kernel.
    `complete(events)`: whether the trace holds the kernels the traced call
    launches. The tracer has lost the first kernels of a short window on a
    healthy run (1 of Q1's 3 launches in one forward; K1 and the lead-in of
    an artifact call), so a trace short of them is taken up to twice more; a
    trace still without some kernel is the caller's to fail."""
    got, events = take()
    if not events:
        print(f"  {what}: torch.profiler recorded no device event; tracing once more",
              flush=True)
        got, events = take()
        if not events:
            raise SystemExit(f"{what}: torch.profiler recorded no device event in two traces "
                             "(a profiler failure: no kernel's count can be read)")
    for _ in range(2):
        if complete is None or complete(events):
            break
        print(f"  {what}: the trace is short of the kernels the call launches; tracing once "
              "more", flush=True)
        got, events = take()
    return got, events


def has_kernels(*patterns, n=1):
    """A `complete` test for `retraced`: every pattern names at least n
    kernels of the trace."""
    def complete(events):
        return all(sum(1 for name, _, _, note in events if not note and pat in name) >= n
                   for pat in patterns)

    return complete


def kernel_names(events):
    """(device busy ms, {kernel name: count}) of device events."""
    busy, names = 0.0, {}
    for name, _, dur, note in events:
        if not note:
            busy += dur / 1e3
            names[name] = names.get(name, 0) + 1
    return busy, names


def device_events(fn, wall=None, complete=None):
    """The device events (name, start us, duration us, is a user annotation)
    of one fn() recorded by torch.profiler after a first, warm-up fn() under
    the same profiler (the tracer's start-up drops a short window's first
    kernels); retaken once when empty (`retraced`). `wall`: a list that
    receives the traced fn()'s wall ms."""
    import torch

    def once():
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        events, ms = [], []

        def record(prof):  # called once, when the active step ends
            events.extend((e.name, e.time_range.start, e.time_range.elapsed_us(),
                           bool(getattr(e, "is_user_annotation", False)))
                          for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)

        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts, on_trace_ready=record,
                                    schedule=torch.profiler.schedule(wait=0, warmup=1,
                                                                     active=1)) as prof:
            for _ in range(2):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                prof.step()
        return ms[-1], events

    ms, events = retraced(once, "device_events", complete)
    if wall is not None:
        wall.append(ms)
    return events


def traced_step(fn, complete=None):
    """(device busy ms, {kernel name: count}) of one fn() (`device_events`)."""
    return kernel_names(device_events(fn, complete=complete))


def path_times(label, steps, wall_ms, traced_ms, busy_ms, stamps):
    """Print and return steps/s and wall ms per step (an untraced epoch of
    `steps` taking wall_ms), host ms per step (median gap between the steps'
    host starts, `stamps`), device busy ms per step and the idle share (a
    traced epoch: busy_ms of device work in traced_ms)."""
    gaps = [b - a for a, b in zip(stamps, stamps[1:])]
    host = statistics.median(gaps) * 1e3 if gaps else float("nan")
    row = {"steps_per_s": steps / wall_ms * 1e3, "wall_ms_per_step": wall_ms / steps,
           "host_ms_per_step": host, "device_busy_ms_per_step": busy_ms / steps,
           "idle_share": max(0.0, 1.0 - busy_ms / traced_ms)}
    print(f"    {label}: steps_per_s={row['steps_per_s']:.3f} wall_ms_per_step="
          f"{row['wall_ms_per_step']:.4f} host_ms_per_step={host:.4f} (median gap between "
          f"steps' host starts) device_busy_ms_per_step={row['device_busy_ms_per_step']:.4f} "
          f"idle_share={row['idle_share']:.4f}", flush=True)
    return row


def same_state(a, b, what):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        if not torch_equal(p, q):
            raise SystemExit(f"{what}: parameter {name} differs between graph and loop")
    for (ka, sa), (kb, sb) in zip(a.optimizer.state.items(), b.optimizer.state.items()):
        for key in sa:
            if not torch_equal(sa[key], sb[key]):
                raise SystemExit(f"{what}: optimizer state {key} differs between graph and loop")


def torch_equal(x, y) -> bool:
    import torch

    return torch.equal(x, y)


def run_epoch_programs(dev, workdir: str):
    """Both trainers' whole-epoch programs at full width with every kernel
    flag on, each against its eager loop from the same weights: LipNet at
    B=8 over a fully cached 64-clip corpus (S=8), at dropout 0 then 0.5,
    with cuDNN held to its deterministic algorithms; the detector at B=32
    over a bank of 256 clips (S=16 train, 16 eval). Params, optimizer
    state, losses, gradient norms and probabilities must be equal bit for
    bit after two epochs (the first runs the warm-up and the capture). Then,
    in the trainers' own step scope (cuDNN deterministic), one timed
    epoch per path (steps/s, wall
    and host ms per step) and one traced (device busy time, idle share, and
    the kernels the graph's replays launched, by profiler name)."""
    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.config import (AudioConfig, AvsyncConfig, DataConfig, DetectorConfig,
                                     ModelConfig, TrainConfig)
    from avsync_torch.data.grid import GridDataSource
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.data.synthetic import write_corpus
    from avsync_torch.features import FeatureBank
    from avsync_torch.models.lipnet import LipNet
    from avsync_torch.train.detector_trainer import DetectorTrainer
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.logging import Logger

    quiet = Logger(None, console=False)
    root = os.path.join(workdir, "programs")
    t0 = time.perf_counter()
    write_corpus(root, n_speakers=8, clips_per_speaker=8, layout="standard", seed=5)
    src = GridDataSource(root)
    print(f"epoch programs: corpus of {len(src)} clips (75x50x100, 3 s audio) written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    replayed = {}
    out = {"lipnet": {}, "detector": {}}

    # -- LipNet, B=8, S=8 ------------------------------------------------------
    def lipnet_cfg(dropout):
        return AvsyncConfig(data=DataConfig(data_path=root, device_cache="on"),
                            model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True,
                                              dropout_rate=dropout),
                            train=TrainConfig(seed=3))

    batcher = LipNetBatcher(src, lipnet_cfg(0.0), device=dev)  # the cache serves every run

    def lipnet_run(dropout, path):
        """A trainer from the seeded weights and an epoch function over
        the cache: the program (`graph`) or the per-batch loop (`loop`)."""
        trainer = LipNetTrainer(lipnet_cfg(dropout), device=dev, log=quiet)
        state = trainer.init_state()
        log = StepLog()

        def epoch(e):
            if path == "graph":
                return trainer.train_epoch_scanned(
                    state, batcher.scan_plan(shuffle=True, seed=e), metrics_writer=log)
            return trainer.train_epoch(state, batcher.epoch(shuffle=True, seed=e),
                                       metrics_writer=log)

        return trainer, state, log, epoch

    cudnn = torch.backends.cudnn
    for dropout in (0.0, 0.5):
        # cuDNN's deterministic algorithms: its defaults for conv2/conv3's
        # backward sum in a run-dependent order (two eager runs part, below)
        with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
            runs = {}
            for path in ("graph", "loop"):
                trainer, state, log, epoch = lipnet_run(dropout, path)
                zero_counts()
                epoch(1)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                epoch(2)
                torch.cuda.synchronize()
                runs[path] = (state, log, counts(), (time.perf_counter() - t0) * 1e3)
        (sg, lg, cg, wg), (sl, ll, cl, wl) = runs["graph"], runs["loop"]
        S = len(lg.rows) // 2
        n = program_wrapper_calls(S, 2)  # one capture for both epochs
        if cg != {"conv1_pool": n, "gru_fwd": 2 * n, "gru_bwd": 2 * n, "conv1_pool_bwd": n,
                  "mel_stats": 0}:
            raise SystemExit(f"LipNet epoch program: wrapper calls {cg}, not {n} steps' worth "
                             f"(warm-up and one capture)")
        same_state(sg, sl, f"LipNet dropout {dropout}")
        if lg.rows != ll.rows:
            raise SystemExit(f"LipNet dropout {dropout}: losses or gradient norms differ")
        print(f"  LipNet B=8 S={S} dropout {dropout}, cudnn.deterministic: 2 epochs graph vs "
              f"eager loop: parameters, Adam state, {len(lg.rows)} losses and gradient norms "
              f"equal bit for bit (last loss {lg.rows[-1][1]:.6f}); wrapper calls graph {cg} "
              f"(warm-up steps + one capture), loop {cl}; epoch 2 wall per step graph "
              f"{wg / S:.4f} ms, loop {wl / S:.4f} ms", flush=True)
        out["lipnet"]["wrapper_calls_graph_path"] = cg
        out["lipnet"][f"deterministic_dropout_{dropout}_wall_ms_per_step"] = {
            "graph": wg / S, "loop": wl / S}
        del runs
    logs = []
    for _ in range(2):  # in the trainers' step scope: the loop against itself
        _, _, log, epoch = lipnet_run(0.0, "loop")
        epoch(1)
        logs.append(log.rows)
    part = next((i for i, (a, b) in enumerate(zip(*logs)) if a != b), None)
    print(f"  LipNet loop vs loop in the trainers' step scope (cuDNN deterministic; "
          f"dropout 0, 1 epoch): "
          f"{'equal bit for bit' if part is None else f'parted at step {part + 1}'} "
          f"(informational)", flush=True)
    for path in ("graph", "loop"):  # timed in the trainers' step scope (deterministic)
        trainer, state, _, epoch = lipnet_run(0.5, path)
        epoch(1)  # the graph's warm-up and capture
        stamps = timed_before(trainer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch(2)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        gaps = list(stamps)
        _, twall, busy, found, _ = traced(lambda: epoch(3))
        row = path_times(f"LipNet {path} path (dropout 0.5, epoch 2 timed, epoch 3 traced)", S,
                         wall, twall, busy, gaps)
        print(f"    kernels in the traced epoch: {found}", flush=True)
        out["lipnet"][path] = row
        if path == "graph":
            replayed["lipnet"] = found
        trainer._programs.clear()
    del batcher
    torch.cuda.empty_cache()
    want = {"conv1_pool": S, "gru_fwd": 2 * S, "gru_bwd": 2 * S, "conv1_pool_bwd": S}
    print(f"  LipNet replayed epoch ({S} replays, no capture): kernels by profiler name "
          f"{replayed['lipnet']} (expected at least {want})", flush=True)
    if any(replayed["lipnet"][k] < n for k, n in want.items()):
        raise SystemExit("a LipNet kernel did not run inside the graph's replays")

    # -- detector, B=32, bank of 256 clips -------------------------------------
    dcfg = AvsyncConfig(model=ModelConfig(fused_conv_pool=True),
                        audio=AudioConfig(use_pallas=True),
                        detector=DetectorConfig(batch_size=32), train=TrainConfig(seed=4))
    lipnet = LipNet(dcfg.model, generator=torch.Generator().manual_seed(6)).to(dev).eval()
    bank = cli._build_bank(dcfg, src, lipnet, src.video_paths, dev)
    bank = FeatureBank(*(torch.cat([t] * 4).contiguous() for t in bank))
    n = bank.visual.shape[0]
    dim = bank.visual.shape[1] + 2 * dcfg.audio.n_mfcc
    S = 2 * n // 32
    runs = {}
    for path in ("graph", "loop"):
        trainer = DetectorTrainer(dcfg, device=dev, log=quiet)
        trainer._force_loop = path == "loop"
        state = trainer.init_state(dim)
        zero_counts()
        ms = [trainer.run_epoch(state, bank, n, seed=e)[1] for e in (1, 2)]
        ms.append(trainer.run_epoch(state, bank, n, seed=99, train=False)[1])
        torch.cuda.synchronize()
        runs[path] = (trainer, state, ms, counts())
    (tg, sg, mg, cg), (tl, sl, ml, cl) = runs["graph"], runs["loop"]
    same_state(sg, sl, "detector")
    want = program_wrapper_calls(S, 2) + program_wrapper_calls(S, 1)  # train, eval programs
    if cg["mel_stats"] != want:
        raise SystemExit(f"detector epoch programs: {cg['mel_stats']} K5 wrapper calls, not "
                         f"{want} (warm-up and one capture per program)")
    for a, b in zip(mg, ml):
        if a["loss"] != b["loss"] or not np.array_equal(a["probs"], b["probs"]):
            raise SystemExit("detector: epoch losses or probabilities differ")
    print(f"  detector B=32 S={S}: 2 train epochs + 1 eval epoch, graph vs eager loop: "
          f"parameters, Adam state, epoch losses and {len(mg[0]['probs'])} probabilities per "
          f"epoch equal bit for bit (val loss {mg[2]['loss']:.6f}, auc {mg[2]['auc']:.4f}); "
          f"wrapper calls graph {cg}, loop {cl}", flush=True)
    out["detector"]["wrapper_calls_graph_path"] = cg
    for path, (trainer, state, _, _) in runs.items():
        stamps = timed_before(trainer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for e in (3, 4, 5):
            trainer.run_epoch(state, bank, n, seed=e)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        gaps = list(stamps)
        _, twall, busy, found, _ = traced(lambda: trainer.run_epoch(state, bank, n, seed=6))
        row = path_times(f"detector train {path} path (3 epochs timed, 1 traced)", S, wall / 3,
                         twall, busy, gaps)
        t0 = time.perf_counter()
        for e in (3, 4, 5):
            trainer.run_epoch(state, bank, n, seed=100 + e, train=False)
        torch.cuda.synchronize()
        ewall = (time.perf_counter() - t0) * 1e3 / 3
        _, etwall, ebusy, efound, _ = traced(
            lambda: trainer.run_epoch(state, bank, n, seed=106, train=False))
        erow = path_times(f"detector eval {path} path (3 epochs timed, 1 traced; no host "
                          f"stamp: eval steps draw no dropout)", S, ewall, etwall, ebusy, [])
        print(f"    kernels in the traced train epoch {found}, eval epoch {efound}", flush=True)
        out["detector"][path] = {"train": row, "eval": erow}
        if path == "graph":
            replayed["detector_train"], replayed["detector_eval"] = found, efound
    same_state(runs["graph"][1], runs["loop"][1], "detector after 6 epochs")
    print(f"  detector replayed epochs ({S} replays each): mel_stats by profiler name train "
          f"{replayed['detector_train']['mel_stats']}, eval "
          f"{replayed['detector_eval']['mel_stats']} (expected {S} each; conv1_pool runs "
          f"in the bank build, before the programs: "
          f"{replayed['detector_train']['conv1_pool']} in the replays)", flush=True)
    if min(replayed["detector_train"]["mel_stats"],
           replayed["detector_eval"]["mel_stats"]) < S:
        raise SystemExit("K5 did not run inside the detector graphs' replays")
    del runs
    torch.cuda.empty_cache()
    return out, replayed


# ---------------------------------------------------------------------------
# 10. serving daemon and artifacts
# ---------------------------------------------------------------------------

# the phase's load: 64 /v1/transcribe and 32 /v1/sync_score requests from 16
# client threads; near-tie margin for comparing transcripts across batchings
SERVE_TRANSCRIBE, SERVE_SYNC, SERVE_THREADS = 64, 32, 16
NEAR_TIE = 1e-4
MAX_BODY_MB = 8  # a native 75 x 288 x 360 uint8 clip (7.8 MB) fits, 9 MB does not


def http(method, url, body=None, ctype="application/octet-stream", timeout=300.0):
    """(status, JSON answer) of one request; HTTP errors are answers too."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method,
                                 headers={"Content-Type": ctype} if body is not None else {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def npy_bytes(arr):
    import io

    import numpy as np

    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def npz_bytes(**arrays):
    import io

    import numpy as np

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


class Daemon:
    """`python -m avsync_torch.cli serve ...` as a child process: its output
    read by a thread, its address parsed from what it prints."""

    def __init__(self, args, timeout: float = 300.0):
        import queue

        self.proc = subprocess.Popen([sys.executable, "-m", "avsync_torch.cli", "serve", *args],
                                     cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
        self.lines, self._q = [], queue.Queue()
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        deadline = time.perf_counter() + timeout
        self.url = None
        while self.url is None:
            try:
                line = self._q.get(timeout=max(0.1, deadline - time.perf_counter()))
            except queue.Empty:
                line = None
            if line is None or time.perf_counter() > deadline:
                self.kill()
                raise SystemExit(f"serve did not print its address: {self.lines[-20:]}")
            if " on http://" in line:
                self.url = line.split(" on ")[1].split()[0]

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            self._q.put(line)
        self._q.put(None)

    def stop(self, timeout: float = 120.0) -> int:
        """SIGTERM, then the exit code (the drain's)."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise SystemExit("serve did not exit after SIGTERM")
        self._reader.join(timeout=10)
        return rc

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=30)


def load(url, tasks, n_threads=SERVE_THREADS):
    """Run (path, body, ctype) tasks from n_threads client threads: the
    answers, each request's latency in ms, and the wall seconds."""
    answers, lat = [None] * len(tasks), [None] * len(tasks)

    def client(tid):
        for i in range(tid, len(tasks), n_threads):
            path, body, ctype = tasks[i]
            t0 = time.perf_counter()
            answers[i] = http("POST", url + path, body, ctype)
            lat[i] = (time.perf_counter() - t0) * 1e3

    threads = [threading.Thread(target=client, args=(t,), daemon=True) for t in range(n_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or any(a is None for a in answers):
        raise SystemExit("a client thread did not finish")
    return answers, lat, wall


def pct(values, p):
    v = sorted(values)
    return v[min(len(v) - 1, int(p * (len(v) - 1)))]


def same_transcripts(got, clips, reader, what, near_tie=NEAR_TIE):
    """Each served transcript equals the in-process reader's for its clip
    (batches of 8), except where the reader's top two log-probs of some frame
    lie within `near_tie` (a batch of another size may round them the other
    way). Returns the near ties."""
    import numpy as np

    near = []
    for lo in range(0, len(clips), 8):
        group = clips[lo:lo + 8]
        geoms = {c.shape for c in group}
        lps = [reader._logprobs(reader.preprocess_device(np.concatenate(
            [reader.prepare_raw(c)[0] for c in group if c.shape == g]))) for g in geoms]
        order = [[i for i, c in enumerate(group) if c.shape == g] for g in geoms]
        for lp, idx in zip(lps, order):
            texts = reader._decode(lp)
            top2 = lp.topk(2, dim=-1).values
            margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
            for j, i in enumerate(idx):
                if got[lo + i] != texts[j]:
                    if not (margin[j] < near_tie).any():
                        raise SystemExit(f"{what}: request {lo + i} answered {got[lo + i]!r}, "
                                         f"the in-process reader {texts[j]!r}")
                    near.append(lo + i)
    return near


def transcribe_load(url, clips, reader, what, near_tie=NEAR_TIE):
    """One /v1/transcribe request per clip from SERVE_THREADS threads: p50
    and p99 latency and clips/s; each transcript held against the
    in-process reader (`same_transcripts`)."""
    answers, lat, wall = load(url, [("/v1/transcribe", npy_bytes(c), "application/x-npy")
                                    for c in clips])
    bad = [a for a in answers if a[0] != 200]
    if bad:
        raise SystemExit(f"{what}: transcribe answered {bad[:3]}")
    near = same_transcripts([a[1]["transcript"] for a in answers], clips, reader, what,
                            near_tie)
    return {"p50_ms": pct(lat, 0.5), "p99_ms": pct(lat, 0.99), "clips_per_s": len(lat) / wall,
            "wall_s": wall, "near_ties": near}


def serve_checks(url, transcribe_clips, sync_reqs, reader, scorer, what):
    """The phase's load against one daemon, then its status codes: the
    load's numbers and the /v1/stats snapshot."""
    import numpy as np

    # the client's own first request pays for urllib's set-up: a GET first,
    # so the first POST times the daemon's first request after --warmup
    if http("GET", url + "/healthz") != (200, {"status": "ok"}):
        raise SystemExit(f"{what}: /healthz is not ok")
    lone = []
    for _ in range(2):  # the first request after --warmup, then a second one alone
        t0 = time.perf_counter()
        status, ans = http("POST", url + "/v1/transcribe", npy_bytes(transcribe_clips[1]),
                           "application/x-npy")
        lone.append(((time.perf_counter() - t0) * 1e3, ans.get("latency_ms")))
        if status != 200:
            raise SystemExit(f"{what}: a lone request answered {status} {ans}")
    (first_ms, first_server_ms), (second_ms, _) = lone
    trow = transcribe_load(url, transcribe_clips, reader, what)
    near = trow.pop("near_ties")
    sync_tasks = [("/v1/sync_score", npz_bytes(frames=f, audio=a, fps=25.0,
                                                shifts=np.asarray(DET_SHIFTS)),
                   "application/x-npz") for f, a in sync_reqs]
    s_answers, s_lat, s_wall = load(url, sync_tasks)
    worst = 0.0
    for (status, ans), (f, a) in zip(s_answers, sync_reqs):
        if status != 200 or ans["shifts"] != list(DET_SHIFTS):
            raise SystemExit(f"{what}: sync_score answered {status} {ans}")
        want = scorer.score_arrays(f, a, 25.0, DET_SHIFTS)
        got = np.asarray(ans["sync_probs"])
        if got.shape != want.shape or not np.isfinite(got).all():
            raise SystemExit(f"{what}: bad probabilities {got}")
        worst = max(worst, float(np.abs(got - want).max()))
    # the JSON rounds to 6 decimals: 5e-7 of the 1e-4 is rounding
    if worst > PROB_ATOL:
        raise SystemExit(f"{what}: probabilities {worst:.3e} from the in-process scorer")
    _, stats = http("GET", url + "/v1/stats")
    batches = {k: {int(b): n for b, n in stats[k]["batches"].items()}
               for k in ("transcribe", "sync_score")}
    if not all(any(b > 1 for b in v) for v in batches.values()):
        raise SystemExit(f"{what}: no batch of more than one row: {batches}")
    codes = {"400": http("POST", url + "/v1/transcribe", b"{}", "application/json")[0],
             "404": http("GET", url + "/nope")[0],
             "413": http("POST", url + "/v1/transcribe", b"x" * ((MAX_BODY_MB + 1) << 20),
                         "application/x-npy")[0]}
    if codes != {"400": 400, "404": 404, "413": 413}:
        raise SystemExit(f"{what}: status codes {codes}")
    row = {"first_request_ms": first_ms, "first_request_server_ms": first_server_ms,
           "second_lone_request_ms": second_ms, "transcribe": trow,
           "sync_score": {"p50_ms": pct(s_lat, 0.5), "p99_ms": pct(s_lat, 0.99),
                          "requests_per_s": len(s_lat) / s_wall, "wall_s": s_wall},
           "batches": batches, "near_ties": near, "max_prob_err": worst}
    print(f"  {what}: first request (after --warmup) {first_ms:.3f} ms ({first_server_ms} ms "
          f"in the daemon), a second one alone {second_ms:.3f} ms; {len(transcribe_clips)} "
          f"transcribe "
          f"p50_ms={row['transcribe']['p50_ms']:.3f} p99_ms={row['transcribe']['p99_ms']:.3f} "
          f"clips_per_s={row['transcribe']['clips_per_s']:.3f}; {len(s_lat)} sync_score x "
          f"{len(DET_SHIFTS)} shifts p50_ms={row['sync_score']['p50_ms']:.3f} p99_ms="
          f"{row['sync_score']['p99_ms']:.3f} requests_per_s="
          f"{row['sync_score']['requests_per_s']:.3f}; batches {batches}; transcripts equal the "
          f"in-process reader's (near ties {near}); probabilities max_abs_err={worst:.3e} "
          f"(tol {PROB_ATOL}); status codes {codes}", flush=True)
    return row


def sigterm_drain(daemon, clip, n=16):
    """SIGTERM as soon as the first of n concurrent requests is answered:
    every request answers 200 and the process exits 0. Returns how many were
    still unanswered when the signal went."""
    import http.client

    body = npy_bytes(clip)
    conns = []
    host, port = daemon.url.removeprefix("http://").split(":")
    for _ in range(n):
        c = http.client.HTTPConnection(host, int(port), timeout=300)
        c.connect()
        conns.append(c)
    done, codes, first = [], [None] * n, threading.Event()
    go = threading.Barrier(n)

    def client(i):
        go.wait(timeout=60)
        conns[i].request("POST", "/v1/transcribe", body, {"Content-Type": "application/x-npy"})
        r = conns[i].getresponse()
        r.read()
        codes[i] = r.status
        done.append(i)
        first.set()

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    if not first.wait(timeout=300):
        raise SystemExit("no request was answered before SIGTERM")
    pending = n - len(done)
    rc = daemon.stop()
    for t in threads:
        t.join(timeout=60)
    for c in conns:
        c.close()
    if rc != 0 or codes != [200] * n:
        raise SystemExit(f"SIGTERM drain: exit {rc}, answers {codes}")
    return pending


def write_serving_checkpoints(cfg, workdir):
    """Phase 4's and 7's seeded LipNet and detector weights as `.pth` files
    through the bridges."""
    from avsync_torch.compat import (conv_shape_for, detector_params_from_jax,
                                     lipnet_params_from_jax, save_detector_pth, save_lipnet_pth)

    lip, det = os.path.join(workdir, "lipnet.pth"), os.path.join(workdir, "detector.pth")
    shape = conv_shape_for(cfg)
    save_lipnet_pth(lipnet_params_from_jax(seeded_jax_layout_params(cfg, seed=0),
                                           conv_shape=shape), lip)
    save_detector_pth(detector_params_from_jax(
        seeded_jax_layout_detector_params(2 * 6912 + 40, 256, seed=1), shape),
        det, 2 * 6912 + 40, 256, {})
    return lip, det


def served_launches(server, requests, what):
    """Requests through an in-process AvsyncServer with the counters zeroed
    just before and read just after: per batch K1 once and K2 once per
    BiGRU layer (transcribe), K1 and K5 once (sync_score), no backward."""
    zero_counts()
    answers, _, _ = load(f"http://{server.address[0]}:{server.address[1]}", requests)
    import torch

    torch.cuda.synchronize()
    got = counts()
    if any(a[0] != 200 for a in answers):
        raise SystemExit(f"{what}: {[a for a in answers if a[0] != 200][:3]}")
    snap = server.stats_snapshot()
    nt = sum(snap["transcribe"]["batches"].values())
    ns = sum(snap["sync_score"]["batches"].values())
    want = {"conv1_pool": nt + ns, "gru_fwd": 2 * nt, "gru_bwd": 0, "conv1_pool_bwd": 0,
            "mel_stats": ns}
    print(f"  launches through the {what} daemon: {got} for {nt} transcribe and {ns} "
          f"sync_score batches (expected {want})", flush=True)
    if got != want:
        raise SystemExit(f"{what}: launch counts do not match the batches served")
    return {"transcribe_batches": nt, "sync_batches": ns, **got}


def operator_dispatch_ms(dev):
    """Each kernel through its torch.library operator against its CUDA body
    called directly, at the serving shapes (K1 and K2 at B=8, K5 at a
    scorer batch of 8 x 5 shifts), CUDA events: what the dispatch adds."""
    import torch

    from avsync_torch.config import AudioConfig
    from avsync_torch.ops.audio import device_constants
    from avsync_torch.ops.cuda import convpool, gru, mfcc

    g = torch.Generator().manual_seed(12)
    H = 256
    melT, dctT, _ = device_constants(AudioConfig(), dev)
    cases = {
        "conv1_pool": (torch.ops.avsync_torch.conv1_pool, convpool._conv1_pool_cuda,
                       [t.to(dev) for t in (torch.rand(8, 1, 75, 50, 100, generator=g),
                                            torch.randn(32, 1, 3, 5, 5, generator=g) * 0.2,
                                            torch.randn(32, generator=g))]),
        "gru_fwd": (torch.ops.avsync_torch.bigru_fwd, gru._bigru_fwd_cuda,
                    [*(torch.randn(8, 75, 3 * H, generator=g).to(dev) for _ in range(2)),
                     *((torch.randn(3 * H, H, generator=g) / H ** 0.5).to(dev).t()
                       for _ in range(2)),
                     *(torch.randn(3 * H, generator=g).to(dev) for _ in range(2))]),
        "mel_stats": (torch.ops.avsync_torch.mel_stats, mfcc._mel_stats_cuda,
                      [torch.rand(40, 121, 1025, generator=g).to(dev),
                       torch.full((40,), 121, dtype=torch.int32, device=dev), melT, dctT, 80.0]),
    }
    out = {}
    for name, (op, direct, args) in cases.items():
        out[name] = {"operator_ms": time_ms(lambda: op(*args)),
                     "direct_ms": time_ms(lambda: direct(*args))}
    return out


def stored_parameters(art) -> int:
    """The parameters one program of an artifact stores (each program of a
    bucketed artifact stores its own copy)."""
    ep = next(iter(art._exported.values()))
    return sum(ep.state_dict[n].numel() for n in ep.graph_signature.parameters)


def check_sync_artifact_state(art, scorer):
    """The sync-scorer artifact, loaded on the card, stores the LipNet's
    conv blocks and the detector in every program, and no BiGRU or head
    parameter."""
    want = {f"lipnet.{n}": tuple(p.shape) for n, p in scorer.lipnet.named_parameters()
            if n.startswith("conv")}
    want.update({f"detector.{n}": tuple(p.shape) for n, p in scorer.detector.named_parameters()})
    unread = sum(p.numel() for n, p in scorer.lipnet.named_parameters()
                 if not n.startswith("conv"))
    for b, ep in art._exported.items():
        got = {n: tuple(ep.state_dict[n].shape) for n in ep.graph_signature.parameters}
        if got != want:
            raise SystemExit(f"sync artifact bucket {b}: stored parameters part from the conv "
                             f"blocks' and the detector's at {sorted(set(got) ^ set(want))}")
    res = {"programs": len(art._exported), "params_per_program": stored_parameters(art),
           "unread_lipnet_params_left_out": unread}
    print(f"serving phase: sync artifact state: {json.dumps(res)}", flush=True)
    return res


def lead_in(dev):
    """A few small kernels and a sync at the start of a profiled window: a
    trace of one short call lost the call's first kernels without them."""
    import torch

    x = torch.zeros(1024, device=dev)
    for _ in range(8):
        x.add_(1.0)
    torch.cuda.synchronize()


def run_serving(dev, workdir, corpus, ckpt_dir, test_config, greedy_results, smi):
    """Phase 10: export, the live daemon and the artifact daemon under load,
    the launch proof, the times, and beam search through `cli test` on phase
    5's corpus, checkpoint and config (whose greedy results it repeats)."""
    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.config import AudioConfig, AvsyncConfig, ModelConfig
    from avsync_torch.export import load_exported
    from avsync_torch.predictor import LipReader, MisalignmentScorer
    from avsync_torch.serving import (ArtifactSyncScoreService, ArtifactTranscribeService,
                                      AvsyncServer, SyncScoreService, TranscribeService)

    cfg = AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True),
                       audio=AudioConfig(use_pallas=True))
    lip, det = write_serving_checkpoints(cfg, workdir)
    out = {}

    # a. export on the card through the command line
    arts = {"static": (os.path.join(workdir, "static.zip"), ["--batch_sizes", "1,2,4,8"]),
            "symbolic_native": (os.path.join(workdir, "symbolic.zip"),
                                ["--frame_geometry", "288x360"]),
            "sync": (os.path.join(workdir, "sync.zip"),
                     ["--detector_checkpoint", det, "--shifts_per_request",
                      str(len(DET_SHIFTS)), "--batch_sizes", "1,2,4,8"])}
    loaded, secs = {}, {}
    for name, (path, extra) in arts.items():
        t0 = time.perf_counter()
        if cli.main(["export", "--checkpoint", lip, "--out", path, *F32, *extra]) != 0:
            raise SystemExit(f"export {name} failed")
        t1 = time.perf_counter()
        loaded[name] = load_exported(path)
        secs[name] = {"export_s": t1 - t0, "load_s": time.perf_counter() - t1,
                      "mb": os.path.getsize(path) / 1e6,
                      "params": stored_parameters(loaded[name])}
        if loaded[name].meta["device"] != str(dev):
            raise SystemExit(f"{name} artifact exported for {loaded[name].meta['device']}")
    print(f"serving phase: export (cli, on the card): {json.dumps(secs)}", flush=True)
    out["export"] = secs

    reader = LipReader(checkpoint=lip, config=cfg, device=dev)
    scorer = MisalignmentScorer(det, lip, config=cfg, device=dev)
    out["sync_artifact_state"] = check_sync_artifact_state(loaded["sync"], scorer)
    r = np.random.default_rng(10)
    clips = [r.integers(0, 256, (75, 288, 360) if i % 2 == 0 else (75, 50, 100), dtype=np.uint8)
             for i in range(SERVE_TRANSCRIBE)]
    lengths = r.integers(1, 48001, SERVE_SYNC)
    lengths[0], lengths[1] = 0, 48000
    sync_reqs = [(r.integers(0, 256, (75, 288, 360) if i % 2 == 0 else (75, 50, 100),
                             dtype=np.uint8), syllable_audio(r, int(n)))
                 for i, n in enumerate(lengths)]

    # b. the live daemon; then the artifact daemon's load (c) on it too, so
    # the two compare like for like: an artifact takes the one frame geometry
    # it was exported at, so that load is 50x100 crops
    crops = [c if c.shape[1] == 50 else c[:, 100:150, 100:200].copy() for c in clips]
    crop_sync = [(f if f.shape[1] == 50 else f[:, 100:150, 100:200].copy(), a)
                 for f, a in sync_reqs]
    common = ["--port", "0", "--warmup", "--max_batch", str(MAX_BATCH), "--max_body_mb",
              str(MAX_BODY_MB)]
    daemon = Daemon(["--checkpoint", lip, "--detector_checkpoint", det, *F32, *common])
    try:
        out["live"] = serve_checks(daemon.url, clips, sync_reqs, reader, scorer, "live daemon")
        out["live"]["transcribe_crops"] = transcribe_load(daemon.url, crops, reader,
                                                          "live daemon, crops")
        out["live"]["sigterm_pending"] = sigterm_drain(daemon, clips[1])
    finally:
        daemon.kill()
    print(f"  live daemon, the artifact daemon's load of {len(crops)} 50x100 crops: "
          f"{json.dumps(out['live']['transcribe_crops'])}; SIGTERM with "
          f"{out['live']['sigterm_pending']} of 16 requests unanswered: every one answered "
          f"200, exit 0", flush=True)

    # c. the artifact daemon: a 288x360 request gets 400
    daemon = Daemon(["--artifact", arts["static"][0], "--artifact", arts["sync"][0], *common])
    try:
        out["artifact"] = serve_checks(daemon.url, crops, crop_sync, reader, scorer,
                                       "artifact daemon")
        wrong = http("POST", daemon.url + "/v1/transcribe", npy_bytes(clips[0]),
                     "application/x-npy")
        if wrong[0] != 400 or "expects 50x100" not in wrong[1]["error"]:
            raise SystemExit(f"artifact daemon took another geometry: {wrong}")
        out["artifact"]["sigterm_pending"] = sigterm_drain(daemon, crops[1])
    finally:
        daemon.kill()
    print(f"  artifact daemon: a 288x360 request answered 400; SIGTERM with "
          f"{out['artifact']['sigterm_pending']} of 16 unanswered: every one 200, exit 0",
          flush=True)
    worst = {}
    for name in ("static", "symbolic_native"):
        geom = (288, 360) if name == "symbolic_native" else (50, 100)
        frames = r.integers(0, 256, (8, 75, *geom), dtype=np.uint8)
        err = 0.0
        for B in (1, 3, 8):
            _, _, lp = loaded[name].call(frames[:B])
            want = reader._logprobs(reader.preprocess_device(np.concatenate(
                [reader.prepare_raw(f)[0] for f in frames[:B]]))).cpu().numpy()
            if lp.shape != want.shape or not np.isfinite(lp).all():
                raise SystemExit(f"{name} artifact: bad log-probs {lp.shape}")
            err = max(err, float(np.abs(lp - want).max()))
        worst[name] = err
    print(f"  ExportedTranscriber.call log-probs vs the live reader at B = 1, 3, 8: "
          f"max_abs_err {worst} (tol {SLICE_ATOL})", flush=True)
    if max(worst.values()) > SLICE_ATOL:
        raise SystemExit("an artifact's log-probs disagree with the live reader's")
    out["artifact_vs_live_logprob_err"] = worst

    # d. launch proof through in-process daemons, live and artifact
    tasks = ([("/v1/transcribe", npy_bytes(c), "application/x-npy") for c in crops[:32]]
             + [("/v1/sync_score", npz_bytes(frames=f, audio=a, fps=25.0,
                                             shifts=np.asarray(DET_SHIFTS)), "application/x-npz")
                for f, a in crop_sync[:16]])
    launches = {}
    for what, services in (
            ("live", lambda: (TranscribeService(reader, max_batch=MAX_BATCH, max_wait_ms=5.0),
                              SyncScoreService(scorer, max_batch=MAX_BATCH, max_wait_ms=5.0))),
            ("artifact", lambda: (ArtifactTranscribeService(loaded["static"],
                                                            max_batch=MAX_BATCH, max_wait_ms=5.0),
                                  ArtifactSyncScoreService(loaded["sync"], max_batch=MAX_BATCH,
                                                           max_wait_ms=5.0)))):
        server = AvsyncServer(*services(), port=0)
        server.start()
        try:
            launches[what] = served_launches(server, tasks, what)
        finally:
            server.shutdown(drain_timeout=30.0)
    out["launches"] = launches
    frames8 = loaded["static"].prepare_rows(np.stack(crops[1:17:2]))
    audio8 = np.zeros((8, 48000), np.float32)
    calls = {"transcriber": (lambda: loaded["static"].call(frames8), ("conv1_pool", "gru_fwd")),
             "sync_scorer": (lambda: loaded["sync"].call(
                 frames8, audio8 + 0.1, np.full(8, 48000, np.int32), np.full(8, 25.0, np.float32),
                 np.tile(np.asarray(DET_SHIFTS, np.int32), (8, 1))), ("conv1_pool", "mel_stats"))}
    traced_names = {}
    for kind, (call, kernels) in calls.items():
        call()
        _, _, _, found, names = traced(lambda: (lead_in(dev), call()), has_kernels(
            *(KERNEL_NAMES[k] for k in kernels)))
        traced_names[kind] = {k: found[k] for k in KERNEL_NAMES}
        if not all(found[k] for k in kernels):
            raise SystemExit(f"{kind} artifact call: the trace shows {found}, not {kernels}; "
                             f"every kernel in it: {names}")
    print(f"  kernels by profiler name in one artifact call at B=8: {traced_names}", flush=True)
    out["artifact_call_kernels"] = traced_names

    # e. an artifact call against the live path at B = 1 and 8 (host frames
    # in, host results out: upload, preprocess, forward, greedy decode)
    times = {}
    for B in (1, 8):
        frames = np.stack(crops[:B])
        times[f"B{B}"] = {
            "artifact_ms": time_ms(lambda: loaded["static"].call(frames)),
            "live_ms": time_ms(lambda: reader._decode(reader._logprobs(reader.preprocess_device(
                np.concatenate([reader.prepare_raw(f)[0] for f in frames])))))}
    print(f"  artifact call vs live reader (CUDA events, warm-up first, median of 20): "
          f"{json.dumps(times)} [{smi}]", flush=True)
    out["call_ms"] = times
    out["dispatch_ms"] = operator_dispatch_ms(dev)
    print(f"  kernels through their operators vs their CUDA bodies called directly (CUDA "
          f"events, median of 20): {json.dumps(out['dispatch_ms'])} [{smi}]", flush=True)

    # f. beam search through `cli test` on phase 5's corpus and checkpoint
    res = {}
    for width in (0, 4):
        path = os.path.join(workdir, f"beam{width}.json")
        t0 = time.perf_counter()
        if cli.main(["test", "--data_path", corpus, "--config", test_config, "--checkpoint",
                     ckpt_dir, "--output", path, "--beam", str(width), *F32]) != 0:
            raise SystemExit(f"cli test --beam {width} failed")
        with open(path) as f:
            res[width] = json.load(f)
        res[width]["seconds"] = time.perf_counter() - t0
    print(f"  cli test --beam 0: {res[0]}; --beam 4: {res[4]}", flush=True)
    if {k: v for k, v in res[0].items() if k != "seconds"} != greedy_results:
        raise SystemExit("test --beam 0 differs from phase 5's greedy test")
    if res[4]["num_samples"] != greedy_results["num_samples"] or not np.isfinite(res[4]["cer"]):
        raise SystemExit("test --beam 4 wrote a wrong result")
    out["beam"] = res
    print(f"  serving phase numbers [{smi}]: {json.dumps(out)}", flush=True)
    return out, crops


# ---------------------------------------------------------------------------
# 11. int8 serving (Q1)
# ---------------------------------------------------------------------------

INT8_OPS = 1979e12  # H100 SXM dense int8 tensor-core rate (data sheet)
# LipNet's three conv blocks at full width: (Cin, Cout, H, W, kernel)
INT8_BLOCKS = {"conv1": (1, 32, 50, 100, (3, 5, 5)), "conv2": (32, 64, 25, 50, (3, 5, 5)),
               "conv3": (64, 96, 12, 25, (3, 3, 3))}


# the operator's contracts: (input dtype)_(output dtype)
Q1_CONTRACTS = ("f32_f32", "f32_s8", "s8_s8", "s8_f32")


def channels_last(x):
    """x (B, C, T, H, W) with its channels contiguous, as Q1 writes its
    output (the layout the int8 forward gives conv2 and conv3)."""
    return x.permute(0, 2, 3, 4, 1).contiguous().permute(0, 4, 1, 2, 3)


def q1_case(g, dev, B, cin, cout, T, H, W, k, mode="random"):
    """(QuantConvParams, x) on the card, as tests/test_torch_kernels_cuda.py's:
    'random' x around 0.3 with negative values, random int8 weights and
    scales, x_scale = absmax/127; 'ties' x in quarters with x_scale 0.5
    (exact halves to round, values past the clip); 'near_ties' x at (k +
    0.5) * x_scale with x_scale 1/3 (quotients within an ulp or two of a
    half: the quantizer's exact fallback); 'extreme' the largest
    accumulators (every x at +127 steps, every weight 127)."""
    import torch

    from avsync_torch.ops.quant import quant_conv_params

    kq = torch.randint(-127, 128, (cout, cin, *k), generator=g, dtype=torch.int8)
    ks = torch.rand(cout, generator=g) * 0.01 + 1e-4
    bias = torch.randn(cout, generator=g) * 0.1
    if mode == "ties":
        x = torch.randint(-300, 301, (B, cin, T, H, W), generator=g).float() / 4
        xs = 0.5
    elif mode == "near_ties":  # x / x_scale within an ulp or two of k + 0.5
        xs = float(torch.tensor(1 / 3))
        x = (torch.randint(-130, 130, (B, cin, T, H, W), generator=g) + 0.5).float() * xs
    elif mode == "extreme":
        kq.fill_(127)
        xs = 0.01
        x = torch.full((B, cin, T, H, W), 127 * xs)
    else:
        x = torch.randn(B, cin, T, H, W, generator=g) * 0.5 + 0.3
        xs = float(x.abs().max()) / 127
    return quant_conv_params(kq.to(dev), ks, bias, xs), x.to(dev)


def im2col_int_mm_block(qc, x, dt=None):
    """The library yardstick for one int8 block (nothing in the port calls
    it): quantize, an im2col gather of the int8 input (K zero-padded to a
    multiple of 8), `torch._int_mm`, then the same dequant, ReLU and pool in
    PyTorch ops (the bf16 epilogue's roundings under `dt` bf16)."""
    import torch
    import torch.nn.functional as F

    from avsync_torch.ops.cuda import quantconv

    B, cin, T, H, W = x.shape
    cout, _, kt, kh, kw = qc.kernel_q.shape
    K = cin * kt * kh * kw
    k8 = -(-K // 8) * 8
    xq = quantconv.quantize_input(x, float(qc.x_scale)).to(torch.int8)
    xp = F.pad(xq, ((kw - 1) // 2, (kw - 1) // 2, (kh - 1) // 2, (kh - 1) // 2,
                    (kt - 1) // 2, (kt - 1) // 2))
    cols = xp.unfold(2, kt, 1).unfold(3, kh, 1).unfold(4, kw, 1)  # (B, Cin, T, H, W, kt, kh, kw)
    a = cols.permute(0, 2, 3, 4, 5, 6, 7, 1).reshape(B * T * H * W, K)
    if k8 != K:
        a = F.pad(a, (0, k8 - K))
    acc = torch._int_mm(a, qc.packed[:cout, :k8].t())
    acc = acc.view(B, T, H, W, cout).permute(0, 4, 1, 2, 3)
    if dt == torch.bfloat16:
        return quantconv._dequant_pool(acc, qc.scale16, qc.bias16)
    return quantconv._dequant_pool(acc, qc.scale, qc.bias)


# the contract each block of the int8 forward runs in: (input, output) dtype
CHAIN_CONTRACTS = {"conv1": "f32_s8", "conv2": "s8_s8", "conv3": "s8_f32"}


def q1_contract(qc, x, contract, mode, dt=None):
    """(input, out_scale) of one contract of Q1, as
    tests/test_torch_kernels_cuda.py's: an int8 input is x quantized with
    the block's scale, channels-last; an int8 output takes a scale that maps
    the float output's largest value (bf16 under `dt` bf16) to 127 (200 in
    'extreme' mode: past the clip), or 0.125 in 'ties' mode."""
    import torch

    from avsync_torch.ops.cuda import quantconv

    if contract.startswith("s8"):
        x = channels_last(quantconv.quantize_input(x, float(qc.x_scale)).to(torch.int8))
    if not contract.endswith("s8"):
        return x, None
    top = float(quantconv.int8_conv_pool_ref(x, qc.kernel_q, qc.k_scale, qc.bias,
                                             float(qc.x_scale), compute_dtype=dt).float().max())
    return x, {"ties": 0.125, "extreme": top / 200}.get(mode, top / 127 or 1.0)


def q1_bytes_ops(B, T, cin, cout, H, W, k, contract):
    """(bytes, int8 operations) one launch must move and do: each input
    read once (4 or 1 bytes a value), the int8 weights, scale and bias (4
    bytes a value, 2 for the bf16 epilogue's), each output written once (4,
    2 or 1 bytes); the conv over the pre-pool positions the floor pool
    keeps. `contract`: (input)_(output), f32, bf16 or s8; a bf16 epilogue
    with an int8 output is `s8_s8_bf16` or `f32_s8_bf16`."""
    H2, W2 = H // 2, W // 2
    K = cin * k[0] * k[1] * k[2]
    n_ops = 2 * B * T * (2 * H2) * (2 * W2) * cout * K
    size = {"s8": 1, "bf16": 2, "f32": 4}
    parts = contract.split("_")
    x_b, o_b = size[parts[0]], size[parts[1]]
    sb = 2 if parts[-1] == "bf16" else 4
    n_bytes = x_b * B * cin * T * H * W + cout * K + 2 * sb * cout + o_b * B * cout * T * H2 * W2
    return n_bytes, n_ops


def q1_equal_cases(g, dev, cases, contracts=Q1_CONTRACTS, dt=None):
    """Q1 against its plain version in each contract of `contracts` for each
    (B, Cin, Cout, T, H, W, k, mode) case: equal bit for bit (torch.equal),
    a repeat launch equal too; T=75 inputs with Cin > 1 channels-last (the
    int8 forward's layout of conv2 and conv3). `dt` bf16: the bf16
    epilogue (and the bf16 contracts)."""
    import torch

    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.ops.quant import quant_conv_block

    for B, cin, cout, T, H, W, k, mode in cases:
        qc, x32 = q1_case(g, dev, B, cin, cout, T, H, W, k, mode)
        if T == 75 and cin > 1:
            x32 = channels_last(x32)
        tile = quantconv.tile_for(H // 2, W // 2, cin, cout, *k)
        per_sm = quantconv.ctas_per_sm(cin, *k, tile)
        said = []
        for contract in contracts:
            x, out_scale = q1_contract(qc, x32, contract, mode, dt)
            got = quant_conv_block(qc, x, out_scale, compute_dtype=dt)
            again = quant_conv_block(qc, x, out_scale, compute_dtype=dt)
            want = quantconv.int8_conv_pool_ref(x, qc.kernel_q, qc.k_scale, qc.bias,
                                                float(qc.x_scale), out_scale, compute_dtype=dt)
            torch.cuda.synchronize()
            ok = (got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
                  and torch.equal(got, again))
            said.append(f"{contract} {'equal' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"kernel check failed: Q1{'-bf16' if dt else ''} at B={B} "
                                 f"Cin={cin} {H}x{W} {mode} {contract}")
            del x, got, again, want
        tiles = -(-(H // 2) // tile.rows) * -(-(W // 2) // tile.cols)
        print(f"  B={B} Cin={cin} Cout={cout} T={T} {H}x{W} k={k} {mode} ({q1_tile_text(tile)}, "
              f"{per_sm} per SM, {quantconv.frames_for(B, T, tiles, 132, per_sm)} frames per "
              f"CTA): {', '.join(said)} bit for bit, repeat equal", flush=True)
        del qc, x32
        torch.cuda.empty_cache()


def q1_tile_text(tile):
    """A Q1 tile in words: its pooled positions and how B reaches the MMAs."""
    ring = (f", B ring {tile.groups} x 32 channels, stages of {tile.chunks} k-chunks"
            if tile.groups else ", B per warp task")
    return f"tile {tile.rows}x{tile.cols}{ring}"


def q1_block_times(g, dev, blocks, smi, B=8, T=75):
    """Kernel (CUDA events, and on the device alone: `queued_ms`), plain,
    library (im2col + `torch._int_mm`, held equal to Q1) and f32 cuDNN times
    of each of `blocks` {name: (Cin, Cout, H, W, k)} at B, each in the
    contract the int8 forward gives it (CHAIN_CONTRACTS) beside its
    f32-contract time, with the bounds, the tile, its CTAs per SM and the
    weight bytes the planner reckons. Returns ({name: row}, bytes, int8
    operations) of the chain."""
    import torch

    from avsync_torch.ops.conv import conv_relu_pool
    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.ops.quant import quant_conv_block

    rows, total_bytes, total_ops = {}, 0, 0
    for name, (cin, cout, H, W, k) in blocks.items():
        qc, x32 = q1_case(g, dev, B, cin, cout, T, H, W, k)
        if cin > 1:  # the int8 forward's layout
            x32 = channels_last(x32)
        contract = CHAIN_CONTRACTS[name]
        x, out_scale = q1_contract(qc, x32, contract, "random")
        lib = im2col_int_mm_block(qc, x32)
        if not torch.equal(lib, quant_conv_block(qc, x32)):
            raise SystemExit(f"the im2col + _int_mm yardstick differs from Q1 at {name}")
        del lib
        w32 = (qc.kernel_q.float() * qc.k_scale.view(-1, 1, 1, 1, 1)).contiguous()
        ms = time_ms(lambda: quant_conv_block(qc, x, out_scale))
        q_ms = queued_ms(lambda: quant_conv_block(qc, x, out_scale))
        f32c_ms = time_ms(lambda: quant_conv_block(qc, x32))
        plain = time_ms(lambda: quantconv.int8_conv_pool_ref(
            x, qc.kernel_q, qc.k_scale, qc.bias, float(qc.x_scale), out_scale), iters=3,
            warmup=1)
        lib_ms = time_ms(lambda: im2col_int_mm_block(qc, x32), iters=3, warmup=1)
        f32_ms = time_ms(lambda: conv_relu_pool(x32, w32, qc.bias), iters=5, warmup=2)
        n_bytes, n_ops = q1_bytes_ops(B, T, cin, cout, H, W, k, contract)
        f32c_bytes, _ = q1_bytes_ops(B, T, cin, cout, H, W, k, "f32_f32")
        H2, W2 = H // 2, W // 2
        tile = quantconv.tile_for(H2, W2, cin, cout, *k)
        per_sm = quantconv.ctas_per_sm(cin, *k, tile)
        row = {"contract": contract, "ms": ms, "queued_ms": q_ms, "plain_ms": plain,
               "library_ms": lib_ms, "cudnn_f32_ms": f32_ms, "f32_contract_ms": f32c_ms,
               "int8_gops": n_ops / 1e9, "mb": n_bytes / 1e6,
               "f32_contract_mb": f32c_bytes / 1e6, "tile": list(tile), "ctas_per_sm": per_sm,
               "weight_gb": quantconv.weight_traffic(B, T, H2, W2, cin, cout, *k, tile) / 1e9,
               "frames_per_cta": quantconv.frames_for(
                   B, T, -(-H2 // tile.rows) * -(-W2 // tile.cols), 132, per_sm),
               "bound_ms": max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS) * 1e3,
               "f32_contract_bound_ms": max(f32c_bytes / HBM_BYTES_PER_S,
                                            n_ops / INT8_OPS) * 1e3}
        rows[name] = row
        total_bytes += n_bytes
        total_ops += n_ops
        print(f"  {name} B={B} T={T} {H}x{W} {cin}->{cout} {contract}: kernel_ms={ms:.4f} "
              f"queued_ms={q_ms:.4f} ({q1_tile_text(tile)}, {per_sm} per SM, "
              f"{row['weight_gb']:.3f} GB of weights) "
              f"(f32 contract {f32c_ms:.4f}) plain_ms={plain:.4f} library_ms={lib_ms:.4f} "
              f"(im2col + _int_mm) cudnn_f32_ms={f32_ms:.4f} bound_ms={row['bound_ms']:.4f} "
              f"(f32 contract {row['f32_contract_bound_ms']:.4f}; {n_ops / 1e9:.1f} G int8 ops, "
              f"{n_bytes / 1e6:.1f} MB) [{smi}]", flush=True)
        del qc, x, x32, w32
        torch.cuda.empty_cache()
    return rows, total_bytes, total_ops


def q1_chain_row(rows, n_bytes, n_ops):
    """The chain's sums of `q1_block_times` rows and its bound."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / INT8_OPS * 1e3
    row = {key: sum(b[key] for b in rows.values())
           for key in ("ms", "queued_ms", "plain_ms", "library_ms", "cudnn_f32_ms",
                       "f32_contract_ms")}
    return dict(row, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check_int8_conv_pool(dev, smi):
    """Phase 11a-b: Q1 against its plain version in each contract (f32 or
    int8 in, f32 or int8 out) at LipNet's three blocks at full width (B =
    1, 8, 32) and at odd geometries, equal bit for bit, a repeat launch
    equal too; then kernel, plain, library (im2col + `torch._int_mm`) and
    f32 cuDNN times at B=8 (CUDA events) and the bound, each block in the
    contract the int8 forward gives it (conv1 f32 -> int8, conv2 int8 ->
    int8, conv3 int8 -> f32, channels-last between blocks), its f32-contract
    time and bound beside."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(60)
    print("int8_conv_pool (Q1) vs int8_conv_pool_ref (torch.equal required), contracts "
          f"{'/'.join(Q1_CONTRACTS)}:", flush=True)
    cases = [(B, cin, cout, 75, H, W, k, "random")
             for (cin, cout, H, W, k) in INT8_BLOCKS.values() for B in (1, 8, 32)]
    cases += [(2, 3, 5, 5, 9, 13, (1, 3, 5), "random"),
              (3, 64, 40, 4, 13, 27, (3, 3, 3), "random"),
              (2, 1, 7, 3, 7, 201, (5, 1, 3), "random"), (2, 12, 33, 2, 6, 10, (3, 5, 5), "random"),
              (2, 32, 64, 2, 25, 50, (3, 5, 5), "random"),
              (1, 16, 24, 1, 10, 14, (3, 3, 3), "random"),
              (2, 48, 20, 6, 11, 17, (3, 3, 3), "random"),
              (2, 32, 64, 3, 25, 50, (3, 5, 5), "ties"), (1, 1, 32, 3, 50, 100, (3, 5, 5), "ties"),
              (2, 32, 64, 3, 25, 50, (3, 5, 5), "near_ties"),
              (1, 1, 32, 3, 50, 100, (3, 5, 5), "near_ties"),
              (1, 32, 64, 3, 25, 50, (3, 5, 5), "extreme")]
    q1_equal_cases(g, dev, cases)
    blocks, n_bytes, n_ops = q1_block_times(g, dev, INT8_BLOCKS, smi)
    return dict(name="int8_conv_pool", route="cuda", source="avsync_torch/csrc/int8_conv_pool.cu",
                replaces="avsync/ops/quant.py:97", max_abs_err=0.0,
                **q1_chain_row(blocks, n_bytes, n_ops),
                shape="B=8 T=75 full width, conv1 + conv2 + conv3 (one int8 forward, int8 "
                      "between blocks)",
                replaces_note="no pallas_call: the int8 lax.conv_general_dilated of "
                              "quant_conv_block (avsync/ops/quant.py:112-135)",
                blocks=blocks)


def run_int8_serving(dev, workdir, corpus, ckpt_dir, test_config, greedy_results, crops,
                     f32_crops, smi, cfg=None):
    """Phase 11c-e: `cli quantize`, `cli test --quantize int8` and `cli infer
    --quantize int8` on phase 5's corpus and checkpoint; `cli serve
    --quantize int8 --qscales --warmup` as a child process under phase 10's
    64 crops, transcripts against an in-process int8 LipReader with the same
    scales, SIGTERM drain; launches through an in-process int8 daemon (per
    batch Q1 three times, K2 twice, K1 never); the full-width int8 forward
    against the f32 forward with the JAX package's bounds. `cfg`: phase 10's
    serving configuration (its default), which the daemon reads too."""
    import contextlib
    import glob
    import io

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.config import AudioConfig, AvsyncConfig, ModelConfig
    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.predictor import LipReader
    from avsync_torch.serving import AvsyncServer, TranscribeService

    out = {}
    # c. quantize, test, infer on phase 5's corpus and trained checkpoint
    qtrained = os.path.join(workdir, "qscales_trained.npz")
    common = ["--data_path", corpus, "--config", test_config, *F32]
    t0 = time.perf_counter()
    if cli.main(["quantize", *common, "--checkpoint", ckpt_dir, "--out", qtrained]) != 0:
        raise SystemExit("cli quantize failed")
    out["quantize_s"] = time.perf_counter() - t0
    path = os.path.join(workdir, "int8_results.json")
    t0 = time.perf_counter()
    if cli.main(["test", *common, "--checkpoint", ckpt_dir, "--output", path,
                 "--quantize", "int8"]) != 0:
        raise SystemExit("cli test --quantize int8 failed")
    with open(path) as f:
        res = json.load(f)
    out["test"] = {"int8": res, "f32": greedy_results, "seconds": time.perf_counter() - t0}
    if res["num_samples"] != greedy_results["num_samples"] or not np.isfinite(res["cer"]):
        raise SystemExit(f"test --quantize int8 wrote a wrong result: {res}")
    print(f"int8 serving phase: cli quantize -> {np.load(qtrained)['input_scales'].tolist()}; "
          f"cli test --quantize int8: cer={res['cer']} wer={res['wer']} (f32 test: cer="
          f"{greedy_results['cer']} wer={greedy_results['wer']}) on {res['num_samples']} clips",
          flush=True)
    # infer on phase 10's weights (a .pth) and one clip of the corpus: the
    # command calibrates on its own clip, as a fresh int8 reader does
    lip = os.path.join(workdir, "lipnet.pth")
    cfg = cfg or AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True),
                              audio=AudioConfig(use_pallas=True))
    serve_config = os.path.join(workdir, "serve_config.json")
    with open(serve_config, "w") as f:
        f.write(cfg.to_json())
    clip = sorted(glob.glob(os.path.join(corpus, "*", "video", "*.npy")))[0]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["infer", clip, "--checkpoint", lip, "--config", test_config,
                       "--quantize", "int8", *F32])
    said = [ln for ln in buf.getvalue().splitlines() if ln.startswith("Predicted:")]
    fresh = LipReader(checkpoint=lip, config=cli._config(test_config), device=dev,
                      quantize="int8")
    want = f"Predicted: {fresh.predict(clip)}"
    print(f"  cli infer --quantize int8 {os.path.relpath(clip, corpus)}: {said}", flush=True)
    if rc != 0 or said != [want]:
        raise SystemExit(f"cli infer --quantize int8 printed {said}, a fresh int8 reader {want!r}")
    out["infer"] = said[0]

    # d. the int8 daemon under phase 10's crops, on phase 10's weights
    qscales = os.path.join(workdir, "qscales.npz")
    if cli.main(["quantize", *common, "--checkpoint", lip, "--out", qscales]) != 0:
        raise SystemExit("cli quantize (serving weights) failed")
    reader = LipReader(checkpoint=lip, config=cfg, device=dev, quantize="int8",
                       calibration_scales=qscales)
    daemon = Daemon(["--checkpoint", lip, "--config", serve_config, "--quantize", "int8",
                     "--qscales", qscales, "--port", "0", "--warmup", "--max_batch",
                     str(MAX_BATCH), *F32])
    try:
        if http("GET", daemon.url + "/healthz") != (200, {"status": "ok"}):
            raise SystemExit("int8 daemon: /healthz is not ok")
        row = transcribe_load(daemon.url, crops, reader, "int8 daemon, crops")
        row["sigterm_pending"] = sigterm_drain(daemon, crops[1])
    finally:
        daemon.kill()
    out["daemon"] = row
    print(f"  int8 daemon (serve --quantize int8 --qscales --warmup), {len(crops)} 50x100 crops "
          f"from {SERVE_THREADS} threads: p50_ms={row['p50_ms']:.3f} p99_ms={row['p99_ms']:.3f} "
          f"clips_per_s={row['clips_per_s']:.3f}; the f32 daemon on the same crops (phase 10): "
          f"p50_ms={f32_crops['p50_ms']:.3f} p99_ms={f32_crops['p99_ms']:.3f} clips_per_s="
          f"{f32_crops['clips_per_s']:.3f}; transcripts equal the in-process int8 reader's "
          f"(near ties {row['near_ties']}); SIGTERM with {row['sigterm_pending']} of 16 "
          f"unanswered: every one 200, exit 0 [{smi}]", flush=True)

    # launches per served int8 batch, through an in-process daemon
    server = AvsyncServer(TranscribeService(reader, max_batch=MAX_BATCH, max_wait_ms=5.0),
                          None, port=0)
    server.start()
    try:
        zero_counts()
        answers, _, _ = load(f"http://{server.address[0]}:{server.address[1]}",
                             [("/v1/transcribe", npy_bytes(c), "application/x-npy")
                              for c in crops[:32]])
        torch.cuda.synchronize()
        got = {**counts(), "int8_conv_pool": quantconv.launches}
        nt = sum(server.stats_snapshot()["transcribe"]["batches"].values())
    finally:
        server.shutdown(drain_timeout=30.0)
    if any(a[0] != 200 for a in answers):
        raise SystemExit(f"int8 in-process daemon: {[a for a in answers if a[0] != 200][:3]}")
    want = {"conv1_pool": 0, "gru_fwd": 2 * nt, "gru_bwd": 0, "conv1_pool_bwd": 0,
            "mel_stats": 0, "int8_conv_pool": 3 * nt}
    print(f"  launches through the in-process int8 daemon: {got} for {nt} transcribe batches "
          f"(expected {want})", flush=True)
    if got != want:
        raise SystemExit("int8 daemon: launch counts do not match the batches served")
    out["launches"] = {"transcribe_batches": nt, **got}

    # e. the int8 forward against the f32 forward, the JAX package's bounds
    f32 = LipReader(checkpoint=lip, config=cfg, device=dev)
    frames = np.stack(crops[:8])
    clips = f32.preprocess_device(frames)
    lp8, lp32 = reader._logprobs(clips), f32._logprobs(clips)
    # the int8 hand-off between blocks against three f32-contract launches
    from avsync_torch.ops import quant as tq

    block = tq.quant_conv_block
    tq.quant_conv_block = lambda qc, x, out_scale=None, compute_dtype=None: block(
        qc, x, compute_dtype=compute_dtype)
    try:
        before = quantconv.launches
        lp_f32_contract = reader._logprobs(clips)
        if quantconv.launches - before != 3:
            raise SystemExit("the f32-contract int8 forward did not launch Q1 three times")
    finally:
        tq.quant_conv_block = block
    same = torch.equal(lp8, lp_f32_contract)
    out["hand_off_equals_f32_contract"] = same
    print(f"  int8 forward at B=8, int8 hand-off between blocks vs three f32-contract "
          f"launches: {'equal bit for bit' if same else 'DIFFERENT'}", flush=True)
    if not same:
        raise SystemExit("the int8 hand-off changed the int8 forward's log-probs")
    mean_abs = (lp8 - lp32).abs().mean().item()
    agree = (lp8.argmax(-1) == lp32.argmax(-1)).float().mean().item()
    out["int8_vs_f32"] = {"mean_abs_logprob": mean_abs, "argmax_agreement": agree}
    times = {"int8_ms": time_ms(lambda: reader._logprobs(clips)),
             "f32_ms": time_ms(lambda: f32._logprobs(clips))}
    out["forward_B8_ms"] = times
    print(f"  full-width int8 forward vs f32 at B=8: mean |d log-prob| {mean_abs:.3e} (< 0.05), "
          f"argmax agreement {agree:.4f} (>= 0.95); forward (CUDA events, median of 20) "
          f"{json.dumps(times)} [{smi}]", flush=True)
    if not (torch.isfinite(lp8).all() and mean_abs < 0.05 and agree >= 0.95):
        raise SystemExit("the int8 forward is outside the JAX package's bounds of the f32 one")
    # the int8 forward by profiler name: Q1 three times, K2 twice, no K1 and
    # no library convolution (cuDNN's kernels name fprop/implicit/conv)
    q1_k2 = (has_kernels("int8_conv_pool_kernel", n=3), has_kernels(KERNEL_NAMES["gru_fwd"], n=2))
    busy, names = traced_step(lambda: reader._logprobs(clips),
                              lambda events: all(c(events) for c in q1_k2))
    found = {k: sum(n for name, n in names.items() if pat in name)
             for k, pat in KERNEL_NAMES.items()}
    q1_n = sum(n for name, n in names.items() if "int8_conv_pool_kernel" in name)
    convs = {name: n for name, n in names.items() if "int8_conv_pool_kernel" not in name
             and any(w in name.lower() for w in ("cudnn", "fprop", "implicit", "conv"))}
    # an elementwise quantize step (x / s, round, clamp) between blocks
    quantize = {name: n for name, n in names.items() if "int8_conv_pool_kernel" not in name
                and any(w in name.lower() for w in ("round", "clamp", "div_true"))}
    out["int8_forward_trace"] = {"int8_conv_pool": q1_n, "gru_fwd": found["gru_fwd"],
                                 "conv1_pool": found["conv1_pool"], "other_convs": convs,
                                 "quantize_kernels": quantize, "device_busy_ms": busy}
    print(f"  one int8 forward at B=8 by profiler name: {json.dumps(out['int8_forward_trace'])}; "
          f"every kernel: {names}", flush=True)
    if (q1_n, found["gru_fwd"], found["conv1_pool"]) != (3, 2, 0) or convs or quantize:
        raise SystemExit("the int8 forward ran another convolution or quantize kernel than "
                         "Q1's three launches")
    print(f"  int8 serving phase numbers [{smi}]: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 12. the front end: container files and every ROI mode
# ---------------------------------------------------------------------------

ROI_MODES = ("heuristic", "variance", "model", "detector")
FRONT_CLIPS = 8  # native 288x360 clips, T=75: one B=8 batch
ROI_BOX_ATOL = 1e-5  # localizer boxes, card vs CPU (continuous; the gate's choice equal)
EXPORT_ATOL = 1e-4  # an exported variance artifact's log-probs vs the live reader's


def iou(a, b):
    """Elementwise IoU of (..., 4) (y0, y1, x0, x1) boxes, numpy."""
    import numpy as np

    iy = np.clip(np.minimum(a[..., 1], b[..., 1]) - np.maximum(a[..., 0], b[..., 0]), 0, None)
    ix = np.clip(np.minimum(a[..., 3], b[..., 3]) - np.maximum(a[..., 2], b[..., 2]), 0, None)
    area = lambda z: (z[..., 1] - z[..., 0]) * (z[..., 3] - z[..., 2])  # noqa: E731
    return iy * ix / np.maximum(area(a) + area(b) - iy * ix, 1e-9)


def write_container(stem: str, frames, audio, container: str) -> str:
    """A (T, H, W) uint8 clip as GRID ships it, a container file: `.mp4`
    (libx264, AAC audio) through the port's mux, or an MJPG `.avi` through
    cv2 (no audio) where the ingest cannot be built."""
    import numpy as np

    bgr = np.repeat(frames[..., None], 3, axis=-1)
    path = f"{stem}.{container}"
    if container == "mp4":
        from avsync_torch.ingest import native

        native.mux_mp4(path, bgr, 25.0, audio, 16000)
        return path
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                         (frames.shape[2], frames.shape[1]))
    for f in bgr:
        vw.write(f)
    vw.release()
    return path


def front_clip_spec(i: int):
    """Phase 12's clip i: its mouth's (centre, scale)."""
    return (0.66 + 0.03 * (i % 4), 0.38 + 0.04 * i), 0.9 + 0.05 * (i % 3)


def front_end_clips(workdir, container, smi, T: int, native_hw):
    """12a: FRONT_CLIPS native clips from the port's synthetic module, each
    with its mouth at a known box, written as `.npy` and as a container
    (`write_container`; none where neither the ingest nor cv2 exists);
    decoded back through `data/video.py`. Returns (frames as the path
    decodes them, known boxes, container paths or None, decode times)."""
    import numpy as np

    from avsync_torch.data import synthetic, video

    r = np.random.default_rng(12)
    clips, boxes, npys, mp4s = [], [], [], []
    for i in range(FRONT_CLIPS):
        center, scale = front_clip_spec(i)
        v, a = synthetic.make_clip(r, T, *native_hw, mouth_center=center, mouth_scale=scale,
                                   phrase=synthetic.GRID_PHRASES[i])
        clips.append(v)
        boxes.append(synthetic.mouth_box(center, scale, *native_hw))
        npys.append(os.path.join(workdir, f"clip{i}.npy"))
        np.save(npys[-1], v)
        if container:
            mp4s.append(write_container(os.path.join(workdir, f"clip{i}"), v, a, container))
        if container == "avi":  # no audio stream: the clip's audio beside it
            video.save_wav(os.path.join(workdir, f"clip{i}.wav"), a, 16000)
    t0 = time.perf_counter()
    from_npy = [video.decode_video_gray(p) for p in npys]
    npy_ms = (time.perf_counter() - t0) * 1e3 / FRONT_CLIPS
    if not container:
        print(f"  clips: {FRONT_CLIPS} x {(T, *native_hw)} .npy, {npy_ms:.3f} ms per clip to load "
              f"[{smi}]", flush=True)
        return np.stack(from_npy), np.stack(boxes), None, {"npy_ms_per_clip": npy_ms}
    t0 = time.perf_counter()
    decoded = [video.decode_video_gray(p) for p in mp4s]
    mp4_ms = (time.perf_counter() - t0) * 1e3 / FRONT_CLIPS
    # both codecs are lossy and the frames carry pixel noise: the decoded
    # frames are held to correlate with the written ones, the audio to its
    # length
    corr = min(float(np.corrcoef(d.ravel(), c.ravel())[0, 1]) for d, c in zip(decoded, clips))
    err = max(float(np.abs(d.astype(int) - c.astype(int)).mean()) for d, c in zip(decoded, clips))
    if any(d.shape != (T, *native_hw) for d in decoded) or corr < 0.95:
        raise SystemExit(f"container decode is wrong: shapes {[d.shape for d in decoded]}, "
                         f"correlation {corr:.3f}")
    audio_ms = None
    if container == "mp4":
        t0 = time.perf_counter()
        audio = [video.load_audio_for_video(p) for p in mp4s]
        audio_ms = (time.perf_counter() - t0) * 1e3 / FRONT_CLIPS
        if any(sr != 16000 or a.size < 0.9 * T / 25 * 16000 for a, sr in audio):
            raise SystemExit(f"container audio is wrong: {[(a.size, sr) for a, sr in audio]}")
    how = ("libx264 + AAC through the port's mux, decoded by the ingest" if container == "mp4"
           else "MJPG through cv2, decoded by cv2")
    print(f"  clips: {FRONT_CLIPS} x {(T, *native_hw)} as .{container} ({how}) and .npy; decode "
          f"ms per clip: {container} frames {mp4_ms:.3f}"
          + (f", mp4 audio {audio_ms:.3f}" if audio_ms is not None else "")
          + f", npy load {npy_ms:.3f}; decoded vs written: correlation >= {corr:.4f}, mean "
          f"|error| <= {err:.2f} levels [{smi}]", flush=True)
    return np.stack(decoded), np.stack(boxes), mp4s, {
        "container": container, "container_ms_per_clip": mp4_ms,
        "mp4_audio_ms_per_clip": audio_ms, "npy_ms_per_clip": npy_ms}


def roi_boxes(reader, mode, x):
    """The boxes the ROI program of `mode` crops for the (B, T, H, W) uint8
    frames x (on x's device): variance and model per clip, detector per
    frame (host), heuristic fixed (None). The localizer runs on x's device
    (a copy of the reader's for the CPU)."""
    import copy

    import torch

    from avsync_torch.models.localizer import gate_boxes, localize_clip_boxes
    from avsync_torch.ops.image import variance_mouth_boxes
    from avsync_torch.predictor import detect_boxes_host

    d = reader.cfg.data
    xf = x.float()
    if mode == "variance":
        return variance_mouth_boxes(xf)
    if mode == "model":
        loc = copy.deepcopy(reader._localizer).to(x.device)
        heur = torch.tensor([d.mouth_crop[0], 1.0, d.mouth_crop[1], d.mouth_crop[2]],
                            device=x.device)
        return gate_boxes(xf, localize_clip_boxes(loc, xf), heur)
    if mode == "detector":
        return torch.cat([torch.from_numpy(detect_boxes_host(c, reader._mouth))
                          for c in x.cpu().numpy()])
    return None


def transcribe_roi_modes(dev, frames, known, params, smi, base):
    """12b: TranscribeService in each ROI mode at full width (K1 and K2 on)
    over the clips: launches per batch, boxes card vs CPU, log-probs against
    the plain path, and the ROI program's time per batch beside the
    forward's."""
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch.data.pipeline import make_roi_crop_fn
    from avsync_torch.ops.image import crop_resize_boxes
    from avsync_torch.predictor import LipReader
    from avsync_torch.serving import TranscribeService

    out, readers = {}, {}
    x_cpu = torch.from_numpy(frames)
    x_dev = x_cpu.to(dev)
    for mode in ROI_MODES:
        cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, roi_mode=mode))
        plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
            cfg.model, use_pallas_gru=False, fused_conv_pool=False))
        reader = LipReader(params=params, config=cfg, device=dev)
        plain = LipReader(params=params, config=plain_cfg, device=dev)
        readers[mode] = reader
        svc = TranscribeService(reader, max_batch=MAX_BATCH, max_wait_ms=200.0)
        svc.warmup(frames[0])
        answers, errors = [None] * FRONT_CLIPS, []

        def client(i):
            try:
                answers[i] = svc.transcribe_frames(frames[i], timeout=300)
            except Exception as e:  # noqa: BLE001 — reported and failed below
                errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(FRONT_CLIPS)]
        zero_counts()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        got = counts()
        stats = svc.stats.snapshot()
        svc.close()
        if errors or any(a is None for a in answers):
            raise SystemExit(f"{mode}: serving failed: {errors}")
        n_batches = sum(stats["batches"].values())
        layers = cfg.model.num_gru_layers
        if (got["conv1_pool"] != n_batches or got["gru_fwd"] != layers * n_batches
                or got["gru_bwd"] or got["conv1_pool_bwd"] or got["mel_stats"]):
            raise SystemExit(f"{mode}: launches {got} do not match {n_batches} batches")

        # the boxes: on the card and on the CPU from the same frames
        b_dev, b_cpu = roi_boxes(reader, mode, x_dev), roi_boxes(reader, mode, x_cpu)
        if mode == "heuristic":
            box_check = "fixed fractions (no box)"
            crop = cfg.data.mouth_crop
            box_iou = float(iou(np.array([crop[0], 1.0, crop[1], crop[2]]), known).mean())
        else:
            bd, bc = b_dev.cpu(), b_cpu
            if mode == "model":
                crop = cfg.data.mouth_crop
                heur = torch.tensor([crop[0], 1.0, crop[1], crop[2]])
                same_choice = torch.equal((bd == heur).all(-1), (bc == heur).all(-1))
                box_err = (bd - bc).abs().max().item()
                if not same_choice or box_err > ROI_BOX_ATOL:
                    raise SystemExit(f"model boxes differ, card vs CPU: {box_err:.3e}, "
                                     f"gate choice equal {same_choice}")
                box_check = f"within {box_err:.3e} (tol {ROI_BOX_ATOL}), gate choices equal"
            elif not torch.equal(bd, bc):
                raise SystemExit(f"{mode} boxes differ, card vs CPU:\n{bd}\n{bc}")
            else:
                box_check = "equal"
            per_clip = bc.numpy() if bc.dim() == 2 else bc.numpy()[:, 0]
            box_iou = float(iou(per_clip, known).mean())

        # log-probs, the kernel path against the plain path on the same input
        payload = tuple(np.concatenate(p) for p in zip(*(reader.prepare_raw(f) for f in frames)))
        x = reader.preprocess_device(*payload)
        lp_k, lp_p = reader._logprobs(x), plain._logprobs(x)
        torch.cuda.synchronize()
        if lp_k.shape != (FRONT_CLIPS, cfg.data.max_video_length, 39) or not torch.isfinite(
                lp_k).all():
            raise SystemExit(f"{mode}: bad log-probs {tuple(lp_k.shape)}")
        worst = (lp_k - lp_p).abs().max().item()
        if worst > SLICE_ATOL:
            raise SystemExit(f"{mode}: kernel path disagrees with the plain path: {worst:.3e}")
        top2 = lp_k.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).min(dim=-1).values.cpu().numpy()
        texts = reader._decode(lp_k)
        differ = [i for i in range(FRONT_CLIPS) if texts[i] != answers[i]]
        if any(margin[i] >= NEAR_TIE for i in differ):
            raise SystemExit(f"{mode}: service answers differ from the reader's: {differ}")

        # times per B=8 batch: the ROI program (for 'detector' the host
        # cascade, then the device crop of its boxes) and the forward
        if mode == "detector":
            t0 = time.perf_counter()
            host_boxes = roi_boxes(reader, mode, x_cpu)
            host_ms = (time.perf_counter() - t0) * 1e3
            bx = host_boxes.to(dev)
            roi_ms = time_ms(lambda: crop_resize_boxes(
                x_dev.float(), bx, (cfg.data.img_height, cfg.data.img_width)))
        else:
            roi = make_roi_crop_fn(cfg.data, mode, reader._localizer)
            roi_ms, host_ms = time_ms(lambda: roi(x_dev)), None
        fwd_ms = time_ms(lambda: reader._logprobs(x))
        out[mode] = {"batches": stats["batches"], "launches": got, "roi_ms": roi_ms,
                     "host_boxes_ms": host_ms, "forward_ms": fwd_ms, "boxes": box_check,
                     "mean_iou_known_box": box_iou, "max_abs_err_vs_plain": worst,
                     "near_ties": differ}
        print(f"  {mode}: batches {stats['batches']}, launches conv1_pool={got['conv1_pool']} "
              f"gru_fwd={got['gru_fwd']} (per batch 1 and {layers}); boxes card vs CPU: "
              f"{box_check}; mean IoU with the known mouth box {box_iou:.3f}; log-probs vs plain "
              f"{worst:.3e} (tol {SLICE_ATOL}); per B=8 batch (CUDA events, median of 20): "
              f"ROI program {roi_ms:.3f} ms"
              + (f" (+ host cascade {host_ms:.1f} ms, host clock)" if host_ms is not None else "")
              + f", forward with K1+K2 {fwd_ms:.3f} ms [{smi}]", flush=True)
    return out, readers


def train_roi_host(dev, workdir, container, smi, base, native_hw):
    """12c: `cli train` for one epoch on a native 288x360 corpus (container
    files where they can be written) with --roi_mode variance --roi_host
    --device_cache on: K3 and K4 launch, the host crop's time per batch, the
    cache holds crops."""
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.data.grid import GridDataSource, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.data.synthetic import write_corpus

    root, n_speakers = os.path.join(workdir, "grid_native"), 7  # 4 / 1 / 2 speakers
    t0 = time.perf_counter()
    d = base.data
    write_corpus(root, n_speakers=n_speakers, clips_per_speaker=2, layout="standard",
                 preprocessed=False, n_frames=d.max_video_length, height=native_hw[0] // 4,
                 width=native_hw[1] // 4, seed=13, with_audio=False)
    if container:  # the corpus as GRID ships it: container files
        for sp in os.listdir(root):
            vdir = os.path.join(root, sp, "video")
            for name in os.listdir(vdir):
                write_container(os.path.join(vdir, name[:-4]),
                                np.load(os.path.join(vdir, name)), None, container)
                os.remove(os.path.join(vdir, name))
    cfg = dataclasses.replace(base, data=dataclasses.replace(d, roi_mode="variance",
                                                             roi_host=True))
    cfg_path = os.path.join(workdir, "config_native.json")
    with open(cfg_path, "w") as f:
        f.write(base.to_json())
    write_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", "--data_path", root, "--config", cfg_path, *F32, "--epochs", "1",
                   "--checkpoint_dir", os.path.join(workdir, "ckpt_native"), "--roi_mode",
                   "variance", "--roi_host", "--device_cache", "on"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    if rc != 0 or not got["gru_bwd"] or not got["conv1_pool_bwd"] or not got["conv1_pool"]:
        raise SystemExit(f"cli train --roi_mode variance --roi_host: rc {rc}, launches {got}")

    train_sp = split_speakers([f"s{s}" for s in range(1, n_speakers + 1)], cfg.data.split)[0]
    batcher = LipNetBatcher(GridDataSource(root, train_sp), cfg, device=dev)
    raw = np.stack([batcher._decode_clip(s.video_path) for s in batcher.source.samples[:8]])
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        crops = batcher._host_roi(raw)
        host.append((time.perf_counter() - t0) * 1e3)
    batcher.warm_device_cache()
    cache = batcher._device_cache
    crop_shape = (d.max_video_length, d.img_height, d.img_width)
    if (crops.shape != (8, *crop_shape) or crops.dtype != np.uint8 or not cache["u8"]
            or cache["video"].dtype != torch.uint8 or cache["clip_shape"] != (*crop_shape, 1)):
        raise SystemExit(f"roi_host: crops {crops.shape} {crops.dtype}, cache {cache['dtype']} "
                         f"{cache['clip_shape']}")
    out = {"wall_s": wall, "launches": got, "host_crop_ms_per_batch": statistics.median(host),
           "upload_bytes_per_clip": int(crops[0].nbytes), "native_bytes_per_clip":
           int(raw[0].nbytes), "cache": [cache["dtype"], list(cache["clip_shape"]),
                                         int(cache["n_cached"])]}
    print(f"  cli train --roi_mode variance --roi_host --device_cache on, 1 epoch over "
          f"{len(batcher.source)} .{container or 'npy'} clips of {native_hw} (corpus "
          f"written in {write_s:.1f} s): wall {wall:.1f} s, launches {got}; host crop "
          f"{out['host_crop_ms_per_batch']:.1f} ms per B=8 batch (host clock, median of 3), "
          f"{out['upload_bytes_per_clip']} bytes per clip uploaded instead of "
          f"{out['native_bytes_per_clip']}; device cache {cache['dtype']} "
          f"{tuple(cache['clip_shape'])} x {cache['n_cached']} [{smi}]", flush=True)
    return out


def sync_container(dev, mp4, params, smi, base):
    """12d: a sync request on a container clip, scored with its audio (the
    `.mp4`'s own AAC stream, or an `.avi`'s sibling `.wav`): K1 and K5
    launch; the probabilities against the plain path."""
    import dataclasses

    import numpy as np

    from avsync_torch.compat import conv_shape_for
    from avsync_torch.data.video import decode_av
    from avsync_torch.predictor import MisalignmentScorer
    from avsync_torch.serving import SyncScoreService

    cfg = dataclasses.replace(base, audio=dataclasses.replace(base.audio, use_pallas=True))
    plain_cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, use_pallas_gru=False, fused_conv_pool=False), audio=base.audio)
    C, h, w = conv_shape_for(cfg)
    det = seeded_jax_layout_detector_params(2 * C * h * w + 2 * cfg.audio.n_mfcc, 256, seed=1)
    scorer = MisalignmentScorer(detector_params=det, lipnet_params=params, config=cfg, device=dev)
    plain = MisalignmentScorer(detector_params=det, lipnet_params=params, config=plain_cfg,
                               device=dev)
    svc = SyncScoreService(scorer, max_batch=MAX_BATCH)
    svc.score_path(mp4, DET_SHIFTS)  # warm: the kernels' first calls
    zero_counts()
    t0 = time.perf_counter()
    probs = svc.score_path(mp4, DET_SHIFTS)
    ms = (time.perf_counter() - t0) * 1e3
    got = counts()
    svc.close()
    frames, audio, fps = decode_av(mp4, cfg)
    want = plain.score_arrays(frames, audio, fps, DET_SHIFTS)
    err = float(np.abs(probs - want).max())
    if (got["conv1_pool"] != 1 or got["mel_stats"] != 1 or not np.all(np.isfinite(probs))
            or err > PROB_ATOL or audio.size == 0):
        raise SystemExit(f"sync on a container: launches {got}, err {err:.3e}, "
                         f"audio {audio.size} samples")
    source = "its own AAC stream" if mp4.endswith(".mp4") else "its sibling .wav"
    print(f"  sync request on {os.path.basename(mp4)} with {source} ({audio.size} "
          f"samples at 16 kHz, fps {fps}): probs {np.round(probs, 4).tolist()} for shifts "
          f"{list(DET_SHIFTS)}, vs plain {err:.3e} (tol {PROB_ATOL}), launches conv1_pool="
          f"{got['conv1_pool']} mel_stats={got['mel_stats']}; {ms:.1f} ms end to end incl. "
          f"decode (host clock) [{smi}]", flush=True)
    return {"launches": got, "max_abs_err_vs_plain": err, "ms": ms}


def export_variance(dev, workdir, frames, reader, smi, native_hw):
    """12e: an exported artifact with the variance ROI embedded, against the
    live reader at B = 1 and 8."""
    import numpy as np

    from avsync_torch.compat import save_lipnet_pth
    from avsync_torch.export import export_transcriber

    lip = os.path.join(workdir, "lipnet_front.pth")  # the live reader's weights
    save_lipnet_pth(reader.model.state_dict(), lip)
    t0 = time.perf_counter()
    art = export_transcriber(lip, reader.cfg, frame_geometry=native_hw, device=dev)
    export_s = time.perf_counter() - t0
    errs = {}
    for b in (1, FRONT_CLIPS):
        got = art.call(frames[:b])[2]
        want = reader._logprobs(reader.preprocess_device(frames[:b])).cpu().numpy()
        errs[b] = float(np.abs(got - want).max())
    if art.meta["roi"] != "embedded:variance" or max(errs.values()) > EXPORT_ATOL:
        raise SystemExit(f"variance artifact: roi {art.meta['roi']}, errors {errs}")
    print(f"  exported variance artifact ({native_hw}, symbolic batch, {export_s:.1f} s): "
          f"log-probs vs the live reader max_abs_err B=1 {errs[1]:.3e}, B=8 "
          f"{errs[FRONT_CLIPS]:.3e} (tol {EXPORT_ATOL}) [{smi}]", flush=True)
    return errs


def run_front_end(dev, workdir, smi, cfg=None, native_hw=(288, 360)):
    """Phase 12: the ingest's state, then the path from a container clip to
    the model input in every ROI mode, training on host crops, a sync
    request on a container's own audio, and an exported variance artifact.
    `cfg`: the model and crop geometry with the kernel flags on (the full
    default width when None); `native_hw`: the clips' frame size (GRID's)."""
    import shutil

    from avsync_torch.config import AudioConfig, AvsyncConfig, ModelConfig
    from avsync_torch.ingest import native

    cfg = cfg or AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True),
                              audio=AudioConfig())

    out = {}
    if native.available():
        info = native.build_info()
        print(f"ingest: built in {info['seconds']:.1f} s (libavformat {info['libavformat']})",
              flush=True)
        container = "mp4"
    else:
        why = " ".join(native.why_unavailable().split())
        print(f"ingest: unavailable: {why}", flush=True)
        if shutil.which("pkg-config") and subprocess.run(
                ["pkg-config", "--exists", *native.PKGS]).returncode == 0:
            raise SystemExit("libav is installed but the ingest did not build or load")
        try:
            import cv2

            container = "avi"
            print(f"  containers: through cv2 {cv2.__version__} (the fallback of "
                  f"data/video.py)", flush=True)
        except ImportError:
            container = None
            print("  containers: none (no ingest, no cv2): .npy clips only", flush=True)
    out["ingest"] = native.build_info() or {"unavailable": native.why_unavailable()}
    frames, known, mp4s, out["decode"] = front_end_clips(
        workdir, container, smi, cfg.data.max_video_length, native_hw)
    params = seeded_jax_layout_params(cfg, seed=0)
    out["roi_modes"], readers = transcribe_roi_modes(dev, frames, known, params, smi, cfg)
    out["train_roi_host"] = train_roi_host(dev, workdir, container, smi, cfg, native_hw)
    if container:
        out["sync_container"] = sync_container(dev, mp4s[0], params, smi, cfg)
    else:
        print("  sync request on a container clip: not run (no container decoder)", flush=True)
    out["export_variance"] = export_variance(dev, workdir, frames, readers["variance"], smi,
                                             native_hw)
    print(f"  front end phase numbers [{smi}]: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 13. the TF-family LipNet
# ---------------------------------------------------------------------------

# the TF stack's three conv blocks at full width, 75 x 46 x 140 crops:
# (Cin, Cout, H, W, kernel)
TF_INT8_BLOCKS = {"conv1": (1, 128, 46, 140, (3, 3, 3)), "conv2": (128, 256, 23, 70, (3, 3, 3)),
                  "conv3": (256, 64, 11, 35, (3, 3, 3))}
TF_CPU_ATOL = 1e-4  # the card's f32 forward against the CPU's (TF32 would show as ~1e-3)
TF_ARTIFACT_ATOL = 1e-4
TF_SPEAKERS = 7  # 8 clips each, split 4 / 1 / 2 speakers


def tf_config(**model):
    """The TF family at its full default width: 46x140 standardized crops,
    T=75, conv 128/256/64 (3x3x3), BiLSTM 256 x3, Dense 512 x2, 32 outputs."""
    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig

    return AvsyncConfig(data=DataConfig(img_height=46, img_width=140, standardize_clips=True),
                        model=ModelConfig(family="tf", **model))


def seeded_jax_layout_tf_params(cfg, seed: int):
    """TFLipNet weights as the JAX package lays them out, drawn with numpy:
    conv kernels (3, 3, 3, Cin, Cout) at 1/sqrt(fan_in), LSTMs uniform in
    +-1/sqrt(H), Dense kernels (in, out) He-normal."""
    import numpy as np

    r = np.random.default_rng(seed)
    m = cfg.model
    params = {}
    cin, h, w = 1, cfg.data.img_height, cfg.data.img_width
    for i, ch in enumerate(m.conv_channels):
        params[f"conv{i + 1}"] = {
            "kernel": r.normal(0, (27 * cin) ** -0.5, (3, 3, 3, cin, ch)).astype(np.float32),
            "bias": r.normal(0, 0.01, (ch,)).astype(np.float32)}
        cin, h, w = ch, h // 2, w // 2
    dim, H = cin * h * w, m.hidden_dim
    for layer in range(3):
        params[f"lstm{layer + 1}"] = {
            f"{name}_{d}": r.uniform(-H ** -0.5, H ** -0.5, shape).astype(np.float32)
            for d in ("fwd", "bwd")
            for name, shape in (("w_ih", (dim, 4 * H)), ("w_hh", (H, 4 * H)),
                                ("b_ih", (4 * H,)), ("b_hh", (4 * H,)))}
        dim = 2 * H
    for name, din, dout in (("dense1", dim, 512), ("dense2", 512, 512), ("head", 512, 32)):
        params[name] = {"kernel": r.normal(0, (2 / din) ** 0.5, (din, dout)).astype(np.float32),
                        "bias": np.zeros(dout, np.float32)}
    return params


TF_Q1_SWEEP_SHAPES = 3  # 13a's sweep: the planner's best tiles with the B ring per block


def tf_q1_sweep_tiles(cin, cout, H, W, k):
    """The tiles 13a forces at one TF block (Cin % 16 == 0: B through the
    ring): the planner's choice and its TF_Q1_SWEEP_SHAPES best (rows, cols,
    groups) by its estimate, each at every stage size."""
    from avsync_torch.ops.cuda import quantconv

    H2, W2 = H // 2, W // 2
    cands = sorted(quantconv.tiles_to_try(H2, W2, cin, cout, *k),
                   key=lambda t: quantconv.tile_cost(H2, W2, cin, cout, *k, t))
    shapes = list(dict.fromkeys(t[:3] for t in cands))[:TF_Q1_SWEEP_SHAPES]
    return list(dict.fromkeys([quantconv.tile_for(H2, W2, cin, cout, *k)]
                              + [t for t in cands if t[:3] in shapes]))


def tf_q1_sweep(g, dev, smi, B=8, T=75):
    """13a's sweep: at TF conv2 and conv3 (B=8, the int8 forward's
    contracts) Q1 with its tile forced (`tile_for` swapped) to each of
    `tf_q1_sweep_tiles`: each equal to the plain version bit for bit and
    timed on the device alone (`queued_ms`)."""
    import torch

    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.ops.quant import quant_conv_block

    out = {}
    for name in ("conv2", "conv3"):
        cin, cout, H, W, k = TF_INT8_BLOCKS[name]
        qc, x32 = q1_case(g, dev, B, cin, cout, T, H, W, k)
        x, out_scale = q1_contract(qc, channels_last(x32), CHAIN_CONTRACTS[name], "random")
        want = quantconv.int8_conv_pool_ref(x, qc.kernel_q, qc.k_scale, qc.bias,
                                            float(qc.x_scale), out_scale)
        real, said = quantconv.tile_for, []
        try:
            for tile in tf_q1_sweep_tiles(cin, cout, H, W, k):
                quantconv.tile_for = lambda *a, tile=tile: tile
                got = quant_conv_block(qc, x, out_scale)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise SystemExit(f"kernel check failed: Q1 at TF {name} with its "
                                     f"{q1_tile_text(tile)} forced differs from its plain "
                                     "version")
                said.append({"tile": list(tile), "ctas_per_sm": quantconv.ctas_per_sm(
                    cin, *k, tile), "queued_ms": queued_ms(
                        lambda: quant_conv_block(qc, x, out_scale)), "equal": True})
        finally:
            quantconv.tile_for = real
        out[name] = said
        print(f"  {name} B={B} forced tiles (torch.equal each; device alone, queued_ms): "
              + "; ".join(f"{q1_tile_text(quantconv.Q1Tile(*r['tile']))} "
                          f"({r['ctas_per_sm']} per SM) {r['queued_ms']:.4f}" for r in said)
              + f" [{smi}]", flush=True)
        del qc, x, x32, want
        torch.cuda.empty_cache()
    return out


def tf_q1_blocks(dev, smi):
    """13a: Q1 at the TF stack's three blocks: equal to its plain version bit
    for bit in every contract at B = 1 and 8, a repeat launch equal too; at
    conv2 and conv3 the same at forced tiles and stage sizes (`tf_q1_sweep`);
    times at B=8 (events and on the device alone) beside the plain version,
    the library call and cuDNN f32, and the bounds."""
    import torch

    g = torch.Generator(device="cpu").manual_seed(61)
    print("TF family phase: Q1 at the TF stack's blocks (75 x 46 x 140; conv1 1->128, conv2 "
          "128->256 over 23x70, conv3 256->64 over 11x35, 3x3x3) vs int8_conv_pool_ref "
          "(torch.equal required):", flush=True)
    q1_equal_cases(g, dev, [(B, cin, cout, 75, H, W, k, "random")
                            for (cin, cout, H, W, k) in TF_INT8_BLOCKS.values() for B in (1, 8)])
    sweep = tf_q1_sweep(g, dev, smi)
    blocks, n_bytes, n_ops = q1_block_times(g, dev, TF_INT8_BLOCKS, smi)
    return dict(q1_chain_row(blocks, n_bytes, n_ops), blocks=blocks, sweep=sweep)


def tf_forward(dev, reader, frames, smi):
    """13b: the f32 forward at B=8 on the card against the same module on the
    CPU, its time, and the BiLSTM stack's share of its device time from a
    profiler trace (the stack spanned by a user annotation)."""
    import copy

    import torch

    clips = reader.preprocess_device(frames)
    with torch.inference_mode():
        got = reader._logprobs(clips)
        cpu = copy.deepcopy(reader.model).cpu()
        t0 = time.perf_counter()
        want = cpu(clips.cpu())
        cpu_s = time.perf_counter() - t0
    err = (got.cpu() - want).abs().max().item()
    print(f"  f32 forward B=8 on the card vs the same module on the CPU: max_abs_err={err:.3e} "
          f"(tol {TF_CPU_ATOL}; CPU forward {cpu_s:.1f} s)", flush=True)
    if not (err <= TF_CPU_ATOL and torch.isfinite(got).all()):
        raise SystemExit("the TF forward on the card differs from the CPU's")
    del cpu, want
    ms = time_ms(lambda: reader._logprobs(clips), iters=10)
    model = reader.model
    span = {}

    def enter(mod, inp):
        span["rf"] = torch.profiler.record_function("tf_bilstm_stack")
        span["rf"].__enter__()

    def leave(mod, inp, out):
        span.pop("rf").__exit__(None, None, None)

    hooks = [model.lstm1.register_forward_pre_hook(enter),
             model.lstm3.register_forward_hook(leave)]
    events = device_events(lambda: reader._logprobs(clips))
    for h in hooks:
        h.remove()
    kernels = [(t, d) for _, t, d, note in events if not note]
    window = next(((t, t + d) for name, t, d, note in events
                   if note and name == "tf_bilstm_stack"), None)
    busy = sum(d for _, d in kernels) / 1e3
    row = {"f32_forward_B8_ms": ms, "cpu_max_abs_err": err, "device_busy_ms": busy,
           "kernels": len(kernels)}
    if window is not None:
        lstm = [d for t, d in kernels if window[0] <= t < window[1]]
        row.update(lstm_busy_ms=sum(lstm) / 1e3, lstm_kernels=len(lstm),
                   lstm_span_ms=(window[1] - window[0]) / 1e3,
                   lstm_share_of_busy=sum(lstm) / 1e3 / busy)
    print(f"  f32 forward B=8 (CUDA events, median of 10): {ms:.3f} ms; one traced forward: "
          f"{json.dumps(row)} [{smi}]", flush=True)
    return row


def tf_train(dev, workdir, corpus, cfg_path, smi):
    """13c: `cli train --model_family tf` for two epochs (the second an epoch
    program over the device cache), the snapshot naming the family and no
    hand kernel launched (the TF stack's f32 path is cuDNN, cuBLAS and
    plain PyTorch); then the epoch program against the eager loop from the
    same weights under cudnn.deterministic (losses, gradient norms, weights
    and Adam state equal bit for bit), and, with cuDNN's defaults, steps/s,
    ms per step and the idle share of each path."""
    import dataclasses

    import torch

    from avsync_torch import cli
    from avsync_torch.config import TrainConfig
    from avsync_torch.data.grid import GridDataSource, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.checkpoint import CheckpointManager
    from avsync_torch.utils.logging import Logger

    ck = os.path.join(workdir, "tf_ckpt")
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", "--data_path", corpus, "--config", cfg_path, "--model_family", "tf",
                   "--epochs", "2", "--checkpoint_dir", ck, "--show_examples", *F32])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {**counts(), "int8_conv_pool": quantconv.launches}
    payload, meta = CheckpointManager(ck).restore()
    with open(os.path.join(ck, "history.json")) as f:
        hist = json.load(f)
    print(f"  cli train --model_family tf, 2 epochs (the second an epoch program): rc={rc} "
          f"wall_s={wall:.2f}; snapshot family {meta['config']['model']['family']!r}, "
          f"epochs_completed {meta['metrics'].get('epochs_completed')}; loss {hist['loss']} "
          f"val_loss {hist['val_loss']} epoch_seconds {hist['epoch_seconds']}; hand-kernel "
          f"launches {got} (none expected)", flush=True)
    if (rc != 0 or meta["config"]["model"]["family"] != "tf" or "lstm3.weight_hh_l0" not in
            payload["model_state_dict"] or len(hist["loss"]) != 2 or any(got.values())
            or not all(map(lambda v: v == v and abs(v) < float("inf"), hist["loss"]))):
        raise SystemExit("cli train --model_family tf left the wrong snapshot or history")

    quiet = Logger(None, console=False)
    cfg = cli._config(cfg_path)
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, data_path=corpus, device_cache="on"),
                      model=dataclasses.replace(cfg.model, dropout_rate=0.5),
                      train=TrainConfig(seed=3))
    train_sp, _, _ = split_speakers([f"s{i}" for i in range(1, TF_SPEAKERS + 1)],
                                    cfg.data.split)
    batcher = LipNetBatcher(GridDataSource(corpus, train_sp), cfg, device=dev)

    def run(path):
        trainer = LipNetTrainer(cfg, device=dev, log=quiet)
        state = trainer.init_state()
        log = StepLog()

        def epoch(e):
            if path == "graph":
                return trainer.train_epoch_scanned(
                    state, batcher.scan_plan(shuffle=True, seed=e), metrics_writer=log)
            return trainer.train_epoch(state, batcher.epoch(shuffle=True, seed=e),
                                       metrics_writer=log)

        return trainer, state, log, epoch

    cudnn = torch.backends.cudnn
    runs = {}
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        for path in ("graph", "loop"):
            _, state, log, epoch = run(path)
            epoch(1)
            epoch(2)
            torch.cuda.synchronize()
            runs[path] = (state, log)
    (sg, lg), (sl, ll) = runs["graph"], runs["loop"]
    same_state(sg, sl, "TF family")
    if lg.rows != ll.rows:
        raise SystemExit("TF family: the epoch program's losses differ from the eager loop's")
    S = len(lg.rows) // 2
    print(f"  TF B=8 S={S} dropout 0.5, cudnn.deterministic: 2 epochs graph vs eager loop: "
          f"parameters, Adam state, {len(lg.rows)} losses and gradient norms equal bit for bit "
          f"(losses {[round(r[1], 4) for r in lg.rows]})", flush=True)
    del runs, sg, sl
    out = {"cli_train_wall_s": wall, "epoch_seconds": hist["epoch_seconds"], "steps_per_epoch": S}
    for path in ("graph", "loop"):  # timed in the trainers' step scope (deterministic)
        trainer, state, _, epoch = run(path)
        epoch(1)  # the graph's warm-up and capture
        stamps = timed_before(trainer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch(2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        gaps = list(stamps)
        _, twall, busy, _, _ = traced(lambda: epoch(3))
        out[path] = path_times(f"TF {path} path (B=8, dropout 0.5, epoch 2 timed, epoch 3 "
                               f"traced) [{smi}]", S, wall_ms, twall, busy, gaps)
        trainer._programs.clear()
        del trainer, state
    torch.cuda.empty_cache()
    return ck, out


def tf_commands(dev, workdir, corpus, cfg_path, ck, smi):
    """13d: `cli test`, `infer`, `quantize`, `test --quantize int8` and
    `infer --quantize int8` from the trained snapshot: every transcript in
    the TF alphabet."""
    import contextlib
    import glob
    import io

    import numpy as np

    from avsync_torch import cli, text

    common = ["--data_path", corpus, "--config", cfg_path, "--model_family", "tf",
              "--checkpoint", ck, *F32]
    clip = sorted(glob.glob(os.path.join(corpus, "*", "video", "*.npy")))[0]
    results, said = {}, {}
    for name, argv in (("test", ["test", *common]), ("infer", ["infer", clip, *common]),
                       ("quantize", ["quantize", *common, "--out",
                                     os.path.join(workdir, "tf_trained_q.npz")]),
                       ("test_int8", ["test", *common, "--quantize", "int8"]),
                       ("infer_int8", ["infer", clip, *common, "--quantize", "int8"])):
        if name.startswith("test"):
            argv += ["--output", os.path.join(workdir, f"tf_{name}.json")]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(argv)
        secs = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        preds = [ln.split(":", 1)[1].strip() for ln in lines
                 if ln.startswith(("Predicted:", "Predicted text:"))]
        if rc != 0 or any(set(p) - set(text.TF_CHARACTERS) for p in preds):
            raise SystemExit(f"cli {name} --model_family tf: rc={rc}, transcripts {preds}")
        said[name] = {"seconds": secs, "transcripts": preds[:3]}
        if name.startswith("test"):
            with open(os.path.join(workdir, f"tf_{name}.json")) as f:
                results[name] = json.load(f)
            if not np.isfinite(results[name]["cer"]):
                raise SystemExit(f"cli {name} wrote {results[name]}")
    print(f"  cli test / infer / quantize / test --quantize int8 / infer --quantize int8 on the "
          f"trained snapshot: {json.dumps(said)}; results {json.dumps(results)}", flush=True)
    return {"commands": said, "results": results}


def tf_int8_forward(dev, f32, q8, frames, seeded, smi):
    """13d: the int8 forward of the trained snapshot at B=8 on 8 corpus clips
    (`q8`: scales from `cli quantize` over the corpus) against its f32
    forward (`f32`) within the JAX package's bounds (mean |d log-prob| <
    0.05, argmax agreement >= 0.95; tests/test_quant.py:171-180), equal bit
    for bit to three f32-contract launches and to the plain int8 forward
    (Q1's plain version in each block), its time, and a profiler trace: Q1
    three times and no other convolution. `seeded` (f32 reader, int8 reader,
    frames): the seeded weights' distance beside, held to the mean bound
    only: their log-probs are near-uniform, so a frame's argmax there is
    decided by ties (the share within int8's error of a tie is printed)."""
    import torch

    from avsync_torch.ops import quant as tq
    from avsync_torch.ops.cuda import quantconv

    def distance(f, q, x):
        clips = f.preprocess_device(x)
        lp, lp32 = q._logprobs(clips), f._logprobs(clips)
        top2 = lp32.topk(2, dim=-1).values
        near = ((top2[..., 0] - top2[..., 1]) < 2 * (lp - lp32).abs().amax(-1)).float()
        return {"mean_abs_logprob": (lp - lp32).abs().mean().item(),
                "argmax_agreement": (lp.argmax(-1) == lp32.argmax(-1)).float().mean().item(),
                "frames_within_the_error_of_a_tie": near.mean().item(),
                "finite": bool(torch.isfinite(lp).all())}

    clips = f32.preprocess_device(frames)
    lp8 = q8._logprobs(clips)
    block = tq.quant_conv_block
    tq.quant_conv_block = lambda qc, x, out_scale=None, compute_dtype=None: block(
        qc, x, compute_dtype=compute_dtype)
    try:
        before = quantconv.launches
        lp_f32_contract = q8._logprobs(clips)
        launched = quantconv.launches - before
        tq.quant_conv_block = lambda qc, x, out_scale=None, compute_dtype=None: (
            quantconv.int8_conv_pool_ref(x, qc.kernel_q, qc.k_scale, qc.bias,
                                         float(qc.x_scale), out_scale, compute_dtype))
        lp_plain = q8._logprobs(clips)
    finally:
        tq.quant_conv_block = block
    row = {"hand_off_equals_f32_contract": torch.equal(lp8, lp_f32_contract),
           "equals_plain_int8_forward": torch.equal(lp8, lp_plain),
           "f32_contract_launches": launched,
           "trained_snapshot": distance(f32, q8, frames),
           "seeded_weights": distance(*seeded),
           "forward_B8_ms": {"int8_ms": time_ms(lambda: q8._logprobs(clips), iters=10),
                             "int8_queued_ms": queued_ms(lambda: q8._logprobs(clips), iters=10),
                             "f32_ms": time_ms(lambda: f32._logprobs(clips), iters=10)}}
    busy, names = traced_step(lambda: q8._logprobs(clips),
                              has_kernels("int8_conv_pool_kernel", n=3))
    q1_n = sum(n for name, n in names.items() if "int8_conv_pool_kernel" in name)
    convs = {name: n for name, n in names.items() if "int8_conv_pool_kernel" not in name
             and any(w in name.lower() for w in ("cudnn", "fprop", "implicit", "conv"))}
    row["trace"] = {"int8_conv_pool": q1_n, "other_convs": convs, "device_busy_ms": busy}
    print(f"  TF int8 forward B=8: {json.dumps(row)} (bounds on the trained snapshot: mean "
          f"|d log-prob| < 0.05, argmax agreement >= 0.95; seeded weights: the mean bound; "
          f"Q1 three times, no other convolution) [{smi}]", flush=True)
    held, info = row["trained_snapshot"], row["seeded_weights"]
    if not (row["hand_off_equals_f32_contract"] and row["equals_plain_int8_forward"]
            and launched == 3 and q1_n == 3 and not convs and held["finite"] and info["finite"]
            and held["mean_abs_logprob"] < 0.05 and held["argmax_agreement"] >= 0.95
            and info["mean_abs_logprob"] < 0.05):
        raise SystemExit("the TF int8 forward failed its checks")
    return row


def tf_serving(dev, workdir, corpus, f32, q8, snap, cfg_path, qscales, crops, smi):
    """13e: `cli serve --model_family tf --warmup`, live f32 and `--quantize
    int8 --qscales`, as child processes under the crops: transcripts equal the
    in-process readers', SIGTERM drains; Q1's launches per int8 batch through
    an in-process daemon (zeroed before, read after); `cli export` of the TF
    transcriber (its seconds and bytes) against the live reader at B = 1
    and 8."""
    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.export import load_exported
    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.serving import AvsyncServer, TranscribeService

    out = {}
    for what, reader, extra in (("f32", f32, []),
                                ("int8", q8, ["--quantize", "int8", "--qscales", qscales])):
        t0 = time.perf_counter()
        daemon = Daemon(["--checkpoint", snap, "--config", cfg_path, "--model_family", "tf",
                         "--port", "0", "--warmup", "--max_batch", str(MAX_BATCH), *F32,
                         *extra])
        try:
            up = time.perf_counter() - t0
            row = transcribe_load(daemon.url, crops, reader, f"TF {what} daemon")
            rc = daemon.stop()
        finally:
            daemon.kill()
        if rc != 0:
            raise SystemExit(f"TF {what} daemon exited {rc} after SIGTERM")
        out[f"daemon_{what}"] = dict(row, start_s=up)
        print(f"  serve --model_family tf ({what}) as a child process, {len(crops)} crops from "
              f"{SERVE_THREADS} threads: p50_ms={row['p50_ms']:.3f} p99_ms={row['p99_ms']:.3f} "
              f"clips_per_s={row['clips_per_s']:.3f}, transcripts equal the in-process reader's "
              f"(near ties {row['near_ties']}); up in {up:.1f} s (--warmup: buckets 1..8 run "
              f"first); SIGTERM exit 0 [{smi}]",
              flush=True)
    server = AvsyncServer(TranscribeService(q8, max_batch=MAX_BATCH, max_wait_ms=5.0), None,
                          port=0)
    server.start()
    try:
        zero_counts()
        answers, _, _ = load(f"http://{server.address[0]}:{server.address[1]}",
                             [("/v1/transcribe", npy_bytes(c), "application/x-npy")
                              for c in crops])
        torch.cuda.synchronize()
        got = {**counts(), "int8_conv_pool": quantconv.launches}
        nt = sum(server.stats_snapshot()["transcribe"]["batches"].values())
    finally:
        server.shutdown(drain_timeout=30.0)
    want = {"conv1_pool": 0, "gru_fwd": 0, "gru_bwd": 0, "conv1_pool_bwd": 0, "mel_stats": 0,
            "int8_conv_pool": 3 * nt}
    print(f"  launches through an in-process TF int8 daemon: {got} for {nt} transcribe batches "
          f"(expected {want})", flush=True)
    if any(a[0] != 200 for a in answers) or got != want:
        raise SystemExit("TF int8 daemon: answers or launch counts are wrong")
    out["launches"] = {"transcribe_batches": nt, **got}

    art_path = os.path.join(workdir, "tf_transcriber.zip")
    t0 = time.perf_counter()
    if cli.main(["export", "--checkpoint", snap, "--config", cfg_path, "--model_family", "tf",
                 "--out", art_path, *F32]) != 0:
        raise SystemExit("cli export --model_family tf failed")
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = load_exported(art_path)
    load_s = time.perf_counter() - t0
    errs = {}
    for B in (1, 8):
        frames = np.stack(crops[:B])
        _, _, lp = art.call(frames)
        want_lp = f32._logprobs(f32.preprocess_device(frames)).cpu().numpy()
        errs[B] = float(np.abs(lp - want_lp).max())
    art8 = np.stack(crops[:8])
    call_ms = time_ms(lambda: art.call(art8), iters=5, warmup=1)
    out["export"] = {"export_s": export_s, "load_s": load_s, "bytes": os.path.getsize(art_path),
                     "max_abs_err": errs, "call_B8_ms": call_ms, "blank_id": art.meta["blank_id"]}
    print(f"  cli export --model_family tf (symbolic batch): {json.dumps(out['export'])} "
          f"(tol {TF_ARTIFACT_ATOL}) [{smi}]", flush=True)
    if art.meta["blank_id"] != 31 or any(e > TF_ARTIFACT_ATOL for e in errs.values()):
        raise SystemExit("the TF artifact differs from the live reader")
    return out


TF_FUSED_STEP_RTOL = 1e-5  # 13f: first step's loss and gradient norm, K1/K4 vs cuDNN
TF_QSCALE_RTOL = 1e-5  # 13f: calibration scales (absmax / 127) under the flag vs without


def tf_fused(dev, workdir, corpus, cfg, state, snap, f32, qscales, frames, crops, smi):
    """13f: the TF stack under `fused_conv_pool` (conv1 on K1 and K4 in
    float32) from phase 13's seeded weights, each path against the cuDNN
    route (`f32`, `qscales`): a. the forward at B=8 (TF_CPU_ATOL), K1 once;
    b. two epochs of the epoch program against the eager loop under
    cudnn.deterministic, bit for bit, K1 and K4 through their wrappers once
    per eager step and capture, and the first step's loss and gradient norm
    against the cuDNN loop's; c. `cli quantize`'s scales; d. `cli serve` as
    a child process (transcripts equal the cuDNN reader's) and an in-process
    daemon (K1 once per batch, nothing else); e. `cli export`, the artifact
    against the cuDNN reader at B = 1 and 8 (TF_ARTIFACT_ATOL), K1 once per
    call."""
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.config import TrainConfig
    from avsync_torch.data.grid import GridDataSource, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.export import load_exported
    from avsync_torch.predictor import LipReader
    from avsync_torch.serving import AvsyncServer, TranscribeService
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.logging import Logger

    none = {"conv1_pool": 0, "gru_fwd": 0, "gru_bwd": 0, "conv1_pool_bwd": 0, "mel_stats": 0}
    fcfg = cfg.replace(model=dataclasses.replace(cfg.model, fused_conv_pool=True))
    fcfg_path = os.path.join(workdir, "tf_fused_config.json")
    with open(fcfg_path, "w") as f:
        f.write(fcfg.to_json())
    out = {}

    # a. the forward
    reader = LipReader(params=state, config=fcfg, device=dev)
    clips = f32.preprocess_device(frames)
    with torch.inference_mode():
        zero_counts()
        lp = reader._logprobs(clips)
        torch.cuda.synchronize()
        got = counts()
        err = (lp - f32._logprobs(clips)).abs().max().item()
    out["forward"] = {"max_abs_err_vs_cudnn": err, "launches": got,
                      "fused_B8_ms": time_ms(lambda: reader._logprobs(clips), iters=10),
                      "cudnn_B8_ms": time_ms(lambda: f32._logprobs(clips), iters=10)}
    print(f"TF family phase: f. fused_conv_pool (conv1 on K1/K4) against the cuDNN route:\n"
          f"  forward B=8: {json.dumps(out['forward'])} (tol {TF_CPU_ATOL}; K1 once) [{smi}]",
          flush=True)
    if not (reader.model.conv1.fused and err <= TF_CPU_ATOL and got == dict(none, conv1_pool=1)):
        raise SystemExit("the TF forward under fused_conv_pool failed its checks")

    # b. training: the epoch program against the loop, the first step against cuDNN's
    quiet = Logger(None, console=False)
    tcfg = cli._config(fcfg_path)
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, data_path=corpus, device_cache="on"),
                        model=dataclasses.replace(tcfg.model, dropout_rate=0.5),
                        train=TrainConfig(seed=3))
    train_sp, _, _ = split_speakers([f"s{i}" for i in range(1, TF_SPEAKERS + 1)],
                                    tcfg.data.split)
    batcher = LipNetBatcher(GridDataSource(corpus, train_sp), tcfg, device=dev)
    runs = {}
    with torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                    allow_tf32=False):
        for path, c in (("graph", tcfg), ("loop", tcfg), ("cudnn", tcfg.replace(
                model=dataclasses.replace(tcfg.model, fused_conv_pool=False)))):
            trainer = LipNetTrainer(c, device=dev, log=quiet)
            st, log = trainer.init_state(), StepLog()
            zero_counts()
            for e in ((1, 2) if path != "cudnn" else (1,)):
                if path == "graph":
                    trainer.train_epoch_scanned(st, batcher.scan_plan(shuffle=True, seed=e),
                                                metrics_writer=log)
                else:
                    trainer.train_epoch(st, batcher.epoch(shuffle=True, seed=e),
                                        metrics_writer=log)
            torch.cuda.synchronize()
            runs[path] = (st, log.rows, counts())
            trainer._programs.clear()
    (sg, rg, cg), (sl, rl, cl), (_, rc, cc) = runs["graph"], runs["loop"], runs["cudnn"]
    S = len(rl) // 2
    n = program_wrapper_calls(S, 2)
    same_state(sg, sl, "TF family, fused_conv_pool")
    gaps = {k: abs(rl[0][i] - rc[0][i]) / abs(rc[0][i]) for i, k in ((1, "loss"), (2, "grad_norm"))}
    out["train"] = {"steps_per_epoch": S, "wrapper_calls": {"graph": cg, "loop": cl, "cudnn": cc},
                    "first_step_rel_gap_vs_cudnn": gaps,
                    "losses": {"fused": [r[1] for r in rl], "cudnn": [r[1] for r in rc]}}
    print(f"  TF B=8 S={S} dropout 0.5, cudnn.deterministic, 2 epochs graph vs eager loop: "
          f"parameters, Adam state, {len(rl)} losses and gradient norms equal bit for bit: "
          f"{rg == rl}; {json.dumps(out['train'])} (expected wrapper calls graph conv1_pool = "
          f"conv1_pool_bwd = {n}, loop {2 * S}, cudnn 0; first step within "
          f"{TF_FUSED_STEP_RTOL})", flush=True)
    if (rg != rl or cg != dict(none, conv1_pool=n, conv1_pool_bwd=n)
            or cl != dict(none, conv1_pool=2 * S, conv1_pool_bwd=2 * S) or cc != none
            or any(g > TF_FUSED_STEP_RTOL for g in gaps.values())):
        raise SystemExit("TF training under fused_conv_pool failed its checks")
    del runs, sg, sl, batcher
    torch.cuda.empty_cache()

    # c. int8 calibration runs the blocks: the scales under the flag
    fq = os.path.join(workdir, "tf_fused_qscales.npz")
    zero_counts()
    rc_q = cli.main(["quantize", "--data_path", corpus, "--config", fcfg_path, "--checkpoint",
                     snap, "--out", fq, *F32])
    torch.cuda.synchronize()
    got = counts()
    with np.load(qscales) as a, np.load(fq) as b:
        gaps = {k: float(np.max(np.abs(b[k] - a[k]) / np.maximum(np.abs(a[k]), 1e-30)))
                for k in a.files if a[k].dtype.kind == "f"}
        keys_same = sorted(a.files) == sorted(b.files)
    out["quantize"] = {"rc": rc_q, "launches": got, "rel_gap_vs_cudnn": gaps}
    print(f"  cli quantize under the flag: {json.dumps(out['quantize'])} (tol {TF_QSCALE_RTOL}; "
          f"K1 once per calibration batch, no K4)", flush=True)
    if (rc_q != 0 or not keys_same or not got["conv1_pool"] or got["conv1_pool_bwd"]
            or any(g > TF_QSCALE_RTOL for g in gaps.values())):
        raise SystemExit("cli quantize under fused_conv_pool failed its checks")

    # d. serving: a child daemon against the cuDNN reader, an in-process one counted
    t0 = time.perf_counter()
    daemon = Daemon(["--checkpoint", snap, "--config", fcfg_path, "--model_family", "tf",
                     "--port", "0", "--warmup", "--max_batch", str(MAX_BATCH), *F32])
    try:
        up = time.perf_counter() - t0
        row = transcribe_load(daemon.url, crops, f32, "TF fused daemon vs the cuDNN reader")
        rc_d = daemon.stop()
    finally:
        daemon.kill()
    if rc_d != 0:
        raise SystemExit(f"TF fused daemon exited {rc_d} after SIGTERM")
    server = AvsyncServer(TranscribeService(reader, max_batch=MAX_BATCH, max_wait_ms=5.0), None,
                          port=0)
    server.start()
    try:
        zero_counts()
        answers, _, _ = load(f"http://{server.address[0]}:{server.address[1]}",
                             [("/v1/transcribe", npy_bytes(c), "application/x-npy")
                              for c in crops])
        torch.cuda.synchronize()
        got = counts()
        nt = sum(server.stats_snapshot()["transcribe"]["batches"].values())
    finally:
        server.shutdown(drain_timeout=30.0)
    out["serve"] = dict(row, start_s=up, launches={"transcribe_batches": nt, **got})
    print(f"  serve --model_family tf under the flag as a child process, {len(crops)} crops: "
          f"{json.dumps(out['serve'])} (transcripts equal the cuDNN reader's; in-process: K1 "
          f"once per batch) [{smi}]", flush=True)
    if any(a[0] != 200 for a in answers) or got != dict(none, conv1_pool=nt):
        raise SystemExit("TF fused daemon: answers or launch counts are wrong")

    # e. export: the artifact launches K1 (avsync_torch::conv1_pool)
    art_path = os.path.join(workdir, "tf_fused_transcriber.zip")
    if cli.main(["export", "--checkpoint", snap, "--config", fcfg_path, "--model_family", "tf",
                 "--out", art_path, *F32]) != 0:
        raise SystemExit("cli export --model_family tf under fused_conv_pool failed")
    art = load_exported(art_path)
    errs, calls = {}, {}
    for B in (1, 8):
        x = np.stack(crops[:B])
        zero_counts()
        _, _, lp = art.call(x)
        torch.cuda.synchronize()
        calls[B] = counts()
        errs[B] = float(np.abs(lp - f32._logprobs(f32.preprocess_device(x)).cpu().numpy()).max())
    out["export"] = {"max_abs_err_vs_cudnn": errs, "launches": calls,
                     "call_B8_ms": time_ms(lambda: art.call(np.stack(crops[:8])), iters=5,
                                           warmup=1)}
    print(f"  cli export under the flag: {json.dumps(out['export'])} (tol {TF_ARTIFACT_ATOL}; "
          f"K1 once per call) [{smi}]", flush=True)
    if (any(e > TF_ARTIFACT_ATOL for e in errs.values())
            or any(c != dict(none, conv1_pool=1) for c in calls.values())):
        raise SystemExit("the TF artifact under fused_conv_pool failed its checks")
    del reader, art
    torch.cuda.empty_cache()
    return out


def run_tf_family(dev, workdir, smi, cfg=None):
    """Phase 13: the TF-family LipNet at its full default width (`cfg`, the
    TF stack's default config when None), seeded weights through the weight
    bridge: a. Q1 at its three blocks; b. the f32 forward on the card
    against the CPU's; c. `cli train`, the epoch program against the loop;
    d. the commands from the trained snapshot and the int8 forward; e. the
    daemons, f32 and int8, and the exported artifact; f. `fused_conv_pool`
    (conv1 on K1/K4) against the cuDNN route."""
    import glob

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.compat import conv_shape_for, tflipnet_params_from_jax
    from avsync_torch.data.synthetic import write_corpus
    from avsync_torch.predictor import LipReader
    from avsync_torch.utils.checkpoint import CheckpointManager

    out = {"q1": tf_q1_blocks(dev, smi)}
    cfg = cfg or tf_config()
    d = cfg.data
    corpus = os.path.join(workdir, "tf_grid")
    t0 = time.perf_counter()
    write_corpus(corpus, n_speakers=TF_SPEAKERS, clips_per_speaker=8, layout="standard",
                 n_frames=d.max_video_length, height=d.img_height, width=d.img_width, seed=13,
                 with_audio=False)
    print(f"  corpus: {TF_SPEAKERS * 8} clips of {d.max_video_length} x {d.img_height} x "
          f"{d.img_width} (train split 4 speakers: 4 steps of B=8 per epoch) written in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    state = tflipnet_params_from_jax(seeded_jax_layout_tf_params(cfg, seed=2),
                                     conv_shape_for(cfg))
    snap = os.path.join(workdir, "tf_seeded")
    CheckpointManager(snap).save(0, state, config=cfg)
    cfg_path = os.path.join(workdir, "tf_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    f32 = LipReader(params=state, config=cfg, device=dev)
    r = np.random.default_rng(13)
    crops = [r.integers(0, 256, (d.max_video_length, d.img_height, d.img_width),
                        dtype=np.uint8) for _ in range(16)]
    frames = np.stack(crops[:8])
    out["forward"] = tf_forward(dev, f32, frames, smi)
    ck, out["train"] = tf_train(dev, workdir, corpus, cfg_path, smi)
    out["commands"] = tf_commands(dev, workdir, corpus, cfg_path, ck, smi)
    qscales = os.path.join(workdir, "tf_qscales.npz")
    if cli.main(["quantize", "--data_path", corpus, "--config", cfg_path, "--checkpoint", snap,
                 "--out", qscales, *F32]) != 0:
        raise SystemExit("cli quantize (TF seeded weights) failed")
    q8 = LipReader(params=state, config=cfg, device=dev, quantize="int8",
                   calibration_scales=qscales)
    trained = LipReader(checkpoint=ck, config=cfg, device=dev)
    trained8 = LipReader(checkpoint=ck, config=cfg, device=dev, quantize="int8",
                         calibration_scales=os.path.join(workdir, "tf_trained_q.npz"))
    corpus8 = np.stack([np.load(p) for p in sorted(glob.glob(
        os.path.join(corpus, "*", "video", "*.npy")))[:8]])
    out["int8_forward"] = tf_int8_forward(dev, trained, trained8, corpus8, (f32, q8, frames),
                                          smi)
    del trained, trained8
    out["serving"] = tf_serving(dev, workdir, corpus, f32, q8, snap, cfg_path, qscales, crops,
                                smi)
    out["fused"] = tf_fused(dev, workdir, corpus, cfg, state, snap, f32, qscales, frames, crops,
                            smi)
    del f32, q8
    torch.cuda.empty_cache()
    print(f"  TF family phase numbers [{smi}]: {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 14. multi-device: DP, TP, the DP epoch program, CP, the CLI
# ---------------------------------------------------------------------------

P14_B, P14_STEPS = 16, 3  # the DP/TP global batch (8 rows a rank) and the steps checked
P14_PLAN_S, P14_CLIPS = 4, 64  # the DP epoch program's steps and cached corpus
P14_CP = (8, 75, 256, 3)  # CP: B, T, H and ranks (25 steps each)


def p14_config():
    from avsync_torch.config import AvsyncConfig, ModelConfig, TrainConfig

    return AvsyncConfig(model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True,
                                          dropout_rate=0.0), train=TrainConfig(seed=0))


def p14_weights(cfg):
    """Phase 4's seeded weights in the port's layout (CPU tensors)."""
    from avsync_torch.compat import conv_shape_for, lipnet_params_from_jax

    return lipnet_params_from_jax(seeded_jax_layout_params(cfg, seed=0),
                                  conv_shape=conv_shape_for(cfg))


def p14_batch(B=P14_B, seed=14):
    """B full-width clips and feasible GRID-length labels, from a seed."""
    import numpy as np

    r = np.random.default_rng(seed)
    lengths = r.integers(10, 31, B).astype(np.int64)
    labels = r.integers(1, 38, (B, 40)).astype(np.int64)
    for b in range(B):
        labels[b, lengths[b]:] = 0
    return {"video": r.random((B, 75, 50, 100, 1), dtype=np.float32), "labels": labels,
            "label_lengths": lengths}


def p14_trainer(cfg, dev, mesh, weights):
    import torch

    from avsync_torch.models import make_lipnet
    from avsync_torch.train.lipnet_trainer import LipNetTrainer
    from avsync_torch.utils.logging import Logger

    tr = LipNetTrainer(cfg, device=dev, log=Logger(None, console=False), mesh=mesh)
    model = make_lipnet(cfg.model, (50, 100), generator=torch.Generator())
    model.load_state_dict(weights)
    return tr, tr.init_state(model.to(dev))


def p14_steps(cfg, dev, mesh, weights, batch, steps=P14_STEPS, each=None):
    """`steps` train steps from `weights` on `batch` (this rank's rows under
    a mesh); `each(step, state)` after every step. Returns (trainer, state,
    losses)."""
    from avsync_torch.parallel import multihost
    from avsync_torch.train.lipnet_trainer import device_batch, train_step

    tr, st = p14_trainer(cfg, dev, mesh, weights)
    rows = multihost.local_rows(len(batch["labels"]), tr.mesh)
    local = device_batch({k: v[rows] for k, v in batch.items()}, dev)
    losses = []
    for s in range(steps):
        loss, _ = train_step(st.model, st.optimizer, local, tr.current_lr, tr._step_generator(s),
                             cfg.train.grad_clip_norm, False, st.reducer, tr.mesh)
        st.step += 1
        losses.append(float(loss))
        if each is not None:
            each(s, st)
    return tr, st, losses


def p14_flat(model):
    import torch

    return torch.cat([p.detach().reshape(-1) for p in model.parameters()])


def p14_world2(rank, out):
    """Every two-rank scenario on the card: DP (2, 1) with its per-step
    checks and times, TP (1, 2), the DP epoch program against the DP loop."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.mesh import make_mesh
    from avsync_torch.train.lipnet_trainer import device_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = multihost.rank_device()
    res = {"rank": rank, "device": str(dev), "backend": multihost.backend(),
           "cards": torch.cuda.device_count()}
    # whether gloo takes CUDA tensors in all_gather (the port stages them
    # through the host either way; informational)
    try:
        parts = [torch.empty(4, device=dev) for _ in range(2)]
        dist.all_gather(parts, torch.full((4,), float(rank), device=dev))
        res["gloo_all_gather_cuda"] = "taken" if parts[1][0].item() == 1.0 else "wrong values"
    except Exception as e:  # noqa: BLE001 - a probe, reported
        res["gloo_all_gather_cuda"] = f"refused: {str(e).splitlines()[0][:160]}"
    cfg = p14_config()
    weights = p14_weights(cfg)
    batch = p14_batch()

    # b. DP (2, 1): per step the replicas' bits and the wrappers' counts
    same, step_counts = [], []

    def check(s, st):
        torch.cuda.synchronize()
        step_counts.append(counts())
        both = multihost.all_gather(p14_flat(st.model)[None], 0, None)
        same.append(bool(torch.equal(both[0], both[1])))
        zero_counts()

    zero_counts()
    tr, st, losses = p14_steps(cfg, dev, make_mesh((2, 1)), weights, batch, each=check)
    res["dp"] = {"losses": losses, "replicas_equal": same, "counts": step_counts}
    rows = multihost.local_rows(P14_B, tr.mesh)
    local = device_batch({k: v[rows] for k, v in batch.items()}, dev)
    from avsync_torch.train.lipnet_trainer import train_step

    def step():
        train_step(st.model, st.optimizer, local, tr.current_lr, None,
                   cfg.train.grad_clip_norm, False, st.reducer, tr.mesh)

    step()
    torch.cuda.synchronize()
    times, reduce_ms = [], []
    for _ in range(5):
        multihost.barrier()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    for _ in range(5):
        torch.cuda.synchronize()
        multihost.barrier()
        t0 = time.perf_counter()
        st.reducer.reduce()
        torch.cuda.synchronize()
        reduce_ms.append((time.perf_counter() - t0) * 1e3)
    res["dp"]["step_wall_ms"] = statistics.median(times)
    res["dp"]["all_reduce_ms"] = statistics.median(reduce_ms)
    res["dp"]["grad_mb"] = st.reducer.flat.numel() * 4 / 1e6
    del tr, st
    torch.cuda.empty_cache()
    tr, st, losses = p14_steps(cfg, dev, make_mesh((2, 1)), weights, batch)
    dp_full = {k: v.cpu() for k, v in tr.full_state(st)[0].items()}
    del tr, st

    # c. TP (1, 2): both ranks take all 16 rows; gate rows and moments split
    tr, st, tp_losses = p14_steps(cfg, dev, make_mesh((1, 2)), weights, batch)
    full, opt = tr.full_state(st)
    spec = tr.mesh.param_spec
    halves = {n: (tuple(st.optimizer.state[p]["exp_avg"].shape), tuple(full[n].shape))
              for n, p in st.model.named_parameters() if spec[n] is not None}
    res["tp"] = {"losses": tp_losses, "halves": halves,
                 "max_param_diff_vs_dp": max((full[k].cpu() - v).abs().max().item()
                                             for k, v in dp_full.items())}
    if rank == 0:
        torch.save(dp_full, os.path.join(out, "dp_full.pt"))
    del tr, st, full, opt
    torch.cuda.empty_cache()

    # d. the DP epoch program (graph, all-reduce, graph) against the DP loop
    g = np.random.default_rng(7)
    lab = p14_batch(P14_CLIPS, seed=15)
    cache = torch.from_numpy(lab["video"]).to(dev)
    labels = torch.from_numpy(lab["labels"]).to(dev)
    lengths = torch.from_numpy(lab["label_lengths"]).to(dev)
    order = g.permutation(P14_CLIPS)[:P14_PLAN_S * P14_B].reshape(P14_PLAN_S, P14_B)
    cols = multihost.local_rows(P14_B, make_mesh((2, 1)))
    runs = {}
    for path in ("loop", "program"):
        tr, st = p14_trainer(cfg, dev, make_mesh((2, 1)), weights)
        log = StepLog()
        if path == "loop":
            batches = [{"video": cache[torch.from_numpy(order[s, cols]).to(dev)],
                        "labels": lab["labels"][order[s, cols]],
                        "label_lengths": lab["label_lengths"][order[s, cols]]}
                       for s in range(P14_PLAN_S)]
            tr.train_epoch(st, batches, metrics_writer=log)
        else:
            plan = {"video": cache, "gather": lambda r: cache.index_select(0, r),
                    "labels": labels, "lengths": lengths,
                    "idx": order[:, cols].astype(np.int32)}
            tr.train_epoch_scanned(st, plan, metrics_writer=log)
        torch.cuda.synchronize()
        runs[path] = (st, log.rows, tr._programs)
    (sl, ll, _), (sp, lp, progs) = runs["loop"], runs["program"]
    prog = next(iter(progs.values()))
    equal = all(torch.equal(a, b) for a, b in zip(sl.model.parameters(), sp.model.parameters()))
    adam = all(torch.equal(sa[k], sb[k]) for sa, sb in zip(sl.optimizer.state.values(),
                                                           sp.optimizer.state.values())
               for k in sa)
    res["program"] = {"params_equal": equal, "adam_equal": adam, "losses_equal": ll == lp,
                      "losses": [r[1] for r in lp],
                      "graphs": [prog.graph is not None, prog.finish_graph is not None]}
    torch.save(res, os.path.join(out, f"world2_{rank}.pt"))


def p14_cp_inputs():
    import numpy as np
    import torch

    B, T, H, _ = P14_CP
    r = np.random.default_rng(16)
    k = H ** -0.5
    return (torch.from_numpy(r.normal(size=(B, T, 3 * H)).astype(np.float32)),
            torch.from_numpy(r.uniform(-k, k, (H, 3 * H)).astype(np.float32)),
            torch.from_numpy(r.uniform(-k, k, (3 * H,)).astype(np.float32)))


def p14_cp(rank, out):
    """This rank's chunk of the CP chain through K2 with the handed-off h0."""
    import torch

    from avsync_torch.ops.cuda import gru
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.context import cp_gru_recurrence

    dev = multihost.rank_device()
    gi, w, b = (t.to(dev) for t in p14_cp_inputs())
    n = P14_CP[3]
    T = gi.shape[1] // n
    gru.launches = 0
    y = cp_gru_recurrence(None, gi[:, rank * T:(rank + 1) * T].contiguous(), w, b)
    torch.cuda.synchronize()
    torch.save({"y": y.cpu(), "launches": gru.launches}, os.path.join(out, f"cp_{rank}.pt"))


def p14_launch_cli(argv, world, log_dir):
    """`world` processes of `python -m avsync_torch.cli <argv>` with the
    environment torchrun would give them; every one must exit 0."""
    from avsync_torch.parallel import multihost

    port = multihost.free_port()
    procs = []
    for r in range(world):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                   LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), PYTHONPATH=ROOT)
        log = open(os.path.join(log_dir, f"rank{r}.log"), "w")
        procs.append((subprocess.Popen([sys.executable, "-m", "avsync_torch.cli", *argv],
                                       stdout=log, stderr=subprocess.STDOUT, env=env,
                                       cwd=ROOT), log))
    try:
        for p, log in procs:
            rc = p.wait(timeout=600)
            log.close()
            if rc != 0:
                with open(log.name) as f:
                    tail = f.read()[-3000:]
                raise SystemExit(f"cli rank exited {rc}:\n{tail}")
    finally:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
    with open(os.path.join(log_dir, "rank0.log")) as f:
        return f.read()


def run_multi_device(dev, workdir, smi, k2_ms, graph_row, crops):
    """Phase 14 (see the module's docstring)."""
    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.ops.cuda import gru
    from avsync_torch.parallel import multihost

    cards = torch.cuda.device_count()
    route = "nccl" if cards >= 2 else "gloo"
    why = ("one card per rank" if cards >= 2
           else f"the ranks share {cards} card: NCCL refuses two ranks on one card")
    print(f"multi-device phase: route {route} ({why}); world 2 (DP, TP, epoch program, cli "
          f"train --distributed), 3 (CP); cards {cards} [{smi}]", flush=True)
    cfg = p14_config()
    weights = p14_weights(cfg)
    batch = p14_batch()
    lr = cfg.train.learning_rate

    # a. determinism: two eager runs of the default trainer, equal bits
    t0 = time.perf_counter()
    runs = []
    for _ in range(2):
        first8 = {k: v[:8] for k, v in batch.items()}
        tr, st, losses = p14_steps(cfg, dev, None, weights, first8)
        runs.append((p14_flat(st.model), losses))
        del tr, st
    torch.cuda.synchronize()
    det_equal = bool(torch.equal(runs[0][0], runs[1][0])) and runs[0][1] == runs[1][1]
    print(f"  a. two eager runs of the default LipNetTrainer, B=8, {P14_STEPS} steps from the "
          f"same weights: parameters and losses {'equal bit for bit' if det_equal else 'DIFFER'}"
          f" (losses {runs[0][1]}; {time.perf_counter() - t0:.1f} s)", flush=True)
    if not det_equal:
        raise SystemExit("the default trainer's steps are not reproducible")
    del runs

    # the one-process reference of b: the same 16 rows on one device
    tr, st, single_losses = p14_steps(cfg, dev, None, weights, batch)
    single = {k: v.cpu() for k, v in st.model.state_dict().items()}
    del tr, st
    torch.cuda.empty_cache()

    out = os.path.join(workdir, "p14")
    os.makedirs(out)
    t0 = time.perf_counter()
    multihost.spawn(p14_world2, 2, (out,), device="cuda")
    ranks = [torch.load(os.path.join(out, f"world2_{r}.pt"), weights_only=False)
             for r in range(2)]
    dp_full = torch.load(os.path.join(out, "dp_full.pt"))
    print(f"  ranks: {[(r['rank'], r['device'], r['backend']) for r in ranks]} "
          f"({time.perf_counter() - t0:.1f} s); gloo all_gather of CUDA tensors: "
          f"{ranks[0]['gloo_all_gather_cuda']} (the port stages gloo's CUDA collectives "
          f"through the host either way)", flush=True)
    a, b = ranks
    if a["backend"] != route:
        raise SystemExit(f"the ranks took {a['backend']}, not {route}")
    want = {"conv1_pool": 1, "gru_fwd": 2, "gru_bwd": 2, "conv1_pool_bwd": 1, "mel_stats": 0}
    dp_err = max(abs(x - y) / abs(y) for x, y in zip(a["dp"]["losses"], single_losses))
    dp_param = max((dp_full[k] - v).abs().max().item() for k, v in single.items())
    print(f"  b. DP (2, 1), global B=16 (8 a rank): losses {a['dp']['losses']} vs one process "
          f"{single_losses} (max rel err {dp_err:.2e}, tol 1e-5); parameters after "
          f"{P14_STEPS} steps within {dp_param:.3e} of it (tol 6 lr = {6 * lr:.1e}); replicas "
          f"equal bit for bit after each step: {a['dp']['replicas_equal']}; launches per rank "
          f"and step: {a['dp']['counts']} / {b['dp']['counts']} (want {want})", flush=True)
    if (a["dp"]["losses"] != b["dp"]["losses"] or dp_err > 1e-5 or dp_param > 6 * lr
            or not all(a["dp"]["replicas_equal"] + b["dp"]["replicas_equal"])
            or any(c != want for c in a["dp"]["counts"] + b["dp"]["counts"])):
        raise SystemExit("data-parallel run failed its checks")
    times = {"dp_step_wall_ms_per_rank": [r["dp"]["step_wall_ms"] for r in ranks],
             "all_reduce_ms_per_rank": [r["dp"]["all_reduce_ms"] for r in ranks],
             "grad_mb": a["dp"]["grad_mb"], "route": route}
    print(f"  DP step wall ms per rank {times['dp_step_wall_ms_per_rank']}; all-reduce of the "
          f"{a['dp']['grad_mb']:.1f} MB gradient buffer ({route}"
          f"{', staged through the host' if route == 'gloo' else ''}): "
          f"{times['all_reduce_ms_per_rank']} ms (median of 5) [{smi}]", flush=True)
    tp_err = max(abs(x - y) / abs(y) for x, y in zip(a["tp"]["losses"], a["dp"]["losses"]))
    halves_ok = all(local[0] * 2 == whole[0] and local[1:] == whole[1:]
                    for local, whole in a["tp"]["halves"].values())
    print(f"  c. TP (1, 2) vs DP (2, 1): losses {a['tp']['losses']} (max rel err {tp_err:.2e}, "
          f"tol 1e-5); gathered parameters within {a['tp']['max_param_diff_vs_dp']:.3e} (tol "
          f"{6 * lr:.1e}); {len(a['tp']['halves'])} sharded leaves' Adam moments half the rows: "
          f"{halves_ok}", flush=True)
    if (tp_err > 1e-5 or a["tp"]["max_param_diff_vs_dp"] > 6 * lr or not halves_ok
            or a["tp"]["losses"] != b["tp"]["losses"]):
        raise SystemExit("tensor-parallel run failed its checks")
    progs = [r["program"] for r in ranks]
    print(f"  d. DP epoch program (graph, all-reduce, graph) vs DP loop, {P14_PLAN_S} steps "
          f"over a {P14_CLIPS}-clip cache: parameters {[p['params_equal'] for p in progs]}, "
          f"Adam state {[p['adam_equal'] for p in progs]}, losses "
          f"{[p['losses_equal'] for p in progs]} equal bit for bit; graphs captured "
          f"{progs[0]['graphs']}", flush=True)
    if not all(p["params_equal"] and p["adam_equal"] and p["losses_equal"] and all(p["graphs"])
               for p in progs):
        raise SystemExit("the DP epoch program differs from the DP loop")

    # e. CP over 3 ranks through K2 with h0, against K2 over the whole sequence
    gi, w, bh = (t.to(dev) for t in p14_cp_inputs())
    whole = gru.gru_recurrence(gi, w, bh)
    zeros = gru.gru_recurrence(gi, w, bh, h0=torch.zeros(gi.shape[0], w.shape[0], device=dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    multihost.spawn(p14_cp, P14_CP[3], (out,), device="cuda")
    parts = [torch.load(os.path.join(out, f"cp_{r}.pt")) for r in range(P14_CP[3])]
    chain = torch.cat([p["y"] for p in parts], dim=1)
    cp_equal = bool(torch.equal(chain, whole.cpu()))
    cp_err = (chain - whole.cpu()).abs().max().item()
    print(f"  e. CP over {P14_CP[3]} ranks (B={P14_CP[0]}, T={P14_CP[1]} = 3 x 25, "
          f"H={P14_CP[2]}), K2 from each handed-off h0: "
          f"{'equal bit for bit' if cp_equal else 'DIFFERS'} "
          f"to K2 over the whole sequence (max abs err {cp_err:.3e}); K2 launches per rank "
          f"{[p['launches'] for p in parts]} ({time.perf_counter() - t0:.1f} s); K2 with no h0 "
          f"vs h0 = zeros: {'equal bit for bit' if torch.equal(whole, zeros) else 'DIFFER'}; "
          f"K2 time at B=8 (phase 3) {k2_ms:.4f} ms beside PERF.md §6's 0.1028 ms [{smi}]",
          flush=True)
    if (cp_err > 1e-6 or not torch.equal(whole, zeros)
            or any(p["launches"] != 1 for p in parts)):
        raise SystemExit("the CP chain or K2's h0 failed its checks")

    # f. cli train --distributed under a 2-rank launch, then a one-process test
    data, cfg_path = os.path.join(workdir, "grid"), os.path.join(workdir, "config.json")
    ck = os.path.join(workdir, "ck14")
    t0 = time.perf_counter()
    log0 = p14_launch_cli(["train", "--distributed", "--data_path", data, "--config", cfg_path,
                           "--epochs", "1", "--checkpoint_dir", ck, *F32], 2, out)
    wall = time.perf_counter() - t0
    res = os.path.join(out, "test14.json")
    rc = cli.main(["test", "--data_path", data, "--config", cfg_path, "--checkpoint", ck,
                   "--output", res, *F32])
    with open(res) as f:
        tested = json.load(f)
    mesh_line = next((ln for ln in log0.splitlines() if ln.startswith("mesh ")), "")
    print(f"  f. cli train --distributed, 2 ranks (torchrun's variables), 1 epoch on phase 5's "
          f"corpus: {wall:.1f} s, rank 0: '{mesh_line}', snapshots "
          f"{sorted(n for n in os.listdir(ck) if n.endswith('.pth'))}; one-process cli test "
          f"from rank 0's snapshot: rc {rc}, {tested}", flush=True)
    if rc != 0 or "epoch_2.pth" not in os.listdir(ck) or "'data': 2" not in mesh_line:
        raise SystemExit("cli train --distributed failed its checks")
    if cards >= 2:  # serve --dp 2's reader against a one-card reader on phase 10's crops
        import argparse

        from avsync_torch.predictor import LipReader

        scfg = cli._serving_config(argparse.Namespace(config=None))
        params = seeded_jax_layout_params(scfg, seed=0)
        one = LipReader(params=params, config=scfg, device=dev)
        two = LipReader(params=params, config=scfg, devices=["cuda:0", "cuda:1"])
        x = torch.cat([one._prepare(np.asarray(c)) for c in crops[:16]])
        same = one._decode(one._logprobs(x)) == two._decode(two._logprobs(x))
        print(f"  serve --dp 2's reader over cuda:0 and cuda:1 on {len(x)} of phase 10's "
              f"crops: transcripts {'equal to' if same else 'DIFFER from'} one card's",
              flush=True)
        if not same:
            raise SystemExit("data-parallel serving differs from one card")
    else:
        print(f"  serve --dp 2: not run: this machine has {cards} card (--dp takes one "
              f"replica per card)", flush=True)
    print(f"  deterministic single-device graph step (phase 9's timed LipNet graph path, B=8, "
          f"dropout 0.5): {graph_row['wall_ms_per_step']:.4f} ms per step, against PERF.md §5's "
          f"65.74 ms with cuDNN's default algorithms and 78.57 ms deterministic [{smi}]",
          flush=True)
    times["graph_step_ms"] = graph_row["wall_ms_per_step"]
    return {"dp_counts": a["dp"]["counts"][0], "times": times,
            "cp_launches": [p["launches"] for p in parts]}


# ---------------------------------------------------------------------------
# 15. bf16 compute
# ---------------------------------------------------------------------------

BF16_FLOPS = 989e12  # H100 SXM, dense bf16 on the tensor cores
# bf16 against f32 on the same weights: the JAX package's nearest
# reduced-precision bounds (tests/test_quant.py:135-137)
BF16_MEAN_LOGPROB, BF16_ARGMAX = 0.05, 0.95
# one bf16 function through another dispatch or batching (cuDNN may pick
# another algorithm, so a float32 sum may round to the neighbouring bf16):
# a logit's flipped rounding is one bf16 ulp, 2^-7 of its magnitude, 0.125
# below |16|; transcripts may differ only where two log-probs lie that close
BF16_NEAR_TIE = 0.125
# a sync probability moves at most a quarter of its logit's change: 0.05
# for a logit moved by 0.2 (bf16 conv statistics into an f32 MLP)
BF16_PROB_ATOL = 0.05
# K1-bf16 on random data: the share of pooled values one bf16 ulp from the
# plain version's at most (its float32 sums run in another order)
BF16_DIFF_SHARE = 1e-3


def bf16_replayed(names):
    """Kernels of a bf16 LipNet step by profiler name: K1-bf16 and K4-bf16
    (their own kernels, BF16_KERNEL_NAMES), the float K1, K2 and K3."""
    def count(pat, bf16):
        return sum(n for name, n in names.items()
                   if pat in name and ("bfloat16" in name) == bf16)

    return {"conv1_pool_bf16": count(BF16_KERNEL_NAMES["conv1_pool_bf16"], False),
            "conv1_pool_bwd_bf16": count(BF16_KERNEL_NAMES["conv1_pool_bwd_bf16"], False),
            "conv1_pool_f32": count(KERNEL_NAMES["conv1_pool"], False),
            "gru_fwd": count(KERNEL_NAMES["gru_fwd"], False),
            "gru_bwd": count(KERNEL_NAMES["gru_bwd"], False)}


def bf16_bound_ms(n_bytes: float, n_ops: float):
    """The least time: bytes over 3.35 TB/s or operations over the bf16
    tensor-core rate, the larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def agreement(lp, ref, what, smi):
    """mean |d log-prob| and argmax agreement of lp against ref, held to
    the JAX package's reduced-precision bounds."""
    import torch

    mean = (lp.float() - ref.float()).abs().mean().item()
    agree = (lp.argmax(-1) == ref.argmax(-1)).float().mean().item()
    worst = (lp.float() - ref.float()).abs().max().item()
    print(f"  {what}: mean |d log-prob| {mean:.3e} (< {BF16_MEAN_LOGPROB}), argmax agreement "
          f"{agree:.4f} (>= {BF16_ARGMAX}), max |d| {worst:.3e} [{smi}]", flush=True)
    if not (mean < BF16_MEAN_LOGPROB and agree >= BF16_ARGMAX and torch.isfinite(lp).all()):
        raise SystemExit(f"{what}: outside the JAX package's reduced-precision bounds")
    return {"mean_abs": mean, "argmax_agreement": agree, "max_abs": worst}


def bf16_exact_grid(g, dev, B, T=75):
    """bf16 LipNet-shape inputs on grids where every partial sum of the bf16
    kernels' recompute is exact in float32 in any order (and K4's dW at B=1,
    T=8): x = i/16, w = j/64, b = k/64, cotangent m/8 (|j|, |k| <= 15,
    |m| <= 8)."""
    import torch

    bf = torch.bfloat16
    x = (torch.randint(0, 16, (B, T, 50, 100, 1), generator=g) / 16).to(dev).to(bf)
    w = (torch.randint(-15, 16, (3, 5, 5, 1, 32), generator=g) / 64).to(dev).to(bf)
    b = (torch.randint(-15, 16, (32,), generator=g) / 64).to(dev)
    cot = (torch.randint(-8, 9, (B, T, 25, 50, 32), generator=g) / 8).to(dev).to(bf)
    return x, w, b, cot


def one_ulp_share(got, want, what):
    """K1-bf16 against its plain version on random data: within one bf16
    ulp of the plain value at every element (the ulp taken at no less than
    2^-5: 2^-12 near 0, the bound of an f32 reorder of the sums), at most
    BF16_DIFF_SHARE of the elements differing. Returns (max |d|, share)."""
    import torch

    got, want = got.float(), want.float()
    mag = want.abs().clamp_min(2.0 ** -5)
    ok = ((got - want).abs() <= torch.exp2(torch.floor(torch.log2(mag)) - 7)).all().item()
    err = (got - want).abs().max().item()
    share = (got != want).float().mean().item()
    print(f"  {what}: max_abs_err={err:.3e}, {share:.3e} of the elements differ (one ulp "
          f"at most: {'ok' if ok else 'FAIL'}; share <= {BF16_DIFF_SHARE})", flush=True)
    if not ok or share > BF16_DIFF_SHARE:
        raise SystemExit(f"kernel check failed: {what}")
    return err, share


def hmma_bf16_count(name, kernel):
    """HMMA instructions with bf16 operands in the SASS of `kernel`'s
    functions in kernel library `name` (cuobjdump -sass)."""
    import shutil

    from avsync_torch.ops.cuda import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(build.library_path(name))], capture_output=True,
                          text=True, check=True).stdout
    n, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside and "HMMA" in line and "BF16" in line:
            n += 1
    return n


def bf16_kernels(dev, smi):
    """15a: K1-bf16 and K4-bf16 on the bf16 tensor cores against their plain
    versions. Their float32 sums run in the K order, not the plain versions'
    tap order, so: on exact-grid inputs K1-bf16 equals its plain version bit
    for bit at B = 8 and 128 in both layouts, K4-bf16 at B=1, T=8 (within
    K4_TOL at B = 8 and 128); on random data (the cases of earlier slices)
    K1-bf16 is within one bf16 ulp, at most BF16_DIFF_SHARE differing, and
    K4-bf16 within K4_TOL once the cotangent of the near-tie windows is zero;
    clip 0 alone gives its slice's bits; a repeat launch of each the same
    bits; HMMA with bf16 operands in both kernels' SASS. Both timed at B=8
    beside the f32 kernels, cuDNN's bf16 block and its autograd backward,
    and the bf16 bound. Returns the kernel line's two rows."""
    import torch
    import torch.nn.functional as F

    from avsync_torch.ops.conv import fp32_step
    from avsync_torch.ops.cuda import convpool

    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(15)
    ge = torch.Generator(device="cpu").manual_seed(1515)
    print("bf16 phase: a. K1-bf16 and K4-bf16 (bf16 x, weights and cotangent, float32 "
          "bias; avs_conv1_pool_bf16, avs_conv1_pool_bwd_bf16) vs their plain versions:",
          flush=True)
    k1_errs, k4_errs, shares, zeroed = [], [], {}, {}

    def case(B):
        x = torch.rand(B, 75, 50, 100, 1, generator=g).to(dev).to(bf)
        w = ((torch.rand(3, 5, 5, 1, 32, generator=g) * 2 - 1) * 0.115).to(dev).to(bf)
        b = ((torch.rand(32, generator=g) * 2 - 1) * 0.115).to(dev)
        cot = torch.randn(B, 75, 25, 50, 32, generator=g).to(dev).to(bf)
        return x, w, b, cot

    # exact grids: every sum exact, so the bits are the plain version's
    x, w, b, cot = bf16_exact_grid(ge, dev, 1, T=8)
    got, want = convpool.conv1_pool_bwd(x, w, b, cot), convpool.conv1_pool_bwd_ref(x, w, b, cot)
    torch.cuda.synchronize()
    if not all(torch.equal(a, r) for a, r in zip(got, want)):
        raise SystemExit("kernel check failed: K4-bf16 at B=1 T=8 on the exact grid differs "
                         "from its plain version in some bit")
    print("  exact grid: K4-bf16 B=1 T=8 50x100 C=32 equal to the plain version bit for bit",
          flush=True)
    for B in (8, 128):
        x, w, b, cot = bf16_exact_grid(ge, dev, B)
        x_n, w_n = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
        want = convpool.conv1_pool_ref(x, w, b)
        got, got_j = convpool.conv1_pool_block(x_n, w_n, b), convpool.conv1_pool_fused(x, w, b)
        one = convpool.conv1_pool_block(x_n[:1], w_n, b)
        torch.cuda.synchronize()
        if not (got.dtype == bf and torch.equal(got, want.permute(0, 4, 1, 2, 3))
                and torch.equal(got_j, want)):
            raise SystemExit(f"kernel check failed: K1-bf16 at B={B} on the exact grid differs "
                             "from its plain version in some bit")
        if not torch.equal(one, got[:1]):
            raise SystemExit(f"kernel check failed: K1-bf16's clip 0 alone differs from its "
                             f"slice of B={B}")
        print(f"  exact grid: K1-bf16 B={B} T=75 50x100 C=32 equal to the plain version bit "
              f"for bit in both layouts; clip 0 alone equals its slice", flush=True)
        del got, got_j, want, one
        want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
        for name, a, r in zip(("dkernel", "dbias"), convpool.conv1_pool_bwd(x, w, b, cot), want):
            k4_errs.append(max_err(a, r, K4_TOL, f"exact grid: K4-bf16 {name} B={B}"))
        del x, w, cot, want
        torch.cuda.empty_cache()

    # random data: today's cases
    for B in (8, 128):
        x, w, b, cot = case(B)
        x_n, w_n = x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous()
        got = convpool.conv1_pool_block(x_n, w_n, b)
        want = convpool.conv1_pool_ref(x, w, b).permute(0, 4, 1, 2, 3)
        err, shares[f"B{B}"] = one_ulp_share(got, want, f"K1-bf16 B={B} T=75 50x100 C=32")
        k1_errs.append(err)
        same_bits([got], [convpool.conv1_pool_block(x_n, w_n, b)], f"K1-bf16 B={B}")
        if not torch.equal(convpool.conv1_pool_block(x_n[:1], w_n, b), got[:1]):
            raise SystemExit(f"kernel check failed: K1-bf16's clip 0 alone differs from its "
                             f"slice of B={B}")
        del got, want
        ties = convpool.near_ties(x, w, b)
        zeroed[f"B{B}"] = int(ties.sum().item())
        print(f"  K4-bf16 B={B}: the cotangent of {zeroed[f'B{B}']} near-tie windows of "
              f"{ties.numel()} zeroed (pre-activations within 2^-12)", flush=True)
        cot = cot.masked_fill(ties, 0)
        del ties
        want = convpool.conv1_pool_bwd_ref(x, w, b, cot)
        got = convpool.conv1_pool_bwd(x, w, b, cot)
        for name, a, r in zip(("dkernel", "dbias"), got, want):
            k4_errs.append(max_err(a, r, K4_TOL, f"K4-bf16 {name} B={B} (float32 sums)"))
        same_bits(got, convpool.conv1_pool_bwd(x, w, b, cot), f"K4-bf16 B={B}")
        del x, w, cot, got, want
        torch.cuda.empty_cache()
    hmma = {"conv1_pool_bf16": hmma_bf16_count("conv1_pool",
                                               BF16_KERNEL_NAMES["conv1_pool_bf16"]),
            "conv1_pool_bwd_bf16": hmma_bf16_count("conv1_pool_bwd",
                                                   BF16_KERNEL_NAMES["conv1_pool_bwd_bf16"])}
    print(f"  SASS: HMMA with bf16 operands {json.dumps(hmma)}", flush=True)
    if not all(hmma.values()):
        raise SystemExit("a bf16 kernel runs no bf16 HMMA")

    B, T, H, W, C, taps = 8, 75, 50, 100, 32, 75
    x, w, b, cot = case(B)
    x_n, w_n, cot_n = (x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2).contiguous(),
                       cot.permute(0, 4, 1, 2, 3))
    xf_n, wf_n, cotf_n = x_n.float(), w_n.float(), cot_n.float()

    def library():
        with fp32_step():
            return F.max_pool3d(F.relu(F.conv3d(x_n, w_n, b.to(bf), padding=(1, 2, 2))),
                                (1, 2, 2))

    max_err(library().float(), convpool.conv1_pool_block(x_n, w_n, b).float(),
            dict(atol=3e-2, rtol=1e-2), "cuDNN bf16 block vs K1-bf16 (yardstick sanity: the "
            "bias added before the rounding)")
    k1 = {"ms": time_ms(lambda: convpool.conv1_pool_block(x_n, w_n, b)),
          "f32_ms": time_ms(lambda: convpool.conv1_pool_block(xf_n, wf_n, b)),
          "plain_ms": time_ms(lambda: convpool.conv1_pool_ref(x, w, b)),
          "library_ms": time_ms(library),
          "device_ms": queued_ms(lambda: convpool.conv1_pool_block(x_n, w_n, b)),
          "f32_device_ms": queued_ms(lambda: convpool.conv1_pool_block(xf_n, wf_n, b))}
    n_pre = B * T * H * W * C
    k1["bound_ms"], k1["bound_by"] = bf16_bound_ms(
        2 * (B * T * H * W + w.numel() + B * T * (H // 2) * (W // 2) * C) + 4 * C,
        n_pre * (2 * taps + 2))
    wl, bl = w_n.clone().requires_grad_(), b.to(bf).requires_grad_()
    with fp32_step():
        y_lib = F.max_pool3d(F.relu(F.conv3d(x_n, wl, bl, padding=(1, 2, 2))), (1, 2, 2))

    def library_bwd():
        with fp32_step():
            return torch.autograd.grad(y_lib, (wl, bl), cot_n, retain_graph=True)

    library_bwd()
    routed = int((convpool.conv1_pool_ref(x, w, b) > 0).sum().item())
    k4 = {"ms": time_ms(lambda: convpool.conv1_pool_block_bwd(x_n, w_n, b, cot_n)),
          "f32_ms": time_ms(lambda: convpool.conv1_pool_block_bwd(xf_n, wf_n, b, cotf_n)),
          "plain_ms": time_ms(lambda: convpool.conv1_pool_bwd_ref(x, w, b, cot), iters=5,
                              warmup=1),
          "library_ms": time_ms(library_bwd),
          "device_ms": queued_ms(lambda: convpool.conv1_pool_block_bwd(x_n, w_n, b, cot_n)),
          "f32_device_ms": queued_ms(lambda: convpool.conv1_pool_block_bwd(xf_n, wf_n, b,
                                                                           cotf_n))}
    k4["bound_ms"], k4["bound_by"] = bf16_bound_ms(
        2 * (B * T * H * W + B * T * (H // 2) * (W // 2) * C + taps * C) + 4 * (C + taps * C + C),
        n_pre * (2 * taps + 2) + routed * (2 * taps + 1))
    for name, row in (("K1-bf16", k1), ("K4-bf16", k4)):
        print(f"  {name} B=8 T=75 50x100 C=32: kernel_ms={row['ms']:.4f} (f32 kernel "
              f"{row['f32_ms']:.4f}, x{row['ms'] / row['f32_ms']:.3f}; device alone "
              f"{row['device_ms']:.4f}, f32 {row['f32_device_ms']:.4f}) plain_ms="
              f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} bound_ms="
              f"{row['bound_ms']:.4f} ({row['bound_by']}, bf16 at 989 TFLOP/s) [{smi}]",
              flush=True)
    shape = "B=8 T=75 50x100 C=32 k=3x5x5, bf16 x/w/out, float32 bias"
    return (dict(name="conv1_pool_bf16", route="cuda", source="avsync_torch/csrc/conv1_pool.cu",
                 replaces="avsync/ops/pallas/convpool.py:100", max_abs_err=max(k1_errs), **k1,
                 differing_share=shares, hmma_bf16_sass=hmma["conv1_pool_bf16"],
                 entry="avs_conv1_pool_bf16", shape=shape,
                 library_note="cuDNN bf16 max_pool3d(relu(conv3d + b))"),
            dict(name="conv1_pool_bwd_bf16", route="cuda",
                 source="avsync_torch/csrc/conv1_pool_bwd.cu",
                 replaces="avsync/ops/pallas/convpool.py:244", max_abs_err=max(k4_errs), **k4,
                 near_ties_zeroed=zeroed, hmma_bf16_sass=hmma["conv1_pool_bwd_bf16"],
                 entry="avs_conv1_pool_bwd_bf16", shape=shape + ", bf16 cotangent",
                 library_note="torch.autograd.grad of the cuDNN bf16 block w.r.t. (w, b)"))


def bf16_forward(dev, smi):
    """15b: the bf16 LipNet forward at B=8 with K1 and K2 on (phase 4's
    seeded weights): one K1 and two K2 launches; against the same module in
    bf16 on the CPU and against the f32 forward on the card within the JAX
    package's reduced-precision bounds; its time beside the f32 forward's."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
    from avsync_torch.predictor import LipReader

    cfg = AvsyncConfig(data=DataConfig(), model=ModelConfig(use_pallas_gru=True,
                                                            fused_conv_pool=True))
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               compute_dtype="bfloat16"))
    params = seeded_jax_layout_params(cfg, seed=0)
    f32 = LipReader(params=params, config=cfg, device=dev)
    r16 = LipReader(params=params, config=cfg16, device=dev)
    frames = np.random.default_rng(15).integers(0, 256, (8, 75, 50, 100), dtype=np.uint8)
    x = r16.preprocess_device(frames)
    zero_counts()
    lp16 = r16._logprobs(x)
    torch.cuda.synchronize()
    got = counts()
    want = {"conv1_pool": 1, "gru_fwd": 2, "gru_bwd": 0, "conv1_pool_bwd": 0, "mel_stats": 0}
    print(f"bf16 phase: b. the bf16 forward B=8 (K1-bf16 and K2 on): launches {got} "
          f"(expected {want})", flush=True)
    if got != want or lp16.dtype != torch.float32:
        raise SystemExit("the bf16 forward's launches or output dtype are wrong")
    row = {"vs_f32": agreement(lp16, f32._logprobs(x), "bf16 vs f32 forward on the card", smi)}
    cpu = copy.deepcopy(r16.model).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode():
        want_cpu = cpu(x.cpu())
    row["cpu_s"] = time.perf_counter() - t0
    row["vs_cpu"] = agreement(lp16.cpu(), want_cpu, "bf16 forward on the card vs the same "
                              f"module in bf16 on the CPU ({row['cpu_s']:.1f} s)", smi)
    del cpu, want_cpu
    row["bf16_ms"] = time_ms(lambda: r16._logprobs(x), iters=10)
    row["f32_ms"] = time_ms(lambda: f32._logprobs(x), iters=10)
    print(f"  forward B=8 T=75 (CUDA events, median of 10): bf16 {row['bf16_ms']:.3f} ms, "
          f"f32 {row['f32_ms']:.3f} ms [{smi}]", flush=True)
    return row, got


def bf16_train(dev, workdir, smi, f32_graph):
    """15c: `cli train --compute_dtype bfloat16` for 2 epochs on phase 5's
    corpus (the second an epoch program over the device cache): K1-K4 launch
    as counted; the bf16 epoch program against its eager loop under
    cudnn.deterministic (bit for bit), steps/s and the idle share beside
    phase 9's f32 graph step; the loss falling over 20 steps on one repeated
    batch. Returns the snapshot and the launch counts."""
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig, TrainConfig
    from avsync_torch.data.grid import GridDataSource, split_speakers
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.models.lipnet import LipNet
    from avsync_torch.train.lipnet_trainer import (LipNetTrainer, device_batch, make_optimizer,
                                                   train_step)
    from avsync_torch.utils.checkpoint import CheckpointManager
    from avsync_torch.utils.logging import Logger

    data, cfg_path = os.path.join(workdir, "grid"), os.path.join(workdir, "config.json")
    ck = os.path.join(workdir, "ckpt_bf16")
    cfg = cli._config(cfg_path)
    splits = split_speakers(GridDataSource(data).speakers, cfg.data.split)
    n_train, n_val, n_test = (len(GridDataSource(data, sp)) for sp in splits)
    bsz = cfg.data.batch_size
    steps = n_train // bsz
    val_b, test_b = -(-n_val // bsz), -(-n_test // bsz)
    zero_counts()
    t0 = time.perf_counter()
    rc = cli.main(["train", "--data_path", data, "--config", cfg_path, "--epochs", "2",
                   "--checkpoint_dir", ck, "--compute_dtype", "bfloat16"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    plain = steps + program_wrapper_calls(steps, 1)  # epoch 1 streamed, epoch 2 a program
    fwd = 2 * val_b + test_b  # validation per epoch, the command's test pass
    want = {"conv1_pool": plain + fwd, "gru_fwd": 2 * (plain + fwd), "gru_bwd": 2 * plain,
            "conv1_pool_bwd": plain, "mel_stats": 0}
    payload, meta = CheckpointManager(ck).restore()
    with open(os.path.join(ck, "history.json")) as f:
        hist = json.load(f)
    print(f"bf16 phase: c. cli train --compute_dtype bfloat16, 2 epochs on phase 5's corpus "
          f"(epoch 2 an epoch program over the device cache): rc={rc} wall_s={wall:.2f}; "
          f"loss {hist['loss']} val_loss {hist['val_loss']}; launches {got} (expected {want}); "
          f"snapshot compute_dtype {meta['config']['model']['compute_dtype']!r}, parameters "
          f"{sorted({str(v.dtype) for v in payload['model_state_dict'].values()})}", flush=True)
    if (rc != 0 or got != want or meta["config"]["model"]["compute_dtype"] != "bfloat16"
            or any(v.dtype != torch.float32 for v in payload["model_state_dict"].values())
            or not np.all(np.isfinite(hist["loss"] + hist["val_loss"]))):
        raise SystemExit("cli train --compute_dtype bfloat16 left the wrong launches, "
                         "snapshot or history")

    # the epoch program against its eager loop, bit for bit (phase 9's corpus)
    root = os.path.join(workdir, "programs")
    quiet = Logger(None, console=False)
    pcfg = AvsyncConfig(data=DataConfig(data_path=root, device_cache="on"),
                        model=ModelConfig(use_pallas_gru=True, fused_conv_pool=True,
                                          dropout_rate=0.5, compute_dtype="bfloat16"),
                        train=TrainConfig(seed=3))
    batcher = LipNetBatcher(GridDataSource(root), pcfg, device=dev)
    def lipnet_run(path):
        trainer = LipNetTrainer(pcfg, device=dev, log=quiet)
        state, log = trainer.init_state(), StepLog()

        def epoch(e):
            if path == "graph":
                return trainer.train_epoch_scanned(
                    state, batcher.scan_plan(shuffle=True, seed=e), metrics_writer=log)
            return trainer.train_epoch(state, batcher.epoch(shuffle=True, seed=e),
                                       metrics_writer=log)

        return trainer, state, log, epoch

    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=True, benchmark=False, deterministic=True, allow_tf32=False):
        runs = {path: lipnet_run(path) for path in ("graph", "loop")}
        for path in ("graph", "loop"):
            for e in (1, 2):
                runs[path][3](e)
        (trainer, sg, lg, epoch), (_, sl, ll, _) = runs["graph"], runs["loop"]
        same_state(sg, sl, "bf16 LipNet dropout 0.5")
        if lg.rows != ll.rows:
            raise SystemExit("bf16 LipNet: the program's losses or gradient norms differ from "
                             "the loop's")
        n_rows, S = len(lg.rows), len(lg.rows) // 2
        del runs["loop"], sl
        # the graph's epoch 3 timed; epoch 4 traced after a warm-up epoch
        # under the same profiler (`device_events`): replays only
        stamps = timed_before(trainer)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        epoch(3)
        torch.cuda.synchronize()
        twall_ms = (time.perf_counter() - t0) * 1e3
        gaps = list(stamps)
        tw = []
        busy, names = kernel_names(device_events(lambda: epoch(4), wall=tw))
        row = path_times(f"bf16 LipNet graph path B=8 S={S} dropout 0.5 (cudnn.deterministic; "
                         "epoch 3 timed, epoch 4 traced after a warm-up)", S, twall_ms, tw[0],
                         busy, gaps)
        row["replayed"] = bf16_replayed(names)
        del runs
    # as phase 9 requires of the f32 replays: each kernel at least once per step
    want = {"conv1_pool_bf16": S, "conv1_pool_bwd_bf16": S, "gru_fwd": 2 * S, "gru_bwd": 2 * S}
    print(f"  bf16 epoch program vs eager loop, 2 epochs of S={S}, cudnn.deterministic: "
          f"parameters, Adam state and {n_rows} losses and gradient norms equal "
          f"bit for bit; kernels in the traced replayed epoch {row['replayed']} (expected at "
          f"least {want}); the f32 graph step in this call (phase 9) "
          f"{f32_graph['wall_ms_per_step']:.4f} ms, idle {f32_graph['idle_share']:.4f}; PR "
          f"14's 78.6198-78.6836 [{smi}]", flush=True)
    if any(row["replayed"][k] < n for k, n in want.items()):
        raise SystemExit("a kernel of the bf16 LipNet step did not run inside the graph's "
                         f"replays; the trace's kernels: {names}")

    # the loss falls on one repeated batch
    batch = device_batch(batcher.first_batch(), dev)
    model = LipNet(dataclasses.replace(pcfg.model, dropout_rate=0.0),
                   generator=torch.Generator().manual_seed(4)).to(dev)
    opt = make_optimizer(model.parameters(), OVERFIT_LR)
    first = train_step(model, opt, batch, OVERFIT_LR)[0].item()
    for _ in range(OVERFIT_STEPS - 2):
        train_step(model, opt, batch, OVERFIT_LR)
    last = train_step(model, opt, batch, OVERFIT_LR)[0].item()
    print(f"  bf16 repeated batch, lr {OVERFIT_LR}, {OVERFIT_STEPS} steps: loss {first:.4f} -> "
          f"{last:.4f}", flush=True)
    if not last < first:
        raise SystemExit("the bf16 loss did not fall over the repeated batch")
    row.update(cli_train_wall_s=wall, overfit=[first, last])
    return ck, got, row


def bf16_commands(dev, workdir, smi, ck):
    """15d: `cli test`, `infer`, `serve` (a child process under 16 crops:
    transcripts equal an in-process bf16 LipReader's, SIGTERM drains) and
    `export` (the artifact against the live bf16 reader at B = 1 and 8) with
    `--compute_dtype bfloat16` on the bf16 snapshot; `test --quantize int8
    --compute_dtype bfloat16` on it runs (phase 16 holds the int8-bf16 path
    itself)."""
    import contextlib
    import dataclasses
    import glob
    import io

    import numpy as np

    from avsync_torch import cli
    from avsync_torch.export import load_exported
    from avsync_torch.predictor import LipReader

    data, cfg_path = os.path.join(workdir, "grid"), os.path.join(workdir, "config.json")
    cfg = cli._config(cfg_path)
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               compute_dtype="bfloat16"))
    r16 = LipReader(checkpoint=ck, config=cfg16, device=dev)
    common = ["--config", cfg_path, "--checkpoint", ck, "--compute_dtype", "bfloat16"]
    out = {}
    results = os.path.join(workdir, "results_bf16.json")
    clip = sorted(glob.glob(os.path.join(data, "*", "video", "*.npy")))[0]
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        rc = [cli.main(["test", "--data_path", data, *common, "--output", results]),
              cli.main(["infer", clip, *common])]
    with open(results) as f:
        out["test"] = json.load(f)
    pred = [ln.split(":", 1)[1].strip() for ln in said.getvalue().splitlines()
            if ln.startswith("Predicted:")]
    want_pred = r16.predict_frames(np.load(clip))
    print(f"bf16 phase: d. cli test / infer --compute_dtype bfloat16 on the bf16 snapshot: "
          f"rc {rc}; test {json.dumps(out['test'])}; infer {pred} (in-process bf16 reader "
          f"{want_pred!r})", flush=True)
    if rc != [0, 0] or not np.isfinite(out["test"]["cer"]) or pred != [want_pred]:
        raise SystemExit("cli test/infer --compute_dtype bfloat16 failed")

    geom = (cfg.data.max_video_length, cfg.data.img_height, cfg.data.img_width)
    crops = [np.random.default_rng(100 + i).integers(0, 256, geom, dtype=np.uint8)
             for i in range(16)]
    t0 = time.perf_counter()
    daemon = Daemon([*common, "--port", "0", "--warmup", "--max_batch", str(MAX_BATCH)])
    try:
        up = time.perf_counter() - t0
        row = transcribe_load(daemon.url, crops, r16, "bf16 daemon", near_tie=BF16_NEAR_TIE)
        pending = sigterm_drain(daemon, crops[0])
    finally:
        daemon.kill()
    out["daemon"] = dict(row, start_s=up, drained_in_flight=pending)
    print(f"  serve --compute_dtype bfloat16 as a child process, 16 crops from {SERVE_THREADS} "
          f"threads: p50_ms={row['p50_ms']:.3f} p99_ms={row['p99_ms']:.3f} clips_per_s="
          f"{row['clips_per_s']:.3f}, transcripts equal the in-process bf16 reader's (near "
          f"ties within {BF16_NEAR_TIE}: {row['near_ties']}); up in {up:.1f} s; SIGTERM with "
          f"{pending} of 16 in flight: all 200, exit 0 [{smi}]", flush=True)

    art_path = os.path.join(workdir, "bf16_transcriber.zip")
    t0 = time.perf_counter()
    if cli.main(["export", *common, "--out", art_path]) != 0:
        raise SystemExit("cli export --compute_dtype bfloat16 failed")
    export_s = time.perf_counter() - t0
    art = load_exported(art_path)
    errs = {}
    for B in (1, 8):
        frames = np.stack(crops[:B])
        want_lp = r16._logprobs(r16.preprocess_device(frames)).cpu().numpy()
        errs[B] = float(np.abs(art.call(frames)[2] - want_lp).max())
    out["export"] = {"export_s": export_s, "bytes": os.path.getsize(art_path),
                     "max_abs_err": errs}
    print(f"  cli export --compute_dtype bfloat16: {json.dumps(out['export'])} against the live "
          f"bf16 reader (tol {BF16_NEAR_TIE}) [{smi}]", flush=True)
    if any(e > BF16_NEAR_TIE for e in errs.values()):
        raise SystemExit("the bf16 artifact differs from the live bf16 reader")

    results = os.path.join(workdir, "results_bf16_int8.json")
    rc = cli.main(["test", "--data_path", data, *common, "--quantize", "int8", "--output",
                   results])
    with open(results) as f:
        out["test_int8"] = json.load(f)
    print(f"  test --quantize int8 --compute_dtype bfloat16 on the bf16 snapshot: rc {rc}; "
          f"{json.dumps(out['test_int8'])}", flush=True)
    if rc != 0 or not np.isfinite(out["test_int8"]["cer"]):
        raise SystemExit("test --quantize int8 --compute_dtype bfloat16 failed")
    return out


def bf16_detector(dev, workdir, smi):
    """15e: `cli misalign-train` (1 epoch) and `misalign-eval` with bf16 conv
    features on phase 8's corpus, config and LipNet (K1-bf16 and K5 launch,
    no other kernel); the sync scorer in bf16 against f32 on phase 8's
    detector, probabilities within BF16_PROB_ATOL."""
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.predictor import MisalignmentScorer

    data, ck = os.path.join(workdir, "grid"), os.path.join(workdir, "ckpt")
    cfg_path = os.path.join(workdir, "detector_config.json")
    det16 = os.path.join(workdir, "detector_bf16.pth")
    common = ["--data_path", data, "--config", cfg_path, "--checkpoint", ck,
              "--compute_dtype", "bfloat16"]
    zero_counts()
    t0 = time.perf_counter()
    rc = [cli.main(["misalign-train", *common, "--detector_checkpoint", det16, "--epochs", "1",
                    "--log_dir", os.path.join(workdir, "det_logs_bf16")]),
          cli.main(["misalign-eval", *common, "--detector_checkpoint", det16, "--min_shift", "5",
                    "--max_shift", "20", "--output", os.path.join(workdir, "sweep_bf16.json")])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    with open(os.path.join(workdir, "sweep_bf16.json")) as f:
        sweep = json.load(f)
    print(f"bf16 phase: e. misalign-train (1 epoch) + misalign-eval --compute_dtype bfloat16: "
          f"rc {rc} wall_s={wall:.2f}; launches {got} (K1-bf16 for the banks, K5 for the "
          f"steps and sweep rows, nothing else); overall AUROC {sweep['overall_auroc']:.4f}",
          flush=True)
    if (rc != [0, 0] or not got["conv1_pool"] or not got["mel_stats"] or got["gru_fwd"]
            or got["gru_bwd"] or got["conv1_pool_bwd"] or not np.isfinite(sweep["overall_auroc"])):
        raise SystemExit("the bf16 detector commands failed or launched the wrong kernels")
    cfg = cli._config(cfg_path)
    det = os.path.join(workdir, "detector.pth")  # phase 8's trained detector
    f32 = MisalignmentScorer(det, ck, config=cfg, device=dev)
    s16 = MisalignmentScorer(det, ck, device=dev, config=dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="bfloat16")))
    r = np.random.default_rng(151)
    probs = []
    for i in range(4):
        frames = r.integers(0, 256, (cfg.data.max_video_length, cfg.data.img_height,
                                     cfg.data.img_width), dtype=np.uint8)
        audio = (0.3 * r.standard_normal(48000)).astype(np.float32)
        probs.append((s16.score_arrays(frames, audio, 25.0, DET_SHIFTS),
                      f32.score_arrays(frames, audio, 25.0, DET_SHIFTS)))
    d = max(float(np.abs(a - b).max()) for a, b in probs)
    print(f"  sync scorer bf16 vs f32, 4 requests x {len(DET_SHIFTS)} shifts: max |d prob| "
          f"{d:.3e} (tol {BF16_PROB_ATOL}) [{smi}]", flush=True)
    if d > BF16_PROB_ATOL or not all(np.isfinite(a).all() for a, _ in probs):
        raise SystemExit("the bf16 sync scorer is outside its bound")
    return got, {"misalign_wall_s": wall, "auroc": sweep["overall_auroc"], "scorer_max_abs": d}


def bf16_tf(dev, tf_dir, smi, f32_ms):
    """15f: the TF family. The TFLipNet class's bf16 forward
    (`TFModelConfig(compute_dtype="bfloat16")`, reachable from Python only) at
    B=8 on phase 13's trained snapshot against the float32 forward the CLI
    builds under a bf16 config (the bounds of 15b), its time beside phase
    13's f32 forward; two epochs of `cli train --model_family tf
    --compute_dtype bfloat16 --device_cache on`: the family switch builds a
    float32 model, as the JAX CLI's, whose parameters and log-probs are
    float32, and the epochs read the bf16 cache that the bf16 config asks
    for."""
    import dataclasses
    import glob

    import numpy as np
    import torch

    from avsync_torch import cli
    from avsync_torch.data.pipeline import LipNetBatcher
    from avsync_torch.models.lipnet_tf import TFLipNet, tf_model_config
    from avsync_torch.ops.conv import fp32_step
    from avsync_torch.predictor import LipReader
    from avsync_torch.utils.checkpoint import CheckpointManager

    cfg_path, ck = os.path.join(tf_dir, "tf_config.json"), os.path.join(tf_dir, "tf_ckpt")
    corpus = os.path.join(tf_dir, "tf_grid")
    cfg = cli._config(cfg_path)
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               compute_dtype="bfloat16"))
    f32 = LipReader(checkpoint=ck, config=cfg16, device=dev)
    if f32.model.compute_dtype is not None:
        raise SystemExit("the TF family switch built a bf16 model under a bf16 config")
    m16 = TFLipNet(dataclasses.replace(tf_model_config(cfg.model), compute_dtype="bfloat16"),
                   img_hw=(cfg.data.img_height, cfg.data.img_width)).to(dev).eval()
    m16.load_state_dict(f32.model.state_dict())
    frames = np.stack([np.load(p) for p in sorted(glob.glob(
        os.path.join(corpus, "*", "video", "*.npy")))[:8]])
    x = f32.preprocess_device(frames)

    def class_bf16():
        with fp32_step(), torch.inference_mode():
            return m16(x)

    print("bf16 phase: f. the TF family:", flush=True)
    row = {"vs_f32": agreement(class_bf16(), f32._logprobs(x),
                               "TFLipNet class bf16 vs f32 forward B=8 (phase 13's trained "
                               "snapshot)", smi)}
    row["class_bf16_ms"] = time_ms(class_bf16, iters=5, warmup=1)
    row["f32_ms_phase13"] = f32_ms
    print(f"  TFLipNet class forward B=8 (CUDA events, median of 5): bf16 "
          f"{row['class_bf16_ms']:.3f} ms; f32 {f32_ms:.3f} ms in phase 13 (the CLI's TF "
          f"commands run the f32 one under either dtype) [{smi}]", flush=True)
    del f32, m16
    ck16 = os.path.join(tf_dir, "tf_ckpt_bf16")
    caches = []
    warm = LipNetBatcher.warm_device_cache

    def recording_warm(self):
        warm(self)
        if self._device_cache is not None:
            caches.append(self._device_cache["dtype"])

    LipNetBatcher.warm_device_cache = recording_warm
    zero_counts()
    t0 = time.perf_counter()
    try:
        rc = cli.main(["train", "--data_path", corpus, "--config", cfg_path, "--model_family",
                       "tf", "--compute_dtype", "bfloat16", "--epochs", "2", "--device_cache",
                       "on", "--checkpoint_dir", ck16])
        torch.cuda.synchronize()
    finally:
        LipNetBatcher.warm_device_cache = warm
    row["train_wall_s"] = time.perf_counter() - t0
    got = counts()
    _, meta = CheckpointManager(ck16).restore()
    with open(os.path.join(ck16, "history.json")) as f:
        hist = json.load(f)
    trained = LipReader(checkpoint=ck16, config=cfg16, device=dev)
    lp = trained._logprobs(x)
    dtypes = sorted({str(p.dtype) for p in trained.model.parameters()})
    row.update(cache_dtypes=caches, param_dtypes=dtypes, logprob_dtype=str(lp.dtype))
    print(f"  cli train --model_family tf --compute_dtype bfloat16 --device_cache on, 2 epochs: "
          f"rc={rc} wall_s={row['train_wall_s']:.2f}; loss {hist['loss']} val_loss "
          f"{hist['val_loss']}; snapshot compute_dtype "
          f"{meta['config']['model']['compute_dtype']!r}; device caches {caches}; trained "
          f"model's parameters {dtypes}, compute dtype {trained.model.compute_dtype}, "
          f"log-probs {lp.dtype}; hand-kernel launches {got} (none: the TF stack's convs are "
          f"past K1's gate)", flush=True)
    if (rc != 0 or meta["config"]["model"]["compute_dtype"] != "bfloat16" or any(got.values())
            or len(hist["loss"]) != 2 or not np.all(np.isfinite(hist["loss"]))
            or "bfloat16" not in caches or dtypes != ["torch.float32"]
            or trained.model.compute_dtype is not None or lp.dtype != torch.float32
            or not torch.isfinite(lp).all()):
        raise SystemExit("cli train --model_family tf --compute_dtype bfloat16 failed")
    return row


def run_bf16(dev, workdir, tf_dir, smi, f32_graph, tf_f32_ms):
    """Phase 15: `compute_dtype="bfloat16"` at full width: a. K1-bf16 and
    K4-bf16 against their plain versions and timed; b. the forward; c.
    training, the program against the loop; d. the other commands; e. the
    detector; f. the TF family. Returns the kernel rows and the numbers."""
    import torch

    k1, k4 = bf16_kernels(dev, smi)
    out = {}
    out["forward"], served = bf16_forward(dev, smi)
    ck, trained, out["train"] = bf16_train(dev, workdir, smi, f32_graph)
    out["commands"] = bf16_commands(dev, workdir, smi, ck)
    detector, out["detector"] = bf16_detector(dev, workdir, smi)
    out["tf"] = bf16_tf(dev, tf_dir, smi, tf_f32_ms)
    torch.cuda.empty_cache()
    k1.update(launches=trained["conv1_pool"], launches_forward=served["conv1_pool"],
              launches_detector=detector["conv1_pool"],
              launches_graph_replay_epoch=out["train"]["replayed"]["conv1_pool_bf16"])
    k4.update(launches=trained["conv1_pool_bwd"],
              launches_graph_replay_epoch=out["train"]["replayed"]["conv1_pool_bwd_bf16"])
    for k in (k1, k4):
        if not k["launches"] or not k["launches_graph_replay_epoch"]:
            raise SystemExit(f"{k['name']} was not launched on the bf16 training path")
    if not k1["launches_forward"] or not k1["launches_detector"]:
        raise SystemExit("conv1_pool_bf16 was not launched on the bf16 serving or detector path")
    print(f"  bf16 phase numbers [{smi}]: {json.dumps(out)}", flush=True)
    return k1, k4, trained, out


# ---------------------------------------------------------------------------
# 16. int8 serving under bf16 compute, and the card's CLI defaults
# ---------------------------------------------------------------------------

# Q1's contracts under the bf16 epilogue: (input)_(output)
Q1_BF16_CONTRACTS = ("f32_bf16", "f32_s8", "s8_s8", "s8_bf16")
# the contract each block of the int8 forward runs in under bf16
CHAIN_CONTRACTS_BF16 = {"conv1": "f32_s8", "conv2": "s8_s8", "conv3": "s8_bf16"}


def q1_bf16_kernel(dev, smi):
    """16a: Q1's bf16 epilogue (the kernel's bf16 flag) against its plain
    version with torch.equal in each contract at LipNet's three blocks (B =
    1, 8, 32) and the TF stack's (B=8), a repeat launch equal too; the three
    LipNet blocks timed at B=8 in their chain contracts beside f32 Q1 in
    its own, the plain version, the library yardstick (im2col +
    `torch._int_mm` + the bf16 epilogue in PyTorch, held equal to Q1-bf16)
    and the bound. Returns the kernel line's row."""
    import torch

    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.ops.quant import quant_conv_block

    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(160)
    print("int8 under bf16 phase: a. Q1's bf16 epilogue vs int8_conv_pool_ref(compute_dtype="
          f"bf16) (torch.equal required), contracts {'/'.join(Q1_BF16_CONTRACTS)}:", flush=True)
    cases = [(B, cin, cout, 75, H, W, k, "random")
             for (cin, cout, H, W, k) in INT8_BLOCKS.values() for B in (1, 8, 32)]
    cases += [(8, cin, cout, 75, H, W, k, "random")
              for (cin, cout, H, W, k) in TF_INT8_BLOCKS.values()]
    q1_equal_cases(g, dev, cases, Q1_BF16_CONTRACTS, bf)
    B, T = 8, 75
    rows, total = {}, {"bytes": 0, "ops": 0}
    for name, (cin, cout, H, W, k) in INT8_BLOCKS.items():
        qc, x32 = q1_case(g, dev, B, cin, cout, T, H, W, k)
        if cin > 1:  # the int8 forward's layout
            x32 = channels_last(x32)
        contract = CHAIN_CONTRACTS_BF16[name]
        x, out16 = q1_contract(qc, x32, contract, "random", bf)
        xf, out32 = q1_contract(qc, x32, CHAIN_CONTRACTS[name], "random")
        lib = im2col_int_mm_block(qc, x32, bf)
        if not torch.equal(lib, quant_conv_block(qc, x32, compute_dtype=bf)):
            raise SystemExit(f"the im2col + _int_mm yardstick differs from Q1-bf16 at {name}")
        del lib
        row = {"contract": contract,
               "ms": time_ms(lambda: quant_conv_block(qc, x, out16, compute_dtype=bf)),
               "f32_q1_ms": time_ms(lambda: quant_conv_block(qc, xf, out32)),
               "plain_ms": time_ms(lambda: quantconv.int8_conv_pool_ref(
                   x, qc.kernel_q, qc.k_scale, qc.bias, float(qc.x_scale), out16,
                   compute_dtype=bf), iters=3, warmup=1),
               "library_ms": time_ms(lambda: im2col_int_mm_block(qc, x32, bf), iters=3,
                                     warmup=1)}
        n_bytes, n_ops = q1_bytes_ops(B, T, cin, cout, H, W, k, contract + "_bf16")
        row["bound_ms"] = max(n_bytes / HBM_BYTES_PER_S, n_ops / INT8_OPS) * 1e3
        rows[name] = row
        total["bytes"] += n_bytes
        total["ops"] += n_ops
        print(f"  {name} B={B} T={T} {H}x{W} {cin}->{cout} {contract}: kernel_ms={row['ms']:.4f}"
              f" (f32 Q1 {CHAIN_CONTRACTS[name]} {row['f32_q1_ms']:.4f}) plain_ms="
              f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} (im2col + _int_mm + "
              f"the bf16 epilogue) bound_ms={row['bound_ms']:.4f} [{smi}]", flush=True)
        del qc, x, xf, x32
        torch.cuda.empty_cache()
    chain = {key: sum(r[key] for r in rows.values())
             for key in ("ms", "f32_q1_ms", "plain_ms", "library_ms")}
    t_bytes = total["bytes"] / HBM_BYTES_PER_S * 1e3
    t_ops = total["ops"] / INT8_OPS * 1e3
    chain.update(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops
                 else "operations", ratio_to_f32=chain["ms"] / chain["f32_q1_ms"])
    print(f"  three blocks at B=8: bf16 epilogue {chain['ms']:.4f} ms, f32 Q1 "
          f"{chain['f32_q1_ms']:.4f} ms (x{chain['ratio_to_f32']:.3f}), "
          f"bound {chain['bound_ms']:.4f} ms ({chain['bound_by']}) [{smi}]", flush=True)
    return dict(name="int8_conv_pool_bf16", route="cuda",
                source="avsync_torch/csrc/int8_conv_pool.cu", replaces="avsync/ops/quant.py:97",
                max_abs_err=0.0, **chain, entry="avs_int8_conv_pool(bf16=1)",
                shape="B=8 T=75 full width, conv1 + conv2 + conv3 in the bf16 chain contracts "
                      "(f32->s8, s8->s8, s8->bf16)",
                replaces_note="no pallas_call: quant_conv_block(out_dtype=bfloat16), "
                              "avsync/ops/quant.py:109-135",
                library_note="im2col + torch._int_mm + the bf16 epilogue in PyTorch ops",
                blocks=rows)


def k2_bf16_kernel(dev, smi, k2_row):
    """16b: K2 with bf16 operands (the kernel's bf16 flag) at B=8, T=75, H=256,
    both directions: every step within K2_TOL of the plain version's step
    from the kernel's own previous state; over the whole sequence its
    distance from the plain version beside the plain version's own distance
    between the card and the CPU (float32 sums in another order move h by
    an ulp, which moves bf16(h) by a bf16 ulp at some later step); a repeat
    gives the same bits; times beside f32 K2, the bound and `torch.nn.GRU`
    in bf16, each kernel also with its launch queued behind a spin (the
    device's time, which phase 3's f32 K2 `k2_row` also has). Returns the
    kernel line's row."""
    import torch

    from avsync_torch.models.lipnet import BiGRU
    from avsync_torch.ops.cuda import gru
    from avsync_torch.ops.gru import GRUWeights, bigru

    bf = torch.bfloat16
    g = torch.Generator(device="cpu").manual_seed(161)
    B, T, H, D = 8, 75, 256, 6912
    k = H ** -0.5
    cpu_args = [(torch.randn(B, T, 3 * H, generator=g),
                 (torch.rand(H, 3 * H, generator=g) * 2 - 1) * k,
                 (torch.rand(3 * H, generator=g) * 2 - 1) * k) for _ in range(2)]
    args = [tuple(t.to(dev) for t in a) for a in cpu_args]
    (gf, wf, bf_), (gb, wb, bb) = args
    got = gru.bigru_recurrence_bf16(gf, gb, wf, wb, bf_, bb)
    same_bits([got], [gru.bigru_recurrence_bf16(gf, gb, wf, wb, bf_, bb)], "K2-bf16 B=8")
    step_err = max_err(got, gru.bigru_steps_ref(gf, gb, wf, wb, bf_, bb, got, bf), K2_TOL,
                       "K2-bf16 B=8 T=75 H=256, each step from the kernel's previous state")

    def plain(args, dt=bf):
        return torch.cat([gru.gru_recurrence_ref(*args[0], False, compute_dtype=dt),
                          gru.gru_recurrence_ref(*args[1], True, compute_dtype=dt)], -1)

    want, f32, on_cpu = plain(args), plain(args, None), plain(cpu_args)
    seq = {"kernel_vs_plain_max": (got - want).abs().max().item(),
           "kernel_vs_plain_mean": (got - want).abs().mean().item(),
           "plain_card_vs_cpu_max": (want.cpu() - on_cpu).abs().max().item(),
           "plain_card_vs_cpu_mean": (want.cpu() - on_cpu).abs().mean().item(),
           "bf16_vs_f32_plain_mean": (want - f32).abs().mean().item()}
    print(f"  K2-bf16 whole sequence: {json.dumps(seq)} (the kernel's mean distance must stay "
          "under a tenth of the bf16 rounding's own mean effect)", flush=True)
    if seq["kernel_vs_plain_mean"] > 0.1 * seq["bf16_vs_f32_plain_mean"]:
        raise SystemExit("K2-bf16 drifts from its plain version over the sequence")
    k2_bf16 = (lambda: gru.bigru_recurrence_bf16(gf, gb, wf, wb, bf_, bb))
    k2_f32 = (lambda: gru.bigru_recurrence(gf, gb, wf, wb, bf_, bb))
    row = {"ms": time_ms(k2_bf16), "f32_ms": time_ms(k2_f32),
           "queued_ms": queued_ms(k2_bf16), "f32_queued_ms": queued_ms(k2_f32),
           "phase3_f32_ms": k2_row["ms"], "phase3_f32_queued_ms": k2_row["queued_ms"],
           "plain_ms": time_ms(lambda: plain(args), iters=3, warmup=1)}
    # f32 gi, w_hh, b_hh and out, each moved once; h W_hh's products are
    # bf16 x bf16 summed in f32, which the bf16 tensor cores do (989 TFLOP/s),
    # and the gates' few f32 operations are counted at that rate too: a bound
    n_bytes = 4 * 2 * (B * T * 3 * H + H * 3 * H + 3 * H + B * T * H)
    n_ops = 2 * (2 * B * T * H * 3 * H + 12 * B * T * H)
    row["bound_ms"], row["bound_by"] = bf16_bound_ms(n_bytes, n_ops)
    # the library yardstick: a bf16 torch.nn.GRU layer (cuDNN) beside the
    # port's bf16-operand layer (two bf16 input projections + the kernel)
    layer = BiGRU(D, H, use_kernel=True, generator=torch.Generator().manual_seed(3)).to(dev)
    fw, bw = (GRUWeights(*(getattr(layer, f"{n}_l0{sfx}") for n in
                           ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
              for sfx in ("", "_reverse"))
    cudnn = torch.nn.GRU(D, H, batch_first=True, bidirectional=True).to(dev)
    cudnn.load_state_dict(layer.state_dict())
    cudnn = cudnn.to(bf)
    cudnn.flatten_parameters()
    x = torch.randn(B, T, D, generator=g).to(dev)
    xb = x.to(bf)
    with torch.inference_mode():
        ours = bigru(x, fw, bw, True, compute_dtype=bf, recurrence_dtype=bf)
        lib = cudnn(xb)[0].float()
        lib_err = (ours - lib).abs().max().item()
        row["layer_ms"] = time_ms(lambda: bigru(x, fw, bw, True, compute_dtype=bf,
                                                recurrence_dtype=bf))
        row["library_ms"] = time_ms(lambda: cudnn(xb))
    print(f"  K2-bf16 both directions B=8 T=75 H=256: kernel_ms={row['ms']:.4f} (f32 K2 "
          f"{row['f32_ms']:.4f}, x{row['ms'] / row['f32_ms']:.3f}); launch queued behind a "
          f"spin: {row['queued_ms']:.4f} (f32 K2 {row['f32_queued_ms']:.4f}, "
          f"x{row['queued_ms'] / row['f32_queued_ms']:.3f}; phase 3's f32 K2 "
          f"{k2_row['ms']:.4f}, queued {k2_row['queued_ms']:.4f}) "
          f"plain_ms={row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
          f"({row['bound_by']}, x{row['queued_ms'] / row['bound_ms']:.1f}); BiGRU layer D=6912: port layer_ms={row['layer_ms']:.4f}, "
          f"torch.nn.GRU in bf16 library_ms={row['library_ms']:.4f} (max |d| against the "
          f"port's layer {lib_err:.3e}: the library rounds every operand and output) [{smi}]",
          flush=True)
    return dict(name="gru_fwd_bf16", route="cuda", source="avsync_torch/csrc/gru_fwd.cu",
                replaces="avsync/ops/pallas/gru.py:357", max_abs_err=step_err, **row,
                entry="avs_gru_fwd(bf16=1)", whole_sequence=seq,
                shape="both directions B=8 T=75 H=256, bf16 operands (h, w_hh) in each step's "
                      "product, float32 sums, gates and carry",
                replaces_note="the JAX int8 forward under bf16 runs gru_scan(compute_dtype=bf16) "
                              "(avsync/ops/quant.py:292-296), not the Pallas kernel, which K2 "
                              "ports; max_abs_err is per step, from the kernel's previous state",
                library_note="library_ms and layer_ms time the whole BiGRU layer (D=6912): "
                             "torch.nn.GRU in bf16 vs the port's bf16 matmuls + kernel")


def int8_bf16_forward(dev, smi):
    """16c: the int8-bf16 LipNet forward at full width (B=8, T=75, 50x100,
    conv 32/64/96, BiGRU 256 x2) on phase 4's seeded weights: Q1-bf16 three
    times and K2-bf16 twice, nothing else; against the bf16 float-conv
    forward on the card and the same int8-bf16 forward on the CPU (two of
    the rows: the CPU's int8 conv is float64) within the JAX package's int8
    bounds (mean |d log-prob| < 0.05, argmax agreement >= 0.95); its int8
    hand-off equal to three bf16-contract blocks bit for bit; timed beside
    the f32 int8 forward."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch.config import AvsyncConfig, DataConfig, ModelConfig
    from avsync_torch.ops import quant as tq
    from avsync_torch.predictor import LipReader

    cfg = AvsyncConfig(data=DataConfig(), model=ModelConfig(use_pallas_gru=True,
                                                            fused_conv_pool=True))
    cfg16 = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               compute_dtype="bfloat16"))
    params = seeded_jax_layout_params(cfg, seed=0)
    frames = np.random.default_rng(16).integers(0, 256, (8, 75, 50, 100), dtype=np.uint8)
    b16 = LipReader(params=params, config=cfg16, device=dev)
    x = b16.preprocess_device(frames)
    q16 = LipReader(params=params, config=cfg16, device=dev, quantize="int8",
                    calibration_frames=list(frames[:2]))
    q32 = LipReader(params=params, config=cfg, device=dev, quantize="int8",
                    calibration_frames=list(frames[:2]))
    q16._logprobs(x)  # every kernel built
    zero_counts()
    lp = q16._logprobs(x)
    torch.cuda.synchronize()
    got = int8_counts()
    want = {"conv1_pool": 0, "gru_fwd": 0, "gru_bwd": 0, "conv1_pool_bwd": 0, "mel_stats": 0,
            "int8_conv_pool": 0, "int8_conv_pool_bf16": 3, "gru_fwd_bf16": 2}
    print(f"int8 under bf16 phase: c. the int8-bf16 forward B=8 at full width: launches {got} "
          f"(expected {want})", flush=True)
    if got != want or lp.dtype != torch.float32:
        raise SystemExit("the int8-bf16 forward's launches or output dtype are wrong")
    row = {"vs_bf16": agreement(lp, b16._logprobs(x), "int8-bf16 vs the bf16 forward on the "
                                "card", smi)}
    block = tq.quant_conv_block
    tq.quant_conv_block = lambda qc, h, out_scale=None, compute_dtype=None: block(
        qc, h, compute_dtype=compute_dtype)
    try:
        no_hand_off = q16._logprobs(x)
    finally:
        tq.quant_conv_block = block
    row["hand_off_equals_bf16_contract"] = torch.equal(lp, no_hand_off)
    print(f"  int8 hand-off between blocks vs three bf16-contract launches: "
          f"{'equal bit for bit' if row['hand_off_equals_bf16_contract'] else 'DIFFERENT'}",
          flush=True)
    if not row["hand_off_equals_bf16_contract"]:
        raise SystemExit("the int8 hand-off changed the int8-bf16 forward's log-probs")
    scales = np.asarray([float(c.x_scale) for c in q16._qparams.convs], np.float32)
    cpu_model = copy.deepcopy(q16.model).cpu()
    t0 = time.perf_counter()
    with torch.inference_mode():
        want_cpu = tq.make_int8_forward(cfg16.model)(
            tq.quantize_lipnet(cpu_model, [], input_scales=scales), x[:2].cpu())
    row["cpu_s"] = time.perf_counter() - t0
    row["vs_cpu"] = agreement(lp[:2].cpu(), want_cpu, "int8-bf16 forward on the card vs the "
                              f"same forward on the CPU, 2 rows ({row['cpu_s']:.1f} s)", smi)
    del cpu_model, want_cpu
    row["int8_bf16_ms"] = time_ms(lambda: q16._logprobs(x), iters=10)
    row["int8_f32_ms"] = time_ms(lambda: q32._logprobs(x), iters=10)
    print(f"  int8 forward B=8 T=75 (CUDA events, median of 10): bf16 {row['int8_bf16_ms']:.3f} "
          f"ms, f32 {row['int8_f32_ms']:.3f} ms [{smi}]", flush=True)
    return row


def int8_counts():
    """The launch counters with Q1's and K2's bf16 instantiations apart."""
    from avsync_torch.ops.cuda import gru, quantconv

    return {**counts(), "int8_conv_pool": quantconv.launches,
            "int8_conv_pool_bf16": quantconv.bf16_launches, "gru_fwd_bf16": gru.bf16_launches}


def int8_bf16_daemon(reader, crops, what):
    """Launches per transcribe batch through an in-process daemon serving
    `reader`, the counters zeroed just before and read just after."""
    import torch

    from avsync_torch.serving import AvsyncServer, TranscribeService

    server = AvsyncServer(TranscribeService(reader, max_batch=MAX_BATCH, max_wait_ms=5.0),
                          None, port=0)
    server.start()
    try:
        zero_counts()
        answers, _, _ = load(f"http://{server.address[0]}:{server.address[1]}",
                             [("/v1/transcribe", npy_bytes(c), "application/x-npy")
                              for c in crops])
        torch.cuda.synchronize()
        got = int8_counts()
        nt = sum(server.stats_snapshot()["transcribe"]["batches"].values())
    finally:
        server.shutdown(drain_timeout=30.0)
    if any(a[0] != 200 for a in answers):
        raise SystemExit(f"{what}: {[a for a in answers if a[0] != 200][:3]}")
    print(f"  launches through the in-process {what}: {got} for {nt} transcribe batches",
          flush=True)
    return {"transcribe_batches": nt, **got}


def int8_bf16_commands(dev, workdir, serving_dir, tf_dir, crops, smi):
    """16d: `quantize`, `test --quantize int8`, `infer --quantize int8` and
    `serve --quantize int8 --qscales` (a child process under 16 crops:
    transcripts equal an in-process int8-bf16 reader's, near ties aside,
    SIGTERM drains) under `--compute_dtype bfloat16` on phase 5's corpus and
    checkpoint, `quantize` writing phase 11's float32 scales (calibration is
    float32); per transcribe batch Q1-bf16 three times and K2-bf16 twice
    through an in-process daemon; the TF family on phase 13's trained
    snapshot, whose model computes in float32 under a bf16 config as the
    JAX CLI's does: float32 Q1 three times per batch, no Q1-bf16. Returns
    the daemons' counts."""
    import contextlib
    import glob
    import io

    import numpy as np

    from avsync_torch import cli
    from avsync_torch.predictor import LipReader

    BF = ["--compute_dtype", "bfloat16"]
    out = {}

    def commands(what, corpus, cfg_path, ck, f32_scales, extra=()):
        common = ["--data_path", corpus, "--config", cfg_path, "--checkpoint", ck, *extra, *BF]
        q16 = os.path.join(workdir, f"q16_{what}.npz")
        res = os.path.join(workdir, f"int8_bf16_{what}.json")
        clip = sorted(glob.glob(os.path.join(corpus, "*", "video", "*.npy")))[0]
        t0 = time.perf_counter()
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            rc = [cli.main(["quantize", *common, "--out", q16]),
                  cli.main(["test", *common, "--quantize", "int8", "--output", res]),
                  cli.main(["infer", clip, *common[2:], "--quantize", "int8"])]
        secs = time.perf_counter() - t0
        scales = np.load(q16)["input_scales"]
        with open(res) as f:
            tested = json.load(f)
        pred = [ln.split(":", 1)[1].strip() for ln in said.getvalue().splitlines()
                if ln.startswith("Predicted:")]
        cfg16 = cli._config_from_args(cli.build_parser().parse_args(["test", *common]))
        fresh = LipReader(checkpoint=ck, config=cfg16, device=dev, quantize="int8")
        want = fresh.predict(clip)
        same = bool(np.array_equal(scales, np.load(f32_scales)["input_scales"]))
        print(f"int8 under bf16 phase: d. {what}: quantize / test --quantize int8 / infer "
              f"--quantize int8 under --compute_dtype bfloat16: rc {rc} in {secs:.1f} s; scales "
              f"{scales.tolist()} ({'equal to' if same else 'DIFFERENT from'} the float32 "
              f"command's); test {json.dumps(tested)}; infer {pred} (a fresh int8-bf16 reader "
              f"{want!r})", flush=True)
        if rc != [0, 0, 0] or not same or not np.isfinite(tested["cer"]) or pred != [want]:
            raise SystemExit(f"{what}: the int8 commands under bf16 failed")
        return q16, cfg16, {"seconds": secs, "test": tested, "scales": scales.tolist()}

    data, ck, cfg_path = (os.path.join(workdir, n) for n in ("grid", "ckpt", "config.json"))
    q16, cfg16, out["lipnet"] = commands("lipnet", data, cfg_path, ck,
                                         os.path.join(serving_dir, "qscales_trained.npz"))
    reader = LipReader(checkpoint=ck, config=cfg16, device=dev, quantize="int8",
                       calibration_scales=q16)
    t0 = time.perf_counter()
    daemon = Daemon(["--checkpoint", ck, "--config", cfg_path, "--quantize", "int8", "--qscales",
                     q16, "--port", "0", "--warmup", "--max_batch", str(MAX_BATCH), *BF])
    try:
        up = time.perf_counter() - t0
        row = transcribe_load(daemon.url, crops[:16], reader, "int8-bf16 daemon",
                              near_tie=BF16_NEAR_TIE)
        pending = sigterm_drain(daemon, crops[0])
    finally:
        daemon.kill()
    out["daemon"] = dict(row, start_s=up, drained_in_flight=pending)
    print(f"  serve --quantize int8 --qscales --compute_dtype bfloat16 as a child process, 16 "
          f"crops from {SERVE_THREADS} threads: p50_ms={row['p50_ms']:.3f} p99_ms="
          f"{row['p99_ms']:.3f} clips_per_s={row['clips_per_s']:.3f}, transcripts equal the "
          f"in-process int8-bf16 reader's "
          f"(near ties within {BF16_NEAR_TIE}: {row['near_ties']}); up in {up:.1f} s; SIGTERM "
          f"with {pending} of 16 in flight: all 200, exit 0 [{smi}]", flush=True)
    got = int8_bf16_daemon(reader, crops[:32], "int8-bf16 daemon (phase 5's checkpoint)")
    nt = got["transcribe_batches"]
    want = {"conv1_pool": 0, "gru_fwd": 0, "gru_bwd": 0, "conv1_pool_bwd": 0, "mel_stats": 0,
            "int8_conv_pool": 0, "int8_conv_pool_bf16": 3 * nt, "gru_fwd_bf16": 2 * nt}
    if {k: v for k, v in got.items() if k != "transcribe_batches"} != want or not nt:
        raise SystemExit(f"int8-bf16 daemon: launches {got}, expected {want}")
    out["launches"] = got

    tf_cfg, tf_ck = os.path.join(tf_dir, "tf_config.json"), os.path.join(tf_dir, "tf_ckpt")
    tf_corpus = os.path.join(tf_dir, "tf_grid")
    _, tf16, out["tf"] = commands("tf", tf_corpus, tf_cfg, tf_ck,
                                  os.path.join(tf_dir, "tf_trained_q.npz"),
                                  ("--model_family", "tf"))
    tf_reader = LipReader(checkpoint=tf_ck, config=tf16, device=dev, quantize="int8",
                          calibration_scales=os.path.join(workdir, "q16_tf.npz"))
    if tf16.model.compute_dtype != "bfloat16" or tf_reader.model.compute_dtype is not None:
        raise SystemExit("the TF int8 reader under a bf16 config is not the float32 model")
    geom = (tf16.data.max_video_length, tf16.data.img_height, tf16.data.img_width)
    tf_crops = [np.random.default_rng(300 + i).integers(0, 256, geom, dtype=np.uint8)
                for i in range(16)]
    got = int8_bf16_daemon(tf_reader, tf_crops,
                           "TF int8 daemon under bf16 (phase 13's snapshot, float32 model)")
    nt = got["transcribe_batches"]
    want = dict(want, int8_conv_pool=3 * nt, int8_conv_pool_bf16=0, gru_fwd_bf16=0)
    if {k: v for k, v in got.items() if k != "transcribe_batches"} != want or not nt:
        raise SystemExit(f"TF int8 daemon under bf16: launches {got}, expected {want}")
    out["tf_launches"] = got
    return out


def card_defaults(dev, workdir, tf_dir, smi):
    """16e: `cli test` on phase 5's corpus and checkpoint with no
    --compute_dtype and no --config runs bf16 on the card (K1's bf16
    instantiation by profiler name, its float32 one never);
    `--compute_dtype float32` wins (float32 K1 only); with `--config` (a
    float32 file) the file's dtype is kept. `cli test --model_family tf` on
    phase 13's corpus and snapshot with no dtype flag and no --config
    resolves bf16 and builds the float32 TF model, as the JAX CLI does: its
    JSON equals `--compute_dtype float32`'s."""
    from avsync_torch import cli, predictor

    data, ck, cfg_path = (os.path.join(workdir, n) for n in ("grid", "ckpt", "config.json"))
    runs = {"no flag": [], "--compute_dtype float32": F32, "--config (float32 file)":
            ["--config", cfg_path]}
    out = {}
    for what, extra in runs.items():
        res = os.path.join(workdir, f"defaults_{len(out)}.json")
        rc, _, _, _, names = traced(lambda: cli.main(["test", "--data_path", data, "--checkpoint",
                                                      ck, "--output", res, *extra]),
                                    has_kernels("conv1_pool"))
        k1 = bf16_replayed(names)
        out[what] = {"rc": rc, "conv1_pool_bf16": k1["conv1_pool_bf16"],
                     "conv1_pool_f32": k1["conv1_pool_f32"]}
    built = []
    load = predictor.load_lipnet

    def recording_load(cfg, state, device):
        model = load(cfg, state, device)
        built.append({"config": cfg.model.compute_dtype, "model": str(model.compute_dtype),
                      "params": sorted({str(p.dtype) for p in model.parameters()})})
        return model

    tf = {}
    predictor.load_lipnet = recording_load
    try:
        for what, extra in (("no flag", []), ("--compute_dtype float32", F32)):
            res = os.path.join(workdir, f"defaults_tf_{len(tf)}.json")
            rc = cli.main(["test", "--data_path", os.path.join(tf_dir, "tf_grid"),
                           "--checkpoint", os.path.join(tf_dir, "tf_ckpt"), "--model_family",
                           "tf", "--output", res, *extra])
            with open(res) as f:
                tf[what] = {"rc": rc, **built[-1], "results": json.load(f)}
    finally:
        predictor.load_lipnet = load
    out["tf"] = tf
    print(f"int8 under bf16 phase: e. the card's defaults, cli test on phase 5's checkpoint, K1 "
          f"by profiler name, and cli test --model_family tf on phase 13's: {json.dumps(out)} "
          f"[{smi}]", flush=True)
    ok = (all(r["rc"] == 0 for r in out.values() if "rc" in r)
          and out["no flag"]["conv1_pool_bf16"] > 0 and out["no flag"]["conv1_pool_f32"] == 0
          and all(out[w]["conv1_pool_bf16"] == 0 and out[w]["conv1_pool_f32"] > 0
                  for w in ("--compute_dtype float32", "--config (float32 file)")))
    if not ok:
        raise SystemExit("the card's CLI defaults are not bf16, or a flag or --config did not "
                         f"win; the last trace's kernels: {names}")
    if (any(r["rc"] != 0 or r["model"] != "None" or r["params"] != ["torch.float32"]
            for r in tf.values()) or tf["no flag"]["config"] != "bfloat16"
            or tf["no flag"]["results"] != tf["--compute_dtype float32"]["results"]):
        raise SystemExit(f"cli test --model_family tf under the card's defaults: {tf}")
    return out


def run_int8_bf16(dev, workdir, serving_dir, tf_dir, crops, smi, k2_row):
    """Phase 16: int8 serving under bf16 compute: a. Q1's bf16 epilogue; b.
    K2 with bf16 operands; c. the full-width int8-bf16 forward; d. the
    commands and daemons; e. the card's CLI defaults. Returns the kernel
    line's two rows and the numbers."""
    q1 = q1_bf16_kernel(dev, smi)
    k2 = k2_bf16_kernel(dev, smi, k2_row)
    out = {"forward": int8_bf16_forward(dev, smi)}
    out["commands"] = int8_bf16_commands(dev, workdir, serving_dir, tf_dir, crops, smi)
    out["defaults"] = card_defaults(dev, workdir, tf_dir, smi)
    served = out["commands"]["launches"]
    q1.update(launches=served["int8_conv_pool_bf16"],
              launches_daemon_int8_bf16={"transcribe_batches": served["transcribe_batches"],
                                         "launches": served["int8_conv_pool_bf16"]})
    k2.update(launches=served["gru_fwd_bf16"],
              launches_daemon_int8_bf16={"transcribe_batches": served["transcribe_batches"],
                                         "launches": served["gru_fwd_bf16"]})
    for k in (q1, k2):
        if not k["launches"]:
            raise SystemExit(f"{k['name']} was not launched on the int8-bf16 serving path")
    print(f"  int8 under bf16 phase numbers [{smi}]: {json.dumps(out)}", flush=True)
    return q1, k2, out


# ---------------------------------------------------------------------------
# 17. the last JAX surfaces: K3 from h0, the CP backward, misalign-demo,
#     test over ranks, the device edit distance
# ---------------------------------------------------------------------------

P17_CP = (8, 74, 256, 2)  # the CP backward: B, T, H and ranks (37 steps each)
DEMO_ATOL = 1e-4  # misalign-demo's scores vs the in-process scorer's


def p17_cp_inputs():
    """gi, w_hh, b_hh and the output's cotangent of the CP backward, seeded."""
    import numpy as np
    import torch

    B, T, H, _ = P17_CP
    r = np.random.default_rng(17)
    k = H ** -0.5
    return tuple(torch.from_numpy(a.astype(np.float32)) for a in (
        r.normal(size=(B, T, 3 * H)), r.uniform(-k, k, (H, 3 * H)), r.uniform(-k, k, (3 * H,)),
        r.normal(size=(B, T, H))))


def p17_ranks(rank, out, workdir):
    """Two ranks sharing the card: this rank's chunk of the CP chain through
    its backward (K3 from the handed-off h0, dh0 back to rank 0), then `cli
    test` over the two ranks, f32 and int8."""
    import contextlib

    import torch

    from avsync_torch import cli
    from avsync_torch.ops.cuda import gru
    from avsync_torch.parallel import multihost
    from avsync_torch.parallel.context import cp_gru_recurrence

    dev = multihost.rank_device()
    gi, w, b, cot = (t.to(dev) for t in p17_cp_inputs())
    T = gi.shape[1] // P17_CP[3]
    part = slice(rank * T, (rank + 1) * T)
    local = gi[:, part].contiguous().requires_grad_()
    w, b = w.requires_grad_(), b.requires_grad_()
    zero_counts()
    gru.bwd_h0_launches = 0
    y = cp_gru_recurrence(None, local, w, b)
    (y * cot[:, part]).sum().backward()
    torch.cuda.synchronize()
    launches = {"gru_fwd": gru.launches, "gru_bwd": gru.bwd_launches,
                "gru_bwd_h0": gru.bwd_h0_launches}
    torch.save({"y": y.detach().cpu(), "dgi": local.grad.cpu(), "dw": w.grad.cpu(),
                "db": b.grad.cpu(), "launches": launches}, os.path.join(out, f"cp_{rank}.pt"))
    with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
        for name, extra in (("f32", []), ("int8", ["--quantize", "int8"])):
            rc = cli.main(["test", "--data_path", os.path.join(workdir, "grid"), "--config",
                           os.path.join(out, "config_2ranks.json"), "--checkpoint",
                           os.path.join(workdir, "ckpt"), "--output",
                           os.path.join(out, f"test_{name}.json"), *F32, *extra])
            if rc:
                raise SystemExit(f"rank {rank}: cli test {name} exited {rc}")


def k3_from_h0(dev, smi, k3):
    """a. K3 with h0 and dh0 at the training shape against its plain version;
    without h0 the launch equals h0 = zeros; both timed in turns."""
    import torch

    from avsync_torch.ops.cuda import gru

    g = torch.Generator().manual_seed(17)
    B, T, H = 8, 75, 256
    k = H ** -0.5
    gf, gb = (torch.randn(B, T, 3 * H, generator=g).to(dev) for _ in range(2))
    wf, wb = (((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev) for _ in range(2))
    bf, bb = (((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev) for _ in range(2))
    h0f, h0b = (torch.randn(B, H, generator=g).to(dev) for _ in range(2))
    out = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False, h0f),
                     gru.gru_recurrence_ref(gb, wb, bb, True, h0b)], -1)
    cot = torch.randn(B, T, 2 * H, generator=g).to(dev)
    args = (gf, gb, out, cot, wf, wb, bf, bb)

    def plain():
        f = gru.gru_recurrence_bwd_ref(gf, out[..., :H], cot[..., :H], wf, bf, False, h0f)
        r = gru.gru_recurrence_bwd_ref(gb, out[..., H:], cot[..., H:], wb, bb, True, h0b)
        return f[0], r[0], f[1], r[1], f[2], r[2], f[3], r[3]

    print("phase 17: the last JAX surfaces", flush=True)
    print("  a. K3 from an initial state h0 with its gradient dh0 (B=8 T=75 H=256, both "
          "directions) vs gru_recurrence_bwd_ref:", flush=True)
    got = gru.bigru_recurrence_bwd(*args, h0s=(h0f, h0b))
    errs = []
    for i, want in enumerate(plain()):
        what = ("dgi", "dgi", "dw_hh", "dw_hh", "db_hh", "db_hh", "dh0", "dh0")[i]
        tol = K3_SUM_TOL if what in ("dw_hh", "db_hh") else K3_TOL
        errs.append(max_err(got[i], want, tol, f"{what} {'fwd' if i % 2 == 0 else 'rev'}"))
    same_bits(got, gru.bigru_recurrence_bwd(*args, h0s=(h0f, h0b)), "K3 h0")
    no_h0 = gru.bigru_recurrence_bwd(*args)  # the call as it was before h0
    zeros = gru.bigru_recurrence_bwd(*args, h0s=(torch.zeros_like(h0f),) * 2)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(no_h0, zeros[:6])):
        raise SystemExit("K3 without h0 differs from K3 with h0 = zeros")
    print("  K3 without h0 (the earlier call) equals K3 with h0 = zeros bit for bit", flush=True)
    turns = {"no_h0": [], "h0": []}
    for name in ("no_h0", "h0", "h0", "no_h0"):
        fn = ((lambda: gru.bigru_recurrence_bwd(*args)) if name == "no_h0" else
              (lambda: gru.bigru_recurrence_bwd(*args, h0s=(h0f, h0b))))
        turns[name].append((time_ms(fn), queued_ms(fn)))
    ms, ms_q = (statistics.mean(t[i] for t in turns["h0"]) for i in (0, 1))
    no_ms, no_q = (statistics.mean(t[i] for t in turns["no_h0"]) for i in (0, 1))
    plain_ms = time_ms(plain, iters=5, warmup=1)
    # the library yardstick as K3's row takes it (phase 3): the whole BiGRU
    # layer's backward through torch.nn.GRU (D=6912), here from an initial
    # state that requires its gradient, so the call also returns dh0
    cudnn = torch.nn.GRU(6912, H, batch_first=True, bidirectional=True).to(dev)
    x = torch.randn(B, T, 6912, generator=g).to(dev).requires_grad_()
    h0_lib = torch.stack([h0f, h0b]).requires_grad_()
    y_lib = cudnn(x, h0_lib)[0]
    ins_lib = [x, h0_lib, *cudnn.parameters()]
    lib_ms = time_ms(lambda: torch.autograd.grad(y_lib, ins_lib, cot, retain_graph=True))
    # each direction: K3's bytes and operations, plus h0 read, dh0 written and
    # the (B, 3H) x (3H, H) product of dh0
    n_bytes = 4 * 2 * (B * T * 3 * H + 2 * B * T * H + H * 3 * H + 3 * H
                       + B * T * 3 * H + H * 3 * H + 3 * H + 2 * B * H)
    n_ops = 2 * (3 * 2 * B * T * H * 3 * H + 30 * B * T * H + 2 * B * 3 * H * H)
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"  K3 in turns (no h0, h0, h0, no h0), CUDA events median of 20: with h0 + dh0 "
          f"{ms:.4f} ms (queued {ms_q:.4f}), without {no_ms:.4f} ms (queued {no_q:.4f}); "
          f"phase 3's K3 {k3['ms']:.4f} ms (queued {k3['queued_ms']:.4f}; without h0 over "
          f"phase 3: events {no_ms / k3['ms']:.4f}, queued {no_q / k3['queued_ms']:.4f}); "
          f"plain {plain_ms:.4f} ms; bound {bms:.4f} ms ({by}); torch.nn.GRU from h0 "
          f"library_ms={lib_ms:.4f} [{smi}]", flush=True)
    return dict(name="gru_bwd_h0", route="cuda", source="avsync_torch/csrc/gru_bwd.cu",
                replaces="avsync/ops/pallas/gru.py:276", max_abs_err=max(errs), ms=ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                queued_ms=ms_q, no_h0_ms=no_ms, no_h0_queued_ms=no_q,
                phase3_ms=k3["ms"], phase3_queued_ms=k3["queued_ms"], shape="both directions B=8 T=75 H=256, h0 in, dh0 out",
                library_note="library_ms times the whole BiGRU layer's backward (D=6912, "
                             "dx, dh0 and every weight) through torch.nn.GRU from h0, as "
                             "K3's row times it without h0")


def misalign_demo(dev, out, smi):
    """c. `cli misalign-demo` on a small corpus with phases 4 and 7's seeded
    weights: the files, their frames, no failure, and the scores against the
    in-process scorer."""
    import contextlib
    import io

    import numpy as np

    from avsync_torch import cli, demo
    from avsync_torch.config import AvsyncConfig, AudioConfig, ModelConfig
    from avsync_torch.data.video import decode_av, decode_video_gray
    from avsync_torch.predictor import MisalignmentScorer

    cfg = AvsyncConfig(model=ModelConfig(fused_conv_pool=True), audio=AudioConfig(use_pallas=True))
    lip, det = write_serving_checkpoints(cfg, out)
    data = os.path.join(out, "demo_grid")
    write_grid_corpus(data, 2, 2, seed=17)
    cfg_path = os.path.join(out, "demo_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    calls, real = [], demo.export_demo

    def recorded(frames, audio, sr, fps, shift, a, m, out_dir, scale=1):
        calls.append((out_dir, frames.shape[0], shift, a, m))
        return real(frames, audio, sr, fps, shift, a, m, out_dir, scale=scale)

    demo.export_demo = recorded
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["misalign-demo", "--data_path", data, "--config", cfg_path,
                           "--checkpoint", lip, "--detector_checkpoint", det, "--output_dir",
                           os.path.join(out, "demo"), "--seed", "0", *F32])
    finally:
        demo.export_demo = real
    secs = time.perf_counter() - t0
    printed = buf.getvalue()
    print("\n".join("  " + ln for ln in printed.splitlines() if "shift=" in ln or "failed" in ln),
          flush=True)
    if rc != 0 or "failed" in printed or len(calls) != 2:
        raise SystemExit("misalign-demo failed its checks")
    scorer = MisalignmentScorer(detector_checkpoint=det, lipnet_checkpoint=lip, config=cfg,
                                device=dev)
    errs, files = [], {}
    for out_dir, n, shift, a, m in calls:
        speaker = os.path.basename(out_dir)
        line = next(ln for ln in printed.splitlines() if ln.startswith(f"{speaker}: "))
        clip = os.path.join(data, speaker, "video", line.split()[1])
        frames, audio, fps = decode_av(clip, cfg)
        want = scorer.score_arrays(frames, audio, fps, shifts=(0, shift))
        errs.append(float(np.abs(np.asarray([a, m]) - want).max()))
        files[speaker] = sorted(os.listdir(out_dir))
        for name in files[speaker]:
            if name.endswith((".mp4", ".avi")):
                got_n = decode_video_gray(os.path.join(out_dir, name)).shape[0]
                if got_n != n or n != frames.shape[0]:
                    raise SystemExit(f"misalign-demo wrote {name} with {got_n} frames, not {n}")
    print(f"  c. misalign-demo, 2 speakers: {secs:.1f} s; files {json.dumps(files)}; scores "
          f"vs the in-process scorer max |d| {max(errs):.3e} (bound {DEMO_ATOL}) [{smi}]",
          flush=True)
    if max(errs) > DEMO_ATOL:
        raise SystemExit("misalign-demo's scores differ from the in-process scorer's")
    return {"seconds": secs, "max_abs_err": max(errs), "files": files}


def run_last_surfaces(dev, workdir, smi, k3):
    """Phase 17 (see the module's docstring)."""
    import contextlib
    import dataclasses

    import numpy as np
    import torch

    from avsync_torch import cli, eval as teval
    from avsync_torch.config import AvsyncConfig
    from avsync_torch.ops.cuda import gru
    from avsync_torch.parallel import multihost

    row = k3_from_h0(dev, smi, k3)
    out = os.path.join(workdir, "p17")
    os.makedirs(out)

    # b. and d. one group of two ranks sharing the card
    with open(os.path.join(workdir, "config.json")) as f:
        cfg = AvsyncConfig.from_dict(json.load(f))
    with open(os.path.join(out, "config_2ranks.json"), "w") as f:
        f.write(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, mesh_shape=(2, 1))).to_json())
    t0 = time.perf_counter()
    multihost.spawn(p17_ranks, P17_CP[3], (out, workdir), device="cuda")
    ranks_s = time.perf_counter() - t0
    parts = [torch.load(os.path.join(out, f"cp_{r}.pt")) for r in range(P17_CP[3])]
    gi, w, b, cot = (t.to(dev) for t in p17_cp_inputs())
    whole = gru.gru_recurrence(gi, w, b)
    dgi, dw, db = gru.gru_recurrence_bwd(gi, whole, cot, w, b)
    chain = torch.cat([p["y"] for p in parts], 1)
    if not torch.equal(chain, whole.cpu()):
        raise SystemExit("the CP chain's forward differs from K2 over the whole sequence")
    errs = [max_err(torch.cat([p["dgi"] for p in parts], 1).to(dev), dgi, K3_TOL,
                    f"CP backward over {P17_CP[3]} ranks: dgi vs K3 over the whole sequence")]
    for p in parts:
        errs.append(max_err(p["dw"].to(dev), dw, K3_SUM_TOL, "  dw_hh (reduced over the ranks)"))
        errs.append(max_err(p["db"].to(dev), db, K3_SUM_TOL, "  db_hh (reduced over the ranks)"))
    launches = [p["launches"] for p in parts]
    want = [{"gru_fwd": 1, "gru_bwd": 1, "gru_bwd_h0": 1 if r else 0} for r in range(len(parts))]
    print(f"  b. CP backward over {P17_CP[3]} ranks (B={P17_CP[0]}, T={P17_CP[1]}, "
          f"H={P17_CP[2]}): forward equal bit for bit to K2 over the whole sequence; launches "
          f"per rank {launches} (want {want})", flush=True)
    if launches != want:
        raise SystemExit("the CP backward did not launch K2 and K3 as expected")
    row["launches"] = sum(p["gru_bwd_h0"] for p in launches)
    row["launches_cp_per_rank"] = [p["gru_bwd_h0"] for p in launches]

    # d. test over the two ranks against the one-rank command
    tested = {}
    for name, extra in (("f32", []), ("int8", ["--quantize", "int8"])):
        one = os.path.join(out, f"test1_{name}.json")
        with open(os.devnull, "w") as null, contextlib.redirect_stdout(null):
            rc = cli.main(["test", "--data_path", os.path.join(workdir, "grid"), "--config",
                           os.path.join(workdir, "config.json"), "--checkpoint",
                           os.path.join(workdir, "ckpt"), "--output", one, *F32, *extra])
        with open(one) as f, open(os.path.join(out, f"test_{name}.json")) as g:
            tested[name] = (json.load(f), json.load(g))
        if rc or tested[name][0] != tested[name][1]:
            raise SystemExit(f"cli test {name} over 2 ranks differs from one rank: "
                             f"{tested[name]}")
    print(f"  d. cli test over 2 ranks sharing the card (gloo; the ranks' group {ranks_s:.1f} s "
          f"with b.): f32 {tested['f32'][1]}, int8 {tested['int8'][1]}: each equal to the "
          f"one-rank command's JSON", flush=True)

    # c. misalign-demo
    demo_row = misalign_demo(dev, out, smi)

    # e. the device edit distance on the card against the CPU
    r = np.random.default_rng(170)
    B, P, L = 64, 40, 32
    arrays = [r.integers(0, 28, (B, P)), r.integers(0, P + 1, B), r.integers(0, 28, (B, L)),
              r.integers(0, L + 1, B)]
    arrays[3][::7] = 0
    cpu = teval.cer_wer_batch(*(torch.from_numpy(a) for a in arrays))
    card = teval.cer_wer_batch(*(torch.from_numpy(a).to(dev) for a in arrays))
    if not torch.equal(card.cpu(), cpu):
        raise SystemExit("cer_wer_batch on the card differs from the CPU")
    print(f"  e. cer_wer_batch (B={B}, P={P}, L={L}) on the card equal to the CPU's; mean rate "
          f"{cpu.mean().item():.4f}", flush=True)
    return row, {"cp_backward_max_abs_err": max(errs), "test_over_ranks": tested,
                 "demo": demo_row, "ranks_seconds": ranks_s}


# ---------------------------------------------------------------------------
# 18. the mouth localizer's training
# ---------------------------------------------------------------------------

LOC_STEPS, LOC_BATCH, LOC_SEED = 1500, 128, 0  # scripts/train_localizer.py's run
LOC_DET_STEPS = 50  # the determinism check's two runs
# rounding noise of a leaf whose exact gradient is zero, against the largest
# gradient (float32 sums of ~10^5 terms of the other leaves' size: ~1e-7)
LOC_ZERO_GRAD = 1e-5
def localizer_warm_step(dev, data, smi):
    """18a: where a warm step's time goes: wall ms per step over 100 untraced
    steps (host clock), and device busy ms, idle share and kernels per step
    from a trace of 10."""
    import copy

    import torch

    from avsync_torch.models.localizer import NET_HW
    from avsync_torch.ops.conv import train_scope
    from avsync_torch.train import localizer_trainer as lt

    model = lt.init_localizer(torch.Generator().manual_seed(LOC_SEED)).to(dev)
    opt = lt.optimizer(model)
    draws = torch.Generator(device=dev).manual_seed(LOC_SEED)
    rows = torch.from_numpy(next(lt.batch_indices(copy.deepcopy(data.rng), len(data.x_train),
                                                  LOC_BATCH, 1))).to(dev)
    x = torch.from_numpy(data.x_train).to(dev)[rows]
    y = torch.from_numpy(data.y_train).to(dev)[rows]

    def steps(n):
        for _ in range(n):
            lt.train_step(model, opt, lt.augment(x, lt.draw_augment(draws, LOC_BATCH, *NET_HW)), y)

    with train_scope():
        steps(20)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(100)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 10
        _, traced_ms, busy, _, names = traced(lambda: steps(10))
    row = {"wall_ms_per_step": wall, "device_busy_ms_per_step": busy / 10,
           "idle_share": max(0.0, 1.0 - busy / traced_ms),
           "kernels_per_step": sum(names.values()) / 10}
    print(f"  a. a warm step (B={LOC_BATCH}, one batch repeated): {wall:.4f} ms wall (host "
          f"clock, 100 steps); traced over 10: device busy {row['device_busy_ms_per_step']:.4f} "
          f"ms, idle share {row['idle_share']:.4f}, {row['kernels_per_step']:.1f} kernels a step "
          f"[{smi}]", flush=True)
    return row


def localizer_step_card_vs_cpu(dev, data):
    """18b: one step's loss and gradients on the card against the CPU, from
    the same parameters, batch and augmentation draws (drawn on the CPU)."""
    import copy

    import torch

    from avsync_torch.models.localizer import NET_HW
    from avsync_torch.ops.conv import train_scope
    from avsync_torch.train import localizer_trainer as lt

    model = lt.init_localizer(torch.Generator().manual_seed(LOC_SEED))
    idx = torch.from_numpy(next(lt.batch_indices(copy.deepcopy(data.rng), len(data.x_train),
                                                 LOC_BATCH, 1)))
    x, y = torch.from_numpy(data.x_train)[idx], torch.from_numpy(data.y_train)[idx]
    draws = lt.draw_augment(torch.Generator().manual_seed(LOC_SEED), len(idx), *NET_HW)
    grads = {}
    for where in ("cpu", dev):
        m = copy.deepcopy(model).to(where)
        with train_scope():
            loss = lt.loss_fn(m, lt.augment(x.to(where), {k: v.to(where) for k, v in
                                                        draws.items()}), y.to(where))
            loss.backward()
        grads[str(where)] = (loss.item(), {k: p.grad.cpu() for k, p in m.named_parameters()})
    (loss_c, g_c), (loss_d, g_d) = grads["cpu"], grads[str(dev)]
    loss_rel = abs(loss_d - loss_c) / abs(loss_c)
    top = max(g.abs().max().item() for g in g_c.values())
    # a leaf whose exact gradient is zero (heat.bias: the softmax does not
    # move under a shift) holds rounding noise on both devices: each device's
    # value is held under LOC_ZERO_GRAD of the largest gradient instead
    zero = {k for k, g in g_c.items() if g.abs().max().item() < LOC_ZERO_GRAD * top}
    grad_rel = max(((g_d[k] - g_c[k]).abs().max() / g_c[k].abs().max()).item()
                   for k in g_c if k not in zero)
    noise = max((max(g_c[k].abs().max().item(), g_d[k].abs().max().item()) / top
                 for k in zero), default=0.0)
    print(f"  b. one step (B={len(idx)}), card vs CPU from the same parameters, batch and "
          f"draws: loss {loss_d:.6f} vs {loss_c:.6f}, rel {loss_rel:.3e} (tol {STEP_LOSS_RTOL}); "
          f"gradients, worst over {len(g_c) - len(zero)} leaves, {grad_rel:.3e} of the leaf's "
          f"largest (tol {STEP_GRAD_RTOL}); {sorted(zero)}, exactly zero, {noise:.3e} of the "
          f"largest gradient on either device (tol {LOC_ZERO_GRAD})", flush=True)
    if loss_rel > STEP_LOSS_RTOL or grad_rel > STEP_GRAD_RTOL or noise > LOC_ZERO_GRAD:
        raise SystemExit("the localizer's step on the card disagrees with the CPU's")
    return {"loss_rel": loss_rel, "grad_rel": grad_rel, "zero_leaves": sorted(zero),
            "zero_leaf_noise": noise}


def localizer_roi(dev, bundle, front_dir, smi):
    """18e: the retrained bundle through `load_bundled_or_none(path=...)` and
    roi_mode='model''s `make_roi_crop_fn` on phase 12's native clips, on the
    card and on the CPU."""
    import numpy as np
    import torch

    from avsync_torch.config import AvsyncConfig, DataConfig
    from avsync_torch.data import synthetic
    from avsync_torch.data.pipeline import make_roi_crop_fn
    from avsync_torch.models.localizer import gate_boxes, load_bundled_or_none, localize_clip_boxes

    d = AvsyncConfig(data=DataConfig(roi_mode="model")).data
    frames = np.stack([np.load(os.path.join(front_dir, f"clip{i}.npy"))
                       for i in range(FRONT_CLIPS)])
    known = np.stack([synthetic.mouth_box(*front_clip_spec(i), *frames.shape[2:])
                      for i in range(FRONT_CLIPS)])
    heur = torch.tensor([d.mouth_crop[0], 1.0, d.mouth_crop[1], d.mouth_crop[2]])
    boxes, crops = {}, {}
    for where in ("cpu", dev):
        loc = load_bundled_or_none(where, path=bundle)
        x = torch.from_numpy(frames).to(where)
        with torch.no_grad():
            crops[str(where)] = make_roi_crop_fn(d, "model", loc)(x).cpu()
            xf = x.float()
            boxes[str(where)] = gate_boxes(xf, localize_clip_boxes(loc, xf),
                                           heur.to(where)).cpu()
    bc, bd = boxes["cpu"], boxes[str(dev)]
    kept_c, kept_d = ~(bc == heur).all(-1), ~(bd == heur).all(-1)
    box_err = (bd - bc).abs().max().item()
    crop = crops[str(dev)]
    shape = (FRONT_CLIPS, frames.shape[1], d.img_height, d.img_width, 1)
    res = {"box_max_abs_err": box_err, "model_boxes_kept": int(kept_d.sum()),
           "mean_iou_known_box": float(iou(bd.numpy(), known).mean()),
           "crop_max_abs_err": (crop - crops["cpu"]).abs().max().item()}
    print(f"  e. roi_mode='model' on the retrained bundle (load_bundled_or_none(path=...), "
          f"make_roi_crop_fn) over phase 12's {FRONT_CLIPS} native clips "
          f"{tuple(frames.shape[1:])}: boxes card vs CPU within {box_err:.3e} (tol "
          f"{ROI_BOX_ATOL}), the gate kept the model's box for {res['model_boxes_kept']} of "
          f"{FRONT_CLIPS} on both: {torch.equal(kept_c, kept_d)}; mean IoU with the known box "
          f"{res['mean_iou_known_box']:.3f}; crops {tuple(crop.shape)}, card vs CPU "
          f"{res['crop_max_abs_err']:.3e} [{smi}]", flush=True)
    if box_err > ROI_BOX_ATOL or not torch.equal(kept_c, kept_d):
        raise SystemExit("the retrained localizer's boxes differ, card vs CPU")
    if tuple(crop.shape) != shape or not torch.isfinite(crop).all():
        raise SystemExit(f"bad crops from the retrained localizer: {tuple(crop.shape)}")
    return res


def run_localizer_training(dev, workdir, front_dir, smi):
    """Phase 18: the mouth localizer retrained on the card at the JAX
    script's full size (2,048 samples, B=128, 1500 steps) into `workdir`
    (the repo's bundle is never written), its weights through the JAX
    package's accuracy gates beside the bundled weights', one step card vs
    CPU, two short runs' bits, and the retrained bundle in roi_mode='model'
    on phase 12's clips (`front_dir`)."""
    import torch

    from avsync_torch.models.localizer import WEIGHTS_FILE, load_bundled_or_none, save_params
    from avsync_torch.train import localizer_trainer as lt

    t0 = time.perf_counter()
    data = lt.build_dataset(LOC_SEED)
    dataset_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, history = lt.train_localizer(LOC_STEPS, LOC_BATCH, LOC_SEED, dev, data=data)
    train_s = time.perf_counter() - t0
    bundle = os.path.join(workdir, "localizer_weights.npz")
    save_params(state, bundle)
    if os.path.abspath(bundle) == os.path.abspath(WEIGHTS_FILE):
        raise SystemExit("the smoke must not write the repo's bundle")
    res = {"dataset_s": dataset_s, "train_s": train_s, "steps_per_s": LOC_STEPS / train_s,
           "final_val_iou": history[-1]["val_iou"], "history": history}
    print(f"localizer training phase: a. dataset {len(data.x_train)} train + {len(data.x_val)} "
          f"val in {dataset_s:.1f} s (host numpy); {LOC_STEPS} steps at B={LOC_BATCH} in "
          f"{train_s:.2f} s (host clock, {res['steps_per_s']:.1f} steps/s, with "
          f"{len(history)} validations); loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f}; final val IoU {res['final_val_iou']:.4f} [{smi}]",
          flush=True)
    res["warm_step"] = localizer_warm_step(dev, data, smi)
    res["step"] = localizer_step_card_vs_cpu(dev, data)

    # c. determinism: two short runs from one seed
    runs = [lt.train_localizer(LOC_DET_STEPS, LOC_BATCH, LOC_SEED, dev, data=data)
            for _ in range(2)]
    same = runs[0][1] == runs[1][1] and all(torch.equal(runs[0][0][k], runs[1][0][k])
                                            for k in runs[0][0])
    print(f"  c. two {LOC_DET_STEPS}-step runs from seed {LOC_SEED}: equal bits {same}",
          flush=True)
    if not same:
        raise SystemExit("two localizer runs from one seed differ")

    # d. the JAX package's accuracy gates, card-trained beside the bundled weights
    gates = {}
    for name, path in (("retrained", bundle), ("bundled", WEIGHTS_FILE)):
        gates[name], failed = lt.accuracy_gates(load_bundled_or_none(dev, path=path), dev)
        gates[name]["failed"] = failed
    print(f"  d. the JAX package's gates (tests/test_localizer.py:54-123; mean IoU >= "
          f"{lt.GATE_IOU} at {', '.join(f'{h}x{w}' for _, (h, w) in lt.GATE_GEOMETRIES)}, >= "
          f"{lt.GATE_DEGRADED} degraded, >= {lt.GATE_CLIP} on one clip; mouth retention >= "
          f"{lt.GATE_RETENTION} and above the heuristic's + {lt.GATE_RETENTION_MARGIN}): "
          f"retrained on the card {json.dumps(gates['retrained'])}; bundled "
          f"{json.dumps(gates['bundled'])} [{smi}]", flush=True)
    if gates["retrained"]["failed"]:
        raise SystemExit(f"the card-trained localizer fails {gates['retrained']['failed']}")
    res["gates"] = gates
    res["roi"] = localizer_roi(dev, bundle, front_dir, smi)
    return res


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "avsync_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository (avsync_torch/ missing)",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; bf16 reduced-precision reduction in "
          f"cuBLAS: {torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}",
          flush=True)

    from avsync_torch.ops.cuda import build

    names = ["conv1_pool", "gru_fwd", "gru_bwd", "conv1_pool_bwd", "mel_stats", "int8_conv_pool"]
    t0 = time.perf_counter()
    secs = build.build(names)
    print(f"build: {sorted(secs)} in {time.perf_counter() - t0:.1f} s "
          f"(per source: {', '.join(f'{k} {v:.1f} s' for k, v in secs.items())})", flush=True)
    for name in names:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}", flush=True)

    k1 = check_conv1_pool(dev)
    k2 = check_gru(dev)
    k3 = check_gru_bwd(dev)
    k4 = check_conv1_pool_bwd(dev)
    k5 = check_mel_stats(dev)
    k1["launches_serving"], k2["launches_serving"] = run_slice(dev)
    served = run_detector_serving(dev)
    with tempfile.TemporaryDirectory() as workdir:
        trained = run_training(dev, workdir)
        detector = run_detector_training(dev, workdir)
        programs, replayed = run_epoch_programs(dev, workdir)
        with open(os.path.join(workdir, "results.json")) as f:
            greedy = json.load(f)
        serving_dir = os.path.join(workdir, "serving")
        os.makedirs(serving_dir)
        serving, crops = run_serving(dev, serving_dir, *(os.path.join(workdir, n) for n in
                                                         ("grid", "ckpt", "config.json")),
                                     greedy, smi)
        t11 = time.perf_counter()
        q1 = check_int8_conv_pool(dev, smi)
        int8 = run_int8_serving(dev, serving_dir, *(os.path.join(workdir, n) for n in
                                                    ("grid", "ckpt", "config.json")),
                                greedy, crops, serving["live"]["transcribe_crops"], smi)
        print(f"int8 serving phase: {time.perf_counter() - t11:.1f} s", flush=True)
        t12 = time.perf_counter()
        front_dir = os.path.join(workdir, "front")
        os.makedirs(front_dir)
        front = run_front_end(dev, front_dir, smi)
        print(f"front end phase: {time.perf_counter() - t12:.1f} s", flush=True)
        t13 = time.perf_counter()
        tf_dir = os.path.join(workdir, "tf")
        os.makedirs(tf_dir)
        tf = run_tf_family(dev, tf_dir, smi)
        print(f"TF family phase: {time.perf_counter() - t13:.1f} s", flush=True)
        t14 = time.perf_counter()
        multi = run_multi_device(dev, workdir, smi, k2["ms"], programs["lipnet"]["graph"], crops)
        print(f"multi-device phase: {time.perf_counter() - t14:.1f} s", flush=True)
        t15 = time.perf_counter()
        k1_16, k4_16, trained16, bf16 = run_bf16(dev, workdir, tf_dir, smi,
                                                 programs["lipnet"]["graph"],
                                                 tf["forward"]["f32_forward_B8_ms"])
        print(f"bf16 phase: {time.perf_counter() - t15:.1f} s", flush=True)
        t16 = time.perf_counter()
        q1_16, k2_16, int8_16 = run_int8_bf16(dev, workdir, serving_dir, tf_dir, crops, smi, k2)
        print(f"int8 under bf16 phase: {time.perf_counter() - t16:.1f} s", flush=True)
        t17 = time.perf_counter()
        k3_h0, last = run_last_surfaces(dev, workdir, smi, k3)
        print(f"last JAX surfaces phase: {time.perf_counter() - t17:.1f} s", flush=True)
        t18 = time.perf_counter()
        loc_dir = os.path.join(workdir, "localizer")
        os.makedirs(loc_dir)
        loc = run_localizer_training(dev, loc_dir, front_dir, smi)
        print(f"localizer training phase: {time.perf_counter() - t18:.1f} s", flush=True)
    for k in (k1, k2, k3, k4):
        k["launches"] = trained[k["name"]]
    k5["launches"], k5["launches_serving"] = detector["mel_stats"], served["mel_stats"]
    k1["launches_detector"] = detector["conv1_pool"]
    k1["launches_detector_serving"] = served["conv1_pool"]
    for k in (k1, k2, k3, k4):
        k["launches_graph_replay_lipnet_epoch"] = replayed["lipnet"][k["name"]]
    k1["launches_graph_replay_detector_epoch"] = replayed["detector_train"]["conv1_pool"]
    k5["launches_graph_replay_detector_epoch"] = {
        "train": replayed["detector_train"]["mel_stats"],
        "eval": replayed["detector_eval"]["mel_stats"]}
    for what in ("live", "artifact"):
        got = serving["launches"][what]
        per_batch = {"transcribe_batches": got["transcribe_batches"],
                     "sync_batches": got["sync_batches"]}
        k1[f"launches_daemon_{what}"] = {**per_batch, "launches": got["conv1_pool"]}
        k2[f"launches_daemon_{what}"] = {**per_batch, "launches": got["gru_fwd"]}
        k5[f"launches_daemon_{what}"] = {**per_batch, "launches": got["mel_stats"]}
    q1["launches"] = int8["launches"]["int8_conv_pool"]
    q1["launches_daemon_int8"] = int8["launches"]
    k2["launches_daemon_int8"] = {"transcribe_batches": int8["launches"]["transcribe_batches"],
                                  "launches": int8["launches"]["gru_fwd"]}
    for mode, row in front["roi_modes"].items():  # phase 12's own path, per ROI mode
        k1.setdefault("launches_roi_modes", {})[mode] = row["launches"]["conv1_pool"]
        k2.setdefault("launches_roi_modes", {})[mode] = row["launches"]["gru_fwd"]
    for k in (k1, k3, k4):
        k["launches_train_roi_host"] = front["train_roi_host"]["launches"][k["name"]]
    if "sync_container" in front:
        k5["launches_container_sync"] = front["sync_container"]["launches"]["mel_stats"]
    # phase 13's own path: the TF stack's int8 daemon, Q1 at the TF blocks
    q1["launches_tf_int8_daemon"] = tf["serving"]["launches"]
    q1["tf_blocks"] = dict(tf["q1"], shape="B=8 T=75 46x140, the TF stack's conv1 + conv2 + "
                                           "conv3 in their chain contracts")
    if not tf["serving"]["launches"]["int8_conv_pool"]:
        raise SystemExit("int8_conv_pool was not launched on the TF family's int8 path")
    # 13f's own path: the TF stack's conv1 under fused_conv_pool
    k1["launches_tf_fused"] = {"train_loop": tf["fused"]["train"]["wrapper_calls"]["loop"][
        "conv1_pool"], "daemon": tf["fused"]["serve"]["launches"],
        "export_B8": tf["fused"]["export"]["launches"][8]["conv1_pool"]}
    k4["launches_tf_fused"] = tf["fused"]["train"]["wrapper_calls"]["loop"]["conv1_pool_bwd"]
    for k in (k1, k2, k3, k4):  # phase 14's own path: a DP rank's train step
        k["launches_dp_rank_step"] = multi["dp_counts"][k["name"]]
        if not k["launches_dp_rank_step"]:
            raise SystemExit(f"{k['name']} was not launched on a data-parallel rank's step")
    k2["launches_cp_per_rank"] = multi["cp_launches"]
    k2["initial_state"] = "h0: the CP chain's handed-off state"
    for k in (k2, k3):  # phase 15's own path: bf16 training feeds them float32 gi
        k["launches_bf16_train"] = trained16[k["name"]]
        if not k["launches_bf16_train"]:
            raise SystemExit(f"{k['name']} was not launched on the bf16 training path")
    for k in (k1, k2, k3, k4, k5, q1, k3_h0):
        if not k["launches"] or k.get("launches_serving") == 0 or any(
                k.get(f"launches_daemon_{w}", {"launches": 1})["launches"] == 0
                for w in ("live", "artifact")):
            raise SystemExit(f"{k['name']} was not launched on its main path")
    print(f"epoch programs: {json.dumps(programs)}", flush=True)
    print(f"multi-device: {json.dumps(multi['times'])} [{smi}]", flush=True)
    print(f"bf16: forward {json.dumps(bf16['forward'])}; graph step "
          f"{bf16['train']['wall_ms_per_step']:.4f} ms, idle {bf16['train']['idle_share']:.4f} "
          f"[{smi}]", flush=True)
    print(f"int8 under bf16: forward {json.dumps(int8_16['forward'])}; daemon "
          f"{json.dumps(int8_16['commands']['daemon'])} [{smi}]", flush=True)
    print(f"last JAX surfaces: {json.dumps(last)} [{smi}]", flush=True)
    print(f"localizer training: {json.dumps(loc)} [{smi}]", flush=True)

    print("kernels: K1 conv1_pool_fused (avsync/ops/pallas/convpool.py:100)=ported+checked; "
          "K2 pallas_gru_scan (avsync/ops/pallas/gru.py:357)=ported+checked; "
          "K3 pallas_gru_bwd (avsync/ops/pallas/gru.py:276)=ported+checked; "
          "K4 conv1_pool_bwd (avsync/ops/pallas/convpool.py:244)=ported+checked; "
          "K5 pallas_mel_stats (avsync/ops/pallas/mfcc.py:60)=ported+checked; "
          "Q1 int8_conv_pool (no pallas_call: the int8 lax.conv_general_dilated of "
          "quant_conv_block, avsync/ops/quant.py:97)=ported+checked, also at the TF "
          "stack's blocks (tflipnet_int8_apply, avsync/ops/quant.py:208); under "
          "compute_dtype bfloat16 K1 and K4 run their bf16 kernels on the bf16 tensor cores "
          "(conv1_pool_bf16, conv1_pool_bwd_bf16, csrc/conv1_mma.cuh)=ported+checked, "
          "K2/K3/K5 unchanged (f32 in "
          "the JAX package too); int8 serving under bf16: Q1's bf16 epilogue "
          "(int8_conv_pool_bf16, quant_conv_block(out_dtype=bfloat16), avsync/ops/quant.py:"
          "109)=ported+checked, the int8 forward's gru_scan(compute_dtype=bf16) as K2 with "
          "bf16 operands (gru_fwd_bf16)=ported+checked; the card's CLI default is bf16; "
          "the context-parallel chain's backward (jax.grad of avsync/parallel/context.py's "
          "scan) as K3 from a carried h0 with dh0 out (gru_bwd_h0)=ported+checked",
          flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{**{k: d[k] for k in keys},
                         **{k: v for k, v in d.items() if k not in keys}}
                        for d in (k1, k2, k3, k4, k5, q1, k1_16, k4_16, q1_16, k2_16,
                                  k3_h0)]}
    print(json.dumps(line), flush=True)
    if any(m.split(".")[0] in ("jax", "flax", "avsync") for m in sys.modules):
        raise SystemExit("the port pulled in jax or the avsync package")
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
