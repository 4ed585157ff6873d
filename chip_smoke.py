#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. card: nvidia-smi name and power limit, torch/CUDA versions, TF32 flags
     (both set off: the port computes in full fp32);
  2. build: nvcc builds every kernel of the serving, training and detector
     paths from avsync_torch/csrc/ (one process per source, started together);
  3. kernels: each LipNet kernel (K1 conv1_pool, K2 gru_fwd, K3 gru_bwd, K4
     conv1_pool_bwd) against its plain PyTorch version on the card, at the
     main paths' shapes, at the batch sizes users train at (B = 16, 32 and
     128, full width) and at odd ones (K1 at its tile's edges, K2/K3 at
     every rows-per-cluster choice, at H = 264 and 512 through the generic
     instantiation and at H = 20 through the wrapper's padding), with the
     tolerance beside the max error; K1 equal to its plain version bit for
     bit at B=8 and 128, and for K1-K4 a repeat launch that must give the
     same bits (at B=8 and B=128);
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
     (and 3 s of audio each) written with numpy; `cli train` at full width with both kernel flags on
     for 2 epochs with a checkpoint, `--resume auto` for a third, `cli test`;
     the counters zeroed before and checked after against the steps taken;
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
     .wav per clip) and its trained LipNet; `cli misalign-train` for 2 epochs
     with a snapshot each, `cli misalign-eval` over shifts 5..20, launch
     counts against the banks, steps, eval batches and sweep rows; one
     detector step of the kernel path against the plain path; the loss
     falling over 20 steps on one repeated batch; the step's time on both
     paths;
  9. the kernels: a text line with the state of every TPU kernel of the
     JAX package, and one JSON line with the measured numbers (launches from
     the training slices, the serving slices' beside them);
  10. the card's name/power line, then the status JSON as the last line.

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
    # tiles), 77 frames against 52 chunks
    shapes = [(B, 75, 50, 100, (3, 5, 5), 32) for B in BUCKETS + TRAIN_BATCHES]
    shapes += [(3, 7, 10, 18, (3, 3, 3), 5), (2, 4, 12, 70, (1, 3, 5), 7),
               (1, 1, 2, 2, (3, 5, 5), 32), (2, 5, 54, 102, (3, 5, 5), 32),
               (1, 3, 50, 100, (3, 5, 5), 20), (1, 3, 50, 100, (3, 5, 5), 9),
               (1, 2, 20, 200, (3, 5, 5), 9), (7, 11, 50, 100, (3, 5, 5), 32)]
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
        if (B, T, H, W, C) in ((8, 75, 50, 100, 32), (128, 75, 50, 100, 32)):
            same_bits([got_n], [convpool.conv1_pool_block(x_n, w_n, b)], f"B={B} T={T} {H}x{W}")
            # the same fmaf chain per pre-pool value as the plain version
            if not torch.equal(got_n, want.permute(0, 4, 1, 2, 3)):
                raise SystemExit(f"kernel check failed: K1 at B={B} differs from its plain "
                                 "version in some bit")
            print(f"  B={B} T=75 50x100: equal to the plain version bit for bit", flush=True)

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
          f"per_step_us={ms / T * 1e3:.2f}; B=1: kernel_ms={ms_b1:.4f} "
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
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                layer_ms=layer_ms, shape="both directions B=8 T=75 H=256",
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
    print(f"  both directions B=8 T=75 H=256: kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"bound_ms={bms:.4f} ({by}: {n_bytes / 1e6:.2f} MB, {n_ops / 1e9:.3f} GFLOP) "
          f"per_step_us={ms / T * 1e3:.2f}", flush=True)
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
                layer_ms=layer_ms, shape="both directions B=8 T=75 H=256",
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
        if B in (8, 128) and T == 75:
            same_bits(got, convpool.conv1_pool_bwd(x, w, b, cot), f"B={B} T={T} {H}x{W}")
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

GRID_WORDS = (("bin", "lay", "place", "set"), ("blue", "green", "red", "white"),
              ("at", "by", "in", "with"), tuple("abcdefghijklmnopqrstuvxyz"),
              ("zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
               "nine"), ("again", "now", "please", "soon"))


def syllable_audio(r, n: int):
    """n samples of noise under a syllable-rate envelope (2-5 Hz), numpy."""
    import numpy as np

    t = np.arange(n) / 16000.0
    env = 0.5 + 0.5 * np.sin(2 * np.pi * r.uniform(2.0, 5.0) * t + r.uniform(0, 2 * np.pi))
    return (0.3 * env ** 2 * r.standard_normal(n)).astype(np.float32)


def write_grid_corpus(root: str, n_speakers: int, clips: int, seed: int):
    """A GRID-layout corpus (<root>/sN/video/*.npy + <root>/sN/align/*.align)
    of (75, 50, 100) uint8 mouth crops and GRID-grammar transcripts, and a
    sibling 3 s, 16 kHz PCM16 .wav per clip (the port's `save_wav`), drawn
    with numpy from `seed`."""
    import numpy as np

    from avsync_torch.data.video import save_wav

    r = np.random.default_rng(seed)
    audio_r = np.random.default_rng(seed + 1)
    for s in range(1, n_speakers + 1):
        vdir, adir = (os.path.join(root, f"s{s}", d) for d in ("video", "align"))
        os.makedirs(vdir)
        os.makedirs(adir)
        for c in range(clips):
            name = f"clip{c:03d}"
            np.save(os.path.join(vdir, name + ".npy"),
                    r.integers(0, 256, (75, 50, 100), dtype=np.uint8))
            save_wav(os.path.join(vdir, name + ".wav"), syllable_audio(audio_r, 48000), 16000)
            words = [str(r.choice(slot)) for slot in GRID_WORDS]
            lines, t = ["0 9375 sil"], 9375
            for w in words:
                lines.append(f"{t} {t + 9375} {w}")
                t += 9375
            lines.append(f"{t} 75000 sil")
            with open(os.path.join(adir, name + ".align"), "w") as f:
                f.write("\n".join(lines) + "\n")


def counts():
    from avsync_torch.ops.cuda import convpool, gru, mfcc

    return {"conv1_pool": convpool.launches, "gru_fwd": gru.launches,
            "gru_bwd": gru.bwd_launches, "conv1_pool_bwd": convpool.bwd_launches,
            "mel_stats": mfcc.launches}


def zero_counts():
    from avsync_torch.ops.cuda import convpool, gru, mfcc

    convpool.launches = convpool.bwd_launches = gru.launches = gru.bwd_launches = 0
    mfcc.launches = 0


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
    from avsync_torch.train.lipnet_trainer import (device_batch, fp32_step, make_optimizer,
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
    common = ["--data_path", data, "--config", cfg_path]
    results = os.path.join(workdir, "results.json")
    zero_counts()
    t0 = time.perf_counter()
    rc = [cli.main(["train", *common, "--epochs", "2", "--checkpoint_dir", ck]),
          cli.main(["train", *common, "--epochs", "3", "--checkpoint_dir", ck,
                    "--resume", "auto"]),
          cli.main(["test", *common, "--checkpoint", ck, "--output", results])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = counts()
    if rc != [0, 0, 0]:
        raise SystemExit(f"cli train/resume/test returned {rc}")
    steps = 3 * steps_per_epoch
    forwards = 3 * val_b + 3 * test_b  # validation per epoch, a test pass per command
    want = {"conv1_pool": steps + forwards, "gru_fwd": 2 * (steps + forwards),
            "gru_bwd": 2 * steps, "conv1_pool_bwd": steps, "mel_stats": 0}
    print(f"  train 2 epochs + resume 1 + test: wall_s={wall:.2f}, {steps} train steps, "
          f"{forwards} eval forwards", flush=True)
    print(f"  launches: {got} (expected {want}: per train step conv1_pool 1, gru_fwd 2, "
          f"gru_bwd 2 (each also runs its reduction kernel), conv1_pool_bwd 1; per eval "
          f"forward conv1_pool 1, gru_fwd 2)", flush=True)
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
    from avsync_torch.predictor import load_lipnet
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
    steps = det.epochs * math.ceil(plan * len(train_p) / det.batch_size)
    evals = (det.epochs * math.ceil(plan * len(val_p) / det.batch_size)
             + math.ceil(plan * len(test_p) / det.batch_size))
    sweep_rows = math.ceil(len(paths) / cli._SWEEP_CLIP_CHUNK) * (1 + 16)
    print(f"detector training slice: full width, {len(paths)} clips with audio "
          f"(train {len(train_p)}, val {len(val_p)}, test {len(test_p)}), the LipNet trained "
          f"above, batch {det.batch_size}, {det.epochs} epochs", flush=True)
    common = ["--data_path", data, "--config", cfg_path, "--checkpoint", ck,
              "--detector_checkpoint", det_path]
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
            "mel_stats": steps + evals + sweep_rows}
    print(f"  misalign-train + misalign-eval: wall_s={wall:.2f}; launches {got} (expected "
          f"{want}: conv1_pool once per bank batch of {bsz} clips ({bank_batches}), mel_stats "
          f"once per train step ({steps}), eval batch ({evals}) and sweep row "
          f"({sweep_rows}))", flush=True)
    if got != want:
        raise SystemExit("detector launch counts do not match what the commands ran")
    (run,) = os.listdir(logs)
    written = sorted(os.listdir(os.path.join(logs, run)))
    with open(sweep_json) as f:
        sweep = json.load(f)
    aurocs = list(sweep["auroc_by_shift"].values()) + [sweep["overall_auroc"]]
    print(f"  log folder {written}; sweep over {sweep['num_clips']} clips: overall AUROC "
          f"{sweep['overall_auroc']:.4f} (random LipNet and a 2-epoch detector on noise: "
          f"a check of the path, not of accuracy)", flush=True)
    if (not {"checkpoint_epoch_1.pth", "checkpoint_epoch_2.pth", "detector.pth"} <= set(written)
            or sweep["num_clips"] != len(paths) or len(sweep["auroc_by_shift"]) != 16
            or not all(np.isfinite(aurocs))):
        raise SystemExit("the detector run left the wrong snapshots or sweep")

    # one step, kernel path vs plain path: same weights, same batch, dropout 0
    lipnet = load_lipnet(cfg, cli._load_state_dict(ck), dev)
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
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}", flush=True)

    from avsync_torch.ops.cuda import build

    names = ["conv1_pool", "gru_fwd", "gru_bwd", "conv1_pool_bwd", "mel_stats"]
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
    for k in (k1, k2, k3, k4):
        k["launches"] = trained[k["name"]]
    k5["launches"], k5["launches_serving"] = detector["mel_stats"], served["mel_stats"]
    k1["launches_detector"] = detector["conv1_pool"]
    k1["launches_detector_serving"] = served["conv1_pool"]
    for k in (k1, k2, k3, k4, k5):
        if not k["launches"] or k.get("launches_serving") == 0:
            raise SystemExit(f"{k['name']} was not launched on its main path")

    print("kernels: K1 conv1_pool_fused (avsync/ops/pallas/convpool.py:100)=ported+checked; "
          "K2 pallas_gru_scan (avsync/ops/pallas/gru.py:357)=ported+checked; "
          "K3 pallas_gru_bwd (avsync/ops/pallas/gru.py:276)=ported+checked; "
          "K4 conv1_pool_bwd (avsync/ops/pallas/convpool.py:244)=ported+checked; "
          "K5 pallas_mel_stats (avsync/ops/pallas/mfcc.py:60)=ported+checked", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{**{k: d[k] for k in keys},
                         **{k: v for k, v in d.items() if k not in keys}}
                        for d in (k1, k2, k3, k4, k5)]}
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
