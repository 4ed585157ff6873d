#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):
  1. card: nvidia-smi name and power limit, torch/CUDA versions, TF32 flags
     (both set off: the port computes in full fp32);
  2. build: nvcc builds every kernel of the serving and training paths from
     avsync_torch/csrc/ (one process per source, started together);
  3. kernels: each kernel (K1 conv1_pool, K2 gru_fwd, K3 gru_bwd, K4
     conv1_pool_bwd) against its plain PyTorch version on the card, at the
     main paths' shapes and at odd ones, with the tolerance beside the max
     error, and for K3/K4 a repeat launch that must give the same bits; then
     kernel / plain / library times (CUDA events, warm-up first, median of
     20 runs) and the bound (least time the card could take: bytes over
     3.35 TB/s or fp32 operations over 67 TFLOP/s);
  4. serving slice: LipReader + TranscribeService at the full default width
     with both kernel flags on and seeded random weights (numpy draw in the
     JAX package's layout, through the weight bridge); 64 concurrent
     requests from 16 threads, half native 288x360 frames (heuristic mouth
     crop), half 50x100 crops. The four launch counters are zeroed just
     before and read just after; each batch must launch conv1_pool once and
     gru_fwd once per BiGRU layer, and no backward kernel. Log-probs are held
     against the same reader with both flags off (plain path, on the card);
  5. training slice: a GRID-layout corpus of (75, 50, 100) uint8 clips
     written with numpy; `cli train` at full width with both kernel flags on
     for 2 epochs with a checkpoint, `--resume auto` for a third, `cli test`;
     the counters zeroed before and checked after against the steps taken;
     one step of the kernel path against the plain path (loss and every
     gradient); TF32 read from inside train_step's backward; the loss falling
     over 20 steps on one repeated batch; the train step's time on both paths;
  6. the kernels: a text line with the state of every TPU kernel of the
     JAX package, and one JSON line with the measured numbers (launches from
     the training slice, the serving slice's beside them for K1/K2);
  7. the card's name/power line, then the status JSON as the last line.

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
MAX_BATCH = 8  # the slice's TranscribeService(max_batch=8)
BUCKETS = (1, 2, 4, 8)  # the padded batch sizes it can form


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
    # at the serving shape, then odd shapes and the generic (untemplated) path
    shapes = [(B, 75, 50, 100, (3, 5, 5), 32) for B in BUCKETS]
    shapes += [(3, 7, 10, 18, (3, 3, 3), 5), (2, 4, 12, 70, (1, 3, 5), 7),
               (1, 1, 2, 2, (3, 5, 5), 32)]
    for B, T, H, W, k, C in shapes:
        x = torch.rand(B, T, H, W, 1, generator=g).to(dev)
        bound = 1.0 / (k[0] * k[1] * k[2]) ** 0.5
        w = ((torch.rand(*k, 1, C, generator=g) * 2 - 1) * bound).to(dev)
        b = ((torch.rand(C, generator=g) * 2 - 1) * bound).to(dev)
        want = convpool.conv1_pool_ref(x, w, b)
        errs.append(max_err(convpool.conv1_pool_fused(x, w, b), want, K1_TOL,
                            f"B={B} T={T} {H}x{W} k={k} C={C} (B,T,H,W,C) layout"))
        x_n = x.permute(0, 4, 1, 2, 3)
        w_n = w.permute(4, 3, 0, 1, 2).contiguous()
        errs.append(max_err(convpool.conv1_pool_block(x_n, w_n, b),
                            want.permute(0, 4, 1, 2, 3), K1_TOL,
                            f"B={B} T={T} {H}x{W} k={k} C={C} NCDHW layout"))

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
    n_pre = B * T * H * W * C
    n_bytes = 4 * (B * T * H * W + w.numel() + C + B * T * (H // 2) * (W // 2) * C)
    n_ops = n_pre * (2 * 75 + 2)  # 75 FMAs, bias add, pool compare per pre-pool value
    bms, by = bound_ms(n_bytes, n_ops)
    print(f"  B=8 T=75 50x100 C=32: kernel_ms={ms:.4f} plain_ms={plain:.4f} "
          f"library_ms={lib_ms:.4f} bound_ms={bms:.4f} ({by}: {n_bytes / 1e6:.1f} MB, "
          f"{n_ops / 1e9:.2f} GFLOP)", flush=True)
    return dict(name="conv1_pool", route="cuda", source="avsync_torch/csrc/conv1_pool.cu",
                replaces="avsync/ops/pallas/convpool.py:100", max_abs_err=max(errs),
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                shape="B=8 T=75 50x100 C=32 k=3x5x5")


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
    for B, T, H in [(B, 75, 256) for B in BUCKETS] + [(3, 75, 256), (12, 9, 256), (2, 5, 8)]:
        gf, wf, bf = case(B, T, H)
        gb, wb, bb = case(B, T, H)
        want = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False),
                          gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
        errs.append(max_err(gru.bigru_recurrence(gf, gb, wf, wb, bf, bb), want, K2_TOL,
                            f"both directions B={B} T={T} H={H}"))
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

    # times at the serving path's shape: one BiGRU layer, B=8, T=75, H=256
    B, T, H, D = 8, 75, 256, 6912
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
          f"per_step_us={ms / T * 1e3:.2f}", flush=True)
    print(f"  BiGRU layer D=6912: port (2 matmuls + kernel) layer_ms={layer_ms:.4f} "
          f"torch.nn.GRU library_ms={lib_ms:.4f}", flush=True)
    return dict(name="gru_fwd", route="cuda", source="avsync_torch/csrc/gru_fwd.cu",
                replaces="avsync/ops/pallas/gru.py:357", max_abs_err=max(errs),
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                layer_ms=layer_ms, shape="both directions B=8 T=75 H=256",
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
    for B, T, H in [(B, 75, 256) for B in BUCKETS] + [(8, 1, 256), (8, 7, 256), (2, 5, 8)]:
        args, H = case(B, T, H)
        got = gru.bigru_recurrence_bwd(*args)
        for i, want in enumerate(plain(args, H)):
            what = ("dgi", "dgi", "dw_hh", "dw_hh", "db_hh", "db_hh")[i]
            errs.append(max_err(got[i], want, K3_TOL if i < 2 else K3_SUM_TOL,
                                f"{what} {'fwd' if i % 2 == 0 else 'rev'} B={B} T={T} H={H}"))
        if (B, T) == (8, 75):
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
    return dict(name="gru_bwd", route="cuda", source="avsync_torch/csrc/gru_bwd.cu",
                replaces="avsync/ops/pallas/gru.py:276", max_abs_err=max(errs),
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=lib_ms,
                layer_ms=layer_ms, shape="both directions B=8 T=75 H=256",
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
    shapes = [(B, 75, 50, 100, (3, 5, 5), 32) for B in BUCKETS]
    shapes += [(3, 7, 10, 18, (3, 3, 3), 5), (2, 4, 12, 70, (1, 3, 5), 7),
               (1, 1, 2, 2, (3, 5, 5), 32)]
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
        if B == 8:
            same_bits(got, convpool.conv1_pool_bwd(x, w, b, cot), f"B={B} T={T} {H}x{W}")
    # the tie case: constant input, every interior pool window a 4-way tie;
    # the gradient goes to the first window position
    x = torch.ones(1, 3, 4, 4, 1, device=dev)
    w = (torch.rand(3, 3, 3, 1, 2, generator=g) - 0.2).to(dev)
    b = torch.rand(2, generator=g).to(dev)
    cot = 2 * convpool.conv1_pool_ref(x, w, b)
    for name, a, r in zip(("dkernel", "dbias"), convpool.conv1_pool_bwd(x, w, b, cot),
                          convpool.conv1_pool_bwd_ref(x, w, b, cot)):
        errs.append(max_err(a, r, K4_TOL, f"{name} tie case (constant input)"))

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
            or got["gru_bwd"] or got["conv1_pool_bwd"]):
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


def write_grid_corpus(root: str, n_speakers: int, clips: int, seed: int):
    """A GRID-layout corpus (<root>/sN/video/*.npy + <root>/sN/align/*.align)
    of (75, 50, 100) uint8 mouth crops and GRID-grammar transcripts, drawn
    with numpy from `seed`."""
    import numpy as np

    r = np.random.default_rng(seed)
    for s in range(1, n_speakers + 1):
        vdir, adir = (os.path.join(root, f"s{s}", d) for d in ("video", "align"))
        os.makedirs(vdir)
        os.makedirs(adir)
        for c in range(clips):
            name = f"clip{c:03d}"
            np.save(os.path.join(vdir, name + ".npy"),
                    r.integers(0, 256, (75, 50, 100), dtype=np.uint8))
            words = [str(r.choice(slot)) for slot in GRID_WORDS]
            lines, t = ["0 9375 sil"], 9375
            for w in words:
                lines.append(f"{t} {t + 9375} {w}")
                t += 9375
            lines.append(f"{t} 75000 sil")
            with open(os.path.join(adir, name + ".align"), "w") as f:
                f.write("\n".join(lines) + "\n")


def counts():
    from avsync_torch.ops.cuda import convpool, gru

    return {"conv1_pool": convpool.launches, "gru_fwd": gru.launches,
            "gru_bwd": gru.bwd_launches, "conv1_pool_bwd": convpool.bwd_launches}


def zero_counts():
    from avsync_torch.ops.cuda import convpool, gru

    convpool.launches = convpool.bwd_launches = gru.launches = gru.bwd_launches = 0


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
            "gru_bwd": 2 * steps, "conv1_pool_bwd": steps}
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

    names = ["conv1_pool", "gru_fwd", "gru_bwd", "conv1_pool_bwd"]
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
    k1["launches_serving"], k2["launches_serving"] = run_slice(dev)
    with tempfile.TemporaryDirectory() as workdir:
        trained = run_training(dev, workdir)
    for k in (k1, k2, k3, k4):
        k["launches"] = trained[k["name"]]
        if not k["launches"] or k.get("launches_serving") == 0:
            raise SystemExit(f"{k['name']} was not launched on its main path")

    print("kernels: K1 conv1_pool_fused (avsync/ops/pallas/convpool.py:100)=ported+checked; "
          "K2 pallas_gru_scan (avsync/ops/pallas/gru.py:357)=ported+checked; "
          "K3 pallas_gru_bwd (avsync/ops/pallas/gru.py:276)=ported+checked; "
          "K4 conv1_pool_bwd (avsync/ops/pallas/convpool.py:244)=ported+checked; "
          "K5 pallas_mel_stats (avsync/ops/pallas/mfcc.py:60)=not yet ported "
          "(detector slice)", flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    line = {"kernels": [{**{k: d[k] for k in keys},
                         **{k: v for k, v in d.items() if k not in keys}}
                        for d in (k1, k2, k3, k4)]}
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
