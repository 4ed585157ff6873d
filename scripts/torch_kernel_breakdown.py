#!/usr/bin/env python3
"""Where the time of the port's kernels goes, and each kernel against an
earlier design, on one GPU. Modes:

    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_breakdown.py --parent build/parent [--out k.json]
    python3 scripts/torch_kernel_breakdown.py --mode k5 --parent build/parent [--out k.json]
    python3 scripts/torch_kernel_breakdown.py --mode q1 [--blocks tf|lipnet|both]
        [--parent DIR] [--out k.json]
    python3 scripts/torch_kernel_breakdown.py --mode conv1-bf16 [--parent DIR] [--out k.json]
    python3 scripts/torch_kernel_breakdown.py --mode k2-bf16 [--out k.json]
    python3 scripts/torch_kernel_breakdown.py --mode k3-h0 --parent DIR [--out k.json]
    python3 scripts/torch_kernel_breakdown.py --mode conv1-tf [--parent DIR] [--out k.json]

`--parent` is the root of an unpacked checkout whose `avsync_torch/csrc/`
holds the earlier design. The default mode (`lipnet`) takes the LipNet
kernels of commit 6ec0e61, whose C interfaces its launchers follow; `--mode
k5` takes K5 (fused mel -> dB -> DCT -> statistics) of commit 5e863d4 (one
CTA per clip).

Mode `k5`:
  * builds the earlier mel_stats.cu and variants with one part cut out (no
    band sums, no DCT, no staging loads of the power rows, an empty kernel,
    no launch at all: the host's share of the event window), and the same
    cuts of the current design; prints ptxas' register report for each;
  * times each at the detector's shapes (F=121, K=1025, M=128, C=20, every
    clip's 121 frames valid) at B = 32 (a train step) and 512 (an eval
    chunk): CUDA events around one call (warm-up first, median of 20), and
    device time per call from torch.profiler; the earlier design is called
    as its wrapper called it (output allocated per call), the current one
    through the package's wrapper (cut variants swapped in);
  * times the current design's grid choices in device time: 16, 32, 64 or
    128 rows per CTA (the cluster's size), each with 16- and 8-row slabs,
    at B = 32 and 512 (F=121) and B = 8 at F = 401;
  * times the earlier design against the current wrapper in turns:
    earlier, current, current, earlier, at B = 32, 40 and 512.

Mode `q1` (the int8 conv + dequant + ReLU + pool block of int8 serving),
`--blocks tf|lipnet|both` (default both) and optionally `--parent DIR`, the
root of a checkout whose int8_conv_pool.cu has commit d3be8d9's C interface
(a tile, no B ring):
  * builds int8_conv_pool.cu (and DIR's) and prints ptxas' register report;
  * at each family's three blocks at full width, B=8, T=75, in the
    contracts and layouts the int8 forward gives them (conv1 f32 NCDHW in,
    int8 out; conv2 int8 in and out; conv3 int8 in, f32 out; channels-last
    between blocks; static scales calibrated on the input), prints the
    planner's tile, warps, CTAs per SM, shared memory, estimate and the
    weight bytes it reckons per CTA and frame and per launch (DIR's too);
  * sweeps forced tiles (`tile_for` swapped): the planner's best few by its
    estimate, at every stage size of the B ring where Cin % 16 == 0; each
    held equal to the plain version bit for bit, timed on the device alone
    (`queued_ms`: the launch queued behind a device spin, CUDA events,
    median of 20);
  * with `--parent`, each block and the whole chain against DIR's Q1 (its
    wrapper's tiles) in turns (parent, current, current, parent) by
    `queued_ms`, after holding both to the plain version; at LipNet's
    blocks the chain with the bf16 epilogue too.

Mode `conv1-bf16` (K1-bf16 and K4-bf16, the conv1 block under bf16 on the
tensor cores, csrc/conv1_mma.cuh):
  * builds conv1_pool.cu and conv1_pool_bwd.cu with one part cut out (K1:
    no MMA task loop, no stores of the pooled tile, no staging of the next
    frame; K4: no recompute and routing, no dW product, no cotangent
    loads), and with `--parent DIR` DIR's two sources (the same C entries,
    called with DIR's wrapper's grids: `fwd_grid` and `bwd_grid` of its
    convpool.py); prints ptxas' register report for each;
  * at LipNet's shape in NCDHW (T=75, 50x100, C=32, 3x5x5 taps, bf16 x,
    weights and cotangent, float32 bias), B=8: each cut variant through
    the package's wrapper with the variant swapped in, in device time
    (`queued_ms`: the launch queued behind a device spin, CUDA events, median
    of 20) and the profiler's device time per call;
  * with `--parent`, the parent's K1-bf16 and K4-bf16 against the current
    ones in turns (parent, current, current, parent), `queued_ms`, at B = 8
    and 128, after checking both against the plain versions (K1's share of
    elements equal, K4's largest difference).

Mode `k2-bf16` (K2's recurrence with bf16 operands, int8 serving under
bf16; csrc/gru_fwd.cu's bf16 flag):
  * builds gru_fwd.cu whole and with its per-step product cut out (each
    lane's FMAs over its slice of h; the exchange, the butterfly over the
    k lanes and the gates stay), one nvcc each, and prints ptxas' register
    report;
  * at LipNet's shape (both directions, T=75, H=256) at B = 1 and 8, times
    both through the package's wrapper with the variant swapped in, with
    bf16 operands and in float32, in turns (whole, cut, cut, whole):
    `queued_ms` and the profiler's device time per call, each turn and
    their means. The product's share of a step is 1 - cut / whole.

Mode `k3-h0` (K3 with the initial state h0 and its gradient dh0, the
context-parallel chain's backward): builds DIR's gru_bwd.cu (commit
6d60f39's C interface, without h0 and dh0) beside the package's, checks at
LipNet's shape (both directions, B=8, T=75, H=256) that the current call
without h0 gives the parent's bits (torch.equal on dgi, dW_hh, db_hh), and
times the parent, the current call without h0 and with h0 + dh0 in turns
(parent, current, h0, h0, current, parent): `queued_ms` and the profiler's
device time per call.

Mode `conv1-tf` (the TF stack's conv1 block in float32: Cin 1, 128 channels,
3x3x3, 46x140, B=8, T=75, NCDHW as the model calls it), optionally `--parent
DIR`, a checkout whose K4 takes at most 32 channels (its TF conv1 ran on
cuDNN):
  * prints K1's and K4's grids (and DIR's wrapper's);
  * holds K1 to its plain version bit for bit (torch.equal), K4's dW and db
    to theirs (largest differences, and within K4_TOL: atol 1e-3, rtol
    1e-4), a repeat launch of each to the same bits, and cuDNN's block to
    K1 (largest difference);
  * times on the device alone (`queued_ms`) and by profiler device time:
    K1, K4, and cuDNN's block as the model ran it before (forward: conv3d,
    ReLU, `max_pool3d_with_indices`, TF32 off; backward: autograd of that
    block for dW and db under the trainers' `train_scope`, cuDNN
    deterministic); then cuDNN's block (forward + backward) against K1 + K4
    in turns (cuDNN, fused, fused, cuDNN); and K4 with a part cut out (no dW
    product, no recompute, neither: staging, cotangent loads and barriers),
    through the wrapper with the cut library swapped in;
  * with `--parent`, DIR's K1 at the TF shape with its wrapper's grid
    against the current K1 in turns, and at LipNet's shape (B=8, 50x100,
    32 channels, 3x5x5) DIR's K1, K4, K1-bf16 and K4-bf16 against the
    current ones: torch.equal on every output, and each pair in turns.

Mode `lipnet`:
  * builds the earlier design's four LipNet kernels and variants of its K3 and K1
    with parts cut out (text patches below; each variant computes a wrong
    result and is only timed), one nvcc per source, all started together,
    and prints ptxas' register report for each;
  * checks whether the earlier K1 and the current one equal their plain
    version bit for bit at B=8 (torch.equal);
  * times, at the LipNet training shapes (K3, K2: both directions, T=75,
    H=256; K1, K4: T=75, 50x100, C=32, 3x5x5 taps, NCDHW), every variant
    at B=8, then each kernel's earlier design (called as its wrapper did:
    outputs allocated per call) against the package's current wrapper in
    turns: earlier, current, current, earlier; K1 and K2 also at B=1.
Each time: CUDA events around one call, warm-up first, median of 20. The
parts follow by difference: K3's gh product per step = (k3_full -
k3_no_gh) / 75, its reduction kernel = k3_full - k3_chain_only, the host's
share of the event window = k3_host_only; K1's compute = k1_full -
k1_staging_only. The host's share is noisy; the profiler's device time of
each kernel per call (earlier and current K3 and K1) has none. Needs a GPU
and nvcc; prints one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT_DIR = Path(ROOT) / "build" / "kernel_breakdown"
T = 75

# where a variant drops the step's cluster barrier, one at the end keeps every
# CTA alive until its peers' last stores have landed
FINAL_SYNC = ("    cur ^= 1;\n  }\n}", "    cur ^= 1;\n  }\n  cluster.sync();\n}")
PUSH = ("*cluster.map_shared_rank(snd + b * U + (j % U), owner) = acc[b];",
        "snd[b * U + (j % U)] = acc[b] + owner;")
BARRIER = ("cluster.sync();  // partials delivered everywhere; buffers free to reuse",
           "__syncthreads();")
NO_REDUCE = ("gru_bwd_reduce_kernel<<<grid, NT, 0, s>>>(p);", "(void)grid;")
NO_CHAIN = ("case 8: e = launch_chain<8>(p, ndir, s); break;", "case 8: e = cudaSuccess; break;")
# name -> [(text to replace, replacement), ...] on the earlier design's gru_bwd.cu
K3_VARIANTS = {
    "k3_full": [],
    # the gh = h_prev W_hh recompute's product
    "k3_no_gh": [("for (int k = k0; k < k1; ++k) {", "for (int k = k0; k < k0; ++k) {")],
    # the dh = dgh W_hh^T product
    "k3_no_dh": [("for (int c = 0; c < U3; ++c) {", "for (int c = 0; c < 0; ++c) {")],
    # the finalize phase: receive sum, s_red sum, gate math, dgi/dgh stores
    "k3_no_finalize": [("if (fin) {\n      if (s > 0) {", "if (fin && s < 0) {\n      if (s > 0) {")],
    # the partials go to the CTA's own buffer (dh is wrong)
    "k3_no_push": [PUSH],
    # the step's cluster barrier becomes a CTA barrier (a race: dh is wrong)
    "k3_no_cluster_sync": [BARRIER, FINAL_SYNC],
    "k3_no_exchange": [PUSH, BARRIER, FINAL_SYNC],
    # no per-step h_prev staging (the product reads a stale buffer)
    "k3_no_staging": [("if (i > 0) stage_hprev(i - 1, cur ^ 1, true);  // overlaps this step",
                       "(void)0;")],
    # one of the launch's two kernels (B=8 takes 8 rows per cluster)
    "k3_chain_only": [NO_REDUCE],
    "k3_reduce_only": [NO_CHAIN],
    # neither kernel: the host's work inside the event window
    "k3_host_only": [NO_REDUCE, NO_CHAIN],
}
K1_VARIANTS = {
    "k1_full": [],
    # weight, bias and halo staging and the barrier; no FMA and no store
    "k1_staging_only": [("for (int c0 = 0; c0 < p.C; c0 += CB) {",
                         "for (int c0 = 0; c0 < 0; c0 += CB) {")],
}

# the same kind of cuts of the current design (avsync_torch/csrc/), timed
# through the package's wrappers with the cut library swapped in
GH = ("  gru_bwd_gh_kernel<<<dim3((H3 + TN - 1) / TN, (M + TM - 1) / TM, ndir), NT, 0, s>>>(p);",
      "  (void)M;")
CHAIN = ("  if ((e = launch_chain_any(p, device, s)) != cudaSuccess) return static_cast<int>(e);",
         "")
DW = ("""  gru_bwd_dw_kernel<<<dim3((H3 + TN - 1) / TN, (H + TM - 1) / TM, ndir * n_chunks), NT, 0,
                      s>>>(p);""", "")
SUM = ("  gru_bwd_sum_kernel<<<(unsigned)((n_out + NT - 1) / NT), NT, 0, s>>>(p);", "(void)n_out;")
CUR_K3_VARIANTS = {
    "cur_k3_no_gh": [GH],
    "cur_k3_chain_only": [GH, DW, SUM],
    "cur_k3_no_chain": [CHAIN],
    "cur_k3_host_only": [GH, CHAIN, DW, SUM],
    # the chain without its dh product (dh = a z only)
    "cur_k3_no_product": [("        if (NK == 0 && c >= nk) break;", "        if (c >= 0) break;")],
}
CUR_K1_VARIANTS = {
    "cur_k1_staging_only": [("for (int c0 = 0; c0 < p.C; c0 += CB) {",
                             "for (int c0 = 0; c0 < 0; c0 += CB) {")],
}

# K5: cuts of the earlier design's mel_stats.cu (commit 5e863d4)
K5_VARIANTS = {
    "k5_full": [],
    "k5_no_bands": [("for (int j = 0; j < len; ++j) acc", "for (int j = 0; j < 0; ++j) acc")],
    "k5_no_dct": [("for (int m = 0; m < p.M; ++m) acc", "for (int m = 0; m < 0; ++m) acc")],
    "k5_no_staging": [("for (int i0 = tid; i0 < total; i0 += NT * LOADS) {",
                       "for (int i0 = tid; i0 < 0; i0 += NT * LOADS) {")],
    "k5_launch_only": [("  extern __shared__ float smem[];\n",
                        "  if (p.B > 0) return;\n  extern __shared__ float smem[];\n")],
    "k5_host_only": [("  mel_stats_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);",
                      "  (void)p;")],
}
# the same cuts of the current design (avsync_torch/csrc/mel_stats.cu)
CUR_K5_VARIANTS = {
    "cur_k5_no_bands": [("for (int j = 0; j < len; ++j) acc", "for (int j = 0; j < 0; ++j) acc")],
    "cur_k5_no_dct": [("for (int m = 0; m < M; ++m) {", "for (int m = 0; m < 0; ++m) {")],
    "cur_k5_no_staging": [("for (int i = tid; i < chunks; i += NT) cp_async16",
                           "for (int i = tid; i < 0; i += NT) cp_async16")],
    "cur_k5_launch_only": [("  extern __shared__ __align__(16) float smem[];\n",
                            "  if (p.F > 0) return;\n"
                            "  extern __shared__ __align__(16) float smem[];\n")],
    "cur_k5_host_only": [("  e = cudaLaunchKernelEx(&cfg, mel_stats_kernel, p);", "  (void)cfg;")],
}
# the earlier K5's C entry: (power, n_valid, band_lo, band_len, band_off,
# wpack, dct, out, B, F, K, M, C, R, top_db, device, stream)
K5_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
               + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
K5_SHAPES = (32, 512)  # clips per call: a detector train step, an eval chunk
K5_F = 121


# the earlier design's C entries (commit 6ec0e61)
K1_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_longlong] * 11
               + [ctypes.c_int, ctypes.c_void_p])
K2_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 7
               + [ctypes.c_int] * 6 + [ctypes.c_void_p])
K3_ARGTYPES = ([ctypes.c_void_p] * 18 + [ctypes.c_longlong] * 10
               + [ctypes.c_int] * 6 + [ctypes.c_void_p])
K4_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_longlong] * 13
               + [ctypes.c_int, ctypes.c_void_p])


def build_variants(specs):
    """Write and compile every variant of `specs` ((source dir, kernel name,
    {variant: patches}, C symbol, argtypes), ...), all nvcc processes at
    once; returns {variant: (ctypes function, ptxas lines)}."""
    from avsync_torch.ops.cuda import build

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    for root, src_name, variants, symbol, argtypes in specs:
        text = (root / f"{src_name}.cu").read_text()
        for name, patches in variants.items():
            src = text
            for old, new in patches:
                if old not in src:
                    raise SystemExit(f"{name}: patch target not in {src_name}.cu: {old!r}")
                src = src.replace(old, new)
            sources[name] = (src, symbol, argtypes, root)
    jobs = {}  # every patch applied: now compile
    for name, (src, symbol, argtypes, root) in sources.items():
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(src)
        # each source's headers come from its own csrc/
        proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(root),
                                 "-o", str(so), str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so, symbol, argtypes)
    out = {}
    for name, (proc, so, symbol, argtypes) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "Function properties" in ln]
        out[name] = (fn, regs)
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
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


def queued_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() with its launches queued behind a
    device-side spin (~0.5 ms): the device's work, not the host's launch
    (as chip_smoke.py's)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def device_ms(fn, n: int = 10):
    """Device time per call of each CUDA kernel fn() launches (torch.profiler
    over n calls after a warm-up): the split without the host's share."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)):
            per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                    + evt.time_range.elapsed_us() / 1e3 / n)
    return per_kernel


def swapped(key, fn, call):
    """call() with the package wrapper's library function `key` swapped for fn."""
    from avsync_torch.ops.cuda import build

    def run():
        real = build._fns[key]
        build._fns[key] = fn
        try:
            call()
        finally:
            build._fns[key] = real
    return run


def checked(err, what):
    if err:
        raise SystemExit(f"{what} launch failed: CUDA error {err}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", default=None, help="root of the earlier design's checkout")
    ap.add_argument("--mode", choices=("lipnet", "k5", "q1", "conv1-bf16", "k2-bf16", "k3-h0",
                                       "conv1-tf"),
                    default="lipnet",
                    help="lipnet: K1-K4 against 6ec0e61; k5: K5 against 5e863d4; q1: Q1 "
                         "(int8 serving): tiles, a sweep of forced tiles, against --parent "
                         "in turns if given; "
                         "conv1-bf16: K1-bf16 and K4-bf16 cut into parts, against --parent "
                         "if given; k2-bf16: K2's per-step product cut out; k3-h0: K3 "
                         "without h0 against --parent's, and with h0; conv1-tf: K1 and K4 "
                         "at the TF stack's conv1 against cuDNN's block (and --parent)")
    ap.add_argument("--blocks", choices=("tf", "lipnet", "both"), default="both",
                    help="q1: the family whose three blocks to time")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    if args.parent is None and args.mode not in ("q1", "conv1-bf16", "k2-bf16", "conv1-tf"):
        ap.error(f"--mode {args.mode} needs --parent")
    parent = Path(args.parent).resolve() if args.parent else None
    blocks = ("tf", "lipnet") if args.blocks == "both" else (args.blocks,)
    out = {"k5": k5_breakdown, "q1": lambda p, d: q1_breakdown(p, d, blocks),
           "lipnet": lipnet_breakdown,
           "conv1-bf16": conv1_bf16_breakdown, "k2-bf16": k2_bf16_breakdown,
           "k3-h0": k3_h0_breakdown, "conv1-tf": conv1_tf_breakdown}[args.mode](
               parent, dev)
    text = json.dumps({"card": card, "torch": torch.__version__, **out}, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


def lipnet_breakdown(parent: Path, dev):
    import torch

    from avsync_torch.ops.cuda import build, convpool, gru

    stream = torch.cuda.current_stream(dev).cuda_stream
    csrc = parent / "avsync_torch" / "csrc"
    fns = build_variants((
        (csrc, "gru_bwd", K3_VARIANTS, "avs_gru_bwd", K3_ARGTYPES),
        (csrc, "conv1_pool", K1_VARIANTS, "avs_conv1_pool", K1_ARGTYPES),
        (csrc, "gru_fwd", {"k2_full": []}, "avs_gru_fwd", K2_ARGTYPES),
        (csrc, "conv1_pool_bwd", {"k4_full": []}, "avs_conv1_pool_bwd", K4_ARGTYPES),
        (build.CSRC, "gru_bwd", CUR_K3_VARIANTS, "avs_gru_bwd", gru._BWD_ARGTYPES),
        (build.CSRC, "conv1_pool", CUR_K1_VARIANTS, "avs_conv1_pool", convpool._ARGTYPES)))
    names = ["conv1_pool", "gru_fwd", "gru_bwd", "conv1_pool_bwd"]
    build.build(names)
    out = {"ptxas_earlier": {k: v[1] for k, v in fns.items()},
           "ptxas_current": {n: [ln.strip() for ln in build.build_log(n).splitlines()
                                 if "registers" in ln or "spill" in ln] for n in names}}
    g = torch.Generator().manual_seed(0)

    # K1 and K4 at the LipNet shape, NCDHW as the model calls them
    def conv_case(B):
        C, taps = 32, 75
        x = torch.rand(B, 1, T, 50, 100, generator=g).to(dev)
        w = ((torch.rand(C, 1, 3, 5, 5, generator=g) * 2 - 1) * taps ** -0.5).to(dev)
        b = ((torch.rand(C, generator=g) * 2 - 1) * taps ** -0.5).to(dev)
        cot = torch.randn(B, C, T, 25, 50, generator=g).to(dev)
        return x, w, b, cot

    def k1_old(fn, case):
        x, w, b, _ = case
        B = x.shape[0]

        def run():
            o = torch.empty(B, 32, T, 25, 50, device=dev)
            checked(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
                       B, T, 50, 100, 3, 5, 5, 32, x.stride(0), x.stride(2), x.stride(3),
                       x.stride(4), 1, 75, o.stride(0), o.stride(2), o.stride(3), o.stride(4),
                       o.stride(1), dev.index, stream), "K1")
            return o
        return run

    def k1_new(case):
        x, w, b, _ = case
        return lambda: convpool.conv1_pool_block(x, w, b)

    def k4_old(fn, case):
        x, w, b, cot = case
        B = x.shape[0]
        rows, cols, tiles, chunks, _ = convpool.bwd_grid(B, T, 25, 50, 32)
        gs = cot.stride()

        def run():
            partial = torch.empty(tiles * chunks, 75 * 32 + 32, device=dev)
            dw, db = torch.empty_like(w), torch.empty(32, device=dev)
            checked(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), cot.data_ptr(),
                       partial.data_ptr(), dw.data_ptr(), db.data_ptr(),
                       B, T, 50, 100, 3, 5, 5, 32, chunks, rows, cols,
                       x.stride(0), x.stride(2), x.stride(3), x.stride(4), 1, 75,
                       gs[0], gs[2], gs[3], gs[4], gs[1], 1, 75, dev.index, stream), "K4")
        return run

    def k4_new(case):
        x, w, b, cot = case
        return lambda: convpool.conv1_pool_block_bwd(x, w, b, cot)

    # K2 and K3, both directions, H = 256
    def gru_case(B):
        Hh = 256
        k = Hh ** -0.5
        dirs = [(torch.randn(B, T, 3 * Hh, generator=g).to(dev),
                 ((torch.rand(Hh, 3 * Hh, generator=g) * 2 - 1) * k).to(dev),
                 ((torch.rand(3 * Hh, generator=g) * 2 - 1) * k).to(dev)) for _ in range(2)]
        (gf, wf, bf), (gb, wb, bb) = dirs
        o = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False),
                       gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
        cot = torch.randn(B, T, 2 * Hh, generator=g).to(dev)
        return dirs, o, cot

    def k2_old(fn, case):
        (gf, wf, bf), (gb, wb, bb) = case[0]
        B = gf.shape[0]

        def run():
            o = torch.empty(B, T, 512, device=dev)
            checked(fn(gf.data_ptr(), gb.data_ptr(), wf.data_ptr(), wb.data_ptr(),
                       bf.data_ptr(), bb.data_ptr(), o.data_ptr(), gf.stride(0), gf.stride(1),
                       wf.stride(0), wf.stride(1), o.stride(0), o.stride(1), 256,
                       B, T, 256, 2, 0b10, dev.index, stream), "K2")
        return run

    def k2_new(case):
        (gf, wf, bf), (gb, wb, bb) = case[0]
        return lambda: gru.bigru_recurrence(gf, gb, wf, wb, bf, bb)

    def k3_old(fn, case):
        (gf, wf, bf), (gb, wb, bb) = case[0]
        o, cot = case[1], case[2]
        B, H = gf.shape[0], 256
        outs, gs = (o[..., :H], o[..., H:]), (cot[..., :H], cot[..., H:])

        def run():
            dgi = torch.empty(2, B, T, 3 * H, device=dev)
            dgh = torch.empty(2, B, T, 3 * H, device=dev)
            dw = torch.empty(2, H, 3 * H, device=dev)
            db = torch.empty(2, 3 * H, device=dev)
            checked(fn(gf.data_ptr(), gb.data_ptr(), outs[0].data_ptr(), outs[1].data_ptr(),
                       gs[0].data_ptr(), gs[1].data_ptr(), wf.data_ptr(), wb.data_ptr(),
                       bf.data_ptr(), bb.data_ptr(), dgi[0].data_ptr(), dgi[1].data_ptr(),
                       dgh[0].data_ptr(), dgh[1].data_ptr(), dw[0].data_ptr(), dw[1].data_ptr(),
                       db[0].data_ptr(), db[1].data_ptr(), gf.stride(0), gf.stride(1),
                       o.stride(0), o.stride(1), cot.stride(0), cot.stride(1),
                       wf.stride(0), wf.stride(1), dw.stride(1), dw.stride(2),
                       B, T, H, 2, 0b10, dev.index, stream), "K3")
        return run

    def k3_new(case):
        (gf, wf, bf), (gb, wb, bb) = case[0]
        return lambda: gru.bigru_recurrence_bwd(gf, gb, case[1], case[2], wf, wb, bf, bb)

    conv = {b: conv_case(b) for b in (8, 1)}
    grus = {b: gru_case(b) for b in (8, 1)}

    # bit-for-bit: the earlier and the current K1 against the plain version
    x, w, b, _ = conv[8]
    plain = convpool.conv1_pool_ref(x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0), b)
    plain = plain.permute(0, 4, 1, 2, 3)
    earlier = k1_old(fns["k1_full"][0], conv[8])()
    current = convpool.conv1_pool_block(x, w, b)
    torch.cuda.synchronize()
    out["k1_B8_equals_plain"] = {"earlier": bool(torch.equal(earlier, plain)),
                                 "current": bool(torch.equal(current, plain)),
                                 "earlier_max_abs_err": (earlier - plain).abs().max().item(),
                                 "current_max_abs_err": (current - plain).abs().max().item()}

    k3_key, k1_key = ("gru_bwd", "avs_gru_bwd"), ("conv1_pool", "avs_conv1_pool")
    k3_new(grus[8])()
    k1_new(conv[8])()  # both wrappers' functions loaded
    variants = {}
    for name, (fn, _) in fns.items():
        if name.startswith("k3"):
            variants[name] = time_ms(k3_old(fn, grus[8]))
        elif name.startswith("k1"):
            variants[name] = time_ms(k1_old(fn, conv[8]))
        elif name.startswith("cur_k3"):
            variants[name] = time_ms(swapped(k3_key, fn, k3_new(grus[8])))
        elif name.startswith("cur_k1"):
            variants[name] = time_ms(swapped(k1_key, fn, k1_new(conv[8])))
    variants["cur_k3_full"] = time_ms(k3_new(grus[8]))
    variants["cur_k1_full"] = time_ms(k1_new(conv[8]))
    out["variants_ms_B8"] = variants
    out["k3_variants_us_per_step_B8"] = {k: v / T * 1e3 for k, v in variants.items()
                                         if "k3" in k}

    # device time per kernel, no host share: K3 and K1, earlier and current
    out["device_ms_per_call_B8"] = {
        "k3_earlier": device_ms(k3_old(fns["k3_full"][0], grus[8])),
        "k3_current": device_ms(k3_new(grus[8])),
        "k1_earlier": device_ms(k1_old(fns["k1_full"][0], conv[8])),
        "k1_current": device_ms(k1_new(conv[8])),
    }

    turns = {}
    pairs = [("k3_B8", k3_old(fns["k3_full"][0], grus[8]), k3_new(grus[8])),
             ("k1_B8", k1_old(fns["k1_full"][0], conv[8]), k1_new(conv[8])),
             ("k1_B1", k1_old(fns["k1_full"][0], conv[1]), k1_new(conv[1])),
             ("k4_B8", k4_old(fns["k4_full"][0], conv[8]), k4_new(conv[8])),
             ("k2_B8", k2_old(fns["k2_full"][0], grus[8]), k2_new(grus[8])),
             ("k2_B1", k2_old(fns["k2_full"][0], grus[1]), k2_new(grus[1]))]
    for name, old, new in pairs:
        turns[name] = {"earlier": [], "current": []}
        for side in ("earlier", "current", "current", "earlier"):
            turns[name][side].append(time_ms(old if side == "earlier" else new))
    out["turns_ms"] = turns
    out["us_per_step"] = {k: {s: [t / T * 1e3 for t in v] for s, v in d.items()}
                          for k, d in turns.items() if k.startswith(("k2", "k3"))}
    return out


def k5_breakdown(parent: Path, dev):
    import torch

    from avsync_torch.config import AudioConfig
    from avsync_torch.ops import audio
    from avsync_torch.ops.cuda import build, mfcc

    stream = torch.cuda.current_stream(dev).cuda_stream
    specs = [(parent / "avsync_torch" / "csrc", "mel_stats", K5_VARIANTS, "avs_mel_stats",
              K5_ARGTYPES)]
    if CUR_K5_VARIANTS:
        specs.append((build.CSRC, "mel_stats", CUR_K5_VARIANTS, "avs_mel_stats",
                      mfcc._ARGTYPES))
    fns = build_variants(specs)
    build.build(["mel_stats"])
    out = {"ptxas_variants": {k: v[1] for k, v in fns.items()},
           "ptxas_current": [ln.strip() for ln in build.build_log("mel_stats").splitlines()
                             if "registers" in ln or "spill" in ln]}
    melT, dctT, _ = audio.device_constants(AudioConfig(), dev)
    lo, length, off, wpack = mfcc._band_table(melT)
    K, (M, C), F = melT.shape[0], dctT.shape, K5_F
    g = torch.Generator().manual_seed(0)

    def case(B, frames=F):  # ~100 dB of spread, every frame valid
        power = (torch.rand(B, frames, K, generator=g) ** 8
                 * 10.0 ** (torch.rand(B, frames, 1, generator=g) * 9 - 6)).to(dev)
        return power, torch.full((B,), frames, dtype=torch.int32, device=dev)

    def earlier(fn, c):
        power, n = c
        B = power.shape[0]

        def run():
            o = torch.empty(B, 2 * C, device=dev)
            checked(fn(power.data_ptr(), n.data_ptr(), lo.data_ptr(), length.data_ptr(),
                       off.data_ptr(), wpack.data_ptr(), dctT.data_ptr(), o.data_ptr(),
                       B, F, K, M, C, 16, 80.0, dev.index, stream), "K5")
            return o
        return run

    def current(c):
        power, n = c
        return lambda: mfcc.mel_stats(power, n, melT, dctT)

    cases = {B: case(B) for B in (32, 40, 512)}
    key = ("mel_stats", "avs_mel_stats")
    current(cases[32])()  # the wrapper's function loaded
    a, b = earlier(fns["k5_full"][0], cases[32])(), current(cases[32])()
    torch.cuda.synchronize()
    out["k5_B32_earlier_vs_current_max_abs_diff"] = (a - b).abs().max().item()
    variants = {}
    for B in K5_SHAPES:
        for name, (fn, _) in fns.items():
            run = (earlier(fn, cases[B]) if name.startswith("k5")
                   else swapped(key, fn, current(cases[B])))
            dev_ms = device_ms(run)
            variants[f"{name}_B{B}"] = {"events_ms": time_ms(run),
                                        "device_ms": sum(dev_ms.values()), "kernels": dev_ms}
        run = current(cases[B])
        dev_ms = device_ms(run)
        variants[f"cur_k5_full_B{B}"] = {"events_ms": time_ms(run),
                                         "device_ms": sum(dev_ms.values()), "kernels": dev_ms}
    out["variants_F121"] = variants
    # the grid's two choices, device time: rows per CTA (the cluster's size)
    # and the slab height (16 rows, or 8 so that two CTAs share an SM)
    cases["8_F401"] = case(8, 401)
    sweep = {}
    rows0, sm_count = mfcc.ROWS_PER_CTA, mfcc._sm_count
    try:
        for rows in (16, 32, 64, 128):
            mfcc.ROWS_PER_CTA = rows
            mfcc.cluster_grid.cache_clear()
            for slab, sms in ((16, 1 << 30), (8, 0)):
                mfcc._sm_count = lambda dev, sms=sms: sms
                sweep[f"rows{rows}_slab{slab}"] = {
                    f"B{B}": sum(device_ms(current(cases[B])).values())
                    for B in (32, 512, "8_F401")}
    finally:
        mfcc.ROWS_PER_CTA, mfcc._sm_count = rows0, sm_count
        mfcc.cluster_grid.cache_clear()
    out["grid_sweep_device_ms"] = sweep
    turns = {}
    for B in (32, 40, 512):
        old, new = earlier(fns["k5_full"][0], cases[B]), current(cases[B])
        turns[f"k5_B{B}"] = {"earlier": [], "current": []}
        for side in ("earlier", "current", "current", "earlier"):
            turns[f"k5_B{B}"][side].append(time_ms(old if side == "earlier" else new))
        turns[f"k5_B{B}"]["device_ms"] = {"earlier": sum(device_ms(old).values()),
                                          "current": sum(device_ms(new).values())}
    out["turns_ms"] = turns
    return out


# Q1 (the int8 conv + dequant + ReLU + pool block of int8 serving): each
# family's three blocks at full width, (Cin, Cout, H, W, kernel), and the
# contract the int8 forward runs each in
Q1_BLOCKS = {
    "lipnet": {"conv1": (1, 32, 50, 100, (3, 5, 5)), "conv2": (32, 64, 25, 50, (3, 5, 5)),
               "conv3": (64, 96, 12, 25, (3, 3, 3))},
    "tf": {"conv1": (1, 128, 46, 140, (3, 3, 3)), "conv2": (128, 256, 23, 70, (3, 3, 3)),
           "conv3": (256, 64, 11, 35, (3, 3, 3))}}
Q1_CHAIN = {"conv1": "f32_s8", "conv2": "s8_s8", "conv3": "s8_f32"}
Q1_SWEEP_TILES = 4  # tiles (with their group counts) forced per block: the planner's best
Q1_SWEEP_DIRECT = 3  # its best tiles where Cin % 16 != 0 (B per warp task, no ring)
# the C interface of the parent's Q1 (d3be8d9: a tile, no B ring)
Q1_PARENT_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_float] * 2 + [ctypes.c_int] * 18
                      + [ctypes.c_longlong] * 10 + [ctypes.c_int, ctypes.c_void_p])


def parent_tiling(parent: Path):
    """The parent wrapper's planner (its quantconv.py's functions and
    constants, executed alone: importing the module would register its
    operator a second time): (H2, W2, Cin, Cout, kt, kh, kw) -> (rows, cols,
    CTAs per SM), and its `pos_bytes`."""
    import ast
    import functools
    import typing

    src = (parent / "avsync_torch" / "ops" / "cuda" / "quantconv.py").read_text()
    keep = {"padded", "pos_bytes", "shared_memory_bytes", "tile_for"}
    nodes = [n for n in ast.parse(src).body
             if (isinstance(n, ast.FunctionDef) and n.name in keep)
             or (isinstance(n, ast.Assign) and all(isinstance(t, ast.Name) and t.id.isupper()
                                                   and t.id[0] != "_" for t in n.targets))]
    ns = {"functools": functools, "Tuple": typing.Tuple, "Optional": typing.Optional}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), "parent_quantconv", "exec"), ns)

    def plan(H2, W2, cin, cout, kt, kh, kw):
        rows, cols = ns["tile_for"](H2, W2, cin, cout, kt, kh, kw)
        smem = ns["shared_memory_bytes"](cin, ns["padded"](cin * kt * kh * kw), kt, kh, kw,
                                         rows, cols)
        return rows, cols, 2 if smem <= ns["TWO_PER_SM"] else 1
    return plan, ns["pos_bytes"]


def q1_sweep_tiles(H2, W2, cin, cout, k):
    """The tiles the sweep forces: where Cin % 16 == 0 the planner's
    Q1_SWEEP_TILES best (rows, cols, groups) by its estimate, each at every
    stage size that fits; else its Q1_SWEEP_DIRECT best."""
    from avsync_torch.ops.cuda import quantconv

    cands = sorted(quantconv.tiles_to_try(H2, W2, cin, cout, *k),
                   key=lambda t: quantconv.tile_cost(H2, W2, cin, cout, *k, t))
    if cin % 16:
        return cands[:Q1_SWEEP_DIRECT]
    shapes = list(dict.fromkeys(t[:3] for t in cands))[:Q1_SWEEP_TILES]
    return [t for t in cands if t[:3] in shapes]


def q1_chain_case(blocks, dev, B=8, T=75, seed=0):
    """{name: (QuantConvParams, input, out_scale, want)} of a family's three
    blocks with random weights, each input scale its f32 input's absmax /
    127 (as `quantize` calibrates), in the int8 forward's contracts
    (Q1_CHAIN; channels-last between blocks); `want` the plain version."""
    import numpy as np
    import torch

    from avsync_torch.ops.cuda import quantconv
    from avsync_torch.ops.quant import quant_conv_block, quant_conv_params

    g = torch.Generator().manual_seed(seed)
    cin0, _, H0, W0, _ = next(iter(blocks.values()))
    x = torch.rand(B, T, H0, W0, cin0, generator=g).to(dev).permute(0, 4, 1, 2, 3)
    qcs, h = {}, x
    for name, (cin, cout, H, W, k) in blocks.items():
        kq = torch.randint(-127, 128, (cout, cin, *k), generator=g, dtype=torch.int8)
        ks = torch.rand(cout, generator=g) * 0.01 + 1e-4
        qcs[name] = quant_conv_params(kq.to(dev), ks, torch.randn(cout, generator=g) * 0.1,
                                      np.float32(float(h.abs().max()) / 127))
        h = quant_conv_block(qcs[name], h)
    names = list(blocks)
    cases, h = {}, x
    for i, name in enumerate(names):
        qc = qcs[name]
        out_scale = float(qcs[names[i + 1]].x_scale) if i + 1 < len(names) else None
        want = quantconv.int8_conv_pool_ref(h, qc.kernel_q, qc.k_scale, qc.bias,
                                            float(qc.x_scale), out_scale)
        cases[name] = (qc, h, out_scale, want)
        h = want
    return cases


def q1_breakdown(parent, dev, which=("tf", "lipnet")):
    """Q1 at each family's blocks of `which` (B=8, T=75, the int8 forward's
    contracts): each block's tile, warps, CTAs per SM and reckoned weight
    bytes (this tree's and, with `parent`, the parent's); a sweep of forced
    tiles and stage sizes, each held equal to the plain version bit for
    bit and timed on the device alone (`queued_ms`); with `parent`, each
    block and the whole chain against the parent's in turns (parent,
    current, current, parent), after holding both to the plain version, and
    at LipNet's blocks the bf16 epilogue's chain too."""
    import torch

    from avsync_torch.ops.cuda import build, quantconv
    from avsync_torch.ops.quant import quant_conv_block

    out = {}
    build.build(["int8_conv_pool"])
    out["ptxas"] = [ln.strip() for ln in build.build_log("int8_conv_pool").splitlines()
                    if "registers" in ln or "spill" in ln or "Function properties" in ln]
    pfn = plan = None
    if parent is not None:
        fns = build_variants([(parent / "avsync_torch" / "csrc", "int8_conv_pool",
                               {"q1_parent": []}, "avs_int8_conv_pool", Q1_PARENT_ARGTYPES)])
        pfn, out["ptxas_parent"] = fns["q1_parent"]
        plan, ppos_bytes = parent_tiling(parent)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = quantconv._sm_count(dev.index)

    def parent_block(qc, x, out_scale, bf16=False):
        """One launch of the parent's Q1 as its wrapper made it."""
        B, cin, T, H, W = x.shape
        cout, _, kt, kh, kw = qc.kernel_q.shape
        rows, cols, per_sm = plan(H // 2, W // 2, cin, cout, kt, kh, kw)
        frames = quantconv.frames_for(B, T, -(-(H // 2) // rows) * -(-(W // 2) // cols), sms,
                                      per_sm)
        scale, bias = (qc.scale16, qc.bias16) if bf16 else (qc.scale, qc.bias)
        o = quantconv._out_empty(x, cout, out_scale, scale.dtype)
        checked(pfn(x.data_ptr(), qc.packed.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                    o.data_ptr(), float(qc.x_scale), 1.0 if out_scale is None else out_scale,
                    int(x.dtype == torch.int8), int(out_scale is not None), int(bf16), B, cin,
                    T, H, W, cout, kt, kh, kw, qc.packed.shape[1], qc.packed.shape[0], rows,
                    cols, ppos_bytes(cin), frames, *x.stride(), *o.stride(), dev.index,
                    stream), "parent Q1")
        return o

    def turns(old, new):
        t = {"parent": [], "current": []}
        for side in ("parent", "current", "current", "parent"):
            t[side].append(queued_ms(old if side == "parent" else new))
        return dict(t, ratio=sum(t["current"]) / sum(t["parent"]))

    B, T = 8, 75
    for family in which:
        blocks = Q1_BLOCKS[family]
        cases = q1_chain_case(blocks, dev, B, T)
        fam = {}
        for name, (cin, cout, H, W, k) in blocks.items():
            qc, x, out_scale, want = cases[name]
            H2, W2 = H // 2, W // 2
            tile = quantconv.tile_for(H2, W2, cin, cout, *k)

            def describe(t, per_sm):
                return {"tile": list(t), "warps": quantconv.warps(t), "ctas_per_sm": per_sm,
                        "smem": quantconv.shared_memory_bytes(
                            cin, quantconv.padded(cin * k[0] * k[1] * k[2]), *k, *t),
                        "weight_bytes_per_cta_frame": quantconv.weight_bytes(cin, cout, *k, t),
                        "weight_gb_per_launch": quantconv.weight_traffic(
                            B, T, H2, W2, cin, cout, *k, t) / 1e9,
                        "estimate": quantconv.tile_cost(H2, W2, cin, cout, *k, t)}

            row = {"contract": Q1_CHAIN[name],
                   **describe(tile, quantconv.ctas_per_sm(cin, *k, tile))}
            run = (lambda qc=qc, x=x, out_scale=out_scale: quant_conv_block(qc, x, out_scale))
            row["equal_plain"] = bool(torch.equal(run(), want))
            real = quantconv.tile_for
            sweep = []
            try:
                for t in q1_sweep_tiles(H2, W2, cin, cout, k):
                    quantconv.tile_for = lambda *a, t=t: t
                    ok = bool(torch.equal(run(), want))
                    sweep.append({**describe(t, quantconv.ctas_per_sm(cin, *k, t)),
                                  "equal_plain": ok, "queued_ms": queued_ms(run)})
                    if not ok:
                        raise SystemExit(f"Q1 at {family} {name} tile {tuple(t)} differs from "
                                         "its plain version")
            finally:
                quantconv.tile_for = real
            row["sweep"] = sweep
            if parent is not None:
                prow, pcol, pper = plan(H2, W2, cin, cout, *k)
                old = (lambda qc=qc, x=x, out_scale=out_scale: parent_block(qc, x, out_scale))
                row["parent"] = {**describe(quantconv.Q1Tile(prow, pcol), pper),
                                 "equal_plain": bool(torch.equal(old(), want))}
                row["turns_queued_ms"] = turns(old, run)
            else:
                row["queued_ms"] = queued_ms(run)
            fam[name] = row
            print(f"{family} {name}: {json.dumps(row)}", flush=True)
        names = list(blocks)

        def chain(bf16=False, blk=None):
            h = cases[names[0]][1]
            for n in names:
                qc, _, out_scale, _ = cases[n]
                h = (blk(qc, h, out_scale, bf16) if blk is not None
                     else quant_conv_block(qc, h, out_scale,
                                           compute_dtype=torch.bfloat16 if bf16 else None))
            return h

        if parent is not None:
            fam["chain"] = {"equal": bool(torch.equal(chain(), chain(blk=parent_block))),
                            "turns_queued_ms": turns(lambda: chain(blk=parent_block), chain)}
            if family == "lipnet":
                fam["bf16_chain"] = {
                    "equal": bool(torch.equal(chain(True), chain(True, parent_block))),
                    "turns_queued_ms": turns(lambda: chain(True, parent_block),
                                             lambda: chain(True))}
        else:
            fam["chain"] = {"queued_ms": queued_ms(chain)}
        print(f"{family} chain: {json.dumps({k_: fam[k_] for k_ in fam if 'chain' in k_})}",
              flush=True)
        out[family] = fam
    return out


# cuts of the current bf16 designs (avsync_torch/csrc/conv1_pool*.cu)
K1_BF16_VARIANTS = {
    "k1_full": [],
    "k1_no_mma": [("for (int task = warp; task < tasks; task += MMA_NT / 32) {",
                   "for (int task = warp; task < 0; task += MMA_NT / 32) {")],
    "k1_no_store": [("    if (store) {\n      __nv_bfloat16* of",
                     "    if (store && p.B < 0) {\n      __nv_bfloat16* of")],
    "k1_no_stage": [("    if (t + 1 < t_end) stage(t + pt + 1);\n    cp_async_commit();\n"
                     "    __syncthreads();  // the O copies visible",
                     "    cp_async_commit();\n    __syncthreads();  // the O copies visible")],
}
K4_BF16_VARIANTS = {
    "k4_full": [],
    "k4_no_recompute": [("for (int mg = warp; mg < g.mgroups; mg += MMA_NT / 32) {",
                         "for (int mg = warp; mg < 0; mg += MMA_NT / 32) {")],
    "k4_no_dw": [("#pragma unroll 4\n      for (int ks = kp; ks < g.mgroups * 4; ks += 2) {",
                  "#pragma unroll 4\n      for (int ks = kp; ks < 0; ks += 2) {")],
    "k4_no_gload": [("gr[c] = gload && gc0 + c < g.C ? gsrc[t * p.g_st + c * p.g_sc] : 0;",
                     "gr[c] = 0;")],
}


# the grids swept at B=8: tiles (rows, cols) of the 25 x 50 pooled frame and
# runs of frames per clip
K1_BF16_TILES = ((5, 50), (4, 50), (5, 25))
K4_BF16_TILES = ((5, 25), (2, 50), (4, 25), (2, 64))
BF16_RUNS = (1, 3, 6, 13)


def parent_conv_grids(parent: Path):
    """The parent wrapper's `fwd_grid` and `bwd_grid` (its convpool.py's
    functions and constants, executed alone: importing the module would
    register its operator a second time)."""
    import ast

    src = (parent / "avsync_torch" / "ops" / "cuda" / "convpool.py").read_text()
    keep = {"fwd_grid", "bwd_grid"}
    nodes = [n for n in ast.parse(src).body
             if (isinstance(n, ast.FunctionDef) and n.name in keep)
             or (isinstance(n, ast.Assign) and all(isinstance(t, ast.Name) and t.id.isupper()
                                                   and t.id[0] != "_" for t in n.targets))]
    ns = {}
    exec(compile(ast.Module(body=nodes, type_ignores=[]), "parent_convpool", "exec"), ns)
    return ns["fwd_grid"], ns["bwd_grid"]


def conv1_bf16_breakdown(parent, dev):
    import torch

    from avsync_torch.ops.cuda import build, convpool

    bf = torch.bfloat16
    specs = [(build.CSRC, "conv1_pool", K1_BF16_VARIANTS, "avs_conv1_pool_bf16",
              convpool._ARGTYPES),
             (build.CSRC, "conv1_pool_bwd", K4_BF16_VARIANTS, "avs_conv1_pool_bwd_bf16",
              convpool._BWD_ARGTYPES)]
    if parent is not None:
        csrc = parent / "avsync_torch" / "csrc"
        specs += [(csrc, "conv1_pool", {"k1_parent": []}, "avs_conv1_pool_bf16",
                   convpool._ARGTYPES),
                  (csrc, "conv1_pool_bwd", {"k4_parent": []}, "avs_conv1_pool_bwd_bf16",
                   convpool._BWD_ARGTYPES)]
    fns = build_variants(specs)
    build.build(["conv1_pool", "conv1_pool_bwd"])
    out = {"ptxas_variants": {k: v[1] for k, v in fns.items()}}
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(0)
    C, taps = 32, 75

    def case(B):
        x = torch.rand(B, 1, T, 50, 100, generator=g).to(dev).to(bf)
        w = ((torch.rand(C, 1, 3, 5, 5, generator=g) * 2 - 1) * taps ** -0.5).to(dev).to(bf)
        b = ((torch.rand(C, generator=g) * 2 - 1) * taps ** -0.5).to(dev)
        cot = torch.randn(B, C, T, 25, 50, generator=g).to(dev).to(bf)
        return x, w, b, cot

    def k1(case):
        x, w, b, _ = case
        return lambda: convpool.conv1_pool_block(x, w, b)

    def k4(case):
        x, w, b, cot = case
        return lambda: convpool.conv1_pool_block_bwd(x, w, b, cot)

    keys = {"k1": ("conv1_pool", "avs_conv1_pool_bf16"),
            "k4": ("conv1_pool_bwd", "avs_conv1_pool_bwd_bf16")}
    c8 = case(8)
    k1(c8)()
    k4(c8)()  # both wrappers' functions loaded
    variants = {}
    for name, (fn, _) in fns.items():
        if name.endswith("_parent"):
            continue
        run = swapped(keys[name[:2]], fn, (k1 if name.startswith("k1") else k4)(c8))
        variants[name] = {"queued_ms": queued_ms(run), "device_ms": device_ms(run)}
    out["variants_B8"] = variants
    print(f"variants B=8: {json.dumps(variants)}", flush=True)

    # the grid: tiles and runs of frames, each forced through `mma_grid`
    real = convpool.mma_grid
    sweeps = {}
    try:
        for name, bwd, tiles_opts in (("k1", False, K1_BF16_TILES), ("k4", True, K4_BF16_TILES)):
            chosen = real(8, T, 25, 50, 3, 5, 5, C, bwd)
            rows_ = {"chosen": list(chosen)}
            for rows, cols in tiles_opts:
                n_tiles = -(-25 // rows) * -(-50 // cols)
                for runs in BF16_RUNS:
                    convpool.mma_grid = (lambda *a, bwd=False, r=(rows, cols, n_tiles, runs):
                                         r)
                    fn = (k1 if name == "k1" else k4)(c8)
                    rows_[f"{rows}x{cols}_runs{runs}"] = sum(
                        t for n, t in device_ms(fn).items() if "sum_kernel" not in n)
                convpool.mma_grid = real
            sweeps[name] = rows_
    finally:
        convpool.mma_grid = real
    out["grid_sweep_device_ms_B8"] = sweeps
    print(f"grid sweep B=8: {json.dumps(sweeps)}", flush=True)
    if parent is None:
        return out

    fwd_grid, bwd_grid = parent_conv_grids(parent)

    def k1_parent(case):
        x, w, b, _ = case
        B = x.shape[0]
        rows, cols, _, chunks = fwd_grid(B, T, 25, 50, 3, 5, 5, C)
        fn = fns["k1_parent"][0]

        def run():
            o = torch.empty(B, C, T, 25, 50, device=dev, dtype=bf)
            checked(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), o.data_ptr(),
                       B, T, 50, 100, 3, 5, 5, C, chunks, rows, cols,
                       x.stride(0), x.stride(2), x.stride(3), x.stride(4), 1, taps,
                       o.stride(0), o.stride(2), o.stride(3), o.stride(4), o.stride(1),
                       dev.index, stream), "parent K1-bf16")
            return o
        return run

    def k4_parent(case):
        x, w, b, cot = case
        B = x.shape[0]
        rows, cols, tiles, chunks = bwd_grid(B, T, 25, 50)
        gs = cot.stride()
        fn = fns["k4_parent"][0]

        def run():
            partial = torch.empty(tiles * chunks, taps * C + C, device=dev)
            dw = torch.empty(C, 1, 3, 5, 5, device=dev)
            db = torch.empty(C, device=dev)
            checked(fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), cot.data_ptr(),
                       partial.data_ptr(), dw.data_ptr(), db.data_ptr(),
                       B, T, 50, 100, 3, 5, 5, C, chunks, rows, cols,
                       x.stride(0), x.stride(2), x.stride(3), x.stride(4), 1, taps,
                       gs[0], gs[2], gs[3], gs[4], gs[1], 1, taps, dev.index, stream),
                    "parent K4-bf16")
            return dw, db
        return run

    turns = {}
    for B in (8, 128):
        cs = c8 if B == 8 else case(B)
        x, w, b, cot = cs
        xj, wj, cj = x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0), cot.permute(0, 2, 3, 4, 1)
        plain = convpool.conv1_pool_ref(xj, wj, b).permute(0, 4, 1, 2, 3)
        pk, pb = convpool.conv1_pool_bwd_ref(xj, wj, b, cj)
        pk = pk.permute(4, 3, 0, 1, 2)
        checks = {}
        for side, f1, f4 in (("parent", k1_parent(cs), k4_parent(cs)), ("current", k1(cs), k4(cs))):
            o = f1()
            dk, db = f4()
            torch.cuda.synchronize()
            checks[side] = {"k1_equal_share": (o == plain).float().mean().item(),
                            "k1_max_abs_err": (o.float() - plain.float()).abs().max().item(),
                            "k4_dw_max_abs_err": (dk - pk).abs().max().item(),
                            "k4_db_max_abs_err": (db - pb).abs().max().item()}
            del o, dk, db
        row = {"checks": checks}
        for name, old, new in (("k1", k1_parent(cs), k1(cs)), ("k4", k4_parent(cs), k4(cs))):
            t = {"parent": [], "current": []}
            for side in ("parent", "current", "current", "parent"):
                t[side].append(queued_ms(old if side == "parent" else new))
            row[f"{name}_turns_queued_ms"] = t
        turns[f"B{B}"] = row
        print(f"B={B} vs parent: {json.dumps(row)}", flush=True)
        del cs, x, w, b, cot, plain, pk, pb
        torch.cuda.empty_cache()
    out["vs_parent"] = turns
    return out


# the per-step product of K2's register kernel (both instantiations)
K2_VARIANTS = {
    "k2_full": [],
    "k2_no_product": [("      if (NK == 0 && c * PER >= nk) break;", "      if (c >= 0) break;")],
}


def k2_bf16_breakdown(parent, dev):
    import torch

    from avsync_torch.ops.cuda import build, gru

    fns = build_variants([(build.CSRC, "gru_fwd", K2_VARIANTS, "avs_gru_fwd", gru._ARGTYPES)])
    build.build(["gru_fwd"])
    out = {"ptxas_variants": {k: v[1] for k, v in fns.items()}}
    g = torch.Generator().manual_seed(0)
    H = 256
    k = H ** -0.5
    key = ("gru_fwd", "avs_gru_fwd")
    res = {}
    for B in (1, 8):
        dirs = [(torch.randn(B, T, 3 * H, generator=g).to(dev),
                 ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev),
                 ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev)) for _ in range(2)]
        (gf, wf, bf), (gb, wb, bb) = dirs
        for mode, call in (("bf16", gru.bigru_recurrence_bf16), ("f32", gru.bigru_recurrence)):
            run = (lambda call=call: call(gf, gb, wf, wb, bf, bb))
            run()  # the wrapper's function loaded
            turns = {name: [] for name in fns}
            for name in ("k2_full", "k2_no_product", "k2_no_product", "k2_full"):
                swap = swapped(key, fns[name][0], run)
                turns[name].append({"queued_ms": queued_ms(swap),
                                    "device_ms": sum(device_ms(swap).values())})
            times = {name: {k_: statistics.mean(t[k_] for t in ts)
                            for k_ in ("queued_ms", "device_ms")} for name, ts in turns.items()}
            times["turns"] = turns
            full, cut = times["k2_full"]["device_ms"], times["k2_no_product"]["device_ms"]
            times["product_share_device"] = 1.0 - cut / full
            times["product_share_queued"] = (1.0 - times["k2_no_product"]["queued_ms"]
                                             / times["k2_full"]["queued_ms"])
            res[f"{mode}_B{B}"] = times
            print(f"k2 {mode} B={B}: {json.dumps(times)}", flush=True)
    out["k2_B_T75_H256"] = res
    return out


# avs_gru_bwd of commit 6d60f39: no h0, dh0 or h0 stride
K3_PARENT_ARGTYPES = ([ctypes.c_void_p] * 19 + [ctypes.c_longlong] * 10
                      + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def k3_h0_breakdown(parent, dev):
    import torch

    from avsync_torch.ops.cuda import build, gru

    fns = build_variants([(parent / "avsync_torch" / "csrc", "gru_bwd", {"k3_parent": []},
                           "avs_gru_bwd", K3_PARENT_ARGTYPES)])
    build.build(["gru_bwd"])
    fn = fns["k3_parent"][0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(0)
    B, H = 8, 256
    k = H ** -0.5
    (gf, wf, bf), (gb, wb, bb) = [(torch.randn(B, T, 3 * H, generator=g).to(dev),
                                   ((torch.rand(H, 3 * H, generator=g) * 2 - 1) * k).to(dev),
                                   ((torch.rand(3 * H, generator=g) * 2 - 1) * k).to(dev))
                                  for _ in range(2)]
    h0s = tuple(torch.randn(B, H, generator=g).to(dev) for _ in range(2))
    out = torch.cat([gru.gru_recurrence_ref(gf, wf, bf, False),
                     gru.gru_recurrence_ref(gb, wb, bb, True)], -1)
    cot = torch.randn(B, T, 2 * H, generator=g).to(dev)
    args = (gf, gb, out, cot, wf, wb, bf, bb)

    def parent_call():
        # the parent wrapper's buffers: outputs in one allocation, then gh, dgh
        # and the dW_hh partials
        n_dgi, n_dw = 2 * B * T * 3 * H, 2 * H * 3 * H
        res = torch.empty(n_dgi + n_dw + 2 * 3 * H, device=dev)
        chunks = gru.bwd_chunks(B, T)
        work = torch.empty(2 * n_dgi + 2 * chunks * (H + 1) * 3 * H, device=dev)
        rp, wp, op, gp = res.data_ptr(), work.data_ptr(), out.data_ptr(), cot.data_ptr()
        checked(fn(gf.data_ptr(), gb.data_ptr(), op, op + 4 * H, gp, gp + 4 * H,
                   wf.data_ptr(), wb.data_ptr(), bf.data_ptr(), bb.data_ptr(),
                   rp, rp + 4 * (n_dgi // 2), rp + 4 * n_dgi, rp + 4 * (n_dgi + n_dw // 2),
                   rp + 4 * (n_dgi + n_dw), rp + 4 * (n_dgi + n_dw + 3 * H),
                   wp, wp + 4 * n_dgi, wp + 8 * n_dgi,
                   gf.stride(0), gf.stride(1), out.stride(0), out.stride(1),
                   cot.stride(0), cot.stride(1), wf.stride(0), wf.stride(1), 3 * H, 1,
                   B, T, H, 2, 0b10, chunks, dev.index, stream), "parent K3")
        dgi = res[:n_dgi].view(2, B, T, 3 * H)
        dw = res[n_dgi:n_dgi + n_dw].view(2, H, 3 * H)
        db = res[n_dgi + n_dw:].view(2, 3 * H)
        return dgi[0], dgi[1], dw[0], dw[1], db[0], db[1]

    def current():
        return gru.bigru_recurrence_bwd(*args)

    def with_h0():
        return gru.bigru_recurrence_bwd(*args, h0s=h0s)

    want, got = parent_call(), current()
    torch.cuda.synchronize()
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, want)]
    print(f"k3: current without h0 vs parent, torch.equal per output {equal}", flush=True)
    turns = {"parent": [], "current": [], "h0": []}
    for name in ("parent", "current", "h0", "h0", "current", "parent"):
        call = {"parent": parent_call, "current": current, "h0": with_h0}[name]
        turns[name].append({"queued_ms": queued_ms(call),
                            "device_ms": sum(device_ms(call).values())})
    mean = {name: {key: statistics.mean(t[key] for t in ts) for key in ("queued_ms", "device_ms")}
            for name, ts in turns.items()}
    print(f"k3 turns: {json.dumps(mean)}", flush=True)
    return {"k3_B8_T75_H256": {"equal_to_parent": equal, "turns": turns, "mean": mean,
                               "h0_over_current_device": mean["h0"]["device_ms"]
                               / mean["current"]["device_ms"],
                               "current_over_parent_device": mean["current"]["device_ms"]
                               / mean["parent"]["device_ms"]}}


# cuts of the float K4 (csrc/conv1_pool_bwd.cu), each timed through the wrapper
K4_F32_NO_DW = ("    if (lc < CL) {\n      int toff[TQ];", "    if (lc < 0) {\n      int toff[TQ];")
K4_F32_NO_RECOMPUTE = (
    """        conv1_window_sums<KT, KH, KW, CB>(acc, s_x + 2 * ty * IW + 2 * tx, s_w + c0, kt, kh,
                                          kw, IH, IW, MAXC);""",
    """#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < CB; ++c) acc[j][c] = s_w[c0 + c] * j;""")
K4_F32_VARIANTS = {"k4_no_dw": [K4_F32_NO_DW], "k4_no_recompute": [K4_F32_NO_RECOMPUTE],
                   "k4_staging_only": [K4_F32_NO_DW, K4_F32_NO_RECOMPUTE]}


def conv1_tf_breakdown(parent, dev):
    import torch

    from avsync_torch.ops.conv import conv_relu_pool, fp32_step, train_scope
    from avsync_torch.ops.cuda import build, convpool

    build.build(["conv1_pool", "conv1_pool_bwd"])
    out = {"ptxas_current": {n: [ln.strip() for ln in build.build_log(n).splitlines()
                                 if "registers" in ln or "spill" in ln]
                             for n in ("conv1_pool", "conv1_pool_bwd")}}
    specs = [(build.CSRC, "conv1_pool_bwd", K4_F32_VARIANTS, "avs_conv1_pool_bwd",
              convpool._BWD_ARGTYPES)]
    if parent is not None:
        csrc = parent / "avsync_torch" / "csrc"
        specs += [
            (csrc, "conv1_pool", {"k1_parent": []}, "avs_conv1_pool", convpool._ARGTYPES),
            (csrc, "conv1_pool", {"k1b_parent": []}, "avs_conv1_pool_bf16", convpool._ARGTYPES),
            (csrc, "conv1_pool_bwd", {"k4_parent": []}, "avs_conv1_pool_bwd",
             convpool._BWD_ARGTYPES),
            (csrc, "conv1_pool_bwd", {"k4b_parent": []}, "avs_conv1_pool_bwd_bf16",
             convpool._BWD_ARGTYPES)]
        fwd_grid_p, bwd_grid_p = parent_conv_grids(parent)
    fns = build_variants(specs)
    out["ptxas_variants"] = {k: v[1] for k, v in fns.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator().manual_seed(0)
    B, C, H, W, k = 8, 128, 46, 140, (3, 3, 3)
    H2, W2, taps = H // 2, W // 2, 27
    x = torch.randn(B, 1, T, H, W, generator=g).to(dev)  # standardized clips
    w = ((torch.rand(C, 1, *k, generator=g) * 2 - 1) * taps ** -0.5).to(dev)
    b = ((torch.rand(C, generator=g) * 2 - 1) * taps ** -0.5).to(dev)
    cot = (torch.randn(B, C, T, H2, W2, generator=g) * 1e-3).to(dev)
    out["grids"] = {"fwd_grid": convpool.fwd_grid(B, T, H2, W2, *k, C),
                    "bwd_grid": convpool.bwd_grid(B, T, H2, W2, C)}
    if parent is not None:
        out["grids"]["parent_fwd_grid"] = fwd_grid_p(B, T, H2, W2, *k, C)

    def k1():
        return convpool.conv1_pool_block(x, w, b)

    def k4():
        return convpool.conv1_pool_block_bwd(x, w, b, cot)

    def cudnn_fwd():
        with fp32_step():
            return conv_relu_pool(x, w, b)

    wr, br = w.detach().clone().requires_grad_(), b.detach().clone().requires_grad_()

    def cudnn_block():  # forward and dW, db as the trainers ran conv1 before
        with train_scope():
            y = conv_relu_pool(x, wr, br)
            return torch.autograd.grad(y, (wr, br), cot)

    def fused_block():
        return k1(), k4()

    # checks
    xj, wj, cj = x.permute(0, 2, 3, 4, 1), w.permute(2, 3, 4, 1, 0), cot.permute(0, 2, 3, 4, 1)
    got = k1()
    want = convpool.conv1_pool_ref(xj, wj, b).permute(0, 4, 1, 2, 3)
    checks = {"k1_equals_plain": bool(torch.equal(got, want)),
              "k1_repeat_equal": bool(torch.equal(got, k1())),
              "cudnn_vs_k1_max_abs_err": (cudnn_fwd() - got).abs().max().item()}
    del want
    dk, db = k4()
    pk, pb = convpool.conv1_pool_bwd_ref(xj, wj, b, cj)
    pk = pk.permute(4, 3, 0, 1, 2)
    dk2, db2 = k4()
    checks.update(
        k4_dw_max_abs_err=(dk - pk).abs().max().item(), k4_db_max_abs_err=(db - pb).abs().max().item(),
        k4_within_tol=bool(torch.allclose(dk, pk, atol=1e-3, rtol=1e-4)
                           and torch.allclose(db, pb, atol=1e-3, rtol=1e-4)),
        k4_repeat_equal=bool(torch.equal(dk, dk2) and torch.equal(db, db2)))
    cw, cb = cudnn_block()
    checks.update(cudnn_dw_vs_k4_max_abs_err=(cw - dk).abs().max().item(),
                  cudnn_db_vs_k4_max_abs_err=(cb - db).abs().max().item(),
                  dw_max_abs=pk.abs().max().item())
    del got, dk, db, pk, pb, dk2, db2, cw, cb
    torch.cuda.empty_cache()
    out["checks_B8"] = checks
    print(f"TF conv1 B=8 checks: {json.dumps(checks)}", flush=True)

    times = {}
    for name, fn in (("k1", k1), ("k4", k4), ("cudnn_fwd", cudnn_fwd),
                     ("cudnn_block", cudnn_block), ("fused_block", fused_block)):
        times[name] = {"queued_ms": queued_ms(fn, iters=10), "device_ms": device_ms(fn, n=5)}
    for name in K4_F32_VARIANTS:  # K4 with a part cut out (its results are wrong)
        run = swapped(("conv1_pool_bwd", "avs_conv1_pool_bwd"), fns[name][0], k4)
        times[name] = {"queued_ms": queued_ms(run, iters=10), "device_ms": device_ms(run, n=5)}
    t = {"cudnn_block": [], "fused_block": []}
    for side in ("cudnn_block", "fused_block", "fused_block", "cudnn_block"):
        t[side].append(queued_ms(cudnn_block if side == "cudnn_block" else fused_block, iters=10))
    times["turns_queued_ms"] = t
    out["times_B8"] = times
    print(f"TF conv1 B=8 times: {json.dumps(times)}", flush=True)
    if parent is None:
        return out

    def parent_k1(fn, xx, ww, bb, shape, grid, dtype=torch.float32):
        BB, CC, HH, WW, kk = shape
        rows, cols, _, chunks = grid
        o = torch.empty(BB, CC, T, HH // 2, WW // 2, device=dev, dtype=dtype)

        def run():
            checked(fn(xx.data_ptr(), ww.data_ptr(), bb.data_ptr(), o.data_ptr(),
                       BB, T, HH, WW, *kk, CC, chunks, rows, cols,
                       xx.stride(0), xx.stride(2), xx.stride(3), xx.stride(4), 1, math.prod(kk),
                       o.stride(0), o.stride(2), o.stride(3), o.stride(4), o.stride(1),
                       dev.index, stream), "parent K1")
            return o
        return run

    def in_turns(old, new):
        t = {"parent": [], "current": []}
        for side in ("parent", "current", "current", "parent"):
            t[side].append(queued_ms(old if side == "parent" else new, iters=10))
        return t

    vs = {}
    old = parent_k1(fns["k1_parent"][0], x, w, b, (B, C, H, W, k),
                    fwd_grid_p(B, T, H2, W2, *k, C))
    vs["tf_k1"] = {"equal": bool(torch.equal(old(), k1())), "turns": in_turns(old, k1)}
    del old
    torch.cuda.empty_cache()
    # LipNet's conv1 (f32 and bf16): the parent's bits and times
    Cl, kl = 32, (3, 5, 5)
    for dt, suffix in ((torch.float32, ""), (torch.bfloat16, "b")):
        xl = torch.rand(B, 1, T, 50, 100, generator=g).to(dev).to(dt)
        wl = ((torch.rand(Cl, 1, *kl, generator=g) * 2 - 1) * 75 ** -0.5).to(dev).to(dt)
        bl = ((torch.rand(Cl, generator=g) * 2 - 1) * 75 ** -0.5).to(dev)
        cl = torch.randn(B, Cl, T, 25, 50, generator=g).to(dev).to(dt)
        if dt == torch.float32:
            fgrid = fwd_grid_p(B, T, 25, 50, *kl, Cl)
            rows, cols, tiles, chunks = bwd_grid_p(B, T, 25, 50)
            n_part = tiles * chunks
        else:
            fgrid = convpool.mma_grid(B, T, 25, 50, *kl, Cl)
            rows, cols, tiles, chunks = convpool.mma_grid(B, T, 25, 50, *kl, Cl, bwd=True)
            n_part = B * tiles * chunks
        old1 = parent_k1(fns[f"k1{suffix}_parent"][0], xl, wl, bl, (B, Cl, 50, 100, kl), fgrid,
                         dt)
        fn4, gs = fns[f"k4{suffix}_parent"][0], cl.stride()

        def old4():
            partial = torch.empty(n_part, 75 * Cl + Cl, device=dev)
            dw, db = torch.empty(Cl, 1, *kl, device=dev), torch.empty(Cl, device=dev)
            checked(fn4(xl.data_ptr(), wl.data_ptr(), bl.data_ptr(), cl.data_ptr(),
                        partial.data_ptr(), dw.data_ptr(), db.data_ptr(),
                        B, T, 50, 100, *kl, Cl, chunks, rows, cols,
                        xl.stride(0), xl.stride(2), xl.stride(3), xl.stride(4), 1, 75,
                        gs[0], gs[2], gs[3], gs[4], gs[1], 1, 75, dev.index, stream),
                    "parent K4")
            return dw, db

        def new1():
            return convpool.conv1_pool_block(xl, wl, bl)

        def new4():
            return convpool.conv1_pool_block_bwd(xl, wl, bl, cl)

        a4, b4 = old4(), new4()
        name = "lipnet_f32" if dt == torch.float32 else "lipnet_bf16"
        vs[name] = {"k1_equal": bool(torch.equal(old1(), new1())),
                    "k4_equal": bool(torch.equal(a4[0], b4[0]) and torch.equal(a4[1], b4[1])),
                    "k1_turns": in_turns(old1, new1), "k4_turns": in_turns(old4, new4)}
        print(f"{name} vs parent: {json.dumps(vs[name])}", flush=True)
    out["vs_parent"] = vs
    return out


if __name__ == "__main__":
    sys.exit(main())
