#!/usr/bin/env python3
"""Where the time of the port's kernels goes, and each kernel against an
earlier design, on one GPU. Two modes:

    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_breakdown.py --parent build/parent [--out k.json]
    python3 scripts/torch_kernel_breakdown.py --mode k5 --parent build/parent [--out k.json]

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
            sources[name] = (src, symbol, argtypes)
    jobs = {}  # every patch applied: now compile
    for name, (src, symbol, argtypes) in sources.items():
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(src)
        # the current design's headers come from the package's csrc/
        proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
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
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
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
    ap.add_argument("--parent", required=True, help="root of the earlier design's checkout")
    ap.add_argument("--mode", choices=("lipnet", "k5"), default="lipnet",
                    help="lipnet: K1-K4 against 6ec0e61; k5: K5 against 5e863d4")
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
    parent = Path(args.parent).resolve()
    out = (k5_breakdown if args.mode == "k5" else lipnet_breakdown)(parent, dev)
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
        rows, cols, tiles, chunks = convpool.bwd_grid(B, T, 25, 50)
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


if __name__ == "__main__":
    sys.exit(main())
