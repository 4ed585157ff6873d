#!/usr/bin/env python3
"""Where the time of K2 (GRU forward recurrence) and K4 (conv1 block dW/db)
goes, and the current kernels against an earlier design, on one GPU.

    git archive <commit> | tar -x -C build/parent
    python3 scripts/torch_kernel_breakdown.py --parent build/parent [--out k.json]

`--parent` is the root of an unpacked checkout whose `avsync_torch/csrc/
gru_fwd.cu` and `conv1_pool_bwd.cu` are the earlier design (the one of
commit 12039b3, whose C interfaces the launchers below follow). The script
  * builds that design and variants of it with parts cut out (text patches
    below; each variant computes a wrong result and is only timed), one
    nvcc per source, all started together, and prints ptxas' register
    report for each;
  * times, at the LipNet training shapes (K4: B=8, T=75, 50x100, C=32,
    3x5x5 taps, NCDHW; K2: both directions, T=75, H=256, B=8 and B=1):
    every variant, then the earlier design and the current kernels (the
    package's wrappers) in turns: earlier, current, current, earlier.
Each time: CUDA events around one launch, warm-up first, median of 20.
The parts of a kernel's time follow by difference, e.g. K4's dW phase =
"no_sum" - "no_dw"; the "cur_" variants cut the same parts out of the
current design. Needs a GPU and nvcc; prints one JSON object.
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

# name -> (source, [(text to replace, replacement), ...]) on the earlier design
K4_VARIANTS = {
    "k4_full": [],
    # no dW phase: recompute and routing only
    "k4_no_dw": [("if (lc < C) {\n      const float* gv_row",
                  "if (lc < 0) {\n      const float* gv_row")],
    # neither recompute nor dW: weight staging, halo loads and barriers
    "k4_halo_only": [("if (lc < C) {\n      const float* gv_row",
                      "if (lc < 0) {\n      const float* gv_row"),
                     ("for (int c0 = 0; c0 < C; c0 += CB) {",
                      "for (int c0 = 0; c0 < 0; c0 += CB) {")],
    # the main kernel alone / the sum kernel alone
    "k4_no_sum": [("conv1_pool_bwd_sum_kernel<<<(n_out + NT - 1) / NT, NT, 0, s>>>(p);",
                   "(void)n_out;")],
    "k4_sum_only": [("e = launch<3, 5, 5>(p, grid, s);", "e = cudaSuccess;")],
}
# where a variant drops the step's cluster barrier, one at the end keeps every
# CTA alive until its peers' last pushes have landed
FINAL_SYNC = ("    cur ^= 1;\n  }\n}", "    cur ^= 1;\n  }\n  cluster.sync();\n}")
K2_VARIANTS = {
    "k2_full": [],
    # the push goes to the CTA's own buffer only (h is wrong)
    "k2_no_push": [("for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(nxt, q) = hn;",
                    "*nxt = hn;")],
    # the step's cluster barrier becomes a CTA barrier (a race: h is wrong)
    "k2_no_cluster_sync": [("cluster.sync();  // h_t complete everywhere",
                            "__syncthreads();  // h_t complete everywhere"), FINAL_SYNC],
    "k2_no_exchange": [("for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(nxt, q) = hn;",
                        "*nxt = hn;"),
                       ("cluster.sync();  // h_t complete everywhere",
                        "__syncthreads();  // h_t complete everywhere"), FINAL_SYNC],
    # no h W_hh product: gi loads, the s_red reduce, gates, barriers
    "k2_no_product": [("for (int k = k0; k < k1; ++k) {", "for (int k = k0; k < k0; ++k) {")],
    "k2_gates_only": [("for (int k = k0; k < k1; ++k) {", "for (int k = k0; k < k0; ++k) {"),
                      ("for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(nxt, q) = hn;",
                       "*nxt = hn;"),
                      ("cluster.sync();  // h_t complete everywhere",
                       "__syncthreads();  // h_t complete everywhere"), FINAL_SYNC],
}

# the same cuts of the current design (avsync_torch/csrc/)
CUR_K4_VARIANTS = {
    "cur_k4_no_dw": [("if (lc < C) {\n      int toff[TQ];", "if (lc < 0) {\n      int toff[TQ];")],
    "cur_k4_halo_only": [("if (lc < C) {\n      int toff[TQ];", "if (lc < 0) {\n      int toff[TQ];"),
                         ("if (in_tile) {\n      for (int c0 = 0;",
                          "if (in_tile && C < 0) {\n      for (int c0 = 0;")],
    "cur_k4_no_sum": [("conv1_pool_bwd_sum_kernel<<<(n_out + 31) / 32, NT, 0, s>>>(p);",
                       "(void)n_out;")],
}
CUR_K2_VARIANTS = {
    # no h W_hh product: gi loads, shuffles, gates, pushes, waits
    "cur_k2_no_product": [("if (NK == 0 && c * PER >= nk) break;", "if (c >= 0) break;")],
}

# the earlier design's C entries (commit 12039b3)
K4_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_longlong] * 13
               + [ctypes.c_int, ctypes.c_void_p])
K2_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 7
               + [ctypes.c_int] * 6 + [ctypes.c_void_p])
K4_OLD_TILE, K4_OLD_CHUNKS = (8, 32), 64


def build_variants(parent: Path):
    """Write and compile every variant, all nvcc processes at once; returns
    {name: (ctypes function, ptxas register lines)}."""
    from avsync_torch.ops.cuda import build, convpool

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    sources = {}
    cur = Path(ROOT)
    for root, src_name, variants, symbol in (
            (parent, "conv1_pool_bwd", K4_VARIANTS, "avs_conv1_pool_bwd"),
            (parent, "gru_fwd", K2_VARIANTS, "avs_gru_fwd"),
            (cur, "conv1_pool_bwd", CUR_K4_VARIANTS, "avs_conv1_pool_bwd"),
            (cur, "gru_fwd", CUR_K2_VARIANTS, "avs_gru_fwd")):
        text = (root / "avsync_torch" / "csrc" / f"{src_name}.cu").read_text()
        for name, patches in variants.items():
            src = text
            for old, new in patches:
                if old not in src:
                    raise SystemExit(f"{name}: patch target not in {src_name}.cu: {old!r}")
                src = src.replace(old, new)
            sources[name] = (src, symbol)
    jobs = {}  # every patch applied: now compile
    for name, (src, symbol) in sources.items():
        cu, so = OUT_DIR / f"{name}.cu", OUT_DIR / f"{name}.so"
        cu.write_text(src)
        proc = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, so, symbol)
    out = {}
    for name, (proc, so, symbol) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        fn = getattr(ctypes.CDLL(str(so)), symbol)
        fn.argtypes = (convpool._BWD_ARGTYPES if name.startswith("cur_k4") else
                       K4_ARGTYPES if name.startswith("k4") else K2_ARGTYPES)
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="root of the earlier design's checkout")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs a GPU", file=sys.stderr)
        return 2
    from avsync_torch.ops.cuda import build, convpool, gru

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    fns = build_variants(Path(args.parent).resolve())
    build.build(["conv1_pool_bwd", "gru_fwd"])
    out = {"card": card, "torch": torch.__version__,
           "ptxas": {k: v[1] for k, v in fns.items()},
           "ptxas_current": {n: [ln.strip() for ln in build.build_log(n).splitlines()
                                 if "registers" in ln or "spill" in ln]
                             for n in ("conv1_pool_bwd", "gru_fwd")}}
    g = torch.Generator().manual_seed(0)

    # K4 at the training shape, NCDHW as the model calls it
    B, T, H, W, C, kt, kh, kw = 8, 75, 50, 100, 32, 3, 5, 5
    taps = kt * kh * kw
    x = torch.rand(B, 1, T, H, W, generator=g).to(dev)
    w = ((torch.rand(C, 1, kt, kh, kw, generator=g) * 2 - 1) * taps ** -0.5).to(dev)
    bias = ((torch.rand(C, generator=g) * 2 - 1) * taps ** -0.5).to(dev)
    cot = torch.randn(B, C, T, H // 2, W // 2, generator=g).to(dev)
    dw, db = torch.empty_like(w), torch.empty(C, device=dev)
    tiles = -(-(H // 2) // K4_OLD_TILE[0]) * -(-(W // 2) // K4_OLD_TILE[1])
    partial = torch.empty(tiles * K4_OLD_CHUNKS, taps * C + C, device=dev)
    gs = cot.stride()

    def k4_old(fn):
        def run():
            err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), cot.data_ptr(),
                     partial.data_ptr(), dw.data_ptr(), db.data_ptr(),
                     B, T, H, W, kt, kh, kw, C, K4_OLD_CHUNKS,
                     x.stride(0), x.stride(2), x.stride(3), x.stride(4), 1, taps,
                     gs[0], gs[2], gs[3], gs[4], gs[1], 1, taps, dev.index, stream)
            if err:
                raise SystemExit(f"K4 launch failed: {err}")
        return run

    def k4_new():
        convpool.conv1_pool_block_bwd(x, w, bias, cot)

    rows, cols, tiles_new, chunks = convpool.bwd_grid(B, T, H // 2, W // 2)
    partial_new = torch.empty(tiles_new * chunks, taps * C + C, device=dev)

    def k4_cur(fn):  # a variant of the current kernel, called as the wrapper does
        def run():
            err = fn(x.data_ptr(), w.data_ptr(), bias.data_ptr(), cot.data_ptr(),
                     partial_new.data_ptr(), dw.data_ptr(), db.data_ptr(),
                     B, T, H, W, kt, kh, kw, C, chunks, rows, cols,
                     x.stride(0), x.stride(2), x.stride(3), x.stride(4), 1, taps,
                     gs[0], gs[2], gs[3], gs[4], gs[1], 1, taps, dev.index, stream)
            if err:
                raise SystemExit(f"K4 launch failed: {err}")
        return run

    # K2, both directions, at B = 8 and 1
    def k2_case(B):
        Hh = 256
        k = Hh ** -0.5
        dirs = [(torch.randn(B, T, 3 * Hh, generator=g).to(dev),
                 ((torch.rand(Hh, 3 * Hh, generator=g) * 2 - 1) * k).to(dev),
                 ((torch.rand(3 * Hh, generator=g) * 2 - 1) * k).to(dev)) for _ in range(2)]
        o = torch.empty(B, T, 2 * Hh, device=dev)
        return dirs, o

    def k2_old(fn, case):
        (gf, wf, bf), (gb, wb, bb) = case[0]
        o = case[1]

        def run():
            err = fn(gf.data_ptr(), gb.data_ptr(), wf.data_ptr(), wb.data_ptr(), bf.data_ptr(),
                     bb.data_ptr(), o.data_ptr(), gf.stride(0), gf.stride(1), wf.stride(0),
                     wf.stride(1), o.stride(0), o.stride(1), 256, gf.shape[0], T, 256, 2, 0b10,
                     dev.index, stream)
            if err:
                raise SystemExit(f"K2 launch failed: {err}")
        return run

    def k2_new(case):
        (gf, wf, bf), (gb, wb, bb) = case[0]
        return lambda: gru.bigru_recurrence(gf, gb, wf, wb, bf, bb)

    cases = {b: k2_case(b) for b in (8, 1)}
    variants = {}
    for name, (fn, _) in fns.items():
        if name.startswith("cur_k4"):
            variants[name] = time_ms(k4_cur(fn))
        elif name.startswith("k4"):
            variants[name] = time_ms(k4_old(fn))
        else:
            for b, case in cases.items():
                variants[f"{name}_B{b}"] = time_ms(k2_old(fn, case))
    out["variants_ms"] = variants

    turns = {}
    pairs = [("k4_B8", k4_old(fns["k4_full"][0]), k4_new)]
    pairs += [(f"k2_B{b}", k2_old(fns["k2_full"][0], c), k2_new(c)) for b, c in cases.items()]
    for name, old, new in pairs:
        turns[name] = {"earlier": [], "current": []}
        for side in ("earlier", "current", "current", "earlier"):
            turns[name][side].append(time_ms(old if side == "earlier" else new))
    out["turns_ms"] = turns
    out["k2_us_per_step"] = {k: {s: [t / T * 1e3 for t in v] for s, v in d.items()}
                             for k, d in turns.items() if k.startswith("k2")}
    text = json.dumps(out, indent=1)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
