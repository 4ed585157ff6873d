// The bf16 pre-pool values of the fused conv1 block on the tensor cores,
// shared by K1-bf16 (conv1_pool.cu, the forward) and K4-bf16
// (conv1_pool_bwd.cu, which recomputes them to route the pooled gradient):
// both call the one device function below, so K4 routes on exactly the
// bits K1 pooled. The float kernels keep their CUDA-core loop
// (conv1_recompute.cuh).
//
// The recompute is an implicit GEMM per frame, as Q1's (int8_conv_pool.cu):
//   * M = pre-pool positions: 16 pooled positions of the tile (an m-group)
//     times four m16 row blocks, one per pool-window offset (jh, jw), which
//     share the B fragments, so a thread's accumulators of the four blocks
//     at one index are the four pre-pool values of one pooled output;
//   * N = output channels in n-groups of 32 (four n8 tiles);
//   * K = taps in the order (dt, dh, dw) with each kernel row padded to an
//     even length kwp = kw + 1 (the tap dw = kw has weight 0), K = kt * kh *
//     kwp to a multiple of 16 (LipNet's 3x5x5: 90 -> 96, six k-steps), so a
//     32-bit A register holds the taps (dw, dw + 1) of one kernel row: two
//     neighbouring columns of one halo row;
//   * mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32: bf16 products
//     are exact in f32, and each pre-pool value's f32 sum runs over the
//     k-steps in order, so its bits depend on the K order alone, never on
//     the tile, the CTA, the run of frames or the batch.
// The halo of a frame is kept in shared memory as bf16 in two copies one
// column apart: copy E holds global columns aE, aE + 1, ... (aE a multiple
// of 4 at or left of the halo's first column), copy O the same shifted by
// one. A pair of columns (c, c + 1) is then one aligned 32-bit word: of E
// where c - aE is even, of O where it is odd. Copy E is staged by cp.async
// over the span widened to 8-byte boundaries (4-byte where the rows are
// only 4-byte aligned, through registers for other strides), zero-filled
// through the src-size operand outside the clip (SAME padding); copy O is
// built from E in shared memory. A CTA keeps a ring of kt + 1 frame slots:
// each input frame is staged once and serves kt output frames, and the next
// frame lands while this one computes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int MMA_NT = 256;  // threads per CTA of both bf16 kernels (8 warps)

// The shapes of the decomposition and of the CTA's shared memory;
// ops/cuda/convpool.py's `mma_geometry` computes the same numbers.
struct MmaGeo {
  int kt, kh, kw, C;
  int kwp;           // kw + 1: a kernel row's taps padded to even
  int K, Kpad, ksteps;  // kt * kh * kwp; to a multiple of 16; Kpad / 16
  int npad;          // C to a multiple of 32: the recompute's n-groups
  int mpad;          // C to a multiple of 16: K4's dW m-tiles
  int wrow;          // words of a packed weight row, Kpad / 2 + 4 (no bank conflicts)
  int TR, TC, P, mgroups;  // the tile of pooled positions; P = TR * TC; ceil(P / 16)
  int IH;            // halo rows, 2 TR + kh - 1
  int LE;            // copy E's columns, 2 TC + kw + 4 to a multiple of 4
  int RWu, RW;       // words of a copy's row used; its stride (RW % 32 in [10, 24])
  int OP;            // copy O's first word in a slot, >= IH RW, OP % 32 == 28
  int slot_words;    // one frame slot: copy E, then copy O at OP; OP + IH RW words
  int R;             // ring slots, kt + 1
};

__host__ __device__ inline MmaGeo mma_geo(int kt, int kh, int kw, int C, int TR, int TC) {
  MmaGeo g;
  g.kt = kt, g.kh = kh, g.kw = kw, g.C = C;
  g.kwp = kw + 1;
  g.K = kt * kh * g.kwp;
  g.Kpad = (g.K + 15) / 16 * 16;
  g.ksteps = g.Kpad / 16;
  g.npad = (C + 31) / 32 * 32;
  g.mpad = (C + 15) / 16 * 16;
  g.wrow = g.Kpad / 2 + 4;
  g.TR = TR, g.TC = TC, g.P = TR * TC, g.mgroups = (g.P + 15) / 16;
  g.IH = 2 * TR + kh - 1;
  g.LE = (2 * TC + kw + 4 + 3) / 4 * 4;
  g.RWu = g.LE / 2;
  g.RW = g.RWu;
  while (g.RW % 32 < 10 || g.RW % 32 > 24) g.RW += 2;
  // the row stride and copy O's offset keep the A loads of the recompute and
  // the B loads of K4's dW mostly on distinct banks
  g.OP = g.IH * g.RW + ((28 - g.IH * g.RW % 32) % 32 + 32) % 32;
  g.slot_words = g.OP + g.IH * g.RW;
  g.R = kt + 1;
  return g;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The CTA's set-up, before its first frame: the weights packed as (npad,
// Kpad) bf16 rows of wrow words in the K order (zero past C, at dw == kw and
// past K), the bias (zero past C), and the A-pair table: for output frame t
// with r = t mod R, tab[r * Kpad / 2 + p] is the word of tap pair p (taps
// 2p, 2p + 1 of the K order) relative to a position's word in its slot: the
// slot of input frame t + dt - pt, kernel row dh, column pair pp (pad pairs
// past K: the slot of frame t - pt, staged and finite; their weights are
// zero).
__device__ void mma_prepare(const MmaGeo& g, uint32_t* s_w, float* s_b, int* s_tab,
                            const __nv_bfloat16* w, long long w_tap, long long w_c,
                            const float* bias) {
  __nv_bfloat16* wb = reinterpret_cast<__nv_bfloat16*>(s_w);
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = threadIdx.x; i < g.npad * 2 * g.wrow; i += blockDim.x) {
    const int n = i / (2 * g.wrow), k = i % (2 * g.wrow);
    const int row = k / g.kwp, dw = k % g.kwp;  // row = dt * kh + dh
    const bool real = n < g.C && k < g.K && dw < g.kw;
    wb[i] = real ? w[(row * g.kw + dw) * w_tap + n * w_c] : zero;
  }
  for (int c = threadIdx.x; c < g.npad; c += blockDim.x) s_b[c] = c < g.C ? bias[c] : 0.f;
  const int half = g.Kpad / 2, hp = g.kwp / 2;
  for (int i = threadIdx.x; i < g.R * half; i += blockDim.x) {
    const int r = i / half, p = i % half;
    int off = r * g.slot_words;
    if (2 * p < g.K) {
      const int dt = p / (g.kh * hp), dh = (p / hp) % g.kh, pp = p % hp;
      off = ((r + dt) % g.R) * g.slot_words + dh * g.RW + pp;
    }
    s_tab[i] = off;
  }
}

// Issue the copies of input frame ti's copy E into its slot: rows h0 ..
// h0 + IH - 1 and columns aE .. aE + LE - 1 of clip b (element offset xb),
// zero outside the clip. VEC elements per cp.async (4: 8 bytes, 2: 4
// bytes; x_sw == 1 and rows aligned to 2 VEC bytes), 0: through registers
// (any strides; visible after the caller's next barrier, as the copies).
template <int VEC>
__device__ __forceinline__ void mma_stage(uint32_t* slot, const __nv_bfloat16* x, long long xb,
                                          int ti, int h0, int aE, const MmaGeo& g, int T,
                                          int H, int W, long long x_st, long long x_sh,
                                          long long x_sw) {
  const bool tok = ti >= 0 && ti < T;
  if constexpr (VEC > 0) {
    const int cpr = g.LE / VEC, n = g.IH * cpr;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / cpr, col = aE + (i % cpr) * VEC, hi = h0 + r;
      // a chunk starts at a multiple of VEC: wholly left of column 0 or not
      const int valid = (tok && hi >= 0 && hi < H && col >= 0) ? min(max(W - col, 0), VEC) : 0;
      const __nv_bfloat16* src = valid ? x + xb + ti * x_st + hi * x_sh + col : x;
      cp_async_zfill<2 * VEC>(slot + r * g.RW + (i % cpr) * (VEC / 2), src, 2 * valid);
    }
  } else {
    const int n = g.IH * g.LE;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int r = i / g.LE, c = i % g.LE, hi = h0 + r, col = aE + c;
      const bool ok = tok && hi >= 0 && hi < H && col >= 0 && col < W;
      reinterpret_cast<__nv_bfloat16*>(slot + r * g.RW)[c] =
          ok ? x[xb + ti * x_st + hi * x_sh + col * x_sw] : __float2bfloat16_rn(0.f);
    }
  }
}

// mma_stage's VEC for input x: 8-byte copies where its rows start 8-byte
// aligned and its columns are contiguous, 4-byte where they start 4-byte
// aligned, else registers.
inline int mma_stage_vec(const void* x, long long x_sb, long long x_st, long long x_sh,
                         long long x_sw) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(x);
  if (x_sw != 1) return 0;
  if (a % 8 == 0 && x_sb % 4 == 0 && x_st % 4 == 0 && x_sh % 4 == 0) return 4;
  if (a % 4 == 0 && x_sb % 2 == 0 && x_st % 2 == 0 && x_sh % 2 == 0) return 2;
  return 0;
}

// Copy O of a slot from its landed copy E: O word j = E elements 2j + 1,
// 2j + 2.
__device__ __forceinline__ void mma_build_odd(uint32_t* slot, const MmaGeo& g) {
  uint32_t* odd = slot + g.OP;
  const int n = g.RWu - 1;
  for (int i = threadIdx.x; i < g.IH * n; i += blockDim.x) {
    const int r = i / n, j = i % n;
    const uint32_t* e = slot + r * g.RW + j;
    odd[r * g.RW + j] = __byte_perm(e[0], e[1], 0x5432);
  }
}

// The word of pre-pool position (2 ph + jh, 2 pw + jw) of the tile, for
// the A loads: in copy E or O by the parity of its column's distance from
// aE (e = the halo's first column - aE), so that every tap pair is one
// aligned word.
__device__ __forceinline__ int mma_window_word(const MmaGeo& g, int e, int ph, int pw, int jh,
                                               int jw) {
  const int par = (e + jw) & 1;
  return par * g.OP + (2 * ph + jh) * g.RW + (e + jw - par) / 2 + pw;
}

// acc[wdw][j][i] = the pre-bias sums of window wdw = 2 jh + jw for the
// thread's rows of the m-group (fragment registers 0, 1: row lane / 4;
// 2, 3: row lane / 4 + 8) and channels n0 + 8 j + 2 (lane % 4) + (i & 1):
// the k-steps in order, one m16n8k16 bf16 MMA per (window, n8 tile, k-step).
// ring: the ring's first word; tab: this frame's A-pair table; sw: the
// packed weights at row n0 + lane / 4, word lane % 4; ww[wdw][r]: the
// window words of the thread's two rows. KS == 0: ksteps at run time.
template <int KS>
__device__ __forceinline__ void mma_window_sums(float (&acc)[4][4][4], const uint32_t* ring,
                                                const int* tab, const uint32_t* sw, int wrow,
                                                const int (&ww)[4][2], int ksteps) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int w = 0; w < 4; ++w)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[w][j][i] = 0.f;
  const int n_ks = KS ? KS : ksteps;
#pragma unroll
  for (int ks = 0; ks < n_ks; ++ks) {
    const int lo = tab[ks * 8 + tq], hi = tab[ks * 8 + tq + 4];
    uint32_t b[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j][0] = sw[j * 8 * wrow + ks * 8];
      b[j][1] = sw[j * 8 * wrow + ks * 8 + 4];
    }
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const uint32_t a[4] = {ring[ww[w][0] + lo], ring[ww[w][1] + lo], ring[ww[w][0] + hi],
                             ring[ww[w][1] + hi]};
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[w][j], a, b[j][0], b[j][1]);
    }
  }
}

// The thread's window words for the rows idx[0], idx[1] of the tile (rows
// past the tile take position 0; their results are not used).
__device__ __forceinline__ void mma_row_words(int (&ww)[4][2], const MmaGeo& g, int e,
                                              const int (&idx)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = idx[r] < g.P ? idx[r] : 0;
    const int ph = q / g.TC, pw = q % g.TC;
#pragma unroll
    for (int w = 0; w < 4; ++w) ww[w][r] = mma_window_word(g, e, ph, pw, w >> 1, w & 1);
  }
}

}  // namespace
