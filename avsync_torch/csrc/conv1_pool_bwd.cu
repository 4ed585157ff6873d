// Weight and bias gradients of the fused conv1 + bias + ReLU +
// MaxPool3D(1,2,2) block (one input channel), given the pooled cotangent.
//
// Replaces: avsync/ops/pallas/convpool.py, `conv1_pool_bwd` (Pallas TPU
// kernel `_bwd_kernel`). Same function: recompute the four pre-pool values
// acc_j = conv(x)_j + bias of every pooled position and channel, route the
// pooled gradient to the FIRST window position j (jh-major: (0,0), (0,1),
// (1,0), (1,1)) whose ReLU'd value equals the pooled max, keep it only where
// that position's pre-activation is > 0, and return
//   dW[tap, c] = sum over positions of x[position + tap] * dpre[c],
//   db[c]      = sum over positions of dpre[c].
// No dx: conv1 is the input layer (the wrapper takes dx elsewhere when asked).
// The first position equal to the max of the ReLU'd values is, when the max
// is > 0, the first argmax of the pre-activations; when it is <= 0 nothing
// is routed. That is what the code below tests.
//
// What bounds it on the H100: fp32 operations. At the LipNet shape (B=8,
// T=75, 50x100, 32 channels, 3x5x5 taps) recomputing the pre-pool values is
// 7.2 G multiply-adds (14.4 GFLOP, as K1's forward) and dW on the routed
// positions alone at most 1.8 G (3.6 GFLOP): about 0.26 ms at 67 TFLOP/s,
// against 12 MB of x and 96 MB of g (0.032 ms). The earlier design (an 8x32
// pooled tile, one CTA per SM at 166-206 registers, load, recompute and dW
// one after another) took 2.6 ms: recompute 1.17 ms, dW 1.27 ms (one
// shared load per FMA, a chain of dependent loads per position, 39% of its
// tile outside the 25x50 pooled frame), the sum 0.02 ms. At the TF stack's
// conv1 (B=8, T=75, 46x140, 128 channels, 3x3x3 taps) the recompute is 13.35
// G multiply-adds (26.7 GFLOP) and the routed dW 6.7 GFLOP: 0.50 ms at 67
// TFLOP/s.
//
// Design, no float atomics:
//   * a tile of TR x TC pooled positions chosen by the wrapper with the
//     fewest dead positions (`convpool.bwd_grid`: 5 x 50 at LipNet's 25 x
//     50, none dead; 7 x 35 at the TF stack's 23 x 70, 18% dead, which skip
//     the recompute); a grid of (tile, chunk of frames, group of 32
//     channels), each CTA walking the frames f = chunk, chunk + n_chunks,
//     ... for its own channels and writing its columns of the (tile,
//     chunk)'s partial row (taps x C weights + C biases) for all of them.
//     Each group stages the halo again; the recompute is not repeated (a
//     group recomputes its own channels). C <= 32 is one group;
//   * per frame, cp.async brings the input halo of the tile for the kt
//     frames around t (zero-filled outside the clip: SAME padding, any T)
//     and the tile's pooled cotangent (one position's C values per thread,
//     through g's strides) into shared memory; the cotangent's copy is
//     waited for only after the recompute, so it hides behind it;
//   * each thread recomputes the four pre-pool values of its pooled
//     position for a block of 16 channels in registers with K1's own loop
//     (conv1_recompute.cuh: fmaf over dt, dh, dw from 0, then + bias), so
//     the routing sees the values the forward pooled, and overwrites the
//     cotangent with the routed value (0 where nothing is routed) beside
//     the routed position's input offset;
//   * dW: thread (channel = lane, a run of consecutive taps = warp) walks
//     the tile's positions, four per iteration so that the offsets and
//     values of the next positions are in flight while the current FMAs
//     run, and multiplies only the routed position of each window (the 3.6
//     GFLOP, not 14.4). At 75 taps a warp takes 10 over all the positions;
//     at 27 (the TF stack) a warp takes all 27 over an eighth of them, so
//     that each position's cotangent and offset loads serve 27 FMAs, not 4
//     (on an H100 at B=8, dW took 2.0 of K4's 3.2 ms at 4 taps a warp, 0.5
//     of 1.85 ms at 27), and the eight sums are added
//     in order at the end. The halo is kept as pairs (x[i], x[i+1]), so two
//     taps of one kernel row come from one 8-byte load:
//     6 loads for a warp's 10 taps, not 10. This sparse product is bound by
//     shared-memory loads (one gather per routed (position, channel) and
//     pair of taps); a dense product over the zero-filled pre-pool gradient
//     would do 4x the FMAs on the CUDA cores or need TF32 tensor cores.
//     Its sums live in shared memory between frames, so the recompute has
//     the registers: __launch_bounds__(256, 2) puts two CTAs on each SM,
//     one loading while the other computes;
//   * a second kernel sums the partials of each output: each of 8 warps
//     takes every 8th partial for 32 outputs, then one warp adds the 8 in
//     order, and writes dW through strides (the JAX layout (kt, kh, kw, 1,
//     C) or the model's (C, 1, kt, kh, kw)) and db. Two runs give
//     bit-identical results.
// x and g are read through strides, so the model's NCDHW tensors and the
// JAX layout both work without a copy.
//
// bf16 (`avs_conv1_pool_bwd_bf16`, training under compute_dtype="bfloat16",
// as `conv1_pool_bwd(..., out_dtype=bf16)`; x, the weights and the pooled
// cotangent bf16, the bias, dW and db float) runs
// `conv1_pool_bwd_bf16_kernel` below on the tensor cores; the caller rounds
// dW to bf16 once (the JAX package's `dwmat.astype(bf16)`). Its bound is
// the bf16 one (the recompute's 14.4 GFLOP and the routed dW at 989
// TFLOP/s, 0.018 ms). Design:
//   * a CTA is one clip x a tile of TR x TC pooled positions x a run of F
//     frames (the wrapper's `mma_grid`), its input frames in a ring of
//     kt + 1 slots as K1-bf16's (conv1_mma.cuh); the cotangent of the next
//     frame is loaded into registers while the ring's copy lands;
//   * the recompute is K1-bf16's own device function (mma_window_sums), so
//     the routing sees the bits K1-bf16 pooled: the pooled gradient goes to
//     the first window position, jh-major, whose pre-activation (+ bias in
//     f32) is the max, where that max is > 0;
//   * the routed pre-pool gradient dpre is the bf16 cotangent or 0, so
//     bf16-exact: it is written as bf16 into shared memory, one 32-bit word
//     per (pooled position, jh, channel) holding the windows jw = 0, 1;
//   * dW is a dense bf16 tensor-core product dpre^T x patches (M = channels
//     in m16 tiles, N = the K order's taps in n8 tiles, K = the tile's
//     pre-pool positions, ordered (position, jh, jw), so a patch register is
//     two neighbouring columns of one halo row: one word of copy E or O),
//     f32 accumulation, a frame's sums in registers, then added to the run's
//     in shared memory. This is 4x the products of the float kernel's
//     sparse dW, on the tensor cores. db, the routed cotangent's sum, is
//     added up on the CUDA cores as it is routed (each thread its own
//     channels and rows), then over the threads in a fixed order;
//   * each warp owns every fourth tap tile (3 of LipNet's 12) of both
//     m-tiles over the even or the odd k-steps, so each dpre and patch
//     fragment is loaded by two warps; at the end of the run the even and
//     the odd sums are added in that order and the K order is folded back
//     to (tap, c) into the CTA's partial row; the sum kernel below adds the
//     rows in a fixed order. No float atomics: a repeat launch gives the
//     same bits;
//   * a tile of at most 128 pooled positions (5 x 25 at LipNet's 25 x 50)
//     and __launch_bounds__(256, 2): two CTAs on each SM, one loading or
//     routing while the other multiplies.

#include <cuda_runtime.h>

#include <atomic>

#include "conv1_mma.cuh"
#include "conv1_recompute.cuh"

namespace {

constexpr int NT = 256;          // threads per CTA; positions per tile, at most
constexpr int CB = 16;           // channels per register block (recompute)
constexpr int MAXC = 32;         // channels of a group: one lane each in the dW phase
constexpr int NWARP = NT / 32;   // warps: tap groups x position groups
constexpr int MAXTQ = 16;        // taps per thread in the dW phase, at most
constexpr int GS = MAXC + 1;     // padded row of the routing arrays

struct ConvPoolBwdParams {
  const float* x;     // input, element strides below
  const float* w;     // weights, w[tap * w_tap + c * w_c], tap = (dt*kh+dh)*kw+dw
  const float* bias;  // (C,), contiguous
  const float* g;     // pooled cotangent, element strides below
  float* partial;     // [grid blocks][taps * C + C]
  float* dw;          // dw[tap * dw_tap + c * dw_c]
  float* db;          // (C,), contiguous
  int B, T, H, W, kt, kh, kw, C, n_chunks, n_partials, TR, TC, tiles_w;
  long long x_sb, x_st, x_sh, x_sw;
  long long w_tap, w_c;
  long long g_sb, g_st, g_sh, g_sw, g_sc;
  long long dw_tap, dw_c;
};

// The float kernel. KT/KH/KW == 0 means "read the size from the params"
// (generic path). The dW phase's warps are NWARP / PS tap groups of TQ taps
// (a multiple of 2) x PS groups of the tile's positions: LipNet's 75 taps
// take 8 x 10 over all positions (PS = 1), the TF stack's 27 all 27 (TQ 28)
// over an eighth of them each (PS = 8); the generic path MAXTQ, PS = 1.
template <int KT, int KH, int KW, int TQ, int PS>
__global__ void __launch_bounds__(NT, 2)
conv1_pool_bwd_kernel(const ConvPoolBwdParams p) {
  // the CTA's channel group: channels [z * MAXC, z * MAXC + CL), one lane
  // each; w, bias and g start at its first channel
  const int CL = min(MAXC, p.C - (int)blockIdx.z * MAXC);
  const float* x = p.x;
  const float* w = p.w + blockIdx.z * MAXC * p.w_c;
  const float* bias = p.bias + blockIdx.z * MAXC;
  const float* g = p.g + blockIdx.z * MAXC * p.g_sc;
  const int kt = KT ? KT : p.kt;
  const int kh = KH ? KH : p.kh;
  const int kw = KW ? KW : p.kw;
  const int taps = kt * kh * kw;
  const int TR = p.TR, TC = p.TC, NP = TR * TC;
  const int IH = 2 * TR + kh - 1;
  const int IW = 2 * TC + kw - 1;
  const int H2 = p.H / 2, W2 = p.W / 2;

  static_assert(TQ % 2 == 0, "the dW phase takes its taps in pairs");
  static_assert(NWARP % PS == 0, "the warps split evenly into position groups");
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [taps][MAXC]
  float* s_b = s_w + taps * MAXC;                // [MAXC]
  float* s_g = s_b + MAXC;                       // [NT][GS] cotangent, then routed g
  float* s_acc = s_g + NT * GS;                  // [TQ + 1][NT] dW, db sums
  // [kt][IH][IW] pairs (x[i], x[i + 1]) of the input halo: one 8-byte load
  // gives two neighbouring taps (dW) or window columns (recompute)
  float2* s_x = reinterpret_cast<float2*>(s_acc + (TQ + 1) * NT);
  unsigned short* s_o =
      reinterpret_cast<unsigned short*>(s_x + kt * IH * IW);  // [NT][GS] routed offsets

  const int tid = threadIdx.x;
  const int h2_0 = (blockIdx.x / p.tiles_w) * TR;
  const int w2_0 = (blockIdx.x % p.tiles_w) * TC;

  for (int i = tid; i < taps * MAXC; i += NT) {
    const int tap = i / MAXC, c = i % MAXC;
    s_w[i] = c < CL ? w[tap * p.w_tap + c * p.w_c] : 0.f;
  }
  for (int c = tid; c < MAXC; c += NT) s_b[c] = c < CL ? bias[c] : 0.f;
#pragma unroll
  for (int q = 0; q <= TQ; ++q) s_acc[q * NT + tid] = 0.f;

  // recompute role: one pooled position per thread
  const int ty = tid / TC, tx = tid % TC;
  const bool in_tile = tid < NP;
  const int h2 = h2_0 + ty, w2 = w2_0 + tx;
  const bool live = in_tile && h2 < H2 && w2 < W2;

  // dW role: channel = lane; warp wq takes the run of taps [tap0, tap0 +
  // TQ) of tap group wq / PS over the positions [pos_b, pos_e) of position
  // group wq % PS (with one tap group, tap0 = 0 is known at compile time)
  const int lc = tid % 32, wq = tid / 32;
  const int tap0 = PS == NWARP ? 0 : (wq / PS) * TQ;
  const int pos_n = (NP + PS - 1) / PS, pos_b = (wq % PS) * pos_n;
  const int pos_e = min(NP, pos_b + pos_n);
  // runs start at a kernel row (TQ a multiple of KW): the pairing is known
  // at compile time
  constexpr bool runs_aligned = KW != 0 && TQ % (KW ? KW : 1) == 0;

  for (int f = blockIdx.y; f < p.B * p.T; f += p.n_chunks) {
    const int b = f / p.T, t = f % p.T;
    conv1_stage_halo(s_x, x, b, t, h2_0, w2_0, kt, kh, kw, IH, IW, p.T, p.H, p.W, p.x_sb,
                     p.x_st, p.x_sh, p.x_sw);
    cp_async_commit();
    if (in_tile) {
      const float* gb = g + b * p.g_sb + t * p.g_st + h2 * p.g_sh + w2 * p.g_sw;
      for (int c = 0; c < CL; ++c)
        cp_async4(s_g + tid * GS + c, live ? gb + c * p.g_sc : g, live);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's halo copies
    __syncthreads();     // everyone's

    if (in_tile && !live) {
      // a position past the frame: nothing routed, no recompute
      cp_async_wait<0>();
      for (int c = 0; c < CL; ++c) {
        s_g[tid * GS + c] = 0.f;
        s_o[tid * GS + c] = static_cast<unsigned short>(2 * ty * IW + 2 * tx);
      }
    } else if (in_tile) {
      for (int c0 = 0; c0 < CL; c0 += CB) {
        float acc[4][CB];
        conv1_window_sums<KT, KH, KW, CB>(acc, s_x + 2 * ty * IW + 2 * tx, s_w + c0, kt, kh,
                                          kw, IH, IW, MAXC);

        cp_async_wait<0>();  // this thread's cotangent row
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const int ch = c0 + c;
          if (ch < CL) {
            const float bc = s_b[ch];
            float m = acc[0][c] + bc;
            int jm = 0;
#pragma unroll
            for (int j = 1; j < 4; ++j) {
              const float v = acc[j][c] + bc;
              if (v > m) {
                m = v;
                jm = j;
              }
            }
            float* gv = s_g + tid * GS + ch;
            *gv = (live && m > 0.f) ? *gv : 0.f;
            s_o[tid * GS + ch] =
                static_cast<unsigned short>((2 * ty + (jm >> 1)) * IW + 2 * tx + (jm & 1));
          }
        }
      }
    }
    __syncthreads();

    if (lc < CL) {
      int toff[TQ];
      float acc2[TQ];
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        const int tap = tap0 + q;
        const int tt = tap < taps ? tap : 0;
        toff[q] = ((tt / (kh * kw)) * IH + (tt / kw) % kh) * IW + tt % kw;
        acc2[q] = 0.f;
      }
      float dbacc = 0.f;
#pragma unroll 4
      for (int pos = pos_b; pos < pos_e; ++pos) {
        const float gv = s_g[pos * GS + lc];
        const float2* xo = s_x + s_o[pos * GS + lc];
#pragma unroll
        for (int m = 0; m < TQ / 2; ++m) {
          const int a = tap0 + 2 * m;
          if constexpr (runs_aligned) {
            // straight-line code: taps a, a + 1 share a kernel row unless a
            // ends one; taps past the last are clamped to tap 0 and their
            // sums never written
            if ((2 * m) % (KW ? KW : 1) != KW - 1) {
              const float2 v = xo[toff[2 * m]];
              acc2[2 * m] = fmaf(v.x, gv, acc2[2 * m]);
              acc2[2 * m + 1] = fmaf(v.y, gv, acc2[2 * m + 1]);
            } else {
              acc2[2 * m] = fmaf(xo[toff[2 * m]].x, gv, acc2[2 * m]);
              acc2[2 * m + 1] = fmaf(xo[toff[2 * m + 1]].x, gv, acc2[2 * m + 1]);
            }
          } else if (a + 1 < taps && a % kw != kw - 1) {
            const float2 v = xo[toff[2 * m]];
            acc2[2 * m] = fmaf(v.x, gv, acc2[2 * m]);
            acc2[2 * m + 1] = fmaf(v.y, gv, acc2[2 * m + 1]);
          } else {
            if (a < taps) acc2[2 * m] = fmaf(xo[toff[2 * m]].x, gv, acc2[2 * m]);
            if (a + 1 < taps) acc2[2 * m + 1] = fmaf(xo[toff[2 * m + 1]].x, gv, acc2[2 * m + 1]);
          }
        }
        dbacc += gv;
      }
      // two-level sums: the frame's, then the chunk's running sum (one
      // chain over all of a chunk's ~3,000 positions rounded 10x worse)
#pragma unroll
      for (int q = 0; q < TQ; ++q) s_acc[q * NT + tid] += acc2[q];
      s_acc[TQ * NT + tid] += dbacc;
    }
    __syncthreads();  // s_x and the routing rows are rewritten next frame
  }

  // the (tile, chunk)'s partial row, each channel group its own columns:
  // the position groups' sums added in order by the tap group's first warp
  const int C = p.C;
  float* part = p.partial + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) * (taps * C + C) +
                blockIdx.z * MAXC;
  if (lc < CL && wq % PS == 0) {
#pragma unroll
    for (int q = 0; q <= TQ; ++q) {
      const int tap = q < TQ ? tap0 + q : taps;  // q == TQ: db
      if (tap < taps || (q == TQ && wq == 0)) {
        float sum = s_acc[q * NT + tid];
#pragma unroll
        for (int k = 1; k < PS; ++k) sum += s_acc[q * NT + tid + 32 * k];
        part[tap * C + lc] = sum;
      }
    }
  }
}

// out[o] = sum over the partials: warp w adds partials w, w + 8, ... of 32
// consecutive outputs (lane = output), then warp 0 adds the 8 in order;
// o < taps*C are weights.
__global__ void __launch_bounds__(NT)
conv1_pool_bwd_sum_kernel(const ConvPoolBwdParams p) {
  __shared__ float s_red[NWARP][32];
  const int taps = p.kt * p.kh * p.kw;
  const int n_out = taps * p.C + p.C;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int o = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (o < n_out)
    for (int k = warp; k < p.n_partials; k += NWARP) s += p.partial[(size_t)k * n_out + o];
  s_red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || o >= n_out) return;
  s = s_red[0][lane];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) s += s_red[w][lane];
  if (o < taps * p.C) {
    p.dw[(o / p.C) * p.dw_tap + (o % p.C) * p.dw_c] = s;
  } else {
    p.db[o - taps * p.C] = s;
  }
}

size_t smem_bytes(int kt, int kh, int kw, int TR, int TC, int tq) {
  const size_t floats = (size_t)kt * kh * kw * MAXC + MAXC + (size_t)NT * GS +
                        (size_t)(tq + 1) * NT +
                        2 * (size_t)kt * (2 * TR + kh - 1) * (2 * TC + kw - 1);
  // the halo's offsets fit the 16-bit routing array whenever it fits here
  return floats * sizeof(float) + (size_t)NT * GS * sizeof(unsigned short);
}

constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90
constexpr int MAX_DEVICES = 64;

// Opt kernel `fn` in to MAX_SMEM of dynamic shared memory, once per device
// (`opted_in`: the instantiation's own flags).
template <typename Fn>
cudaError_t opt_in(Fn fn, std::atomic<bool>* opted_in, int device) {
  if (device < MAX_DEVICES && opted_in[device].load()) return cudaSuccess;
  cudaError_t e =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (e == cudaSuccess && device < MAX_DEVICES) opted_in[device].store(true);
  return e;
}

template <int KT, int KH, int KW, int TQ, int PS>
cudaError_t launch(const ConvPoolBwdParams& p, dim3 grid, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = smem_bytes(p.kt, p.kh, p.kw, p.TR, p.TC, TQ);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(conv1_pool_bwd_kernel<KT, KH, KW, TQ, PS>, opted_in, device);
  if (e != cudaSuccess) return e;
  conv1_pool_bwd_kernel<KT, KH, KW, TQ, PS><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  return e;
}

// Grid: (tiles of tile_rows x tile_cols pooled positions, n_chunks,
// ceil(C / 32) channel groups); `partial` holds tiles * n_chunks rows of
// taps * C + C floats, the groups of a (tile, chunk) writing one row's
// columns (the wrapper allocates it and chooses the tile and the chunks).
int run(const float* x, const float* w, const float* bias, const float* g,
        float* partial, float* dw, float* db,
        int B, int T, int H, int W, int kt, int kh, int kw, int C, int n_chunks,
        int tile_rows, int tile_cols,
        long long x_sb, long long x_st, long long x_sh, long long x_sw,
        long long w_tap, long long w_c,
        long long g_sb, long long g_st, long long g_sh, long long g_sw,
        long long g_sc, long long dw_tap, long long dw_c, int device,
        void* stream) {
  if (C < 1 || kt * kh * kw > MAXTQ * NWARP || n_chunks < 1 ||
      B < 1 || T < 1 || H < 2 || W < 2 || tile_rows < 1 || tile_cols < 1 ||
      tile_rows * tile_cols > NT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W / 2 + tile_cols - 1) / tile_cols;
  const int tiles = ((H / 2 + tile_rows - 1) / tile_rows) * tiles_w;
  const ConvPoolBwdParams p{x, w, bias, g, partial, dw, db,
                            B, T, H, W, kt, kh, kw, C, n_chunks,
                            tiles * n_chunks, tile_rows, tile_cols, tiles_w,
                            x_sb, x_st, x_sh, x_sw, w_tap, w_c,
                            g_sb, g_st, g_sh, g_sw, g_sc, dw_tap, dw_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, n_chunks, (C + MAXC - 1) / MAXC);
  if (kt == 3 && kh == 5 && kw == 5) {
    e = launch<3, 5, 5, (75 + NWARP - 1) / NWARP, 1>(p, grid, device, s);
  } else if (kt == 3 && kh == 3 && kw == 3) {
    e = launch<3, 3, 3, 28, NWARP>(p, grid, device, s);
  } else {
    e = launch<0, 0, 0, MAXTQ, 1>(p, grid, device, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = kt * kh * kw * C + C;
  conv1_pool_bwd_sum_kernel<<<(n_out + 31) / 32, NT, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------


struct MmaBwdParams {
  const __nv_bfloat16* x;  // input, element strides below
  const __nv_bfloat16* w;  // weights, w[tap * w_tap + c * w_c]
  const float* bias;       // (C,), contiguous
  const __nv_bfloat16* g;  // pooled cotangent, element strides below
  float* partial;          // [grid blocks][taps * C + C]
  MmaGeo geo;
  int B, T, H, W, runs, F, tiles_w, tiles;
  long long x_sb, x_st, x_sh, x_sw;
  long long w_tap, w_c;
  long long g_sb, g_st, g_sh, g_sw, g_sc;
};

constexpr int BWD_MAXP = 128;  // pooled positions per tile of K4-bf16, at most

// n8 tap tiles per dW warp: the 8 warps are 4 tap groups x the even and the
// odd k-steps, so LipNet's 12 tap tiles are 3 a warp; any other shape takes
// up to 32 tap tiles.
constexpr int BWD_GROUPS = 4;
__host__ __device__ inline int bwd_ntw(const MmaGeo& g) {
  return g.ksteps == 6 ? 3 : 8;
}

// Shared memory in words: the packed weights, the bias, the A-pair tables
// (R x Kpad / 2), the tap tables (R x Kpad), the ring, the cotangent tile ([mgroups * 16][mpad + 2] bf16: an odd
// number of words a row), dpre ([mgroups * 16][mpad + 8][2] words: a
// position's (jh = 0, 1) words of one channel side by side), and each
// thread's dW sums between frames ([8 ntw][256] floats: two m-tiles) and
// db sums ([8][256]).
// ops/cuda/convpool.py's `mma_smem_bytes` mirrors it.
size_t mma_bwd_words(const MmaGeo& g) {
  return (size_t)g.npad * g.wrow + g.npad + (size_t)g.R * (g.Kpad / 2) +
         (size_t)g.R * g.Kpad + (size_t)g.R * g.slot_words +
         (size_t)g.mgroups * 16 * (g.mpad + 2) / 2 + (size_t)g.mgroups * 32 * (g.mpad + 8) +
         (size_t)(8 * bwd_ntw(g) + 8) * MMA_NT;
}

// KS: the k-steps (0: read at run time); VEC: the staging (mma_stage); NTW:
// n8 tiles of taps per dW warp, at most.
template <int KS, int VEC, int NTW>
__global__ void __launch_bounds__(MMA_NT, 2)
conv1_pool_bwd_bf16_kernel(const MmaBwdParams p) {
  const MmaGeo& g = p.geo;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;
  float* s_b = reinterpret_cast<float*>(s_w + g.npad * g.wrow);
  int* s_tab = reinterpret_cast<int*>(s_b + g.npad);
  int* s_tap = s_tab + g.R * (g.Kpad / 2);
  uint32_t* ring = reinterpret_cast<uint32_t*>(s_tap + g.R * g.Kpad);
  unsigned short* s_g = reinterpret_cast<unsigned short*>(ring + g.R * g.slot_words);
  uint32_t* s_dp = reinterpret_cast<uint32_t*>(s_g + g.mgroups * 16 * (g.mpad + 2));
  // [i][thread]: the thread's dW (i < 4 NTW) and db sums between frames
  float* s_acc = reinterpret_cast<float*>(s_dp + g.mgroups * 32 * (g.mpad + 8)) + threadIdx.x;
  // row strides: bf16 of s_g; word pairs of s_dp (cw % 16 == 8: the dW's A
  // loads fall on distinct banks)
  const int gc = g.mpad + 2, cw = g.mpad + 8;

  const int taps = g.kt * g.kh * g.kw, n_out = taps * g.C + g.C;
  float* part = p.partial + (size_t)blockIdx.x * n_out;
  const int tile = blockIdx.x % p.tiles, run = (blockIdx.x / p.tiles) % p.runs;
  const int b = blockIdx.x / (p.tiles * p.runs);
  const int t_begin = run * p.F, t_end = min(t_begin + p.F, p.T);
  if (t_begin >= t_end) {
    for (int o = threadIdx.x; o < n_out; o += MMA_NT) part[o] = 0.f;
    return;
  }
  const int h2_0 = (tile / p.tiles_w) * g.TR, w2_0 = (tile % p.tiles_w) * g.TC;
  const int pt = (g.kt - 1) / 2;
  const int h0 = 2 * h2_0 - (g.kh - 1) / 2, wi0 = 2 * w2_0 - (g.kw - 1) / 2;
  const int e0 = (wi0 % 4 + 4) % 4, aE = wi0 - e0;
  const long long xb = b * p.x_sb;
  auto slot = [&](int ti) { return ring + ((ti + pt) % g.R) * g.slot_words; };
  auto stage = [&](int ti) {
    mma_stage<VEC>(slot(ti), p.x, xb, ti, h0, aE, g, p.T, p.H, p.W, p.x_st, p.x_sh, p.x_sw);
  };

  for (int d = 0; d < g.kt; ++d) stage(t_begin - pt + d);
  cp_async_commit();
  mma_prepare(g, s_w, s_b, s_tab, p.w, p.w_tap, p.w_c, p.bias);
  // tap table: for output frame t with r = t mod R, the word of tap k of
  // the K order relative to a pre-pool position's word: its slot,
  // copy (by the parity of e0 + dw), row dh and column pair (past K: the
  // staged slot of frame t - pt; those columns are not kept)
  for (int i = threadIdx.x; i < g.R * g.Kpad; i += MMA_NT) {
    const int r = i / g.Kpad, k = i % g.Kpad;
    int off = r * g.slot_words;
    if (k < g.K) {
      const int dt = k / (g.kh * g.kwp), dh = (k / g.kwp) % g.kh, dw = k % g.kwp;
      const int par = (e0 + dw) & 1;
      off = ((r + dt) % g.R) * g.slot_words + par * g.OP + dh * g.RW + (e0 + dw - par) / 2;
    }
    s_tap[i] = off;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int H2 = p.H / 2, W2 = p.W / 2, ntiles = g.Kpad / 8, mt_n = g.mpad / 16;
  // dW role: tap tiles dn, dn + 4, ... of every m-tile over the k-steps of
  // parity kp. The sums stay in shared memory between frames, so the
  // recompute has the registers.
  const int dn = warp % BWD_GROUPS, kp = warp / BWD_GROUPS;
  constexpr int NACC = 8 * NTW + 8;  // [m][n][4] dW, then db [j][h]
  for (int i = 0; i < NACC; ++i) s_acc[i * MMA_NT] = 0.f;
  float* s_db = s_acc + 8 * NTW * MMA_NT;  // db of channel 8 j + 2 tq + h: [2 j + h]
  // the lane's dpre rows 8 ks + tq and + 4 at its first k-step: pooled
  // positions 4 kp + tq / 2 and + 2, window row jh = tq % 2
  const int jh = tq & 1, pos0 = 4 * kp + (tq >> 1);
  // the cotangent role: position threadIdx.x % 128 of the tile, half of the
  // channels; a frame's values in registers, frame t's loads in flight
  // during frame t - 1's dW product
  constexpr int GH = MAXC / 2;
  const int gp = threadIdx.x % BWD_MAXP, gc0 = (threadIdx.x / BWD_MAXP) * GH;
  const int gh2 = h2_0 + gp / g.TC, gw2 = w2_0 + gp % g.TC;
  const bool gload = gp < g.P && gh2 < H2 && gw2 < W2;
  const unsigned short* gsrc = reinterpret_cast<const unsigned short*>(p.g) + b * p.g_sb +
                               (gload ? gh2 * p.g_sh + gw2 * p.g_sw : 0) + gc0 * p.g_sc;
  unsigned short* grow = s_g + gp * gc + gc0;
  unsigned short gr[GH];
  auto load_g = [&](int t) {
#pragma unroll
    for (int c = 0; c < GH; ++c)
      gr[c] = gload && gc0 + c < g.C ? gsrc[t * p.g_st + c * p.g_sc] : 0;
  };
  load_g(t_begin);

  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<0>();
    __syncthreads();  // frame t + pt landed; frame t - 1's readers done
    if (t == t_begin) {
      for (int d = 0; d < g.kt; ++d) mma_build_odd(slot(t - pt + d), g);
    } else {
      mma_build_odd(slot(t + pt), g);
    }
    if (t + 1 < t_end) stage(t + pt + 1);
    cp_async_commit();
    if (gp < g.P) {
#pragma unroll
      for (int c = 0; c < GH; ++c)
        if (gc0 + c < g.C) grow[c] = gr[c];
    }
    __syncthreads();  // the O copies and the cotangent visible

    // recompute (K1-bf16's function) and route into dpre
    const int* tab = s_tab + (t % g.R) * (g.Kpad / 2);
    for (int mg = warp; mg < g.mgroups; mg += MMA_NT / 32) {
      const int idx[2] = {mg * 16 + gq, mg * 16 + gq + 8};
      int ww[4][2];
      mma_row_words(ww, g, e0, idx);
      float acc[4][4][4];
      mma_window_sums<KS>(acc, ring, tab, s_w + gq * g.wrow + tq, g.wrow, ww, g.ksteps);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = idx[r];
        const int h2 = h2_0 + pos / g.TC, w2 = w2_0 + pos % g.TC;
        const bool live = pos < g.P && h2 < H2 && w2 < W2;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int c = j * 8 + 2 * tq + h, i = 2 * r + h;
            if (c >= g.mpad) continue;
            const float bc = s_b[c];
            float m = acc[0][j][i] + bc;
            int wm = 0;
#pragma unroll
            for (int wdw = 1; wdw < 4; ++wdw) {
              const float v = acc[wdw][j][i] + bc;
              if (v > m) {
                m = v;
                wm = wdw;
              }
            }
            const uint32_t gv = (live && c < g.C && m > 0.f) ? s_g[pos * gc + c] : 0u;
            const uint32_t d0 = wm == 0 ? gv : 0u, d1 = wm == 1 ? gv : 0u;
            const uint32_t d2 = wm == 2 ? gv : 0u, d3 = wm == 3 ? gv : 0u;
            *reinterpret_cast<uint2*>(s_dp + 2 * (pos * cw + c)) =
                make_uint2(d0 | d1 << 16, d2 | d3 << 16);
            // db: the routed cotangent, row by row into the thread's sum
            s_db[(2 * j + h) * MMA_NT] += __uint_as_float(gv << 16);
          }
        }
      }
    }
    __syncthreads();  // dpre complete
    if (t + 1 < t_end) load_g(t + 1);

    // dW += dpre^T x patches over the frame's k-steps
    // (16 pre-pool positions each: 4 pooled positions x 4 windows)
    {
      // two-level sums: the frame's from zero, then the run's in shared
      // memory (one chain over a run's 75 frames drifted past K4_TOL at B=128)
      float acc_dw[2][NTW][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_dw[m][n][i] = 0.f;
      }
      int toff[NTW];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int nt = dn + n * BWD_GROUPS;
        toff[n] = nt < ntiles ? s_tap[(t % g.R) * g.Kpad + nt * 8 + gq] : 0;
      }
      // the pooled positions of the lane's rows, advanced 8 a k-step pair
      int p0 = pos0, ph0 = p0 / g.TC, pw0 = p0 % g.TC;
      int p1 = pos0 + 2, ph1 = p1 / g.TC, pw1 = p1 % g.TC;
#pragma unroll 4
      for (int ks = kp; ks < g.mgroups * 4; ks += 2) {
        // dpre rows r = 2 pos + jh: word 2 (pos * cw + c) + jh
        const uint32_t* d0 = s_dp + 2 * (p0 * cw + gq) + jh;
        const uint32_t* d1 = s_dp + 2 * (p1 * cw + gq) + jh;
        uint32_t a[2][4] = {};
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          if (m >= mt_n) continue;
          a[m][0] = d0[32 * m];
          a[m][1] = d0[32 * m + 16];
          a[m][2] = d1[32 * m];
          a[m][3] = d1[32 * m + 16];
        }
        // the rows' pre-pool words (past the tile: position 0)
        const int q0 = p0 < g.P ? (2 * ph0 + jh) * g.RW + pw0 : 0;
        const int q1 = p1 < g.P ? (2 * ph1 + jh) * g.RW + pw1 : 0;
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          if (dn + n * BWD_GROUPS >= ntiles) continue;
          const uint32_t b0 = ring[q0 + toff[n]], b1 = ring[q1 + toff[n]];
#pragma unroll
          for (int m = 0; m < 2; ++m)
            if (m < mt_n) mma_bf16(acc_dw[m][n], a[m], b0, b1);
        }
        p0 += 8, pw0 += 8, p1 += 8, pw1 += 8;
        while (pw0 >= g.TC) pw0 -= g.TC, ++ph0;
        while (pw1 >= g.TC) pw1 -= g.TC, ++ph1;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int n = 0; n < NTW; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) s_acc[((m * NTW + n) * 4 + i) * MMA_NT] += acc_dw[m][n][i];
      }
    }
  }

  // the even and the odd k-steps' sums added in that order, the K order
  // folded back to (tap, c): the even warps write the CTA's partial row;
  // db of channel c: the sums of the lanes that routed it, warps then lanes
  // in order
  __syncthreads();
  for (int c = threadIdx.x; c < g.C; c += MMA_NT) {
    const int j = c / 8, q = (c % 8) / 2, h = c % 2;
    float sdb = 0.f;
    for (int w = 0; w < MMA_NT / 32; ++w)
      for (int l = q; l < 32; l += 4) sdb += s_db[(2 * j + h) * MMA_NT + w * 32 + l - threadIdx.x];
    part[taps * g.C + c] = sdb;
  }
  if (kp == 0) {
    const float* odd = s_acc + BWD_GROUPS * 32;  // the same lane of warp + 4
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = m * 16 + gq + 8 * (i >> 1);
        if (m >= mt_n || c >= g.C) continue;
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          const int k = (dn + n * BWD_GROUPS) * 8 + 2 * tq + (i & 1), dw = k % g.kwp;
          const int a = ((m * NTW + n) * 4 + i) * MMA_NT;
          if (dn + n * BWD_GROUPS < ntiles && k < g.K && dw < g.kw)
            part[((k / g.kwp) * g.kw + dw) * g.C + c] = s_acc[a] + odd[a];
        }
      }
    }
  }
}

template <int KS, int VEC, int NTW>
cudaError_t launch_bwd_bf16(const MmaBwdParams& p, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = 4 * mma_bwd_words(p.geo);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(conv1_pool_bwd_bf16_kernel<KS, VEC, NTW>, opted_in, device);
  if (e != cudaSuccess) return e;
  conv1_pool_bwd_bf16_kernel<KS, VEC, NTW>
      <<<p.B * p.tiles * p.runs, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KS, int NTW>
cudaError_t launch_bwd_bf16_vec(const MmaBwdParams& p, int vec, int device, cudaStream_t s) {
  if (vec == 4) return launch_bwd_bf16<KS, 4, NTW>(p, device, s);
  if (vec == 2) return launch_bwd_bf16<KS, 2, NTW>(p, device, s);
  return launch_bwd_bf16<KS, 0, NTW>(p, device, s);
}

// Grid: B x tiles x n_chunks runs of ceil(T / n_chunks) frames (the
// wrapper's `mma_grid`); `partial` holds one row of taps * C + C floats per
// CTA, B * tiles * n_chunks rows.
int run_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
             const __nv_bfloat16* g, float* partial, float* dw, float* db,
             int B, int T, int H, int W, int kt, int kh, int kw, int C, int n_chunks,
             int tile_rows, int tile_cols,
             long long x_sb, long long x_st, long long x_sh, long long x_sw,
             long long w_tap, long long w_c,
             long long g_sb, long long g_st, long long g_sh, long long g_sw,
             long long g_sc, long long dw_tap, long long dw_c, int device, void* stream) {
  if (C < 1 || C > MAXC || kt * kh * kw > MAXTQ * NWARP || n_chunks < 1 || n_chunks > T ||
      B < 1 || T < 1 || H < 2 || W < 2 || tile_rows < 1 || tile_cols < 1 ||
      tile_rows * tile_cols > BWD_MAXP || kt % 2 == 0 || kh % 2 == 0 || kw % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  MmaBwdParams p{x, w, bias, g, partial, mma_geo(kt, kh, kw, C, tile_rows, tile_cols),
                 B, T, H, W};
  p.F = (T + n_chunks - 1) / n_chunks;
  p.runs = (T + p.F - 1) / p.F;
  p.tiles_w = (W / 2 + tile_cols - 1) / tile_cols;
  p.tiles = ((H / 2 + tile_rows - 1) / tile_rows) * p.tiles_w;
  p.x_sb = x_sb, p.x_st = x_st, p.x_sh = x_sh, p.x_sw = x_sw;
  p.w_tap = w_tap, p.w_c = w_c;
  p.g_sb = g_sb, p.g_st = g_st, p.g_sh = g_sh, p.g_sw = g_sw, p.g_sc = g_sc;
  const int vec = mma_stage_vec(x, x_sb, x_st, x_sh, x_sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = p.geo.ksteps == 6 ? launch_bwd_bf16_vec<6, 3>(p, vec, device, s)
                        : launch_bwd_bf16_vec<0, 8>(p, vec, device, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the fixed-order sum of the rows (the float kernel's)
  const int n_partials = B * p.tiles * p.runs;
  const ConvPoolBwdParams q{nullptr, nullptr, bias, nullptr, partial, dw, db,
                            B, T, H, W, kt, kh, kw, C, n_chunks, n_partials,
                            tile_rows, tile_cols, p.tiles_w,
                            x_sb, x_st, x_sh, x_sw, w_tap, w_c,
                            g_sb, g_st, g_sh, g_sw, g_sc, dw_tap, dw_c};
  const int n_out = kt * kh * kw * C + C;
  conv1_pool_bwd_sum_kernel<<<(n_out + 31) / 32, NT, 0, s>>>(q);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define AVS_CONV1_POOL_BWD_ARGS                                                           \
  float *partial, float *dw, float *db, int B, int T, int H, int W, int kt, int kh, int kw, \
      int C, int n_chunks, int tile_rows, int tile_cols, long long x_sb, long long x_st,    \
      long long x_sh, long long x_sw, long long w_tap, long long w_c, long long g_sb,       \
      long long g_st, long long g_sh, long long g_sw, long long g_sc, long long dw_tap,     \
      long long dw_c, int device, void *stream
#define AVS_CONV1_POOL_BWD_PASS                                                             \
  partial, dw, db, B, T, H, W, kt, kh, kw, C, n_chunks, tile_rows, tile_cols, x_sb, x_st,    \
      x_sh, x_sw, w_tap, w_c, g_sb, g_st, g_sh, g_sw, g_sc, dw_tap, dw_c, device, stream

// float x, weights and cotangent
extern "C" int avs_conv1_pool_bwd(const float* x, const float* w, const float* bias,
                                  const float* g, AVS_CONV1_POOL_BWD_ARGS) {
  return run(x, w, bias, g, AVS_CONV1_POOL_BWD_PASS);
}

// bf16 x, weights and cotangent; the bias, dW and db stay float. n_chunks:
// the runs of frames per clip; `partial`: B * tiles * n_chunks rows.
extern "C" int avs_conv1_pool_bwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                       const float* bias, const __nv_bfloat16* g,
                                       AVS_CONV1_POOL_BWD_ARGS) {
  return run_bf16(x, w, bias, g, AVS_CONV1_POOL_BWD_PASS);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
