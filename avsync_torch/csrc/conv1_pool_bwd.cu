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
// tile outside the 25x50 pooled frame), the sum 0.02 ms.
//
// Design, no float atomics:
//   * a tile of TR x TC pooled positions chosen by the wrapper so that it
//     covers the frame with no dead positions at the LipNet shape (5 x 50:
//     five tiles per 25 x 50 frame; any other shape keeps a ragged edge);
//     a grid of (tile, chunk of frames), each CTA walking the frames
//     f = chunk, chunk + n_chunks, ... and writing one partial (taps x C
//     weights + C biases) for all of them;
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
//   * dW: thread (channel = lane, a run of ceil(taps/8) consecutive taps =
//     warp) walks the tile's positions, four per iteration so that the
//     offsets and values of the next positions are in flight while the
//     current FMAs run, and multiplies only the routed position of each
//     window (the 3.6 GFLOP, not 14.4). The halo is kept as pairs (x[i],
//     x[i+1]), so two taps of one kernel row come from one 8-byte load:
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

#include <cuda_runtime.h>

#include <atomic>

#include "conv1_recompute.cuh"

namespace {

constexpr int NT = 256;          // threads per CTA; positions per tile, at most
constexpr int CB = 16;           // channels per register block (recompute)
constexpr int MAXC = 32;         // channels: one lane each in the dW phase
constexpr int NWARP = NT / 32;   // tap groups
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

// KT/KH/KW == 0 means "read the size from the params" (generic path); TQ is
// the taps per warp, ceil(taps / NWARP), or MAXTQ for the generic path.
template <int KT, int KH, int KW, int TQ>
__global__ void __launch_bounds__(NT, 2)
conv1_pool_bwd_kernel(const ConvPoolBwdParams p) {
  const int kt = KT ? KT : p.kt;
  const int kh = KH ? KH : p.kh;
  const int kw = KW ? KW : p.kw;
  const int taps = kt * kh * kw;
  const int C = p.C;
  const int cpad = (C + CB - 1) / CB * CB;
  const int TR = p.TR, TC = p.TC, NP = TR * TC;
  const int IH = 2 * TR + kh - 1;
  const int IW = 2 * TC + kw - 1;
  const int H2 = p.H / 2, W2 = p.W / 2;

  static_assert(TQ % 2 == 0, "the dW phase takes its taps in pairs");
  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [taps][cpad]
  float* s_b = s_w + taps * cpad;                // [cpad]
  float* s_g = s_b + cpad;                       // [NT][GS] cotangent, then routed g
  float* s_acc = s_g + NT * GS;                  // [TQ + 1][NT] dW, db sums
  // [kt][IH][IW] pairs (x[i], x[i + 1]) of the input halo: one 8-byte load
  // gives two neighbouring taps (dW) or window columns (recompute)
  float2* s_x = reinterpret_cast<float2*>(s_acc + (TQ + 1) * NT);
  unsigned short* s_o =
      reinterpret_cast<unsigned short*>(s_x + kt * IH * IW);  // [NT][GS] routed offsets

  const int tid = threadIdx.x;
  const int h2_0 = (blockIdx.x / p.tiles_w) * TR;
  const int w2_0 = (blockIdx.x % p.tiles_w) * TC;

  for (int i = tid; i < taps * cpad; i += NT) {
    const int tap = i / cpad, c = i % cpad;
    s_w[i] = c < C ? p.w[tap * p.w_tap + c * p.w_c] : 0.f;
  }
  for (int c = tid; c < cpad; c += NT) s_b[c] = c < C ? p.bias[c] : 0.f;
#pragma unroll
  for (int q = 0; q <= TQ; ++q) s_acc[q * NT + tid] = 0.f;

  // recompute role: one pooled position per thread
  const int ty = tid / TC, tx = tid % TC;
  const bool in_tile = tid < NP;
  const int h2 = h2_0 + ty, w2 = w2_0 + tx;
  const bool live = in_tile && h2 < H2 && w2 < W2;

  // dW role: channel = lane, the run of taps [tap0, tap0 + TQ) = warp
  const int lc = tid % 32, wq = tid / 32;
  const int tap0 = wq * TQ;
  // runs start at a kernel row (TQ a multiple of KW): the pairing is known
  // at compile time
  constexpr bool runs_aligned = KW != 0 && TQ % (KW ? KW : 1) == 0;

  for (int f = blockIdx.y; f < p.B * p.T; f += p.n_chunks) {
    const int b = f / p.T, t = f % p.T;
    conv1_stage_halo(s_x, p.x, b, t, h2_0, w2_0, kt, kh, kw, IH, IW, p.T, p.H, p.W, p.x_sb,
                     p.x_st, p.x_sh, p.x_sw);
    cp_async_commit();
    if (in_tile) {
      const float* gb = p.g + b * p.g_sb + t * p.g_st + h2 * p.g_sh + w2 * p.g_sw;
      for (int c = 0; c < C; ++c) cp_async4(s_g + tid * GS + c, live ? gb + c * p.g_sc : p.g,
                                            live);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's halo copies
    __syncthreads();     // everyone's

    if (in_tile) {
      for (int c0 = 0; c0 < C; c0 += CB) {
        float acc[4][CB];
        conv1_window_sums<KT, KH, KW, CB>(acc, s_x + 2 * ty * IW + 2 * tx, s_w + c0, kt, kh,
                                          kw, IH, IW, cpad);

        cp_async_wait<0>();  // this thread's cotangent row
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          const int ch = c0 + c;
          if (ch < C) {
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

    if (lc < C) {
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
      for (int pos = 0; pos < NP; ++pos) {
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

  float* part = p.partial + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                                (taps * C + C);
  if (lc < C) {
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      const int tap = tap0 + q;
      if (tap < taps) part[tap * C + lc] = s_acc[q * NT + tid];
    }
    if (wq == 0) part[taps * C + lc] = s_acc[TQ * NT + tid];
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

size_t smem_bytes(int kt, int kh, int kw, int C, int TR, int TC, int tq) {
  const int cpad = (C + CB - 1) / CB * CB;
  const size_t floats = (size_t)kt * kh * kw * cpad + cpad + (size_t)NT * GS +
                        (size_t)(tq + 1) * NT +
                        2 * (size_t)kt * (2 * TR + kh - 1) * (2 * TC + kw - 1);
  // the halo's offsets fit the 16-bit routing array whenever it fits here
  return floats * sizeof(float) + (size_t)NT * GS * sizeof(unsigned short);
}

constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90
constexpr int MAX_DEVICES = 64;

// The shared-memory opt-in of each instantiation, set once per device.
template <int KT, int KH, int KW, int TQ>
cudaError_t launch(const ConvPoolBwdParams& p, dim3 grid, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = smem_bytes(p.kt, p.kh, p.kw, p.C, p.TR, p.TC, TQ);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (device >= MAX_DEVICES || !opted_in[device].load()) {
    cudaError_t e = cudaFuncSetAttribute(conv1_pool_bwd_kernel<KT, KH, KW, TQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MAX_SMEM);
    if (e != cudaSuccess) return e;
    if (device < MAX_DEVICES) opted_in[device].store(true);
  }
  conv1_pool_bwd_kernel<KT, KH, KW, TQ><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Grid: (tiles of tile_rows x tile_cols pooled positions, n_chunks);
// `partial` holds tiles * n_chunks rows of taps * C + C floats (the wrapper
// allocates it and chooses the tile and the chunks).
extern "C" int avs_conv1_pool_bwd(
    const float* x, const float* w, const float* bias, const float* g,
    float* partial, float* dw, float* db,
    int B, int T, int H, int W, int kt, int kh, int kw, int C, int n_chunks,
    int tile_rows, int tile_cols,
    long long x_sb, long long x_st, long long x_sh, long long x_sw,
    long long w_tap, long long w_c,
    long long g_sb, long long g_st, long long g_sh, long long g_sw,
    long long g_sc, long long dw_tap, long long dw_c, int device,
    void* stream) {
  if (C < 1 || C > MAXC || kt * kh * kw > MAXTQ * NWARP || n_chunks < 1 ||
      B < 1 || T < 1 || H < 2 || W < 2 || tile_rows < 1 || tile_cols < 1 ||
      tile_rows * tile_cols > NT)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W / 2 + tile_cols - 1) / tile_cols;
  const int tiles = ((H / 2 + tile_rows - 1) / tile_rows) * tiles_w;
  const ConvPoolBwdParams p{x, w, bias, g, partial, dw, db,
                            B, T, H, W, kt, kh, kw, C, n_chunks,
                            tiles * n_chunks, tile_rows, tile_cols, tiles_w,
                            x_sb, x_st, x_sh, x_sw, w_tap, w_c,
                            g_sb, g_st, g_sh, g_sw, g_sc, dw_tap, dw_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, n_chunks);
  if (kt == 3 && kh == 5 && kw == 5) {
    e = launch<3, 5, 5, (75 + NWARP - 1) / NWARP>(p, grid, device, s);
  } else if (kt == 3 && kh == 3 && kw == 3) {
    e = launch<3, 3, 3, (27 + NWARP - 1) / NWARP>(p, grid, device, s);
  } else {
    e = launch<0, 0, 0, MAXTQ>(p, grid, device, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = kt * kh * kw * C + C;
  conv1_pool_bwd_sum_kernel<<<(n_out + 31) / 32, NT, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
