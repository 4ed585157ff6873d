// Fused conv1 + bias + ReLU + MaxPool3D(1,2,2) for one input channel.
//
// Replaces: avsync/ops/pallas/convpool.py, `conv1_pool_fused` (Pallas TPU
// kernel `_fwd_kernel`). Same function: a SAME-padded stride-1 Conv3D with
// Cin = 1 and odd kernel (kt, kh, kw), plus bias, ReLU and a (1, 2, 2) max
// pool; only the pooled tile is written.
//
// What bounds it on the H100: fp32 FMAs on the CUDA cores. At the LipNet
// shape (B=8, T=75, 50x100, 32 channels, 3x5x5 taps) the conv is 7.2 G
// multiply-adds (14.4 GFLOP, 0.218 ms at 67 TFLOP/s) against 12 MB of input
// and 96 MB of pooled output (0.03 ms), so the operations, not the bytes,
// set the floor. The earlier design (one CTA per frame and 8 x 32 pooled
// tile) took 0.75 ms: 39% of its tile lay outside the 25 x 50 pooled frame
// and computed in full, each of its 4,800 CTAs staged the weights and its
// halo again with plain loads before computing, with nothing overlapping
// them (staging alone 0.09 ms), and it read four scalar halo values per tap.
//
// Design (the recompute of K4, conv1_pool_bwd.cu, which ran the same
// arithmetic in 0.37 ms):
//   * a tile of TR x TC pooled positions, one thread each, chosen by the
//     wrapper so that it covers the frame with no dead positions at the
//     LipNet shape (5 x 50: five tiles per 25 x 50 frame; other shapes keep
//     a ragged edge); in NCDHW each channel's 250 positions of such a tile
//     are contiguous, so a warp's stores coalesce;
//   * a grid of (tile, chunk of frames): each CTA stages the weights and the
//     bias once and walks the frames f = chunk, chunk + n_chunks, ...;
//   * per frame, cp.async brings the tile's input halo for the kt frames
//     around t (zero outside the clip: SAME padding, any T) into one of two
//     buffers, as pairs (x[i], x[i + 1]): one 8-byte load gives both columns
//     of a window row. The next frame's halo is in flight while this one
//     computes;
//   * each thread accumulates its four pre-pool positions for a block of 16
//     channels in registers (conv1_recompute.cuh, shared with K4 so that K4
//     routes on the bits pooled here: a sequential fmaf over the taps
//     (dt, dh, dw) from 0, then + bias, the max of the four, ReLU);
//   * __launch_bounds__(256, 2): two CTAs per SM, one loading or storing
//     while the other computes.
// The output is written through strides, so the same kernel produces the
// model's NCDHW (B, C, T, H/2, W/2) and the JAX package's (B, T, H/2, W/2, C).

#include <cuda_runtime.h>

#include <atomic>

#include "conv1_recompute.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA; pooled positions per tile, at most
constexpr int CB = 16;   // channels per register block
constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90
constexpr int MAX_DEVICES = 64;

struct ConvPoolParams {
  const float* x;     // input, element strides below
  const float* w;     // weights, w[tap * w_tap + c * w_c], tap = (dt*kh+dh)*kw+dw
  const float* bias;  // (C,), contiguous
  float* out;         // pooled output, element strides below
  int B, T, H, W, kt, kh, kw, C, n_chunks, TR, TC, tiles_w;
  long long x_sb, x_st, x_sh, x_sw;
  long long w_tap, w_c;
  long long o_sb, o_st, o_sh, o_sw, o_sc;
};

// KT/KH/KW == 0 means "read the size from the params" (generic path).
template <int KT, int KH, int KW>
__global__ void __launch_bounds__(NT, 2)
conv1_pool_kernel(const ConvPoolParams p) {
  const int kt = KT ? KT : p.kt;
  const int kh = KH ? KH : p.kh;
  const int kw = KW ? KW : p.kw;
  const int taps = kt * kh * kw;
  const int cpad = (p.C + CB - 1) / CB * CB;
  const int IH = 2 * p.TR + kh - 1;
  const int IW = 2 * p.TC + kw - 1;
  const int halo = kt * IH * IW;
  const int H2 = p.H / 2, W2 = p.W / 2;
  const int frames = p.B * p.T;

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [taps][cpad]
  float* s_b = s_w + taps * cpad;                // [cpad]
  // two halo buffers of [kt][IH][IW] pairs; cpad is a multiple of 16, so
  // s_x stays 16-byte aligned
  float2* s_x = reinterpret_cast<float2*>(s_b + cpad);

  const int tid = threadIdx.x;
  const int h2_0 = (blockIdx.x / p.tiles_w) * p.TR;
  const int w2_0 = (blockIdx.x % p.tiles_w) * p.TC;
  const int ty = tid / p.TC, tx = tid % p.TC;
  const int h2 = h2_0 + ty, w2 = w2_0 + tx;
  const bool live = tid < p.TR * p.TC && h2 < H2 && w2 < W2;

  auto stage = [&](int f, int buf) {
    conv1_stage_halo(s_x + buf * halo, p.x, f / p.T, f % p.T, h2_0, w2_0, kt, kh, kw, IH, IW,
                     p.T, p.H, p.W, p.x_sb, p.x_st, p.x_sh, p.x_sw);
    cp_async_commit();
  };
  int f = blockIdx.y;
  if (f < frames) stage(f, 0);
  for (int i = tid; i < taps * cpad; i += NT) {
    const int tap = i / cpad, c = i % cpad;
    s_w[i] = c < p.C ? p.w[tap * p.w_tap + c * p.w_c] : 0.f;
  }
  for (int c = tid; c < cpad; c += NT) s_b[c] = c < p.C ? p.bias[c] : 0.f;

  for (int k = 0; f < frames; ++k, f += p.n_chunks) {
    const int buf = k & 1;
    if (f + p.n_chunks < frames) {
      stage(f + p.n_chunks, buf ^ 1);  // in flight while this frame computes
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this frame's halo (and the weights) visible to all

    if (live) {
      const int b = f / p.T, t = f % p.T;
      float* ob = p.out + b * p.o_sb + t * p.o_st + h2 * p.o_sh + w2 * p.o_sw;
      const float2* xs = s_x + buf * halo + 2 * ty * IW + 2 * tx;
      for (int c0 = 0; c0 < p.C; c0 += CB) {
        float acc[4][CB];
        conv1_window_sums<KT, KH, KW, CB>(acc, xs, s_w + c0, kt, kh, kw, IH, IW, cpad);
#pragma unroll
        for (int c = 0; c < CB; ++c) {
          if (c0 + c < p.C) {
            const float bc = s_b[c0 + c];
            const float m = fmaxf(fmaxf(acc[0][c] + bc, acc[1][c] + bc),
                                  fmaxf(acc[2][c] + bc, acc[3][c] + bc));
            ob[(c0 + c) * p.o_sc] = fmaxf(m, 0.f);
          }
        }
      }
    }
    __syncthreads();  // the buffer is staged again two frames on
  }
}

size_t smem_bytes(int kt, int kh, int kw, int C, int TR, int TC) {
  const int cpad = (C + CB - 1) / CB * CB;
  return sizeof(float) * ((size_t)kt * kh * kw * cpad + cpad) +
         2 * sizeof(float2) * (size_t)kt * (2 * TR + kh - 1) * (2 * TC + kw - 1);
}

// The shared-memory opt-in of each instantiation, set once per device.
template <int KT, int KH, int KW>
cudaError_t launch(const ConvPoolParams& p, dim3 grid, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = smem_bytes(p.kt, p.kh, p.kw, p.C, p.TR, p.TC);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (device >= MAX_DEVICES || !opted_in[device].load()) {
    cudaError_t e = cudaFuncSetAttribute(conv1_pool_kernel<KT, KH, KW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MAX_SMEM);
    if (e != cudaSuccess) return e;
    if (device < MAX_DEVICES) opted_in[device].store(true);
  }
  conv1_pool_kernel<KT, KH, KW><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Grid: (tiles of tile_rows x tile_cols pooled positions, n_chunks); the
// wrapper chooses the tile (at most 256 positions) and the chunks.
extern "C" int avs_conv1_pool(
    const float* x, const float* w, const float* bias, float* out,
    int B, int T, int H, int W, int kt, int kh, int kw, int C, int n_chunks,
    int tile_rows, int tile_cols,
    long long x_sb, long long x_st, long long x_sh, long long x_sw,
    long long w_tap, long long w_c,
    long long o_sb, long long o_st, long long o_sh, long long o_sw,
    long long o_sc, int device, void* stream) {
  if (C < 1 || n_chunks < 1 || B < 1 || T < 1 || H < 2 || W < 2 || tile_rows < 1 ||
      tile_cols < 1 || tile_rows * tile_cols > NT)
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_w = (W / 2 + tile_cols - 1) / tile_cols;
  const int tiles = ((H / 2 + tile_rows - 1) / tile_rows) * tiles_w;
  const ConvPoolParams p{x, w, bias, out, B, T, H, W, kt, kh, kw, C, n_chunks,
                         tile_rows, tile_cols, tiles_w,
                         x_sb, x_st, x_sh, x_sw, w_tap, w_c,
                         o_sb, o_st, o_sh, o_sw, o_sc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, n_chunks);
  if (kt == 3 && kh == 5 && kw == 5) {
    e = launch<3, 5, 5>(p, grid, device, s);
  } else if (kt == 3 && kh == 3 && kw == 3) {
    e = launch<3, 3, 3>(p, grid, device, s);
  } else {
    e = launch<0, 0, 0>(p, grid, device, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
