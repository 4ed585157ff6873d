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
// At the TF stack's conv1 (B=8, T=75, 46x140, 128 channels, 3x3x3) it is
// 13.35 G multiply-adds (26.7 GFLOP, 0.40 ms) against 495 MB of output.
//
// Design (the recompute of K4, conv1_pool_bwd.cu, which ran the same
// arithmetic in 0.37 ms):
//   * a tile of TR x TC pooled positions, one thread each, chosen by the
//     wrapper with the fewest dead positions (5 x 50 at LipNet's 25 x 50,
//     none dead; 7 x 35 at the TF stack's 23 x 70; other shapes keep a
//     ragged edge); in NCDHW a tile row's positions of a channel are
//     contiguous, so a warp's stores coalesce;
//   * a grid of (tile, chunk of frames): each CTA stages the weights and the
//     bias once and walks the frames f = chunk, chunk + n_chunks, ...;
//   * per frame, cp.async brings the tile's input halo for the kt frames
//     around t (zero outside the clip: SAME padding, any T) into one of two
//     buffers, as pairs (x[i], x[i + 1]): one 8-byte load gives both columns
//     of a window row. The next frame's halo is in flight while this one
//     computes;
//   * each thread accumulates its four pre-pool positions for a block of 16
//     channels in registers, block after block up to any C (conv1_recompute.cuh, shared with K4 so that K4
//     routes on the bits pooled here: a sequential fmaf over the taps
//     (dt, dh, dw) from 0, then + bias, the max of the four, ReLU);
//   * __launch_bounds__(256, 2): two CTAs per SM, one loading or storing
//     while the other computes.
// The output is written through strides, so the same kernel produces the
// model's NCDHW (B, C, T, H/2, W/2) and the JAX package's (B, T, H/2, W/2, C).
//
// bf16 (`avs_conv1_pool_bf16`, the model under compute_dtype="bfloat16", as
// `conv1_pool_fused(..., out_dtype=bf16)`; x, the weights and the output
// bf16, the bias float) runs `conv1_pool_bf16_kernel` below on the tensor
// cores. Its bound is the bf16 one: 14.4 GFLOP at 989 TFLOP/s (0.015 ms)
// against 6 MB of bf16 input and 48 MB of bf16 output (0.016 ms, the
// floor at B=8). Design (the recompute shared with K4, conv1_mma.cuh):
//   * a CTA is one clip b x a tile of TR x TC pooled positions (the
//     wrapper's `mma_grid`; 5 x 50 at LipNet's 25 x 50) x a run of F
//     consecutive frames, its input frames in a ring of kt + 1 slots: each
//     staged once by 8-byte cp.async, serving kt output frames, the next
//     one landing while this one computes;
//   * a warp task is 16 pooled positions x 32 channels: the four windows'
//     pre-pool sums on the bf16 tensor cores (mma_window_sums), then + bias
//     in f32, the max of the four, ReLU, one rounding to bf16;
//   * the pooled tile goes through shared memory and out in the output's
//     own order (channels innermost for the JAX layout, positions for
//     NCDHW), so the stores coalesce in both layouts;
//   * __launch_bounds__(256, 2): two CTAs on each SM.
// The f32 sum of each pre-pool value runs over the K order's k-steps, not
// the fmaf chain of the float kernel: the value agrees with the plain
// version's to f32 rounding (bit for bit where the sums are exact), and its
// bits never depend on the tile, the run or the batch.

#include <cuda_runtime.h>

#include <atomic>

#include "conv1_mma.cuh"
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

// The float kernel. KT/KH/KW == 0 means "read the size from the params"
// (generic path).
template <int KT, int KH, int KW>
__global__ void __launch_bounds__(NT, 2)
conv1_pool_kernel(const ConvPoolParams p) {
  const float* x = p.x;
  const float* w = p.w;
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
    conv1_stage_halo(s_x + buf * halo, x, f / p.T, f % p.T, h2_0, w2_0, kt, kh, kw, IH, IW,
                     p.T, p.H, p.W, p.x_sb, p.x_st, p.x_sh, p.x_sw);
    cp_async_commit();
  };
  int f = blockIdx.y;
  if (f < frames) stage(f, 0);
  for (int i = tid; i < taps * cpad; i += NT) {
    const int tap = i / cpad, c = i % cpad;
    s_w[i] = c < p.C ? w[tap * p.w_tap + c * p.w_c] : 0.f;
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

template <int KT, int KH, int KW>
cudaError_t launch(const ConvPoolParams& p, dim3 grid, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = smem_bytes(p.kt, p.kh, p.kw, p.C, p.TR, p.TC);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(conv1_pool_kernel<KT, KH, KW>, opted_in, device);
  if (e != cudaSuccess) return e;
  conv1_pool_kernel<KT, KH, KW><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t set_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  return e;
}

// Grid: (tiles of tile_rows x tile_cols pooled positions, n_chunks); the
// wrapper chooses the tile (at most 256 positions) and the chunks.
int run(const float* x, const float* w, const float* bias, float* out,
        int B, int T, int H, int W, int kt, int kh, int kw, int C, int n_chunks,
        int tile_rows, int tile_cols,
        long long x_sb, long long x_st, long long x_sh, long long x_sw,
        long long w_tap, long long w_c,
        long long o_sb, long long o_st, long long o_sh, long long o_sw,
        long long o_sc, int device, void* stream) {
  if (C < 1 || n_chunks < 1 || B < 1 || T < 1 || H < 2 || W < 2 || tile_rows < 1 ||
      tile_cols < 1 || tile_rows * tile_cols > NT)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_device(device);
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

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

struct MmaParams {
  const __nv_bfloat16* x;  // input, element strides below
  const __nv_bfloat16* w;  // weights, w[tap * w_tap + c * w_c]
  const float* bias;       // (C,), contiguous
  __nv_bfloat16* out;      // pooled output, element strides below
  MmaGeo g;
  int B, T, H, W, runs, F, tiles_w, tiles;
  long long x_sb, x_st, x_sh, x_sw;
  long long w_tap, w_c;
  long long o_sb, o_st, o_sh, o_sw, o_sc;
};

// Shared memory in words: the packed weights, the bias, the A-pair tables,
// the ring of R frame slots, the pooled tile ([mgroups * 16][npad + 2]
// bf16: an odd number of words a row, so a thread's own row of channels is
// read without bank conflicts). ops/cuda/convpool.py's `mma_smem_bytes`
// mirrors it.
size_t mma_fwd_words(const MmaGeo& g) {
  return (size_t)g.npad * g.wrow + g.npad + (size_t)g.R * (g.Kpad / 2) +
         (size_t)g.R * g.slot_words + (size_t)g.mgroups * 16 * (g.npad + 2) / 2;
}

// KS: the k-steps (0: read at run time); VEC: the staging (mma_stage).
template <int KS, int VEC>
__global__ void __launch_bounds__(MMA_NT, 2)
conv1_pool_bf16_kernel(const MmaParams p) {
  const MmaGeo& g = p.g;
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* s_w = smem;
  float* s_b = reinterpret_cast<float*>(s_w + g.npad * g.wrow);
  int* s_tab = reinterpret_cast<int*>(s_b + g.npad);
  uint32_t* ring = reinterpret_cast<uint32_t*>(s_tab + g.R * (g.Kpad / 2));
  __nv_bfloat16* s_out = reinterpret_cast<__nv_bfloat16*>(ring + g.R * g.slot_words);
  const int oc = g.npad + 2;  // bf16 per row of the pooled tile

  // blockIdx.x -> (tile, run of F frames, clip), the tiles fastest
  const int tile = blockIdx.x % p.tiles, run = (blockIdx.x / p.tiles) % p.runs;
  const int b = blockIdx.x / (p.tiles * p.runs);
  const int t_begin = run * p.F, t_end = min(t_begin + p.F, p.T);
  if (t_begin >= t_end) return;
  const int h2_0 = (tile / p.tiles_w) * g.TR, w2_0 = (tile % p.tiles_w) * g.TC;
  const int pt = (g.kt - 1) / 2;
  const int h0 = 2 * h2_0 - (g.kh - 1) / 2, wi0 = 2 * w2_0 - (g.kw - 1) / 2;
  const int e0 = (wi0 % 4 + 4) % 4, aE = wi0 - e0;
  const long long xb = b * p.x_sb;
  // input frame ti (>= -pt) lives in slot (ti + pt) mod R
  auto slot = [&](int ti) { return ring + ((ti + pt) % g.R) * g.slot_words; };
  auto stage = [&](int ti) {
    mma_stage<VEC>(slot(ti), p.x, xb, ti, h0, aE, g, p.T, p.H, p.W, p.x_st, p.x_sh, p.x_sw);
  };

  for (int d = 0; d < g.kt; ++d) stage(t_begin - pt + d);  // the first frame's kt inputs
  cp_async_commit();
  mma_prepare(g, s_w, s_b, s_tab, p.w, p.w_tap, p.w_c, p.bias);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  const int ngroups = g.npad / 32, tasks = g.mgroups * ngroups;
  // the store role: pooled position threadIdx.x of the tile, all channels
  const int sh2 = h2_0 + threadIdx.x / g.TC, sw2 = w2_0 + threadIdx.x % g.TC;
  const bool store = (int)threadIdx.x < g.P && sh2 < p.H / 2 && sw2 < p.W / 2;
  __nv_bfloat16* ob = p.out + b * p.o_sb + sh2 * p.o_sh + sw2 * p.o_sw;
  const __nv_bfloat16* srow = s_out + threadIdx.x * oc;
  for (int t = t_begin; t < t_end; ++t) {
    cp_async_wait<0>();
    // frame t + pt has landed (copy E); every warp is done with frame t - 1,
    // so the slot of input frame t - pt - 1 is free for frame t + pt + 1
    __syncthreads();
    if (t == t_begin) {
      for (int d = 0; d < g.kt; ++d) mma_build_odd(slot(t - pt + d), g);
    } else {
      mma_build_odd(slot(t + pt), g);
    }
    if (t + 1 < t_end) stage(t + pt + 1);
    cp_async_commit();
    __syncthreads();  // the O copies visible

    const int* tab = s_tab + (t % g.R) * (g.Kpad / 2);
    for (int task = warp; task < tasks; task += MMA_NT / 32) {
      const int mg = task / ngroups, ng = task % ngroups;
      const int idx[2] = {mg * 16 + gq, mg * 16 + gq + 8};
      int ww[4][2];
      mma_row_words(ww, g, e0, idx);
      float acc[4][4][4];
      mma_window_sums<KS>(acc, ring, tab, s_w + (ng * 32 + gq) * g.wrow + tq, g.wrow, ww,
                          g.ksteps);
      // + bias in f32, the max of the four windows, ReLU, one rounding
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (idx[r] >= g.P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ng * 32 + j * 8 + 2 * tq;
          float v[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 2 * r + h;
            const float bc = s_b[c + h];
            const float m = fmaxf(fmaxf(acc[0][j][i] + bc, acc[1][j][i] + bc),
                                  fmaxf(acc[2][j][i] + bc, acc[3][j][i] + bc));
            v[h] = fmaxf(m, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(s_out + idx[r] * oc + c) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      }
    }
    __syncthreads();  // the pooled tile complete

    // out: a thread per position, its channels in turn, so a warp's
    // stores are neighbouring positions (contiguous in NCDHW)
    if (store) {
      __nv_bfloat16* of = ob + t * p.o_st;
      for (int c = 0; c < g.C; ++c) of[c * p.o_sc] = srow[c];
    }
  }
}

template <int KS, int VEC>
cudaError_t launch_bf16(const MmaParams& p, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = 4 * mma_fwd_words(p.g);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = opt_in(conv1_pool_bf16_kernel<KS, VEC>, opted_in, device);
  if (e != cudaSuccess) return e;
  conv1_pool_bf16_kernel<KS, VEC><<<p.B * p.tiles * p.runs, MMA_NT, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int KS>
cudaError_t launch_bf16_vec(const MmaParams& p, int vec, int device, cudaStream_t s) {
  if (vec == 4) return launch_bf16<KS, 4>(p, device, s);
  if (vec == 2) return launch_bf16<KS, 2>(p, device, s);
  return launch_bf16<KS, 0>(p, device, s);
}

// Grid: B x tiles of tile_rows x tile_cols pooled positions x n_chunks runs
// of ceil(T / n_chunks) frames (the wrapper's `mma_grid`).
int run_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w, const float* bias,
             __nv_bfloat16* out, int B, int T, int H, int W, int kt, int kh, int kw, int C,
             int n_chunks, int tile_rows, int tile_cols,
             long long x_sb, long long x_st, long long x_sh, long long x_sw,
             long long w_tap, long long w_c,
             long long o_sb, long long o_st, long long o_sh, long long o_sw,
             long long o_sc, int device, void* stream) {
  if (C < 1 || n_chunks < 1 || n_chunks > T || B < 1 || T < 1 || H < 2 || W < 2 ||
      tile_rows < 1 || tile_cols < 1 || tile_rows * tile_cols > MMA_NT || kt % 2 == 0 ||
      kh % 2 == 0 || kw % 2 == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = set_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  MmaParams p{x, w, bias, out, mma_geo(kt, kh, kw, C, tile_rows, tile_cols), B, T, H, W};
  p.F = (T + n_chunks - 1) / n_chunks;
  p.runs = (T + p.F - 1) / p.F;
  p.tiles_w = (W / 2 + tile_cols - 1) / tile_cols;
  p.tiles = ((H / 2 + tile_rows - 1) / tile_rows) * p.tiles_w;
  p.x_sb = x_sb, p.x_st = x_st, p.x_sh = x_sh, p.x_sw = x_sw;
  p.w_tap = w_tap, p.w_c = w_c;
  p.o_sb = o_sb, p.o_st = o_st, p.o_sh = o_sh, p.o_sw = o_sw, p.o_sc = o_sc;
  const int vec = mma_stage_vec(x, x_sb, x_st, x_sh, x_sw);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = p.g.ksteps == 6 ? launch_bf16_vec<6>(p, vec, device, s)
                      : launch_bf16_vec<0>(p, vec, device, s);
  return static_cast<int>(e);
}

}  // namespace

#define AVS_CONV1_POOL_ARGS                                                             \
  int B, int T, int H, int W, int kt, int kh, int kw, int C, int n_chunks, int tile_rows, \
      int tile_cols, long long x_sb, long long x_st, long long x_sh, long long x_sw,      \
      long long w_tap, long long w_c, long long o_sb, long long o_st, long long o_sh,     \
      long long o_sw, long long o_sc, int device, void *stream
#define AVS_CONV1_POOL_PASS                                                              \
  B, T, H, W, kt, kh, kw, C, n_chunks, tile_rows, tile_cols, x_sb, x_st, x_sh, x_sw, w_tap, \
      w_c, o_sb, o_st, o_sh, o_sw, o_sc, device, stream

// float x, weights and output
extern "C" int avs_conv1_pool(const float* x, const float* w, const float* bias, float* out,
                              AVS_CONV1_POOL_ARGS) {
  return run(x, w, bias, out, AVS_CONV1_POOL_PASS);
}

// bf16 x, weights and output; the bias stays float. n_chunks: the runs of
// frames per clip.
extern "C" int avs_conv1_pool_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                   const float* bias, __nv_bfloat16* out,
                                   AVS_CONV1_POOL_ARGS) {
  return run_bf16(x, w, bias, out, AVS_CONV1_POOL_PASS);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
