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
// positions alone is 1.8 G (3.6 GFLOP): about 0.27 ms at 67 TFLOP/s,
// against 12 MB of x and 96 MB of g (0.032 ms).
//
// Design. K1's tile, and no float atomics:
//   * a grid of (spatial tile of 8 x 32 pooled positions, chunk of frames);
//     each CTA walks the frames f = chunk, chunk + n_chunks, ... of its
//     chunk, so that it writes one partial (taps x C weights + C biases) for
//     many frames;
//   * per frame it stages the input halo of its tile for the kt frames
//     around t in shared memory (zero outside the clip: SAME padding, any
//     T), and each thread recomputes the four pre-pool values of its pooled
//     position for a block of 16 channels in registers, in K1's order, so
//     that the routing sees the values the forward pooled;
//   * the routed gradient g (0 where nothing is routed) and the input offset
//     of the routed window position go to shared memory, one row per
//     channel;
//   * then thread (channel c = lane, tap group = warp) accumulates
//     x[offset + tap] * g over the tile's 256 pooled positions into
//     registers that persist across the chunk's frames: only the routed
//     position of each window is multiplied (the 3.6 GFLOP, not 14.4);
//   * a second kernel sums the n_chunks x tiles partials of each output in
//     a fixed order and writes dW through strides (the JAX layout
//     (kt, kh, kw, 1, C) or the model's (C, 1, kt, kh, kw)) and db. Two runs
//     give bit-identical results.
// g is read through strides, so the model's NCDHW cotangent and the JAX
// layout both work without a copy.

#include <cuda_runtime.h>

namespace {

constexpr int TW2 = 32;          // pooled columns per CTA (one warp)
constexpr int TH2 = 8;           // pooled rows per CTA
constexpr int NT = TW2 * TH2;    // threads per CTA, one pooled position each
constexpr int CB = 16;           // channels per register block (recompute)
constexpr int MAXC = 32;         // channels: one lane each in the dW phase
constexpr int TAPQ = 16;         // taps per thread in the dW phase, at most
constexpr int NWARP = NT / 32;   // tap groups
constexpr int GP = NT + 1;       // padded row of the routing arrays

struct ConvPoolBwdParams {
  const float* x;     // input, element strides below
  const float* w;     // weights, w[tap * w_tap + c * w_c], tap = (dt*kh+dh)*kw+dw
  const float* bias;  // (C,), contiguous
  const float* g;     // pooled cotangent, element strides below
  float* partial;     // [grid blocks][taps * C + C]
  float* dw;          // dw[tap * dw_tap + c * dw_c]
  float* db;          // (C,), contiguous
  int B, T, H, W, kt, kh, kw, C, n_chunks, n_partials;
  long long x_sb, x_st, x_sh, x_sw;
  long long w_tap, w_c;
  long long g_sb, g_st, g_sh, g_sw, g_sc;
  long long dw_tap, dw_c;
};

// KT/KH/KW == 0 means "read the size from the params" (generic path).
template <int KT, int KH, int KW>
__global__ void __launch_bounds__(NT, 1)
conv1_pool_bwd_kernel(const ConvPoolBwdParams p) {
  const int kt = KT ? KT : p.kt;
  const int kh = KH ? KH : p.kh;
  const int kw = KW ? KW : p.kw;
  const int taps = kt * kh * kw;
  const int C = p.C;
  const int cpad = (C + CB - 1) / CB * CB;
  const int IH = 2 * TH2 + kh - 1;
  const int IW = 2 * TW2 + kw - 1;
  const int H2 = p.H / 2, W2 = p.W / 2;
  const int tiles_w = (W2 + TW2 - 1) / TW2;

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [taps][cpad]
  float* s_b = s_w + taps * cpad;                // [cpad]
  float* s_gv = s_b + cpad;                      // [MAXC][GP] routed g
  int* s_off = reinterpret_cast<int*>(s_gv + MAXC * GP);  // [MAXC][GP]
  float* s_x = reinterpret_cast<float*>(s_off + MAXC * GP);  // [kt][IH][IW]

  const int tid = threadIdx.x;
  const int h2_0 = (blockIdx.x / tiles_w) * TH2;
  const int w2_0 = (blockIdx.x % tiles_w) * TW2;

  for (int i = tid; i < taps * cpad; i += NT) {
    const int tap = i / cpad, c = i % cpad;
    s_w[i] = c < C ? p.w[tap * p.w_tap + c * p.w_c] : 0.f;
  }
  for (int c = tid; c < cpad; c += NT) s_b[c] = c < C ? p.bias[c] : 0.f;

  // recompute role: one pooled position per thread
  const int ty = tid / TW2, tx = tid % TW2;
  const int h2 = h2_0 + ty, w2 = w2_0 + tx;
  const bool live = h2 < H2 && w2 < W2;

  // dW role: channel = lane, taps wq, wq + NWARP, ...
  const int lc = tid % 32, wq = tid / 32;
  int toff[TAPQ];
  float acc2[TAPQ];
#pragma unroll
  for (int q = 0; q < TAPQ; ++q) {
    const int tap = wq + q * NWARP;
    const int tt = tap < taps ? tap : 0;
    toff[q] = ((tt / (kh * kw)) * IH + (tt / kw) % kh) * IW + tt % kw;
    acc2[q] = 0.f;
  }
  float dbacc = 0.f;

  const int pt = (kt - 1) / 2, ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int h_in0 = 2 * h2_0 - ph, w_in0 = 2 * w2_0 - pw;

  for (int f = blockIdx.y; f < p.B * p.T; f += p.n_chunks) {
    const int b = f / p.T, t = f % p.T;
    const float* xb = p.x + b * p.x_sb;
    for (int i = tid; i < kt * IH * IW; i += NT) {
      const int dt = i / (IH * IW);
      const int r = (i / IW) % IH;
      const int cc = i % IW;
      const int ti = t + dt - pt, hi = h_in0 + r, wi = w_in0 + cc;
      float v = 0.f;
      if (ti >= 0 && ti < p.T && hi >= 0 && hi < p.H && wi >= 0 && wi < p.W)
        v = xb[ti * p.x_st + hi * p.x_sh + wi * p.x_sw];
      s_x[i] = v;
    }
    __syncthreads();

    const float* gb = p.g + b * p.g_sb + t * p.g_st + h2 * p.g_sh + w2 * p.g_sw;
    for (int c0 = 0; c0 < C; c0 += CB) {
      float acc[4][CB];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < CB; ++c) acc[j][c] = 0.f;

      for (int dt = 0; dt < kt; ++dt) {
#pragma unroll
        for (int dh = 0; dh < kh; ++dh) {
          const float* xs = s_x + (dt * IH + 2 * ty + dh) * IW + 2 * tx;
          const float* ws = s_w + ((dt * kh + dh) * kw) * cpad + c0;
#pragma unroll
          for (int dw = 0; dw < kw; ++dw) {
            const float v0 = xs[dw], v1 = xs[dw + 1];
            const float v2 = xs[IW + dw], v3 = xs[IW + dw + 1];
            const float4* w4 = reinterpret_cast<const float4*>(ws + dw * cpad);
#pragma unroll
            for (int q = 0; q < CB / 4; ++q) {
              const float4 wv4 = w4[q];
              const float wv[4] = {wv4.x, wv4.y, wv4.z, wv4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int c = 4 * q + e;
                acc[0][c] = fmaf(v0, wv[e], acc[0][c]);
                acc[1][c] = fmaf(v1, wv[e], acc[1][c]);
                acc[2][c] = fmaf(v2, wv[e], acc[2][c]);
                acc[3][c] = fmaf(v3, wv[e], acc[3][c]);
              }
            }
          }
        }
      }

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
          s_gv[ch * GP + tid] = (live && m > 0.f) ? gb[ch * p.g_sc] : 0.f;
          s_off[ch * GP + tid] = (2 * ty + (jm >> 1)) * IW + 2 * tx + (jm & 1);
        }
      }
    }
    __syncthreads();

    if (lc < C) {
      const float* gv_row = s_gv + lc * GP;
      const int* off_row = s_off + lc * GP;
      for (int pos = 0; pos < NT; ++pos) {
        const float gv = gv_row[pos];
        const float* xo = s_x + off_row[pos];
#pragma unroll
        for (int q = 0; q < TAPQ; ++q)
          if (wq + q * NWARP < taps) acc2[q] = fmaf(xo[toff[q]], gv, acc2[q]);
        dbacc += gv;
      }
    }
    __syncthreads();  // s_x and the routing rows are rewritten next frame
  }

  float* part = p.partial + (size_t)(blockIdx.y * gridDim.x + blockIdx.x) *
                                (taps * C + C);
  if (lc < C) {
#pragma unroll
    for (int q = 0; q < TAPQ; ++q) {
      const int tap = wq + q * NWARP;
      if (tap < taps) part[tap * C + lc] = acc2[q];
    }
    if (wq == 0) part[taps * C + lc] = dbacc;
  }
}

// out[o] = sum over the partials in index order; o < taps*C are weights.
__global__ void __launch_bounds__(NT)
conv1_pool_bwd_sum_kernel(const ConvPoolBwdParams p) {
  const int taps = p.kt * p.kh * p.kw;
  const int n_out = taps * p.C + p.C;
  const int o = blockIdx.x * NT + threadIdx.x;
  if (o >= n_out) return;
  float s = 0.f;
  for (int k = 0; k < p.n_partials; ++k) s += p.partial[(size_t)k * n_out + o];
  if (o < taps * p.C) {
    p.dw[(o / p.C) * p.dw_tap + (o % p.C) * p.dw_c] = s;
  } else {
    p.db[o - taps * p.C] = s;
  }
}

size_t smem_bytes(int kt, int kh, int kw, int C) {
  const int cpad = (C + CB - 1) / CB * CB;
  const size_t floats = (size_t)kt * kh * kw * cpad + cpad +
                        2 * (size_t)MAXC * GP +
                        (size_t)kt * (2 * TH2 + kh - 1) * (2 * TW2 + kw - 1);
  return floats * sizeof(float);
}

constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90

template <int KT, int KH, int KW>
cudaError_t launch(const ConvPoolBwdParams& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.kt, p.kh, p.kw, p.C);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      conv1_pool_bwd_kernel<KT, KH, KW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  conv1_pool_bwd_kernel<KT, KH, KW><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Grid: (spatial tiles, n_chunks); `partial` holds tiles * n_chunks rows of
// taps * C + C floats (the wrapper allocates it).
extern "C" int avs_conv1_pool_bwd(
    const float* x, const float* w, const float* bias, const float* g,
    float* partial, float* dw, float* db,
    int B, int T, int H, int W, int kt, int kh, int kw, int C, int n_chunks,
    long long x_sb, long long x_st, long long x_sh, long long x_sw,
    long long w_tap, long long w_c,
    long long g_sb, long long g_st, long long g_sh, long long g_sw,
    long long g_sc, long long dw_tap, long long dw_c, int device,
    void* stream) {
  if (C < 1 || C > MAXC || kt * kh * kw > TAPQ * NWARP || n_chunks < 1 ||
      B < 1 || T < 1 || H < 2 || W < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((H / 2 + TH2 - 1) / TH2) * ((W / 2 + TW2 - 1) / TW2);
  const ConvPoolBwdParams p{x, w, bias, g, partial, dw, db,
                            B, T, H, W, kt, kh, kw, C, n_chunks,
                            tiles * n_chunks,
                            x_sb, x_st, x_sh, x_sw, w_tap, w_c,
                            g_sb, g_st, g_sh, g_sw, g_sc, dw_tap, dw_c};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(tiles, n_chunks);
  if (kt == 3 && kh == 5 && kw == 5) {
    e = launch<3, 5, 5>(p, grid, s);
  } else if (kt == 3 && kh == 3 && kw == 3) {
    e = launch<3, 3, 3>(p, grid, s);
  } else {
    e = launch<0, 0, 0>(p, grid, s);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_out = kt * kh * kw * C + C;
  conv1_pool_bwd_sum_kernel<<<(n_out + NT - 1) / NT, NT, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
