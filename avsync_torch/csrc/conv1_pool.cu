// Fused conv1 + bias + ReLU + MaxPool3D(1,2,2) for one input channel.
//
// Replaces: avsync/ops/pallas/convpool.py, `conv1_pool_fused` (Pallas TPU
// kernel `_fwd_kernel`). Same function: a SAME-padded stride-1 Conv3D with
// Cin = 1 and odd kernel (kt, kh, kw), plus bias, ReLU and a (1, 2, 2) max
// pool; only the pooled tile is written.
//
// What bounds it on the H100: fp32 FMAs on the CUDA cores. At the LipNet
// shape (B=8, T=75, 50x100, 32 channels, 3x5x5 taps) the conv is 7.2 G
// multiply-adds (14.4 GFLOP) against 12 MB of input and 96 MB of pooled
// output, so the operations, not the bytes, set the floor.
//
// Design. The TPU kernel read a 108x im2col patch tensor from device memory
// because Mosaic could not build patches on chip; here nothing but the raw
// input and the pooled output touch device memory:
//   * one CTA per (frame b*T+t, tile of 8 x 32 pooled positions), 256
//     threads, one pooled position per thread;
//   * the CTA stages the input halo of its tile for the kt frames around t
//     in shared memory ((16+kh-1) x (64+kw-1) x kt floats, zero outside the
//     clip: SAME padding in time and space), plus the weights (taps x C) and
//     the bias;
//   * each thread accumulates its four pre-pool positions for a block of 16
//     channels in registers (64 accumulators): per tap it reads 4 inputs and
//     16 weights (broadcast float4 loads) for 64 FMAs;
//   * epilogue per channel: bias, max of the four, ReLU (ReLU is monotone,
//     so this equals max_pool(relu(conv))), one store.
// The output is written through strides, so the same kernel produces the
// model's NCDHW (B, C, T, H/2, W/2) and the JAX package's (B, T, H/2, W/2, C).
// Any T works (no temporal chunking constraint).

#include <cuda_runtime.h>

namespace {

constexpr int TW2 = 32;          // pooled columns per CTA (one warp)
constexpr int TH2 = 8;           // pooled rows per CTA
constexpr int NT = TW2 * TH2;    // threads per CTA, one pooled position each
constexpr int CB = 16;           // channels per register block

struct ConvPoolParams {
  const float* x;     // input, element strides below
  const float* w;     // weights, w[tap * w_tap + c * w_c], tap = (dt*kh+dh)*kw+dw
  const float* bias;  // (C,), contiguous
  float* out;         // pooled output, element strides below
  int B, T, H, W, kt, kh, kw, C;
  long long x_sb, x_st, x_sh, x_sw;
  long long w_tap, w_c;
  long long o_sb, o_st, o_sh, o_sw, o_sc;
};

// KT/KH/KW == 0 means "read the size from the params" (generic path).
template <int KT, int KH, int KW>
__global__ void __launch_bounds__(NT)
conv1_pool_kernel(const ConvPoolParams p) {
  const int kt = KT ? KT : p.kt;
  const int kh = KH ? KH : p.kh;
  const int kw = KW ? KW : p.kw;
  const int taps = kt * kh * kw;
  const int cpad = (p.C + CB - 1) / CB * CB;
  const int IH = 2 * TH2 + kh - 1;
  const int IW = 2 * TW2 + kw - 1;
  const int H2 = p.H / 2, W2 = p.W / 2;

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [taps][cpad]
  float* s_b = s_w + taps * cpad;                // [cpad]
  float* s_x = s_b + cpad;                       // [kt][IH][IW]

  const int bt = blockIdx.x;
  const int b = bt / p.T, t = bt % p.T;
  const int h2_0 = blockIdx.y * TH2, w2_0 = blockIdx.z * TW2;
  const int tid = threadIdx.x;

  for (int i = tid; i < taps * cpad; i += NT) {
    const int tap = i / cpad, c = i % cpad;
    s_w[i] = c < p.C ? p.w[tap * p.w_tap + c * p.w_c] : 0.f;
  }
  for (int c = tid; c < cpad; c += NT) s_b[c] = c < p.C ? p.bias[c] : 0.f;

  const int pt = (kt - 1) / 2, ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int h_in0 = 2 * h2_0 - ph, w_in0 = 2 * w2_0 - pw;
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

  const int ty = tid / TW2, tx = tid % TW2;
  const int h2 = h2_0 + ty, w2 = w2_0 + tx;
  const bool live = h2 < H2 && w2 < W2;
  float* ob = p.out + b * p.o_sb + t * p.o_st + h2 * p.o_sh + w2 * p.o_sw;

  for (int c0 = 0; c0 < p.C; c0 += CB) {
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
            const float4 wq = w4[q];
            const float wv[4] = {wq.x, wq.y, wq.z, wq.w};
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

    if (live) {
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
}

size_t smem_bytes(int kt, int kh, int kw, int C) {
  const int cpad = (C + CB - 1) / CB * CB;
  const size_t floats = (size_t)kt * kh * kw * cpad + cpad +
                        (size_t)kt * (2 * TH2 + kh - 1) * (2 * TW2 + kw - 1);
  return floats * sizeof(float);
}

template <int KT, int KH, int KW>
cudaError_t launch(const ConvPoolParams& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.kt, p.kh, p.kw, p.C);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        conv1_pool_kernel<KT, KH, KW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(p.B * p.T, (p.H / 2 + TH2 - 1) / TH2,
                  (p.W / 2 + TW2 - 1) / TW2);
  conv1_pool_kernel<KT, KH, KW><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int avs_conv1_pool(
    const float* x, const float* w, const float* bias, float* out,
    int B, int T, int H, int W, int kt, int kh, int kw, int C,
    long long x_sb, long long x_st, long long x_sh, long long x_sw,
    long long w_tap, long long w_c,
    long long o_sb, long long o_st, long long o_sh, long long o_sw,
    long long o_sc, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const ConvPoolParams p{x, w, bias, out, B, T, H, W, kt, kh, kw, C,
                         x_sb, x_st, x_sh, x_sw, w_tap, w_c,
                         o_sb, o_st, o_sh, o_sw, o_sc};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kt == 3 && kh == 5 && kw == 5) {
    e = launch<3, 5, 5>(p, s);
  } else if (kt == 3 && kh == 3 && kw == 3) {
    e = launch<3, 3, 3>(p, s);
  } else {
    e = launch<0, 0, 0>(p, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
