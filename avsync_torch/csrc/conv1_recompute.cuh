// The float pre-pool values of the fused conv1 block, shared by K1
// (conv1_pool.cu, the forward) and K4 (conv1_pool_bwd.cu, which recomputes
// them to route the pooled gradient): both include this one loop, so K4
// routes on exactly the bits K1 pooled. The bf16 instantiations of both
// share conv1_mma.cuh instead: the same function on the bf16 tensor cores.
#pragma once

#include <cuda_runtime.h>

#include "cp_async.cuh"

namespace {

// acc[j][c] = sum over the taps (dt, dh, dw), in that order from 0, one fmaf
// each, of x(window position j + tap) * w(tap, c0 + c), for the four
// positions j = (0,0), (0,1), (1,0), (1,1) of one pooled position's 2x2
// window and CB channels; the caller adds the bias. `xs` is the input halo
// kept as pairs (x[i], x[i + 1]), [kt][IH][IW], at the window's top-left
// corner, so one 8-byte load gives both columns of a window row; `ws` is the
// weights [taps][cpad] at channel c0. KT/KH/KW == 0: sizes read at run time.
template <int KT, int KH, int KW, int CB>
__device__ __forceinline__ void conv1_window_sums(float (&acc)[4][CB], const float2* xs,
                                                  const float* ws, int kt, int kh, int kw,
                                                  int IH, int IW, int cpad) {
  kt = KT ? KT : kt;
  kh = KH ? KH : kh;
  kw = KW ? KW : kw;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CB; ++c) acc[j][c] = 0.f;

  for (int dt = 0; dt < kt; ++dt) {
#pragma unroll
    for (int dh = 0; dh < kh; ++dh) {
      const float2* xr = xs + (dt * IH + dh) * IW;
      const float* wr = ws + ((dt * kh + dh) * kw) * cpad;
#pragma unroll
      for (int dw = 0; dw < kw; ++dw) {
        const float2 top = xr[dw], bot = xr[IW + dw];
        const float v0 = top.x, v1 = top.y, v2 = bot.x, v3 = bot.y;
        const float4* w4 = reinterpret_cast<const float4*>(wr + dw * cpad);
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
}

// Issue the cp.async copies of frame (b, t)'s input halo for the pooled tile
// at (h2_0, w2_0): [kt][IH][IW] pairs (x[i], x[i + 1]), zero outside the
// clip (SAME padding in time and space, any T).
__device__ __forceinline__ void conv1_stage_halo(float2* s_x, const float* x, int b, int t,
                                                 int h2_0, int w2_0, int kt, int kh, int kw,
                                                 int IH, int IW, int T, int H, int W,
                                                 long long x_sb, long long x_st,
                                                 long long x_sh, long long x_sw) {
  const int pt = (kt - 1) / 2, ph = (kh - 1) / 2, pw = (kw - 1) / 2;
  const int h_in0 = 2 * h2_0 - ph, w_in0 = 2 * w2_0 - pw;
  const float* xb = x + b * x_sb;
  // pair i = (dt * IH + r) * IW + cc; the thread's (dt, r, cc) advance by the
  // block's stride without a division per pair
  const int step_r = blockDim.x / IW, step_c = blockDim.x % IW;
  int cc = threadIdx.x % IW, r = threadIdx.x / IW, dt = 0;
  while (r >= IH) r -= IH, ++dt;
  for (int i = threadIdx.x; i < kt * IH * IW; i += blockDim.x) {
    const int ti = t + dt - pt, hi = h_in0 + r, wi = w_in0 + cc;
    const bool row = ti >= 0 && ti < T && hi >= 0 && hi < H;
    const bool ok0 = row && wi >= 0 && wi < W, ok1 = row && wi + 1 >= 0 && wi + 1 < W;
    const float* src = xb + ti * x_st + hi * x_sh + wi * x_sw;
    float* dst = reinterpret_cast<float*>(s_x + i);
    cp_async4(dst, ok0 ? src : x, ok0);
    cp_async4(dst + 1, ok1 ? src + x_sw : x, ok1);
    cc += step_c;
    r += step_r;
    if (cc >= IW) cc -= IW, ++r;
    while (r >= IH) r -= IH, ++dt;
  }
}

}  // namespace
