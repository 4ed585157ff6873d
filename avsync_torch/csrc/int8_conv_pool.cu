// int8 Conv3D block for serving: quantize -> int8 conv on the tensor cores
// (s8 x s8 -> s32) -> dequant + bias -> ReLU -> MaxPool3D(1,2,2), one launch.
//
// Replaces: the int8 `lax.conv_general_dilated` of avsync/ops/quant.py,
// `quant_conv_block` (:97-135), which the JAX package leaves to XLA (no
// Pallas kernel). Same function, per block:
//   xq  = clip(rint(x / x_scale), -127, 127)                  (int8)
//   acc = conv3d(xq, kernel_q), SAME padding, stride 1         (exact int32)
//   out = maxpool(1,2,2)(relu(float(acc) * scale[c] + bias[c])),
//   scale[c] = x_scale * k_scale[c] (f32, made once per load by the wrapper).
// float(), the multiply by a positive scale, + bias and ReLU are monotone
// non-decreasing in f32, so the max of the four pre-pool accumulators is taken
// first, in int32, and the epilogue runs once per pooled value; it is written
// with __fmul_rn / __fadd_rn (no FMA contraction), so the kernel equals its
// plain version (`int8_conv_pool_ref`, ops/cuda/quantconv.py) bit for bit.
//
// What bounds it on the H100: at LipNet's conv2 (B=8, 32 -> 64 channels,
// 3x5x5 taps, 75 x 25 x 50) the conv is 221 G int8 operations over the
// pre-pool positions the floor pool keeps, 0.112 ms at the card's 1,979
// TOPS, against 96 MB of f32 input and 46 MB of pooled output (0.042 ms):
// the operations set the floor. conv1 (Cin = 1, K = 75) is the other way
// round: 14.4 G operations against 12 MB in and 96 MB out (0.032 ms).
//
// Design (simple and right first; wgmma, TMA and a persistent schedule are
// later work; numbers: H100 80GB HBM3 at 700 W,
// scripts/torch_kernel_breakdown.py --mode q1):
//   * an implicit GEMM: M = pre-pool positions, N = output channels, K =
//     (tap, input channel) with each tap's channels contiguous, zero-padded
//     to a multiple of 32 (conv1's 75 -> 96, conv2's 2400 stays);
//   * a CTA is one frame (b, t) x a tile of PR x PC pooled positions (chosen
//     by the wrapper, `quantconv.tile_for`) x every output channel. It stages
//     its input halo for the kt frames around t into shared memory, already
//     quantized to int8, one position after another with its channels
//     contiguous (S bytes per position, S = Cin, or for Cin % 4 == 0 the
//     smallest S >= Cin with S = 8 mod 16, which spreads a warp's A-fragment
//     loads over the 32 banks); out-of-clip positions are 0 (SAME padding).
//     The staging is latency-bound: each thread has four loads in flight,
//     and a channels-last input moves four channels per 16-byte load (at
//     conv2, B=8: 0.28 ms of device time against 0.71 one value per load);
//   * a warp task is 16 pooled positions x 32 channels: four m16 row blocks,
//     one per pool-window offset (jh, jw), share the B fragments, so a
//     thread's accumulators of the four blocks at one index are the four
//     pre-pool values of one pooled output: their max needs no shuffle;
//   * mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, four n8 tiles per
//     task. A fragments come from the halo through a table of byte offsets
//     per k (per group of 4 k when Cin % 4 == 0: one 32-bit load each), B
//     fragments straight from the packed (Npad, Kpad) weights (read-only
//     path; they stay in L1/L2);
//   * pooled positions outside the frame, rows past the tile and channels
//     past Cout compute on zeros or in-bounds data and are not written; the
//     pre-pool row or column a floor pool drops is never computed.
// The output is written through strides (the wrapper asks for channels-last,
// which the next block's halo reads channel-contiguous).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int NT = 256;  // threads per CTA (8 warps)
constexpr int NWARPS = NT / 32;
constexpr int STAGE_UNROLL = 4;  // halo loads in flight per thread
constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90
constexpr int MAX_DEVICES = 64;

struct QParams {
  const float* x;       // (B, Cin, T, H, W) f32, element strides below
  const int8_t* w;      // (Npad, Kpad) int8, k = ((dt*kh + dh)*kw + dw)*Cin + ci
  const float* scale;   // (Cout,) x_scale * k_scale
  const float* bias;    // (Cout,)
  float* out;           // (B, Cout, T, H/2, W/2) f32, element strides below
  float x_scale;
  int B, Cin, T, H, W, Cout, kt, kh, kw, K, Kpad, Npad;
  int PR, PC, tiles_w, tiles, IH, IW, S, off_bytes;
  bool vec4;  // channels-last, Cin % 4 == 0, 16-byte aligned: float4 staging
  long long x_sb, x_sc, x_st, x_sh, x_sw;
  long long o_sb, o_sc, o_st, o_sh, o_sw;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

// The kernel's shared memory: the offset table (one int per k, or per group
// of four k when WORDS), then the halo.
__host__ __device__ inline int offset_entries(bool words, int Kpad) {
  return words ? Kpad / 4 : Kpad;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s)), -127.f), 127.f);
  return static_cast<int8_t>(static_cast<int>(q));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four int8 values of one position's k-run through per-k offsets (-1: zero).
__device__ __forceinline__ uint32_t gather4(const unsigned char* base, const int (&o)[4]) {
  uint32_t v = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t byte = o[i] >= 0 ? base[o[i]] : 0u;
    v |= byte << (8 * i);
  }
  return v;
}

__device__ __forceinline__ uint32_t load4(const unsigned char* base, int o) {
  return o >= 0 ? *reinterpret_cast<const uint32_t*>(base + o) : 0u;
}

// Stage the CTA's halo: frames t - pt .. t + pt, rows 2*h2_0 - ph ..,
// columns 2*w2_0 - pw .., each value quantized; zero outside the clip. Each
// thread issues STAGE_UNROLL loads before it quantizes and stores any of
// them, so that many loads are in flight (the staging is latency-bound);
// a channels-last input with Cin % 4 == 0 (what Q1 writes, `p.vec4`) moves
// four channels per 16-byte load and one 32-bit shared store.
__device__ void stage_halo(const QParams& p, unsigned char* s_x, int b, int t, int h2_0,
                           int w2_0) {
  const int pt = (p.kt - 1) / 2, ph = (p.kh - 1) / 2, pw = (p.kw - 1) / 2;
  const int t0 = t - pt, h0 = 2 * h2_0 - ph, w0 = 2 * w2_0 - pw;
  const float* xb = p.x + b * p.x_sb;
  const int npos = p.kt * p.IH * p.IW;
  if (p.vec4) {
    // i -> (position, group of four channels), the groups fastest
    const int c4 = p.Cin / 4, n = npos * c4;
    for (int i0 = threadIdx.x; i0 < n; i0 += STAGE_UNROLL * NT) {
      float4 v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT, pos = i / c4;
        const int ww = pos % p.IW, hh = (pos / p.IW) % p.IH, dt = pos / (p.IW * p.IH);
        const int ti = t0 + dt, hi = h0 + hh, wi = w0 + ww;
        const bool in = i < n && ti >= 0 && ti < p.T && hi >= 0 && hi < p.H && wi >= 0 &&
                        wi < p.W;
        v[u] = in ? __ldg(reinterpret_cast<const float4*>(
                            xb + ti * p.x_st + hi * p.x_sh + wi * p.x_sw) + i % c4)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT;
        if (i >= n) break;
        const uint32_t q = static_cast<uint8_t>(quantize(v[u].x, p.x_scale)) |
                           static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[u].y, p.x_scale))) << 8 |
                           static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[u].z, p.x_scale))) << 16 |
                           static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[u].w, p.x_scale))) << 24;
        *reinterpret_cast<uint32_t*>(s_x + (i / c4) * p.S + 4 * (i % c4)) = q;
      }
    }
  } else {
    // i -> (channel, position), the columns fastest (coalesced for NCDHW)
    const int n = p.Cin * npos;
    for (int i0 = threadIdx.x; i0 < n; i0 += STAGE_UNROLL * NT) {
      float v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT, pos = i % npos, ci = i / npos;
        const int ww = pos % p.IW, hh = (pos / p.IW) % p.IH, dt = pos / (p.IW * p.IH);
        const int ti = t0 + dt, hi = h0 + hh, wi = w0 + ww;
        const bool in = i < n && ti >= 0 && ti < p.T && hi >= 0 && hi < p.H && wi >= 0 &&
                        wi < p.W;
        v[u] = in ? __ldg(xb + ci * p.x_sc + ti * p.x_st + hi * p.x_sh + wi * p.x_sw) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT;
        if (i >= n) break;
        reinterpret_cast<int8_t*>(s_x)[(i % npos) * p.S + i / npos] = quantize(v[u], p.x_scale);
      }
    }
  }
}

template <bool WORDS>
__global__ void __launch_bounds__(NT, 2) int8_conv_pool_kernel(const QParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_off = reinterpret_cast<int*>(smem);
  unsigned char* s_x = smem + p.off_bytes;

  const int tile = blockIdx.x % p.tiles;
  const int f = blockIdx.x / p.tiles;
  const int b = f / p.T, t = f % p.T;
  const int h2_0 = (tile / p.tiles_w) * p.PR, w2_0 = (tile % p.tiles_w) * p.PC;

  // offsets of k (or of the group k = 4*kg .. 4*kg + 3) from a position's
  // halo byte; -1 past K
  const int n_off = offset_entries(WORDS, p.Kpad);
  const int step = WORDS ? 4 : 1;
  for (int i = threadIdx.x; i < n_off; i += NT) {
    const int k = i * step;
    int off = -1;
    if (k < p.K) {
      const int tap = k / p.Cin, ci = k % p.Cin;
      const int dt = tap / (p.kh * p.kw), dh = (tap / p.kw) % p.kh, dw = tap % p.kw;
      off = ((dt * p.IH + dh) * p.IW + dw) * p.S + ci;
    }
    s_off[i] = off;
  }
  stage_halo(p, s_x, b, t, h2_0, w2_0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int P = p.PR * p.PC;
  const int mgroups = (P + 15) / 16, ngroups = p.Npad / 32;
  const int H2 = p.H / 2, W2 = p.W / 2;
  const int chunks = p.Kpad / 32;

  for (int task = warp; task < mgroups * ngroups; task += NWARPS) {
    const int mg = task / ngroups, ng = task % ngroups;
    // the thread's two rows: pooled positions mg*16 + g and + 8 of the tile
    int idx[2] = {mg * 16 + g, mg * 16 + g + 8};
    int base[4][2];  // [window (jh, jw)][row]: halo byte of the pre-pool position
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = idx[r] < P ? idx[r] : 0;
      const int ph = q / p.PC, pw = q % p.PC;
#pragma unroll
      for (int wdw = 0; wdw < 4; ++wdw)
        base[wdw][r] = ((2 * ph + (wdw >> 1)) * p.IW + 2 * pw + (wdw & 1)) * p.S;
    }
    int acc[4][4][4];  // [window][n8 tile][fragment register]
#pragma unroll
    for (int wdw = 0; wdw < 4; ++wdw)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[wdw][j][i] = 0;

    const int8_t* wg = p.w + (size_t)(ng * 32 + g) * p.Kpad + tq * 4;
    for (int kc = 0; kc < chunks; ++kc) {
      uint32_t bf[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* wr = wg + (size_t)j * 8 * p.Kpad + kc * 32;
        bf[j][0] = static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(wr)));
        bf[j][1] = static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(wr + 16)));
      }
      if constexpr (WORDS) {
        const int o0 = s_off[kc * 8 + tq], o1 = s_off[kc * 8 + tq + 4];
#pragma unroll
        for (int wdw = 0; wdw < 4; ++wdw) {
          const uint32_t a[4] = {load4(s_x + base[wdw][0], o0), load4(s_x + base[wdw][1], o0),
                                 load4(s_x + base[wdw][0], o1), load4(s_x + base[wdw][1], o1)};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[wdw][j], a, bf[j][0], bf[j][1]);
        }
      } else {
        int o0[4], o1[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o0[i] = s_off[kc * 32 + tq * 4 + i];
          o1[i] = s_off[kc * 32 + 16 + tq * 4 + i];
        }
#pragma unroll
        for (int wdw = 0; wdw < 4; ++wdw) {
          const uint32_t a[4] = {gather4(s_x + base[wdw][0], o0), gather4(s_x + base[wdw][1], o0),
                                 gather4(s_x + base[wdw][0], o1),
                                 gather4(s_x + base[wdw][1], o1)};
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[wdw][j], a, bf[j][0], bf[j][1]);
        }
      }
    }

    // epilogue: fragment register i holds row g + 8*(i >> 1), channel 2*tq + (i & 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i >> 1;
      if (idx[r] >= P) continue;
      const int h2 = h2_0 + idx[r] / p.PC, w2 = w2_0 + idx[r] % p.PC;
      if (h2 >= H2 || w2 >= W2) continue;
      float* ob = p.out + b * p.o_sb + t * p.o_st + h2 * p.o_sh + w2 * p.o_sw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = ng * 32 + j * 8 + 2 * tq + (i & 1);
        if (c >= p.Cout) continue;
        const int m = max(max(acc[0][j][i], acc[1][j][i]), max(acc[2][j][i], acc[3][j][i]));
        const float v = __fadd_rn(__fmul_rn(__int2float_rn(m), p.scale[c]), p.bias[c]);
        ob[c * p.o_sc] = fmaxf(v, 0.f);
      }
    }
  }
}

size_t smem_bytes(bool words, int Kpad, int kt, int IH, int IW, int S) {
  return (size_t)align16(4 * offset_entries(words, Kpad)) + (size_t)kt * IH * IW * S;
}

// The shared-memory opt-in of each instantiation, set once per device.
template <bool WORDS>
cudaError_t launch(const QParams& p, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = smem_bytes(WORDS, p.Kpad, p.kt, p.IH, p.IW, p.S);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (device >= MAX_DEVICES || !opted_in[device].load()) {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_pool_kernel<WORDS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MAX_SMEM);
    if (e != cudaSuccess) return e;
    if (device < MAX_DEVICES) opted_in[device].store(true);
  }
  const long long blocks = (long long)p.tiles * p.B * p.T;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int8_conv_pool_kernel<WORDS><<<(unsigned)blocks, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shared memory one CTA takes for this geometry (the wrapper's tile choice
// mirrors it: `quantconv.shared_memory_bytes`).
extern "C" int avs_int8_conv_pool_smem(int Cin, int Kpad, int kt, int kh, int kw,
                                       int tile_rows, int tile_cols, int pos_bytes) {
  return (int)smem_bytes(Cin % 4 == 0, Kpad, kt, 2 * tile_rows + kh - 1,
                               2 * tile_cols + kw - 1, pos_bytes);
}

// Grid: one CTA per (frame, tile of tile_rows x tile_cols pooled positions).
extern "C" int avs_int8_conv_pool(
    const float* x, const int8_t* w, const float* scale, const float* bias, float* out,
    float x_scale, int B, int Cin, int T, int H, int W, int Cout, int kt, int kh, int kw,
    int Kpad, int Npad, int tile_rows, int tile_cols, int pos_bytes,
    long long x_sb, long long x_sc, long long x_st, long long x_sh, long long x_sw,
    long long o_sb, long long o_sc, long long o_st, long long o_sh, long long o_sw,
    int device, void* stream) {
  const int K = Cin * kt * kh * kw;
  const bool words = Cin % 4 == 0;
  if (B < 1 || Cin < 1 || T < 1 || H < 2 || W < 2 || Cout < 1 || kt < 1 || kh < 1 ||
      kw < 1 || !(kt % 2) || !(kh % 2) || !(kw % 2) || Kpad < K || Kpad % 32 ||
      Npad < Cout || Npad % 32 || tile_rows < 1 || tile_cols < 1 || pos_bytes < Cin ||
      (words && pos_bytes % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  QParams p;
  p.x = x; p.w = w; p.scale = scale; p.bias = bias; p.out = out; p.x_scale = x_scale;
  p.B = B; p.Cin = Cin; p.T = T; p.H = H; p.W = W; p.Cout = Cout;
  p.kt = kt; p.kh = kh; p.kw = kw; p.K = K; p.Kpad = Kpad; p.Npad = Npad;
  p.PR = tile_rows; p.PC = tile_cols;
  p.tiles_w = (W / 2 + tile_cols - 1) / tile_cols;
  p.tiles = ((H / 2 + tile_rows - 1) / tile_rows) * p.tiles_w;
  p.IH = 2 * tile_rows + kh - 1; p.IW = 2 * tile_cols + kw - 1; p.S = pos_bytes;
  p.off_bytes = align16(4 * offset_entries(words, Kpad));
  p.x_sb = x_sb; p.x_sc = x_sc; p.x_st = x_st; p.x_sh = x_sh; p.x_sw = x_sw;
  p.vec4 = x_sc == 1 && Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
           x_sb % 4 == 0 && x_st % 4 == 0 && x_sh % 4 == 0 && x_sw % 4 == 0;
  p.o_sb = o_sb; p.o_sc = o_sc; p.o_st = o_st; p.o_sh = o_sh; p.o_sw = o_sw;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = words ? launch<true>(p, device, s) : launch<false>(p, device, s);
  return static_cast<int>(e);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
