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
// Contracts (the int8 forward chains three blocks): the input is f32 at any
// strides (quantized while it is staged) or int8 channels-last (already
// quantized with x_scale by the block before); the output is f32 at any
// strides or int8 channels-last, quantized with the NEXT block's x_scale,
// out_int8 = clip(rint(out_f32 / out_scale), -127, 127), exactly what that
// block's staging would compute from the f32 output.
// Under bf16 compute (the JAX block's out_dtype=bfloat16, the entry's bf16
// flag) scale and bias come as bf16, s16 = bf16(x_scale *
// k_scale[c]) and b16 = bf16(bias[c]), made once per load by the wrapper,
// and the dequant rounds to bf16 after each of its three ops, as XLA does:
//   v = bf16(bf16(bf16(float(acc)) * s16) + b16),  out = maxpool(relu(v));
// the output is bf16 at any strides or int8 channels-last, quantized from v
// (the next JAX block divides the bf16 value by its f32 scale in f32).
// float(), a rounding to bf16, the multiply by a positive scale, + bias and
// ReLU are each monotone non-decreasing, so in either precision the max of
// the four pre-pool accumulators is taken first, in int32, and the epilogue
// runs once per pooled value; it is written with __fmul_rn / __fadd_rn (no
// FMA contraction) and __float2bfloat16_rn after each op, so the kernel
// equals its plain version (`int8_conv_pool_ref`, ops/cuda/quantconv.py) bit
// for bit. One rounding after a fused multiply-add would not: it differs
// from XLA's three roundings on about a third of the values.
// Every sum is exact int32, so no choice of tile or frames per CTA changes a
// bit.
//
// What bounds it on the H100: at LipNet's conv2 (B=8, 32 -> 64 channels,
// 3x5x5 taps, 75 x 25 x 50) the conv is 221 G int8 operations over the
// pre-pool positions the floor pool keeps, 0.112 ms at the card's 1,979
// TOPS, against 24 MB of int8 input and 11.5 MB of int8 output in the int8
// chain: the operations set the floor. conv1 (Cin = 1, K = 75) does 14.4 G
// operations against 12 MB of f32 in and 24 MB of int8 out (0.011 ms).
//
// Design (wgmma, TMA, weights in shared memory and a persistent schedule
// are later work; numbers: H100 80GB HBM3 at 700 W, chip_smoke.py phase 11
// and scripts/torch_kernel_breakdown.py --mode q1):
//   * an implicit GEMM: M = pre-pool positions, N = output channels, K =
//     (tap, input channel) with each tap's channels contiguous, zero-padded
//     to a multiple of 32 (conv1's 75 -> 96, conv2's 2400 stays);
//   * a CTA is one clip b x a tile of PR x PC pooled positions (chosen by
//     the wrapper, `quantconv.tile_for`) x a run of F frames (the wrapper's
//     `frames_for`, from B, so the grid fills the card) x every output
//     channel. It keeps the input halos of kt + 1 frames in a ring in shared
//     memory, already int8: each frame is staged once and serves kt output
//     frames, and while the MMAs run on frame t, frame t + pt + 1 arrives in
//     the free slot (an int8 channels-last input by 16-byte cp.async, zero
//     fill outside the clip from the src-size operand; an f32 or byte-wise
//     input through registers loaded before the MMAs and quantized and
//     stored after them);
//   * a slot holds a frame's halo, S bytes per position; for Cin % 4 == 0
//     with its even and odd columns in two planes and S the smallest
//     multiple of 16 >= Cin with S / 16 odd: the eight rows of an A
//     fragment, pre-pool positions two columns apart, are then consecutive
//     positions of one plane, S bytes apart, and fall on distinct banks
//     (else S = Cin, row by row, for conv1's byte gathers);
//   * a warp task is 16 pooled positions x 32 channels: four m16 row blocks,
//     one per pool-window offset (jh, jw), share the B fragments, so a
//     thread's accumulators of the four blocks at one index are the four
//     pre-pool values of one pooled output: their max needs no shuffle;
//   * mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32, four n8 tiles per
//     task. A fragments come from the ring through tables of byte offsets
//     per k, one table per (frame t mod kt + 1, column parity jw). Where
//     Cin % 16 == 0 (conv2, conv3) a k-chunk of 32 is two runs of 16
//     contiguous channels of one tap each, exactly the four 8x8 b16
//     matrices of the m16n8k32 s8 A fragment (rows 0-7 / 8-15 x k 0-15 /
//     16-31), so one ldmatrix.x4 per (window, chunk) loads it, each lane
//     giving one row's address; else one 32-bit load per group of four k
//     (Cin % 4 == 0) or byte gathers (conv1). B fragments come straight from
//     the packed (Npad, Kpad) weights (read-only path; they stay in L1/L2),
//     the next chunk's loaded while this chunk's MMAs run;
//   * pooled positions outside the frame, rows past the tile and channels
//     past Cout compute on zeros or in-bounds data and are not written; the
//     pre-pool row or column a floor pool drops is never computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int NT = 256;  // threads per CTA (8 warps)
constexpr int NWARPS = NT / 32;
constexpr int STAGE_UNROLL = 4;  // halo loads in flight per thread
constexpr int PREFETCH = 4;  // values per thread of the next frame loaded before the MMAs
constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90
constexpr int MAX_DEVICES = 64;

// How A fragments are loaded from the ring, by Cin.
enum AMode : int {
  A_BYTES = 0,  // byte gathers through a table per k
  A_WORDS = 1,  // Cin % 4 == 0: a 32-bit load per group of four k
  A_LDSM = 2,   // Cin % 16 == 0: one ldmatrix.x4 per m16 x k32 block
};

// How a frame's halo is staged, by input dtype and layout.
enum Stage : int {
  STAGE_F32 = 0,    // f32, any strides: one value per load, quantized
  STAGE_F32X4 = 1,  // f32 channels-last, Cin % 4 == 0, 16-byte aligned: float4 loads
  STAGE_S8 = 2,     // int8 channels-last: one value per load
  STAGE_S8X16 = 3,  // int8 channels-last, Cin % 16 == 0, 16-byte aligned: 16-byte cp.async
};

struct QParams {
  const void* x;        // (B, Cin, T, H, W) f32 or int8, element strides below
  const int8_t* w;      // (Npad, Kpad) int8, k = ((dt*kh + dh)*kw + dw)*Cin + ci
  const void* scale;    // (Cout,) x_scale * k_scale: f32, or bf16 under BF16
  const void* bias;     // (Cout,) f32, or bf16 under BF16
  void* out;            // (B, Cout, T, H/2, W/2) f32 (bf16 under BF16) or int8,
                        // element strides below
  float x_scale, x_rcp;      // quantizes an f32 input (x_rcp = fl(1 / x_scale))
  float out_scale, out_rcp;  // quantizes an int8 output: the next block's x_scale
  bool out_int8;
  bool planes;          // Cin % 4 == 0: the halo's columns in two parity planes
  bool out_pairs;       // channel pairs of the output contiguous and aligned
  int stage;            // Stage
  int B, Cin, T, H, W, Cout, kt, kh, kw, K, Kpad, Npad;
  int PR, PC, tiles_w, tiles, F, runs;
  int IH, IW, IWh, S, R, slot_bytes, n_off, off_bytes;  // the ring (see smem_bytes)
  long long x_sb, x_sc, x_st, x_sh, x_sw;
  long long o_sb, o_sc, o_st, o_sh, o_sw;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

// The kernel's shared memory: the offset tables, R x 2 of them (frame t mod
// R, column parity), one int per k, or per group of four k when Cin % 4 == 0; then
// the ring of R = kt + 1 frame slots, each the halo's two column planes of
// IH x ceil(IW / 2) positions of S bytes.
__host__ __device__ inline int offset_entries(bool words, int Kpad) {
  return words ? Kpad / 4 : Kpad;
}
__host__ __device__ inline int slot_bytes(int IH, int IW, int S) {
  return align16(2 * IH * ((IW + 1) / 2) * S);
}
__host__ __device__ inline int table_bytes(bool words, int Kpad, int kt) {
  return align16(4 * 2 * (kt + 1) * offset_entries(words, Kpad));
}
size_t smem_bytes(bool words, int Kpad, int kt, int IH, int IW, int S) {
  return (size_t)table_bytes(words, Kpad, kt) + (size_t)(kt + 1) * slot_bytes(IH, IW, S);
}

// Byte of halo position (h, w) in a slot: even and odd columns in two
// planes where Cin % 4 == 0 (the 32-bit and ldmatrix A loads), else row by
// row (byte gathers: one offset table serves both column parities).
__device__ __forceinline__ int halo_byte(const QParams& p, int h, int w) {
  return p.planes ? (((w & 1) * p.IH + h) * p.IWh + (w >> 1)) * p.S : (h * p.IW + w) * p.S;
}

// clip(rint(v / s), -127, 127) with the IEEE quotient, as the plain version
// and XLA compute it, without a division in the common case: y = v * (1/s)
// (rcp = fl(1/s)) is within 3 * 2^-24 * |v/s| of fl(v/s), under 2.3e-5 for
// |v/s| < 128 (beyond, both clip alike). Where y is farther than 1e-4 from
// every half-integer, fl(v/s) lies in the same rounding interval as y, so
// rint(y) is its rint; else (ties, near-ties, NaN, inf) it divides.
__device__ __forceinline__ int8_t quantize(float v, float s, float rcp) {
  const float y = __fmul_rn(v, rcp);
  const float d = fabsf(__fsub_rn(__fsub_rn(y, floorf(y)), 0.5f));
  const float r = d > 1e-4f ? rintf(y) : rintf(__fdiv_rn(v, s));
  const float q = fminf(fmaxf(r, -127.f), 127.f);
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

// The B fragments of k-chunk kc for the four n8 tiles of a task, from the
// packed weights (read-only path).
__device__ __forceinline__ void load_b(uint32_t (&bf)[4][2], const int8_t* wg, int Kpad,
                                       int kc) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int8_t* wr = wg + (size_t)j * 8 * Kpad + kc * 32;
    bf[j][0] = static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(wr)));
    bf[j][1] = static_cast<uint32_t>(__ldg(reinterpret_cast<const int*>(wr + 16)));
  }
}

// The four 8x8 b16 matrices whose rows the lanes 0-7, 8-15, 16-23, 24-31
// address, into a[0..3] (16-byte aligned rows in shared memory).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const unsigned char* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// Element offset of halo position (h, w) of frame ti within clip b's
// tensor, or -1 outside the clip (SAME padding: zero).
__device__ __forceinline__ long long src_offset(const QParams& p, int ti, int h0, int w0,
                                                int h, int w) {
  const int hi = h0 + h, wi = w0 + w;
  if (ti < 0 || ti >= p.T || hi < 0 || hi >= p.H || wi < 0 || wi >= p.W) return -1;
  return ti * p.x_st + hi * p.x_sh + wi * p.x_sw;
}

// Scalar staging (STAGE_F32, STAGE_S8): item i of a frame is (channel
// i / npos, position i % npos), the columns fastest (coalesced for NCDHW).
__device__ __forceinline__ float load_item(const QParams& p, int b, int ti, int h0, int w0,
                                           int i) {
  const int npos = p.IH * p.IW, pos = i % npos;
  const long long o = src_offset(p, ti, h0, w0, pos / p.IW, pos % p.IW);
  if (o < 0) return 0.f;
  const long long e = b * p.x_sb + (i / npos) * p.x_sc + o;
  return p.stage == STAGE_F32 ? __ldg(static_cast<const float*>(p.x) + e)
                              : static_cast<float>(__ldg(static_cast<const signed char*>(p.x) + e));
}
__device__ __forceinline__ void store_item(const QParams& p, unsigned char* slot, int i,
                                           float v) {
  const int npos = p.IH * p.IW, pos = i % npos;
  reinterpret_cast<int8_t*>(slot)[halo_byte(p, pos / p.IW, pos % p.IW) + i / npos] =
      p.stage == STAGE_F32 ? quantize(v, p.x_scale, p.x_rcp) : static_cast<int8_t>(v);
}

// Stage items first.. of frame ti into its slot, STAGE_UNROLL loads in
// flight per thread before any is stored (the loads are latency-bound); a
// channels-last f32 input moves four channels per 16-byte load.
__device__ void stage_sync(const QParams& p, unsigned char* slot, int b, int ti, int h0,
                           int w0, int first) {
  if (p.stage == STAGE_F32X4) {
    const int cg = p.Cin / 4, n = p.IH * p.IW * cg;
    const float* xb = static_cast<const float*>(p.x) + b * p.x_sb;
    for (int i0 = first + threadIdx.x; i0 < n; i0 += STAGE_UNROLL * NT) {
      float4 v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT, pos = i / cg;
        const long long o = i < n ? src_offset(p, ti, h0, w0, pos / p.IW, pos % p.IW) : -1;
        v[u] = o >= 0 ? __ldg(reinterpret_cast<const float4*>(xb + o) + i % cg)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT, pos = i / cg;
        if (i >= n) break;
        const uint32_t q = static_cast<uint8_t>(quantize(v[u].x, p.x_scale, p.x_rcp)) |
                           static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[u].y, p.x_scale, p.x_rcp))) << 8 |
                           static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[u].z, p.x_scale, p.x_rcp))) << 16 |
                           static_cast<uint32_t>(static_cast<uint8_t>(quantize(v[u].w, p.x_scale, p.x_rcp))) << 24;
        *reinterpret_cast<uint32_t*>(slot + halo_byte(p, pos / p.IW, pos % p.IW) +
                                     4 * (i % cg)) = q;
      }
    }
  } else {
    const int n = p.Cin * p.IH * p.IW;
    for (int i0 = first + threadIdx.x; i0 < n; i0 += STAGE_UNROLL * NT) {
      float v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT;
        v[u] = i < n ? load_item(p, b, ti, h0, w0, i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * NT;
        if (i >= n) break;
        store_item(p, slot, i, v[u]);
      }
    }
  }
}

// STAGE_S8X16: frame ti into its slot by 16-byte cp.async, one commit group.
__device__ void stage_async(const QParams& p, unsigned char* slot, int b, int ti, int h0,
                            int w0) {
  const int cg = p.Cin / 16, n = p.IH * p.IW * cg;
  const signed char* xb = static_cast<const signed char*>(p.x) + b * p.x_sb;
  for (int i = threadIdx.x; i < n; i += NT) {
    const int pos = i / cg, c = i % cg, h = pos / p.IW, w = pos % p.IW;
    const long long o = src_offset(p, ti, h0, w0, h, w);
    cp_async16(slot + halo_byte(p, h, w) + 16 * c, xb + (o < 0 ? 0 : o) + 16 * c, o >= 0);
  }
  cp_async_commit();
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ReLU of one pooled value from the max m of its four accumulators: in f32,
// float(m) * scale + bias; under BF16, rounded to bf16 after each op.
template <bool BF16>
__device__ __forceinline__ float dequant(const QParams& p, int m, int c) {
  if constexpr (BF16) {
    const float s = __bfloat162float(static_cast<const __nv_bfloat16*>(p.scale)[c]);
    const float b = __bfloat162float(static_cast<const __nv_bfloat16*>(p.bias)[c]);
    const float v = round_bf16(__fmul_rn(round_bf16(__int2float_rn(m)), s));
    return fmaxf(round_bf16(__fadd_rn(v, b)), 0.f);
  } else {
    const float s = static_cast<const float*>(p.scale)[c];
    const float b = static_cast<const float*>(p.bias)[c];
    return fmaxf(__fadd_rn(__fmul_rn(__int2float_rn(m), s), b), 0.f);
  }
}

// The pooled values of a warp task: fragment registers 2r and 2r + 1 hold
// row g + 8r, channels 2*tq and 2*tq + 1 of each n8 tile j; the max of the
// four windows' accumulators, dequantized, + bias, ReLU; f32 (bf16 under
// BF16) out, or int8 quantized with the next block's scale. A channel pair
// goes out in one store where the output's channels are contiguous and
// pairs aligned.
template <bool BF16>
__device__ __forceinline__ void epilogue(const QParams& p, const int (&acc)[4][4][4],
                                         const int (&idx)[2], int b, int t, int h2_0,
                                         int w2_0, int ng, int tq) {
  const int P = p.PR * p.PC, H2 = p.H / 2, W2 = p.W / 2;
  const bool pairs = p.out_pairs;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (idx[r] >= P) continue;
    const int h2 = h2_0 + idx[r] / p.PC, w2 = w2_0 + idx[r] % p.PC;
    if (h2 >= H2 || w2 >= W2) continue;
    const long long o = b * p.o_sb + t * p.o_st + h2 * p.o_sh + w2 * p.o_sw;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = ng * 32 + j * 8 + 2 * tq;
      if (c >= p.Cout) continue;
      float v[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * r + e;
        if (c + e >= p.Cout) break;
        const int m = max(max(acc[0][j][i], acc[1][j][i]), max(acc[2][j][i], acc[3][j][i]));
        v[e] = dequant<BF16>(p, m, c + e);
      }
      if (p.out_int8) {
        int8_t* ob = static_cast<int8_t*>(p.out) + o;
        const int8_t q0 = quantize(v[0], p.out_scale, p.out_rcp);
        const int8_t q1 = quantize(v[1], p.out_scale, p.out_rcp);
        if (pairs) {
          *reinterpret_cast<char2*>(ob + c) = make_char2(q0, q1);
        } else {
          ob[c * p.o_sc] = q0;
          if (c + 1 < p.Cout) ob[(c + 1) * p.o_sc] = q1;
        }
      } else if constexpr (BF16) {
        __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.out) + o;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(ob + c) = __floats2bfloat162_rn(v[0], v[1]);
        } else {
          ob[c * p.o_sc] = __float2bfloat16_rn(v[0]);
          if (c + 1 < p.Cout) ob[(c + 1) * p.o_sc] = __float2bfloat16_rn(v[1]);
        }
      } else {
        float* ob = static_cast<float*>(p.out) + o;
        if (pairs) {
          *reinterpret_cast<float2*>(ob + c) = make_float2(v[0], v[1]);
        } else {
          ob[c * p.o_sc] = v[0];
          if (c + 1 < p.Cout) ob[(c + 1) * p.o_sc] = v[1];
        }
      }
    }
  }
}

template <int MODE, bool BF16>
__global__ void __launch_bounds__(NT, 2) int8_conv_pool_kernel(const QParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_off = reinterpret_cast<int*>(smem);
  unsigned char* ring = smem + p.off_bytes;

  // blockIdx.x -> (tile, run of F frames, clip), the tiles fastest
  const int tile = blockIdx.x % p.tiles;
  const int run = (blockIdx.x / p.tiles) % p.runs;
  const int b = blockIdx.x / (p.tiles * p.runs);
  const int t_begin = run * p.F, t_end = min(t_begin + p.F, p.T);
  const int h2_0 = (tile / p.tiles_w) * p.PR, w2_0 = (tile % p.tiles_w) * p.PC;
  const int pt = (p.kt - 1) / 2;
  const int h0 = 2 * h2_0 - (p.kh - 1) / 2, w0 = 2 * w2_0 - (p.kw - 1) / 2;
  // frame ti (>= -pt) lives in slot (ti + pt) mod R
  auto slot = [&](int ti) { return ring + ((ti + pt) % p.R) * p.slot_bytes; };

  // table (r, jw): for output frame t = r mod R, the byte of k (or of the
  // group k = 4*kg .. 4*kg + 3) in the ring, from the row base of a pre-pool
  // position in column plane jw (`base` below; without planes the position's
  // own byte, and both tables are the same); -1 past K, or for ldmatrix
  // (which cannot skip a row) 0: the packed weights are zero past K
  const int step = MODE == A_BYTES ? 1 : 4;
  for (int i = threadIdx.x; i < 2 * p.R * p.n_off; i += NT) {
    const int e = i % p.n_off, jw = (i / p.n_off) % 2, r = i / (2 * p.n_off);
    const int k = e * step;
    int off = MODE == A_LDSM ? 0 : -1;
    if (k < p.K) {
      const int tap = k / p.Cin, ci = k % p.Cin;
      const int dt = tap / (p.kh * p.kw), dh = (tap / p.kw) % p.kh, dw = tap % p.kw;
      const int wc = jw + dw;
      off = ((r + dt) % p.R) * p.slot_bytes + ci +
            (p.planes ? (((wc & 1) * p.IH + dh) * p.IWh + (wc >> 1)) * p.S
                      : (dh * p.IW + dw) * p.S);
    }
    s_off[i] = off;
  }

  // the first output frame's kt input frames
  const bool async = p.stage == STAGE_S8X16;
  const bool scalar = p.stage == STAGE_F32 || p.stage == STAGE_S8;
  for (int ti = t_begin - pt; ti <= t_begin + pt; ++ti) {
    if (async)
      stage_async(p, slot(ti), b, ti, h0, w0);
    else
      stage_sync(p, slot(ti), b, ti, h0, w0, 0);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int P = p.PR * p.PC;
  const int mgroups = (P + 15) / 16, ngroups = p.Npad / 32;
  const int chunks = p.Kpad / 32;
  const int n_items = p.Cin * p.IH * p.IW;  // scalar staging's items per frame

  for (int t = t_begin; t < t_end; ++t) {
    if (async) cp_async_wait<0>();
    // frame t + pt has landed; every warp is done with output frame t - 1,
    // so the slot of frame t - pt - 1 is free for frame t + pt + 1
    __syncthreads();
    const int next = t + pt + 1;
    const bool more = t + 1 < t_end;
    float pre[PREFETCH];
    if (more && async) stage_async(p, slot(next), b, next, h0, w0);
    if (more && scalar) {
#pragma unroll
      for (int u = 0; u < PREFETCH; ++u) {
        const int i = threadIdx.x + u * NT;
        pre[u] = i < n_items ? load_item(p, b, next, h0, w0, i) : 0.f;
      }
    }
    const int* off0 = s_off + (t % p.R) * 2 * p.n_off;  // column plane 0
    const int* off1 = off0 + p.n_off;                  // column plane 1

    for (int task = warp; task < mgroups * ngroups; task += NWARPS) {
      const int mg = task / ngroups, ng = task % ngroups;
      // the thread's two rows: pooled positions mg*16 + g and + 8 of the tile
      int idx[2] = {mg * 16 + g, mg * 16 + g + 8};
      int acc[4][4][4];  // [window (jh, jw)][n8 tile][fragment register]
#pragma unroll
      for (int wdw = 0; wdw < 4; ++wdw)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[wdw][j][i] = 0;
      const int8_t* wg = p.w + (size_t)(ng * 32 + g) * p.Kpad + tq * 4;

      if constexpr (MODE == A_LDSM) {
        // the lane's ldmatrix row: A row (lane & 7) + 8 * bit 3 of the lane,
        // k half (lane >> 4); its plane-0 byte for each pool-window row jh
        const int row = mg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
        const int q = row < P ? row : 0;
        const int lbase[2] = {((2 * (q / p.PC)) * p.IWh + q % p.PC) * p.S,
                              ((2 * (q / p.PC) + 1) * p.IWh + q % p.PC) * p.S};
        uint32_t bf[4][2], bn[4][2];  // this chunk's B fragments, the next one's
        load_b(bf, wg, p.Kpad, 0);
        for (int kc = 0; kc < chunks; ++kc) {
          load_b(bn, wg, p.Kpad, min(kc + 1, chunks - 1));
          const int o[2] = {off0[kc * 8 + 4 * half], off1[kc * 8 + 4 * half]};
#pragma unroll
          for (int wdw = 0; wdw < 4; ++wdw) {
            uint32_t a[4];
            ldmatrix_x4(a, ring + lbase[wdw >> 1] + o[wdw & 1]);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_s8(acc[wdw][j], a, bf[j][0], bf[j][1]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) bf[j][0] = bn[j][0], bf[j][1] = bn[j][1];
        }
      } else {
        // [window (jh, jw)][row]: the pre-pool position's byte (WORDS: in
        // plane 0, its column pair's; the table adds the plane)
        int base[4][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = idx[r] < P ? idx[r] : 0;
          const int ph = q / p.PC, pw = q % p.PC;
#pragma unroll
          for (int wdw = 0; wdw < 4; ++wdw) {
            const int jh = wdw >> 1, jw = wdw & 1;
            base[wdw][r] = MODE == A_WORDS ? ((2 * ph + jh) * p.IWh + pw) * p.S
                                           : ((2 * ph + jh) * p.IW + 2 * pw + jw) * p.S;
          }
        }
        uint32_t bf[4][2], bn[4][2];  // this chunk's B fragments, the next one's
        load_b(bf, wg, p.Kpad, 0);
        for (int kc = 0; kc < chunks; ++kc) {
          load_b(bn, wg, p.Kpad, min(kc + 1, chunks - 1));
          if constexpr (MODE == A_WORDS) {
            const int o[2][2] = {{off0[kc * 8 + tq], off0[kc * 8 + tq + 4]},
                                 {off1[kc * 8 + tq], off1[kc * 8 + tq + 4]}};
#pragma unroll
            for (int wdw = 0; wdw < 4; ++wdw) {
              const int jw = wdw & 1;
              const uint32_t a[4] = {load4(ring + base[wdw][0], o[jw][0]),
                                     load4(ring + base[wdw][1], o[jw][0]),
                                     load4(ring + base[wdw][0], o[jw][1]),
                                     load4(ring + base[wdw][1], o[jw][1])};
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_s8(acc[wdw][j], a, bf[j][0], bf[j][1]);
            }
          } else {
            int o0[4], o1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              o0[i] = off0[kc * 32 + tq * 4 + i];
              o1[i] = off0[kc * 32 + 16 + tq * 4 + i];
            }
#pragma unroll
            for (int wdw = 0; wdw < 4; ++wdw) {
              const uint32_t a[4] = {gather4(ring + base[wdw][0], o0),
                                     gather4(ring + base[wdw][1], o0),
                                     gather4(ring + base[wdw][0], o1),
                                     gather4(ring + base[wdw][1], o1)};
#pragma unroll
              for (int j = 0; j < 4; ++j) mma_s8(acc[wdw][j], a, bf[j][0], bf[j][1]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) bf[j][0] = bn[j][0], bf[j][1] = bn[j][1];
        }
      }
      epilogue<BF16>(p, acc, idx, b, t, h2_0, w2_0, ng, tq);
    }

    // the next frame, while no warp reads its slot: the prefetched values,
    // then the rest of it
    if (more && scalar) {
#pragma unroll
      for (int u = 0; u < PREFETCH; ++u) {
        const int i = threadIdx.x + u * NT;
        if (i < n_items) store_item(p, slot(next), i, pre[u]);
      }
      stage_sync(p, slot(next), b, next, h0, w0, PREFETCH * NT);
    } else if (more && !async) {
      stage_sync(p, slot(next), b, next, h0, w0, 0);
    }
  }
}

// The shared-memory opt-in of each instantiation, set once per device.
template <int MODE, bool BF16>
cudaError_t launch(const QParams& p, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = smem_bytes(MODE != A_BYTES, p.Kpad, p.kt, p.IH, p.IW, p.S);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (device >= MAX_DEVICES || !opted_in[device].load()) {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_pool_kernel<MODE, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)MAX_SMEM);
    if (e != cudaSuccess) return e;
    if (device < MAX_DEVICES) opted_in[device].store(true);
  }
  const long long blocks = (long long)p.tiles * p.runs * p.B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  int8_conv_pool_kernel<MODE, BF16><<<(unsigned)blocks, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// Grid: one CTA per (clip, run of `frames` frames, tile of tile_rows x
// tile_cols pooled positions). x is f32 (x_int8 = 0) or int8 channels-last
// (x_sc = 1); out is f32 (bf16 under BF16; out_int8 = 0) or int8
// channels-last (o_sc = 1), quantized with out_scale.
template <bool BF16>
int run(
    const void* x, const int8_t* w, const void* scale, const void* bias, void* out,
    float x_scale, float out_scale, int x_int8, int out_int8, int B, int Cin, int T, int H,
    int W, int Cout, int kt, int kh, int kw, int Kpad, int Npad, int tile_rows, int tile_cols,
    int pos_bytes, int frames, long long x_sb, long long x_sc, long long x_st, long long x_sh,
    long long x_sw, long long o_sb, long long o_sc, long long o_st, long long o_sh,
    long long o_sw, int device, void* stream) {
  const int K = Cin * kt * kh * kw;
  const bool words = Cin % 4 == 0;
  if (B < 1 || Cin < 1 || T < 1 || H < 2 || W < 2 || Cout < 1 || kt < 1 || kh < 1 ||
      kw < 1 || !(kt % 2) || !(kh % 2) || !(kw % 2) || Kpad < K || Kpad % 32 ||
      Npad < Cout || Npad % 32 || tile_rows < 1 || tile_cols < 1 || pos_bytes < Cin ||
      (words && pos_bytes % 16) || frames < 1 || (x_int8 && Cin > 1 && x_sc != 1) ||
      (out_int8 && Cout > 1 && o_sc != 1) || (out_int8 && !(out_scale > 0.f)))
    return static_cast<int>(cudaErrorInvalidValue);
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  QParams p;
  p.x = x; p.w = w; p.scale = scale; p.bias = bias; p.out = out;
  p.x_scale = x_scale; p.x_rcp = 1.0f / x_scale;
  p.out_scale = out_scale; p.out_rcp = 1.0f / out_scale; p.out_int8 = out_int8 != 0;
  p.B = B; p.Cin = Cin; p.T = T; p.H = H; p.W = W; p.Cout = Cout;
  p.kt = kt; p.kh = kh; p.kw = kw; p.K = K; p.Kpad = Kpad; p.Npad = Npad;
  p.PR = tile_rows; p.PC = tile_cols;
  p.tiles_w = (W / 2 + tile_cols - 1) / tile_cols;
  p.tiles = ((H / 2 + tile_rows - 1) / tile_rows) * p.tiles_w;
  p.F = frames; p.runs = (T + frames - 1) / frames;
  p.IH = 2 * tile_rows + kh - 1; p.IW = 2 * tile_cols + kw - 1; p.IWh = (p.IW + 1) / 2;
  p.S = pos_bytes; p.R = kt + 1; p.slot_bytes = slot_bytes(p.IH, p.IW, pos_bytes);
  p.planes = words;
  p.n_off = offset_entries(words, Kpad); p.off_bytes = table_bytes(words, Kpad, kt);
  p.x_sb = x_sb; p.x_sc = x_sc; p.x_st = x_st; p.x_sh = x_sh; p.x_sw = x_sw;
  // channels-last, 16-byte aligned, whole 16-byte groups: vector staging
  const int vec = x_int8 ? 16 : 4;
  const bool vector = x_sc == 1 && Cin % vec == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 && x_sb % vec == 0 &&
                      x_st % vec == 0 && x_sh % vec == 0 && x_sw % vec == 0;
  p.stage = x_int8 ? (vector ? STAGE_S8X16 : STAGE_S8) : (vector ? STAGE_F32X4 : STAGE_F32);
  p.o_sb = o_sb; p.o_sc = o_sc; p.o_st = o_st; p.o_sh = o_sh; p.o_sw = o_sw;
  p.out_pairs = o_sc == 1 && Cout % 2 == 0 && o_sb % 2 == 0 && o_st % 2 == 0 &&
                o_sh % 2 == 0 && o_sw % 2 == 0 &&
                reinterpret_cast<uintptr_t>(out) % (out_int8 ? 2 : (BF16 ? 4 : 8)) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = Cin % 16 == 0 ? launch<A_LDSM, BF16>(p, device, s)
      : words       ? launch<A_WORDS, BF16>(p, device, s)
                    : launch<A_BYTES, BF16>(p, device, s);
  return static_cast<int>(e);
}

}  // namespace

// Shared memory one CTA takes for this geometry (the wrapper's tile choice
// mirrors it: `quantconv.shared_memory_bytes`).
extern "C" int avs_int8_conv_pool_smem(int Cin, int Kpad, int kt, int kh, int kw,
                                       int tile_rows, int tile_cols, int pos_bytes) {
  return (int)smem_bytes(Cin % 4 == 0, Kpad, kt, 2 * tile_rows + kh - 1,
                               2 * tile_cols + kw - 1, pos_bytes);
}

// bf16 = 0: f32 scale and bias, f32 or int8 out. bf16 = 1: the bf16
// epilogue, bf16 scale (s16) and bias (b16), bf16 or int8 out.
extern "C" int avs_int8_conv_pool(
    const void* x, const int8_t* w, const void* scale, const void* bias, void* out,
    float x_scale, float out_scale, int x_int8, int out_int8, int bf16, int B, int Cin, int T,
    int H, int W, int Cout, int kt, int kh, int kw, int Kpad, int Npad, int tile_rows,
    int tile_cols, int pos_bytes, int frames, long long x_sb, long long x_sc, long long x_st,
    long long x_sh, long long x_sw, long long o_sb, long long o_sc, long long o_st,
    long long o_sh, long long o_sw, int device, void* stream) {
  return (bf16 ? run<true> : run<false>)(
      x, w, scale, bias, out, x_scale, out_scale, x_int8, out_int8, B, Cin, T, H, W, Cout, kt,
      kh, kw, Kpad, Npad, tile_rows, tile_cols, pos_bytes, frames, x_sb, x_sc, x_st, x_sh, x_sw,
      o_sb, o_sc, o_st, o_sh, o_sw, device, stream);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
