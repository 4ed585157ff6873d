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
// Every sum is exact int32, so no choice of tile, channel groups, stage
// size or frames per CTA changes a bit.
//
// What bounds it on the H100: at LipNet's conv2 (B=8, 32 -> 64 channels,
// 3x5x5 taps, 75 x 25 x 50) the conv is 221 G int8 operations over the
// pre-pool positions the floor pool keeps, 0.112 ms at the card's 1,979
// TOPS, against 24 MB of int8 input and 11.5 MB of int8 output in the int8
// chain: the operations set the floor. conv1 (Cin = 1, K = 75) does 14.4 G
// operations against 12 MB of f32 in and 24 MB of int8 out (0.011 ms). The
// TF stack's conv2 (128 -> 256, 3x3x3, 75 x 23 x 70) does 1,635 G (0.826 ms).
//
// Design (wgmma, warp specialisation and a persistent schedule are later
// work; numbers: H100 80GB HBM3 at 700 W, chip_smoke.py phases 11 and 13a
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
//     per k (one int per 16 k for ldmatrix, per 4 k for 32-bit loads, per k
//     for byte gathers), one per column parity jw. Each entry is the k's
//     byte as if the output frame's first input frame sat in slot 0 (dt *
//     slot + position + channel); at the start of every output frame the
//     CTA writes the frame's copy of both tables, the entries moved by the
//     frame's slot and wrapped around the ring: four tables in all, whatever
//     kt, so the halo ring gets the memory. Where Cin % 16 == 0
//     (conv2, conv3) a k-chunk of 32 is two runs of 16 contiguous channels of
//     one tap each, exactly the four 8x8 b16 matrices of the m16n8k32 s8 A
//     fragment (rows 0-7 / 8-15 x k 0-15 / 16-31), so one ldmatrix.x4 per
//     (window, chunk) loads it, each lane giving one row's address; else one
//     32-bit load per group of four k (Cin % 4 == 0) or byte gathers (conv1);
//   * B fragments, where Cin % 16 == 0 (ldmatrix A): staged once per CTA in
//     a ring of two stages in shared memory, each `stage_chunks` k-chunks
//     of the round's `groups` x 32 output channels, K-major in 16-byte rows
//     per channel ([chunk][k half][channel][16 bytes]: the eight rows of an
//     8x8 b16 matrix are eight channels' 16 contiguous k, 128 bytes without
//     a bank conflict, and the K-major core matrices 8-bit wgmma reads for
//     B). The CTA's warps are mgroups x groups, one task each per round (16
//     pooled positions x 32 channels), so each staged byte feeds the mgroups
//     warps of its channel group; rounds walk the channels in steps of
//     groups x 32 and every round restreams K. Two ldmatrix.x4 give a task's
//     four n8 tiles of a chunk. The ring fills by 16-byte cp.async
//     (cp.async.cg, through L2 only; each thread's items stepped without a
//     division), a commit group per stage: the next stage loads while this
//     one's MMAs run, one __syncthreads a stage. The next frame's int8 halo
//     rides in the second stage's commit group of the frame's first round,
//     so it loads under the first stage's MMAs. The wrapper's planner
//     (`quantconv.tile_for`) chooses the tile, groups and stage size from an
//     estimate of the MMA loop, the barriers, the A loads' bank conflicts,
//     the weight bytes each CTA reads from L2 and the warps an SM keeps
//     resident. cp.async, not TMA: a bulk copy of the packed weights' 32
//     contiguous bytes per channel and chunk would not interleave them into
//     this layout, and a tensor map that does needs libcuda's
//     cuTensorMapEncodeTiled, outside this library's plain C interface;
//   * else (32-bit A loads, conv1's byte gathers: 3 and 1 KB of weights)
//     eight warps walk the tasks, each reading its B fragments straight from
//     the packed weights (read-only path, L1 hits), the next chunk's loaded
//     while this chunk's MMAs run;
//   * pooled positions outside the frame, rows past the tile and channels
//     past Cout compute on zeros or in-bounds data and are not written; the
//     pre-pool row or column a floor pool drops is never computed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "cp_async.cuh"

namespace {

constexpr int MAX_NT = 512;  // threads per CTA at most (16 warps)
constexpr int DIRECT_NT = 256;  // threads per CTA without the B ring (8 warps)
constexpr int STAGE_UNROLL = 4;  // halo loads in flight per thread
constexpr int PREFETCH = 4;  // values per thread of the next frame loaded before the MMAs
constexpr int B_STAGES = 2;  // stages of the B ring
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
  int mgroups, groups, rounds, stage_chunks;  // the B ring (A_LDSM): see the header
  long long x_sb, x_sc, x_st, x_sh, x_sw;
  long long o_sb, o_sc, o_st, o_sh, o_sw;
};

__host__ __device__ inline int align16(int n) { return (n + 15) / 16 * 16; }

// The kernel's shared memory: the offset tables, four of them (column parity
// x (frame-independent, this frame's copy)), one int per k, per four k when
// Cin % 4 == 0 or per sixteen when Cin % 16 == 0; then the ring of R = kt + 1
// frame slots, each the halo's two column planes of IH x ceil(IW / 2)
// positions of S bytes; then the B ring: B_STAGES stages of `stage_chunks`
// k-chunks x groups x 32 channels x 32 bytes (none without it).
__host__ __device__ inline int offset_entries(int mode, int Kpad) {
  return mode == A_LDSM ? Kpad / 16 : mode == A_WORDS ? Kpad / 4 : Kpad;
}
__host__ __device__ inline int slot_bytes(int IH, int IW, int S) {
  return align16(2 * IH * ((IW + 1) / 2) * S);
}
__host__ __device__ inline int table_bytes(int mode, int Kpad) {
  return align16(4 * 4 * offset_entries(mode, Kpad));
}
__host__ __device__ inline int stage_bytes(int groups, int chunks) {
  return chunks * groups * 32 * 32;
}
size_t smem_bytes(int mode, int Kpad, int kt, int IH, int IW, int S, int groups,
                  int stage_chunks) {
  return (size_t)table_bytes(mode, Kpad) + (size_t)(kt + 1) * slot_bytes(IH, IW, S) +
         (size_t)B_STAGES * stage_bytes(groups, stage_chunks);
}
int mode_of(int Cin) { return Cin % 16 == 0 ? A_LDSM : Cin % 4 == 0 ? A_WORDS : A_BYTES; }

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
  const int nt = blockDim.x;
  if (p.stage == STAGE_F32X4) {
    const int cg = p.Cin / 4, n = p.IH * p.IW * cg;
    const float* xb = static_cast<const float*>(p.x) + b * p.x_sb;
    for (int i0 = first + threadIdx.x; i0 < n; i0 += STAGE_UNROLL * nt) {
      float4 v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * nt, pos = i / cg;
        const long long o = i < n ? src_offset(p, ti, h0, w0, pos / p.IW, pos % p.IW) : -1;
        v[u] = o >= 0 ? __ldg(reinterpret_cast<const float4*>(xb + o) + i % cg)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * nt, pos = i / cg;
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
    for (int i0 = first + threadIdx.x; i0 < n; i0 += STAGE_UNROLL * nt) {
      float v[STAGE_UNROLL];
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * nt;
        v[u] = i < n ? load_item(p, b, ti, h0, w0, i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < STAGE_UNROLL; ++u) {
        const int i = i0 + u * nt;
        if (i >= n) break;
        store_item(p, slot, i, v[u]);
      }
    }
  }
}

// STAGE_S8X16: frame ti into its slot by 16-byte cp.async (the caller
// commits them).
__device__ void stage_async(const QParams& p, unsigned char* slot, int b, int ti, int h0,
                            int w0) {
  const int cg = p.Cin / 16, n = p.IH * p.IW * cg;
  const signed char* xb = static_cast<const signed char*>(p.x) + b * p.x_sb;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int pos = i / cg, c = i % cg, h = pos / p.IW, w = pos % p.IW;
    const long long o = src_offset(p, ti, h0, w0, h, w);
    cp_async16(slot + halo_byte(p, h, w) + 16 * c, xb + (o < 0 ? 0 : o) + 16 * c, o >= 0);
  }
}

// The B ring's stage of k-chunks kc0.. for channels n0.. (the round's
// groups x 32), [chunk][k half][channel][16 bytes], by 16-byte cp.async;
// channels past Npad and chunks past Kpad zero-filled. Item i of a stage is
// (chunk c, channel ch, half) with i = (c * nct + ch) * 2 + half:
// consecutive threads take the two halves of one channel's chunk, one
// 32-byte sector. A thread's items are i0 = threadIdx.x, i0 + nt, ...; its
// (c, ch, half) start and step come from `BFill` (no division per copy).
struct BFill {
  int c, ch, half;  // the thread's first item
  int dc, dch;      // (c, ch) advance per step of nt items (the half stays)
};
__device__ __forceinline__ BFill b_fill(int nct) {
  const int q = threadIdx.x >> 1, step = blockDim.x >> 1;
  return {q / nct, q % nct, static_cast<int>(threadIdx.x & 1), step / nct, step % nct};
}
__device__ __forceinline__ void stage_b(const QParams& p, const BFill& f, unsigned char* dst,
                                        int n0, int kc0) {
  const int nct = p.groups * 32, chunks = p.Kpad / 32;
  int c = f.c, ch = f.ch;
  while (c < p.stage_chunks) {
    const int row = n0 + ch, kc = kc0 + c;
    const bool ok = row < p.Npad && kc < chunks;
    cp_async16(dst + ((c * 2 + f.half) * nct + ch) * 16,
               p.w + (ok ? (size_t)row * p.Kpad + kc * 32 + f.half * 16 : 0), ok);
    c += f.dc;
    ch += f.dch;
    if (ch >= nct) ch -= nct, ++c;
  }
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

__device__ __forceinline__ void zero(int (&acc)[4][4][4]) {
#pragma unroll
  for (int wdw = 0; wdw < 4; ++wdw)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[wdw][j][i] = 0;
}

// One output frame's MMAs with the B ring: rounds of groups x 32 channels,
// each streaming K through the ring's stages (see the header); the warp's
// task (mg, round * groups + nl) has its accumulators for the whole of K.
// With a `halo` slot, frame `next`'s int8 halo (STAGE_S8X16) goes into it,
// committed with the first round's second stage.
template <bool BF16>
__device__ __forceinline__ void frame_ring(const QParams& p, const unsigned char* ring,
                                           unsigned char* bring, const int* off0,
                                           const int* off1, int b, int t, int h2_0,
                                           int w2_0, unsigned char* halo, int next, int h0,
                                           int w0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tq = lane % 4;
  const int mg = warp % p.mgroups, nl = warp / p.mgroups;
  const int P = p.PR * p.PC, nct = p.groups * 32, sc = p.stage_chunks;
  const int sb = stage_bytes(p.groups, sc), chunks = p.Kpad / 32, nst = (chunks + sc - 1) / sc;
  const int idx[2] = {mg * 16 + lane / 4, mg * 16 + lane / 4 + 8};
  // the lane's ldmatrix row of A: row (lane & 7) + 8 * bit 3 of the lane, k
  // half (lane >> 4); its plane-0 byte for each pool-window row jh
  const int row = mg * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, half = lane >> 4;
  const int q = row < P ? row : 0;
  const int lbase[2] = {((2 * (q / p.PC)) * p.IWh + q % p.PC) * p.S,
                        ((2 * (q / p.PC) + 1) * p.IWh + q % p.PC) * p.S};
  // the lane's ldmatrix row of B: matrix lane >> 3 is (n8 tile 2jj + (lane >> 4),
  // k half (lane >> 3) & 1), row lane & 7: 16-byte rows from the chunk's start
  const int brow = ((lane >> 3) & 1) * nct + nl * 32 + (lane >> 4) * 8 + (lane & 7);
  const BFill fill = b_fill(nct);
  for (int rd = 0; rd < p.rounds; ++rd) {
    const int ng = rd * p.groups + nl;
    const bool active = ng * 32 < p.Npad;
    int acc[4][4][4];
    zero(acc);
    stage_b(p, fill, bring, rd * nct, 0);
    cp_async_commit();
    for (int s = 0; s < nst; ++s) {
      cp_async_wait<0>();
      // stage s has landed for every thread; every warp is done with stage
      // s - 1, whose slot the next fill takes
      __syncthreads();
      if (s + 1 < nst)
        stage_b(p, fill, bring + ((s + 1) % B_STAGES) * sb, rd * nct, (s + 1) * sc);
      if (halo && rd == 0 && s == 0) stage_async(p, halo, b, next, h0, w0);
      cp_async_commit();
      if (!active) continue;
      const unsigned char* bs = bring + (s % B_STAGES) * sb;
#pragma unroll 2
      for (int c = 0; c < sc; ++c) {
        const int kc = s * sc + c;
        if (kc >= chunks) break;
        uint32_t bq[2][4], bf[4][2];
        ldmatrix_x4(bq[0], bs + (c * 2 * nct + brow) * 16);
        ldmatrix_x4(bq[1], bs + (c * 2 * nct + brow + 16) * 16);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bf[j][0] = bq[j >> 1][2 * (j & 1)];
          bf[j][1] = bq[j >> 1][2 * (j & 1) + 1];
        }
        // A: one ldmatrix.x4 per window, from the lane's row base for its
        // pool-window row jh and its column parity's offset
        const int o[2] = {off0[kc * 2 + half], off1[kc * 2 + half]};
#pragma unroll
        for (int wdw = 0; wdw < 4; ++wdw) {
          uint32_t a[4];
          ldmatrix_x4(a, ring + lbase[wdw >> 1] + o[wdw & 1]);
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_s8(acc[wdw][j], a, bf[j][0], bf[j][1]);
        }
      }
    }
    // every warp is done with the ring before the next round's fills
    __syncthreads();
    if (active) epilogue<BF16>(p, acc, idx, b, t, h2_0, w2_0, ng, tq);
  }
}

// One output frame's MMAs without the B ring (32-bit A loads or byte
// gathers): eight warps walk the tasks (16 pooled positions x 32
// channels), each over the whole of K, B fragments from the packed weights.
template <int MODE, bool BF16>
__device__ __forceinline__ void frame_direct(const QParams& p, const unsigned char* ring,
                                             const int* off0, const int* off1, int b, int t,
                                             int h2_0, int w2_0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4, nwarps = blockDim.x / 32;
  const int P = p.PR * p.PC;
  const int mgroups = (P + 15) / 16, ngroups = p.Npad / 32;
  const int chunks = p.Kpad / 32;
  for (int task = warp; task < mgroups * ngroups; task += nwarps) {
    const int mg = task / ngroups, ng = task % ngroups;
    // the thread's two rows: pooled positions mg*16 + g and + 8 of the tile
    const int idx[2] = {mg * 16 + g, mg * 16 + g + 8};
    int acc[4][4][4];  // [window (jh, jw)][n8 tile][fragment register]
    zero(acc);
    const int8_t* wg = p.w + (size_t)(ng * 32 + g) * p.Kpad + tq * 4;
    uint32_t bf[4][2], bn[4][2];  // this chunk's B fragments, the next one's
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
    epilogue<BF16>(p, acc, idx, b, t, h2_0, w2_0, ng, tq);
  }
}

template <int MODE, bool BF16>
__global__ void __launch_bounds__(MAX_NT, 1) int8_conv_pool_kernel(const QParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* s_tab = reinterpret_cast<int*>(smem);  // [parity]: frame-independent
  int* s_off = s_tab + 2 * p.n_off;           // [parity]: this frame's copy
  unsigned char* ring = smem + p.off_bytes;
  unsigned char* bring = ring + p.R * p.slot_bytes;

  // blockIdx.x -> (tile, run of F frames, clip), the tiles fastest
  const int tile = blockIdx.x % p.tiles;
  const int run = (blockIdx.x / p.tiles) % p.runs;
  const int b = blockIdx.x / (p.tiles * p.runs);
  const int t_begin = run * p.F, t_end = min(t_begin + p.F, p.T);
  const int h2_0 = (tile / p.tiles_w) * p.PR, w2_0 = (tile % p.tiles_w) * p.PC;
  const int pt = (p.kt - 1) / 2;
  const int h0 = 2 * h2_0 - (p.kh - 1) / 2, w0 = 2 * w2_0 - (p.kw - 1) / 2;
  const int nt = blockDim.x;
  // frame ti (>= -pt) lives in slot (ti + pt) mod R
  auto slot = [&](int ti) { return ring + ((ti + pt) % p.R) * p.slot_bytes; };

  // table jw: the byte of k (or of the group k = step*e .. step*e + step -
  // 1) from the row base of a pre-pool position in column plane jw (`base`
  // below; without planes the position's own byte, and both tables are the
  // same), for an output frame whose first input frame (dt = 0) is in slot
  // 0; -1 past K, or for ldmatrix (which cannot skip a row) 0: the packed
  // weights are zero past K
  const int step = MODE == A_LDSM ? 16 : MODE == A_WORDS ? 4 : 1;
  for (int i = threadIdx.x; i < 2 * p.n_off; i += nt) {
    const int e = i % p.n_off, jw = i / p.n_off;
    const int k = e * step;
    int off = MODE == A_LDSM ? 0 : -1;
    if (k < p.K) {
      const int tap = k / p.Cin, ci = k % p.Cin;
      const int dt = tap / (p.kh * p.kw), dh = (tap / p.kw) % p.kh, dw = tap % p.kw;
      const int wc = jw + dw;
      off = dt * p.slot_bytes + ci +
            (p.planes ? (((wc & 1) * p.IH + dh) * p.IWh + (wc >> 1)) * p.S
                      : (dh * p.IW + dw) * p.S);
    }
    s_tab[i] = off;
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
  if (async) cp_async_commit();

  const int n_items = p.Cin * p.IH * p.IW;  // scalar staging's items per frame
  const int ring_bytes = p.R * p.slot_bytes;

  for (int t = t_begin; t < t_end; ++t) {
    if (async) cp_async_wait<0>();
    // frame t + pt has landed; every warp is done with output frame t - 1,
    // so the slot of frame t - pt - 1 is free for frame t + pt + 1, and the
    // tables' frame copy for frame t
    __syncthreads();
    // this frame's tables: its first input frame t - pt is in slot t mod R
    const int fb = (t % p.R) * p.slot_bytes;
    for (int i = threadIdx.x; i < 2 * p.n_off; i += nt) {
      const int u = s_tab[i];
      s_off[i] = u < 0 ? u : (u + fb >= ring_bytes ? u + fb - ring_bytes : u + fb);
    }
    const int next = t + pt + 1;
    const bool more = t + 1 < t_end;
    float pre[PREFETCH];
    if (more && scalar) {
#pragma unroll
      for (int u = 0; u < PREFETCH; ++u) {
        const int i = threadIdx.x + u * nt;
        pre[u] = i < n_items ? load_item(p, b, next, h0, w0, i) : 0.f;
      }
    }
    __syncthreads();  // the frame's tables
    const int* off0 = s_off;            // column plane 0
    const int* off1 = s_off + p.n_off;  // column plane 1
    // an async halo (int8, Cin % 16 == 0) is always the ring's (A_LDSM)
    if constexpr (MODE == A_LDSM)
      frame_ring<BF16>(p, ring, bring, off0, off1, b, t, h2_0, w2_0,
                       more && async ? slot(next) : nullptr, next, h0, w0);
    else
      frame_direct<MODE, BF16>(p, ring, off0, off1, b, t, h2_0, w2_0);

    // the next frame, while no warp reads its slot: the prefetched values,
    // then the rest of it
    if (more && scalar) {
#pragma unroll
      for (int u = 0; u < PREFETCH; ++u) {
        const int i = threadIdx.x + u * nt;
        if (i < n_items) store_item(p, slot(next), i, pre[u]);
      }
      stage_sync(p, slot(next), b, next, h0, w0, PREFETCH * nt);
    } else if (more && !async) {
      stage_sync(p, slot(next), b, next, h0, w0, 0);
    }
  }
}

// The shared-memory opt-in of each instantiation, set once per device.
template <int MODE, bool BF16>
cudaError_t launch(const QParams& p, int device, cudaStream_t stream) {
  static std::atomic<bool> opted_in[MAX_DEVICES];
  const size_t smem = smem_bytes(MODE, p.Kpad, p.kt, p.IH, p.IW, p.S, p.groups, p.stage_chunks);
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
  const int nt = MODE == A_LDSM ? 32 * p.mgroups * p.groups : DIRECT_NT;
  int8_conv_pool_kernel<MODE, BF16><<<(unsigned)blocks, nt, smem, stream>>>(p);
  return cudaGetLastError();
}

// Grid: one CTA per (clip, run of `frames` frames, tile of tile_rows x
// tile_cols pooled positions). x is f32 (x_int8 = 0) or int8 channels-last
// (x_sc = 1); out is f32 (bf16 under BF16; out_int8 = 0) or int8
// channels-last (o_sc = 1), quantized with out_scale. Cin % 16 == 0: the B
// ring's stages of `stage_chunks` k-chunks, groups x 32 channels a round,
// mgroups x groups warps; else groups and stage_chunks 0, B fragments per
// warp task, 8 warps.
template <bool BF16>
int run(
    const void* x, const int8_t* w, const void* scale, const void* bias, void* out,
    float x_scale, float out_scale, int x_int8, int out_int8, int B, int Cin, int T, int H,
    int W, int Cout, int kt, int kh, int kw, int Kpad, int Npad, int tile_rows, int tile_cols,
    int groups, int stage_chunks, int pos_bytes, int frames, long long x_sb, long long x_sc,
    long long x_st, long long x_sh, long long x_sw, long long o_sb, long long o_sc,
    long long o_st, long long o_sh, long long o_sw, int device, void* stream) {
  const int K = Cin * kt * kh * kw;
  const int mode = mode_of(Cin);
  const bool words = Cin % 4 == 0;
  const int mgroups = (tile_rows * tile_cols + 15) / 16;
  const bool ring = mode == A_LDSM;
  if (B < 1 || Cin < 1 || T < 1 || H < 2 || W < 2 || Cout < 1 || kt < 1 || kh < 1 ||
      kw < 1 || !(kt % 2) || !(kh % 2) || !(kw % 2) || Kpad < K || Kpad % 32 ||
      Npad < Cout || Npad % 32 || tile_rows < 1 || tile_cols < 1 || pos_bytes < Cin ||
      (words && pos_bytes % 16) || frames < 1 || (x_int8 && Cin > 1 && x_sc != 1) ||
      (out_int8 && Cout > 1 && o_sc != 1) || (out_int8 && !(out_scale > 0.f)) ||
      (ring && (groups < 1 || stage_chunks < 1 || stage_chunks > 64 ||
                32 * mgroups * groups > MAX_NT)) ||
      (!ring && (groups != 0 || stage_chunks != 0)))
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
  p.n_off = offset_entries(mode, Kpad); p.off_bytes = table_bytes(mode, Kpad);
  p.mgroups = mgroups; p.groups = groups; p.stage_chunks = stage_chunks;
  p.rounds = ring ? (Npad / 32 + groups - 1) / groups : 0;
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
  e = mode == A_LDSM    ? launch<A_LDSM, BF16>(p, device, s)
      : mode == A_WORDS ? launch<A_WORDS, BF16>(p, device, s)
                        : launch<A_BYTES, BF16>(p, device, s);
  return static_cast<int>(e);
}

}  // namespace

// Shared memory one CTA takes for this geometry (the wrapper's tile choice
// mirrors it: `quantconv.shared_memory_bytes`).
extern "C" int avs_int8_conv_pool_smem(int Cin, int Kpad, int kt, int kh, int kw,
                                       int tile_rows, int tile_cols, int pos_bytes,
                                       int groups, int stage_chunks) {
  return (int)smem_bytes(mode_of(Cin), Kpad, kt, 2 * tile_rows + kh - 1,
                         2 * tile_cols + kw - 1, pos_bytes, groups, stage_chunks);
}

// bf16 = 0: f32 scale and bias, f32 or int8 out. bf16 = 1: the bf16
// epilogue, bf16 scale (s16) and bias (b16), bf16 or int8 out.
extern "C" int avs_int8_conv_pool(
    const void* x, const int8_t* w, const void* scale, const void* bias, void* out,
    float x_scale, float out_scale, int x_int8, int out_int8, int bf16, int B, int Cin, int T,
    int H, int W, int Cout, int kt, int kh, int kw, int Kpad, int Npad, int tile_rows,
    int tile_cols, int groups, int stage_chunks, int pos_bytes, int frames,
    long long x_sb, long long x_sc, long long x_st, long long x_sh, long long x_sw,
    long long o_sb, long long o_sc, long long o_st, long long o_sh, long long o_sw, int device,
    void* stream) {
  return (bf16 ? run<true> : run<false>)(
      x, w, scale, bias, out, x_scale, out_scale, x_int8, out_int8, B, Cin, T, H, W, Cout, kt,
      kh, kw, Kpad, Npad, tile_rows, tile_cols, groups, stage_chunks, pos_bytes, frames,
      x_sb, x_sc, x_st, x_sh, x_sw, o_sb, o_sc, o_st, o_sh, o_sw, device, stream);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
