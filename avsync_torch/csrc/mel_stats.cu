// Fused mel -> dB -> top_db clamp -> DCT -> masked mean/std (the MFCC
// statistics of the misalignment detector's audio features).
//
// Replaces: avsync/ops/pallas/mfcc.py:27-97, `pallas_mel_stats` (Pallas TPU
// kernel `_mel_stats_kernel`). Same function, per clip b with n = n_valid[b]:
//   mel = power[b] @ melT                      (F, M)
//   log = 10 log10(max(1e-10, mel))
//   ref = max of log over the rows < n;  log = max(log, ref - top_db)
//   mfcc = log @ dctT                          (F, C)
//   out[b] = concat(mean, unbiased std) of mfcc over the rows < n, the std's
//   divisor max(n-1, 1), the std 0 when n <= 1, the whole row 0 when n <= 0.
// The FFT before it stays outside (cuFFT through torch.fft.rfft).
//
// What bounds it on the H100: the bytes of the power spectrogram, read once.
// The default Slaney filterbank (K = 1025 bins, M = 128 mels) is 98.5%
// zeros: each mel column is one contiguous band of 5-48 bins, 2,020 nonzeros
// in all. Summing each column over its band only, a clip of F = 121 frames
// is 0.24 M multiply-adds for the mel product and 0.31 M for the DCT,
// against 0.5 MB of power: at B = 32 that is 15.9 MB (4.7 us at 3.35 TB/s)
// against 0.035 GFLOP (0.5 us at 67 TFLOP/s fp32).
//
// Design: a cluster of CS CTAs per clip, so that a clip's bytes come in
// through CS SMs at once and no CTA holds the whole clip.
//   * the wrapper chooses CS <= 8 (portable) and R rows per CTA from F, K, M
//     and C alone (`cluster_grid` in ops/cuda/mfcc.py: up to 64 rows per
//     CTA, so CS = 2 and R = 61 at the detector's F = 121, CS = 8 from F =
//     449 on): never from B or the card, so a clip's 40 statistics are the
//     same bits in any batch on any card. CTA `rank` owns rows [rank R, rank
//     R + R) and reads only the valid ones (< n). (Smaller clusters measured
//     faster: at 16 rows per CTA and CS = 8 the cluster's scheduling and
//     barriers cost more than the split saved.)
//   * the rows come into shared memory in slabs of SR rows, each slab one
//     contiguous span of global memory copied with 16-byte cp.async: the
//     span is widened to 16-byte boundaries (K = 1025 makes a row 4,100
//     bytes, so a slab rarely starts on one) and laid out at the same offset
//     mod 16 in shared memory, so the ragged head and tail are read and
//     never used. Two slab buffers when a CTA has more than SR rows, so the
//     next slab is in flight while this one's band sums run. SR = 16 while
//     the launch has at most one CTA per SM; 8 above, where two CTAs share
//     an SM (110 KB each at F = 121), one loading while the other computes.
//     The slabs do not enter the arithmetic;
//   * band sums: lane = (row r = lane % SR, mel m = task * (32/SR) + lane /
//     SR), so a warp walks the bands of 32/SR neighbouring mels (2 at SR =
//     16, whose lengths differ by a bin or so: no divergence to speak of),
//     with the band's packed weights read as a broadcast; each (row, mel) sum
//     is the ascending-bin fmaf chain from 0 of the earlier kernel, which is
//     the dense sequential sum bit for bit (power >= 0: every skipped term is
//     +0);
//   * the cluster exchanges three things, each CTA pushing its values into
//     slot `rank` of every CTA with st.async stores that complete bytes of
//     the receiver's mbarrier (one barrier per exchange, armed with the
//     bytes it expects before a cluster barrier whose wait comes only before
//     the first push, so its latency hides behind the band sums): no
//     cluster-wide barrier and no remote read between the phases;
//   * top_db: each CTA's max of its log-mel, pushed; every CTA then takes
//     the max of the CS maxima (a max is exact in any order);
//   * DCT: lane = row, warp = four coefficients (one 16-byte broadcast of
//     the DCT row per mel, the columns padded to a multiple of 4), the
//     log-mel rows at a stride of M + 1 floats (a stride of 128 would put
//     the 32 lanes in one bank); each (row, coefficient) the fmaf chain over
//     the mels in order;
//   * two-pass statistics in a fixed order: each CTA sums its rows' MFCCs
//     per coefficient (lane l takes rows l, l + 32, ..., then a butterfly),
//     pushes the sums, and adds the CS of them in rank order, so every CTA
//     holds the same mean; the same for the squared deviations; rank 0
//     writes mean and std. No float atomics: a repeat launch gives the same
//     bits.
// Host work once per device: the shared-memory opt-in; cudaSetDevice only
// when the device changes. Accurate log10f/sqrtf and IEEE division: no
// fast-math flags.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "cluster_exchange.cuh"
#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 512;  // threads per CTA
constexpr int NW = NT / 32;
constexpr int MAX_CLUSTER = 8;  // portable cluster size
constexpr int DCT_CG = 2;       // coefficients per DCT task

struct MelStatsParams {
  const float* power;    // (B, F, K), contiguous
  const int* n_valid;    // (B,)
  const int* band_lo;    // (M,) first bin of each mel column's band
  const int* band_len;   // (M,) bins in the band (0: an all-zero column)
  const int* band_off;   // (M,) offset of the band's weights in wpack
  const float* wpack;    // the bands' weights, column after column
  const float* dct;      // (M, C), contiguous
  float* out;            // (B, 2C), contiguous
  int F, K, M, C, R, SR, nbuf;
  float top_db;
};

__host__ __device__ __forceinline__ long long round4(long long v) { return (v + 3) / 4 * 4; }

// Floats of each part of a CTA's dynamic shared memory, every part a
// multiple of 16 bytes: `a` the slab buffers (each `slab` floats: SR rows
// and room for the 16-byte widening), later the (R, C) MFCCs; `log` the
// (R, M + 1) log-mel; `dct` the (M, C4) DCT matrix, its columns padded with
// zeros to C4 = round4(C); `band` the (3, M) band table; `red` the warps'
// maxima and the cluster's maxima and (MAX_CLUSTER, C) partials as they
// arrive from each rank.
struct Layout {
  long long slab, a, log, dct, band, red;
};

__host__ __device__ __forceinline__ Layout layout(int K, int M, int C, int R, int SR, int nbuf) {
  Layout s;
  s.slab = round4((long long)SR * K + 8);
  const long long mfcc = (long long)R * C;
  s.a = round4(nbuf * s.slab > mfcc ? nbuf * s.slab : mfcc);
  s.log = round4((long long)R * (M + 1));
  s.dct = (long long)M * round4(C);
  s.band = round4(3LL * M);
  s.red = round4(NW + MAX_CLUSTER + 2LL * MAX_CLUSTER * C);
  return s;
}

size_t smem_bytes(int K, int M, int C, int R, int SR, int nbuf) {
  const Layout s = layout(K, M, C, R, SR, nbuf);
  return sizeof(float) * (size_t)(s.a + s.log + s.dct + s.band + s.red);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Butterfly sum: every lane ends with the same bits (IEEE addition is
// commutative and every lane adds the same pairs in the same tree).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// First float of a slab's rows inside its 16-byte-widened copy.
__device__ __forceinline__ int slab_head(const float* src) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void __launch_bounds__(NT, 2) mel_stats_kernel(const MelStatsParams p) {
  extern __shared__ __align__(16) float smem[];
  // one mbarrier per exchange: the maxima, the sums, the squared deviations
  __shared__ alignas(8) uint64_t s_bar[3];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = p.K, M = p.M, C = p.C, SR = p.SR, C4 = static_cast<int>(round4(p.C));
  const Layout L = layout(K, M, C, p.R, SR, p.nbuf);
  float* s_pow = smem;              // nbuf slabs; after the band sums the MFCCs [R][C]
  float* s_mfcc = smem;
  float* s_log = smem + L.a;        // [R][M + 1]
  float* s_dct = s_log + L.log;     // [M][C4]
  int* s_lo = reinterpret_cast<int*>(s_dct + L.dct);  // [M] each of lo, len, off
  int* s_len = s_lo + M;
  int* s_off = s_len + M;
  float* s_wmax = s_dct + L.dct + L.band;  // [NW]
  float* s_xmax = s_wmax + NW;             // [MAX_CLUSTER]: each rank's max
  float* s_x1 = s_xmax + MAX_CLUSTER;      // [MAX_CLUSTER][C]: each rank's sums
  float* s_x2 = s_x1 + MAX_CLUSTER * C;    // [MAX_CLUSTER][C]: its squared deviations

  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = p.n_valid[b];
  float* out = p.out + (size_t)b * 2 * C;
  if (n <= 0) {  // the whole cluster leaves here: the row is zeros
    if (rank == 0)
      for (int c = tid; c < 2 * C; c += NT) out[c] = 0.f;
    return;
  }
  // each exchange's barrier expects 4 bytes per value from every rank; the
  // peers push only after the cluster barrier below, so their bytes never
  // arrive before these counts
  const uint32_t bar = smem_addr(s_bar);
  if (tid == 0) {
    for (int k = 0; k < 3; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar + 8 * k) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    expect_bytes(bar, 4 * cs);
    expect_bytes(bar + 8, 4 * cs * C);
    expect_bytes(bar + 16, 4 * cs * C);
  }
  cluster_arrive_release();  // waited for before the first push: latency hidden

  const int row0 = rank * p.R;
  const int rows = max(0, min(min(n, p.F) - row0, p.R));  // this CTA's valid rows
  const int n_slabs = (rows + SR - 1) / SR;
  const float* src0 = p.power + ((size_t)b * p.F + row0) * K;

  // slab s: its rows' contiguous floats, widened to 16-byte boundaries
  auto stage = [&](int s) {
    const int nr = min(SR, rows - s * SR);
    const float* src = src0 + (size_t)s * SR * K;
    const int head = slab_head(src);
    const float4* g = reinterpret_cast<const float4*>(src - head);
    float4* d = reinterpret_cast<float4*>(s_pow + (s % p.nbuf) * L.slab);
    const int chunks = (head + nr * K + 3) / 4;
    for (int i = tid; i < chunks; i += NT) cp_async16(d + i, g + i);
  };
  if (n_slabs > 0) stage(0);
  cp_async_commit();
  if (p.nbuf > 1 && n_slabs > 1) stage(1);
  cp_async_commit();
  for (int i = tid; i < M * C4; i += NT) {
    const int m = i / C4, c = i % C4;
    s_dct[i] = c < C ? __ldg(p.dct + m * C + c) : 0.f;
  }
  for (int m = tid; m < M; m += NT) {
    s_lo[m] = __ldg(p.band_lo + m);
    s_len[m] = __ldg(p.band_len + m);
    s_off[m] = __ldg(p.band_off + m);
  }

  // 1. band sums and dB, slab by slab; this thread's running max
  const int mpw = 32 / SR;  // mels per warp task
  const int r = lane % SR, msub = lane / SR;
  float tmax = -INFINITY;
  for (int s = 0; s < n_slabs; ++s) {
    if (p.nbuf > 1) {
      cp_async_wait<1>();  // slab s (slab s + 1 may still be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // every thread's copies of slab s (and the tables) are in place
    const float* src = src0 + (size_t)s * SR * K;
    const float* x0 = s_pow + (s % p.nbuf) * L.slab + slab_head(src) + r * K;
    const int nr = min(SR, rows - s * SR);
    float* lg = s_log + (size_t)(s * SR + r) * (M + 1);
    for (int t = warp; t * mpw < M; t += NW) {
      const int m = t * mpw + msub;
      if (r < nr && m < M) {
        const float* x = x0 + s_lo[m];
        const float* w = p.wpack + s_off[m];
        const int len = s_len[m];
        float acc = 0.f;
#pragma unroll 4
        for (int j = 0; j < len; ++j) acc = fmaf(x[j], __ldg(w + j), acc);
        const float db = 10.f * log10f(fmaxf(1e-10f, acc));
        lg[m] = db;
        tmax = fmaxf(tmax, db);
      }
    }
    __syncthreads();  // slab s is consumed: its buffer may be staged again
    if (s + p.nbuf < n_slabs) stage(s + p.nbuf);
    cp_async_commit();
  }

  // 2. the clip's max: this CTA's, pushed into slot `rank` of every CTA of
  //    the cluster (st.async completing bytes of the receiver's barrier)
  tmax = warp_max(tmax);
  if (lane == 0) s_wmax[warp] = tmax;
  __syncthreads();
  cluster_wait();  // every CTA's barriers are initialised
  if (warp == 0) {
    float v = lane < NW ? s_wmax[lane] : -INFINITY;
    v = warp_max(v);
    if (lane < cs) st_peer(peer_addr(smem_addr(s_xmax + rank), lane), v, peer_addr(bar, lane));
  }
  wait_phase(bar, 0);
  float ref = -INFINITY;
  for (int q = 0; q < cs; ++q) ref = fmaxf(ref, s_xmax[q]);
  const float floor_db = ref - p.top_db;

  // 3. clamp and DCT: lane = row, a warp task = (32 rows, 4 coefficients),
  //    the mels in order; the MFCCs overwrite the slabs
  const int n_cg = C4 / 4;
  for (int t = warp; t < ((rows + 31) / 32) * n_cg; t += NW) {
    const int row = (t / n_cg) * 32 + lane, c0 = (t % n_cg) * 4;
    if (row < rows) {
      const float* lg = s_log + (size_t)row * (M + 1);
      const float4* d = reinterpret_cast<const float4*>(s_dct + c0);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll 4
      for (int m = 0; m < M; ++m) {
        const float v = fmaxf(lg[m], floor_db);
        const float4 dm = d[m * n_cg];
        a0 = fmaf(v, dm.x, a0);
        a1 = fmaf(v, dm.y, a1);
        a2 = fmaf(v, dm.z, a2);
        a3 = fmaf(v, dm.w, a3);
      }
      float* o = s_mfcc + row * C + c0;
      o[0] = a0;
      if (c0 + 1 < C) o[1] = a1;
      if (c0 + 2 < C) o[2] = a2;
      if (c0 + 3 < C) o[3] = a3;
    }
  }
  __syncthreads();

  // 4. two-pass statistics: this CTA's partials (warp = coefficient, lane l
  //    takes rows l, l + 32, ..., then a butterfly) pushed into slot `rank`
  //    of every CTA, then added in rank order there: every CTA holds the
  //    same mean
  const float nf = fmaxf(static_cast<float>(n), 1.f);
  for (int c = warp; c < C; c += NW) {
    float s = 0.f;
    for (int f = lane; f < rows; f += 32) s += s_mfcc[f * C + c];
    s = warp_sum(s);
    if (lane < cs) st_peer(peer_addr(smem_addr(s_x1 + rank * C + c), lane), s,
                           peer_addr(bar + 8, lane));
  }
  wait_phase(bar + 8, 0);
  for (int c = warp; c < C; c += NW) {
    float sum = 0.f;
    for (int q = 0; q < cs; ++q) sum += s_x1[q * C + c];
    const float mean = sum / nf;
    float v = 0.f;
    for (int f = lane; f < rows; f += 32) {
      const float d = s_mfcc[f * C + c] - mean;
      v = fmaf(d, d, v);
    }
    v = warp_sum(v);
    if (lane < cs) st_peer(peer_addr(smem_addr(s_x2 + rank * C + c), lane), v,
                           peer_addr(bar + 16, lane));
  }
  wait_phase(bar + 16, 0);
  if (rank == 0) {
    for (int c = tid; c < C; c += NT) {
      float sum = 0.f, var = 0.f;
      for (int q = 0; q < cs; ++q) {
        sum += s_x1[q * C + c];
        var += s_x2[q * C + c];
      }
      out[c] = sum / nf;
      out[C + c] = n > 1 ? sqrtf(var / fmaxf(nf - 1.f, 1.f)) : 0.f;
    }
  }
  // every CTA has received all it waits for, so no push is in flight once
  // all have arrived: no CTA leaves before
  cluster_arrive_relaxed();
  cluster_wait();
}

}  // namespace

// Bytes of dynamic shared memory one CTA takes (`shared_memory_bytes` in
// ops/cuda/mfcc.py mirrors it; chip_smoke.py compares the two).
extern "C" long long avs_mel_stats_smem(int K, int M, int C, int R, int SR, int nbuf) {
  return static_cast<long long>(smem_bytes(K, M, C, R, SR, nbuf));
}

// Grid: B clusters of CS CTAs; CTA rank of a cluster takes rows [rank R,
// rank R + R) of its clip in slabs of SR rows, nbuf slab buffers (the
// wrapper chooses all four).
extern "C" int avs_mel_stats(const float* power, const int* n_valid, const int* band_lo,
                             const int* band_len, const int* band_off, const float* wpack,
                             const float* dct, float* out, int B, int F, int K, int M, int C,
                             int CS, int R, int SR, int nbuf, float top_db, int device,
                             void* stream) {
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (F < 1 || K < 1 || M < 1 || C < 1 || CS < 1 || CS > MAX_CLUSTER || R < 1 ||
      (long long)CS * R < F || SR < 1 || SR > 32 || 32 % SR != 0 || nbuf < 1 || nbuf > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(K, M, C, R, SR, nbuf);
  if (smem > MAX_DYN_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  static std::atomic<bool> opted_in[MAX_DEVICES];
  if ((e = opt_in_smem(opted_in, device, mel_stats_kernel)) != cudaSuccess)
    return static_cast<int>(e);
  const MelStatsParams p{power, n_valid, band_lo, band_len, band_off, wpack, dct, out,
                         F, K, M, C, R, SR, nbuf, top_db};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * CS, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, mel_stats_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
