// Fused mel -> dB -> top_db clamp -> DCT -> masked mean/std (the MFCC
// statistics of the misalignment detector's audio features).
//
// Replaces: avsync/ops/pallas/mfcc.py, `pallas_mel_stats` (Pallas TPU kernel
// `_mel_stats_kernel`). Same function, per clip b with n = n_valid[b]:
//   mel = power[b] @ melT                      (F, M)
//   log = 10 log10(max(1e-10, mel))
//   ref = max of log over the rows < n;  log = max(log, ref - top_db)
//   mfcc = log @ dctT                          (F, C)
//   out[b] = concat(mean, unbiased std) of mfcc over the rows < n, the std's
//   divisor max(n-1, 1), the std 0 when n <= 1, the whole row 0 when n <= 0.
// The FFT before it stays outside (cuFFT through torch.fft.rfft).
//
// What bounds it on the H100: the bytes of the power spectrogram. The
// default Slaney filterbank (K = 1025 bins, M = 128 mels) is 98.5% zeros:
// each mel column is one contiguous band of 5-48 bins, 2,020 nonzeros in
// all. Summing each column over its band only, a clip of F = 121 frames is
// 0.24 M multiply-adds for the mel product and 0.31 M for the DCT, against
// 0.5 MB of power read once: at B = 32 that is 15.9 MB (4.7 us at
// 3.35 TB/s) against 0.035 GFLOP (0.5 us at 67 TFLOP/s fp32). A dense
// product would be 1.02 GFLOP (15.2 us): the bands are what makes it a
// bytes-bound kernel.
//
// Design (simple and right first):
//   * one CTA of 1024 threads per clip (the only CTA on its SM: 32 warps to
//     hide the latency of its loads); only the clip's n valid rows are read
//     (rows >= n enter neither the max nor the statistics);
//   * the power rows come into shared memory in chunks of R rows, each chunk
//     one coalesced read of R*K contiguous floats with 16 loads in flight
//     per thread (64 KB per CTA at R = 16); a thread per (row, mel)
//     sums its band in ascending bin order against the band's packed weights
//     (the wrapper packs each column's nonzero band once per filterbank, so
//     any melT works: a dense one gives full-width bands). Skipping exact
//     zeros in ascending order gives the dense sequential sum bit for bit,
//     since power >= 0 makes every skipped term +0;
//   * the clip's (F, M) log-mel lives in dynamic shared memory (121 x 128
//     floats = 62 KB), with the DCT matrix and the (F, C) MFCCs beside it;
//   * the max, the sums and the squared deviations are reduced in a fixed
//     order (warp butterflies over a fixed lane assignment, no float atomics),
//     so a repeat launch gives the same bits; the variance is two-pass (mean
//     first, then squared deviations), as the TPU kernel computes it.
// Occupancy: at B = 32 (a detector train step) this is 32 CTAs on 132 SMs,
// each pulling its clip's 0.5 MB through one SM, so the kernel is expected
// well above its bound there; at the eval sweep's 512 clips about 4 waves
// of one CTA per SM (R = 16 takes 146 KB of shared memory). Splitting a
// clip's frames over a cluster of CTAs, exchanging the max and the column
// sums through distributed shared memory, is the lever if the time shows
// it matters.
// Accurate log10f/sqrtf and IEEE division: no fast-math flags.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int NT = 1024;  // threads per CTA
constexpr int NW = NT / 32;
constexpr int LOADS = 16;  // power loads a thread has in flight while staging

struct MelStatsParams {
  const float* power;    // (B, F, K), contiguous
  const int* n_valid;    // (B,)
  const int* band_lo;    // (M,) first bin of each mel column's band
  const int* band_len;   // (M,) bins in the band (0: an all-zero column)
  const int* band_off;   // (M,) offset of the band's weights in wpack
  const float* wpack;    // the bands' weights, column after column
  const float* dct;      // (M, C), contiguous
  float* out;            // (B, 2C), contiguous
  int B, F, K, M, C, R;
  float top_db;
};

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

__global__ void __launch_bounds__(NT) mel_stats_kernel(const MelStatsParams p) {
  extern __shared__ float smem[];
  float* s_log = smem;                   // [F][M]
  float* s_pow = s_log + p.F * p.M;      // [R][K]
  float* s_dct = s_pow + p.R * p.K;      // [M][C]
  float* s_mfcc = s_dct + p.M * p.C;     // [F][C]
  float* s_red = s_mfcc + p.F * p.C;     // [NW]
  int* s_lo = reinterpret_cast<int*>(s_red + NW);
  int* s_len = s_lo + p.M;
  int* s_off = s_len + p.M;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int n = p.n_valid[b];
  float* out = p.out + (size_t)b * 2 * p.C;
  if (n <= 0) {  // no valid frame: the row is zeros (and no -inf max)
    for (int c = tid; c < 2 * p.C; c += NT) out[c] = 0.f;
    return;
  }
  const int rows = min(n, p.F);

  for (int m = tid; m < p.M; m += NT) {
    s_lo[m] = p.band_lo[m];
    s_len[m] = p.band_len[m];
    s_off[m] = p.band_off[m];
  }
  for (int i = tid; i < p.M * p.C; i += NT) s_dct[i] = p.dct[i];

  // 1. mel product over each column's band, then dB; running max
  const float* pw = p.power + (size_t)b * p.F * p.K;
  float tmax = -INFINITY;
  for (int f0 = 0; f0 < rows; f0 += p.R) {
    const int nr = min(p.R, rows - f0);
    __syncthreads();  // the previous chunk is consumed (and the bands are staged)
    // the chunk's nr*K contiguous floats, LOADS loads in flight per thread
    // before any store (one CTA per clip: the loads must not go one by one)
    const float* src = pw + (size_t)f0 * p.K;
    const int total = nr * p.K;
    for (int i0 = tid; i0 < total; i0 += NT * LOADS) {
      float v[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * NT;
        v[u] = i < total ? __ldg(src + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int i = i0 + u * NT;
        if (i < total) s_pow[i] = v[u];
      }
    }
    __syncthreads();
    for (int i = tid; i < nr * p.M; i += NT) {
      const int r = i / p.M, m = i % p.M;
      const float* x = s_pow + r * p.K + s_lo[m];
      const float* w = p.wpack + s_off[m];
      const int len = s_len[m];
      float acc = 0.f;
      for (int j = 0; j < len; ++j) acc = fmaf(x[j], __ldg(w + j), acc);
      const float db = 10.f * log10f(fmaxf(1e-10f, acc));
      s_log[(f0 + r) * p.M + m] = db;
      tmax = fmaxf(tmax, db);
    }
  }

  // 2. max over the valid rows (exact in any order)
  tmax = warp_max(tmax);
  if (lane == 0) s_red[warp] = tmax;
  __syncthreads();
  if (warp == 0) {
    float v = lane < NW ? s_red[lane] : -INFINITY;
    v = warp_max(v);
    if (lane == 0) s_red[0] = v;
  }
  __syncthreads();
  const float floor_db = s_red[0] - p.top_db;

  // 3. clamp and DCT: one thread per (row, coefficient), mels in order
  for (int i = tid; i < rows * p.C; i += NT) {
    const int f = i / p.C, c = i % p.C;
    const float* lg = s_log + f * p.M;
    float acc = 0.f;
    for (int m = 0; m < p.M; ++m) acc = fmaf(fmaxf(lg[m], floor_db), s_dct[m * p.C + c], acc);
    s_mfcc[f * p.C + c] = acc;
  }
  __syncthreads();

  // 4. two-pass statistics: one warp per coefficient, lane l takes rows
  //    l, l+32, ... in order, then a butterfly
  const float nf = fmaxf(static_cast<float>(n), 1.f);
  for (int c = warp; c < p.C; c += NW) {
    float s = 0.f;
    for (int f = lane; f < rows; f += 32) s += s_mfcc[f * p.C + c];
    const float mean = warp_sum(s) / nf;
    float v = 0.f;
    for (int f = lane; f < rows; f += 32) {
      const float d = s_mfcc[f * p.C + c] - mean;
      v = fmaf(d, d, v);
    }
    v = warp_sum(v);
    if (lane == 0) {
      out[c] = mean;
      out[p.C + c] = n > 1 ? sqrtf(v / fmaxf(nf - 1.f, 1.f)) : 0.f;
    }
  }
}

size_t smem_bytes(int F, int K, int M, int C, int R) {
  return sizeof(float) * ((size_t)F * M + (size_t)R * K + (size_t)M * C + (size_t)F * C + NW) +
         sizeof(int) * 3 * (size_t)M;
}

}  // namespace

extern "C" int avs_mel_stats(const float* power, const int* n_valid, const int* band_lo,
                             const int* band_len, const int* band_off, const float* wpack,
                             const float* dct, float* out, int B, int F, int K, int M, int C,
                             int R, float top_db, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B <= 0) return static_cast<int>(cudaSuccess);
  if (F < 1 || K < 1 || M < 1 || C < 1 || R < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(F, K, M, C, R);
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(mel_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const MelStatsParams p{power, n_valid, band_lo, band_len, band_off, wpack, dct, out,
                         B, F, K, M, C, R, top_db};
  mel_stats_kernel<<<B, NT, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
