// GRU recurrence over precomputed input projections, whole sequence in one
// launch, one or two directions at once.
//
// Replaces: avsync/ops/pallas/gru.py, `pallas_gru_scan` (Pallas TPU kernels
// `_gru_kernel_vmem` / `_gru_kernel`). Same function: given
// gi = x @ w_ih + b_ih for every step (B, T, 3H), w_hh (H, 3H) and b_hh (3H),
// run h_t = GRU(gi_t, h_{t-1}) from h_0 = 0 with torch's [r, z, n] gates,
//   r = sigmoid(gi_r + h W_hr + b_hr)
//   z = sigmoid(gi_z + h W_hz + b_hz)
//   n = tanh(gi_n + r * (h W_hn + b_hn))
//   h' = (1 - z) * n + z * h
// walking time backwards for a reverse direction, and write every h_t.
//
// What bounds it on the H100: not bytes (w_hh 0.79 MB + gi 1.8 MB + out
// 0.6 MB per direction at B=8, T=75, H=256) and barely operations (0.24
// GFLOP per direction), but the chain of T dependent steps: each step needs
// the whole h_{t-1} from the step before, so the latency of one step (a
// (B, H) x (H, 3H) product, the gates, and one exchange of h) times T is
// the floor that matters.
//
// Design. Like the TPU kernel, w_hh and h stay on chip for all T steps. In
// f32 w_hh is 768 KiB at H = 256, more than one SM's shared memory, so a
// thread-block cluster of 8 CTAs splits it:
//   * one cluster per (direction, tile of BT batch rows); CTA k of the
//     cluster owns hidden units [k*U, (k+1)*U), U = H/8, and keeps their r, z
//     and n columns of w_hh in shared memory (H x 3U floats: 96 KB at
//     H = 256) for the whole launch;
//   * every CTA holds a full copy of h_{t-1} (H x BT floats) in a
//     double-buffered shared array;
//   * per step each CTA computes its 3U columns of h W_hh for its BT rows
//     (the K = H sum split over warps, partial sums reduced through shared
//     memory), the gates and its U units of h_t; it writes them to out and
//     pushes them into the next h buffer of all 8 CTAs through distributed
//     shared memory; one cluster barrier ends the step. Double buffering
//     makes that one barrier per step enough;
//   * the step's gi values are loaded before the product, so their latency
//     hides behind it.
// Both directions of a bidirectional layer share one launch (grid.y is the
// direction) and write their halves of the (B, T, 2H) output directly.
// Accuracy: expf / tanhf, no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // CTAs per cluster; each owns H/8 hidden units
constexpr int NT = 256;     // threads per CTA

struct GruParams {
  const float* gi[2];   // per direction; gi[d][b*gi_sb + t*gi_st + col]
  const float* w_hh[2]; // per direction; w[k*w_sk + col*w_sc], (H, 3H) logical
  const float* b_hh[2]; // per direction; (3H,), contiguous
  float* out;           // out[b*o_sb + t*o_st + d*o_sd + j]
  long long gi_sb, gi_st, w_sk, w_sc, o_sb, o_st, o_sd;
  int B, T, H, reverse_mask;  // bit d set: direction d walks time backwards
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

template <int BT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
gru_fwd_kernel(const GruParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int H = p.H, T = p.T;
  const int U = H / CLUSTER;
  const int U3 = 3 * U;
  const int S = NT / U;              // K-slices of the h W_hh product
  const int L = (H + S - 1) / S;     // slice length
  const int tid = threadIdx.x;
  const bool rev = (p.reverse_mask >> d) & 1;

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [H][3U]: r | z | n columns
  float* s_h = s_w + H * U3;                     // [2][H][BT]
  float* s_red = s_h + 2 * H * BT;               // [S][3][BT][U]

  const float* W = p.w_hh[d];
  for (int i = tid; i < H * U3; i += NT) {
    const int k = i / U3, c = i % U3;
    const int col = (c / U) * H + rank * U + (c % U);
    s_w[i] = W[k * p.w_sk + col * p.w_sc];
  }
  for (int i = tid; i < H * BT; i += NT) s_h[i] = 0.f;  // h_0 = 0

  // finalize role: one (batch row, unit) per thread
  const bool fin = tid < BT * U;
  const int fb = tid / U, fu = tid % U;
  const int gb = b0 + fb;
  const bool row_ok = fin && gb < p.B;
  const int jr = rank * U + fu;
  float bhr = 0.f, bhz = 0.f, bhn = 0.f;
  if (fin) {
    bhr = p.b_hh[d][jr];
    bhz = p.b_hh[d][H + jr];
    bhn = p.b_hh[d][2 * H + jr];
  }
  const float* gi_row = p.gi[d] + (row_ok ? gb : 0) * p.gi_sb;
  float* out_row = p.out + (row_ok ? gb : 0) * p.o_sb + d * p.o_sd + jr;

  // product role: column u, K-slice s
  const int du = tid % U, ds = tid / U;
  const bool dot = ds < S;
  const int k0 = ds * L;
  const int k1 = min(H, k0 + L);

  cluster.sync();  // every CTA's shared memory is initialised before any push

  int cur = 0;
  for (int i = 0; i < T; ++i) {
    const int t = rev ? T - 1 - i : i;
    float xr = 0.f, xz = 0.f, xn = 0.f;
    if (row_ok) {
      const float* g = gi_row + t * p.gi_st;
      xr = g[jr];
      xz = g[H + jr];
      xn = g[2 * H + jr];
    }
    const float* hcur = s_h + cur * H * BT;

    if (dot) {
      float acc[3][BT];
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[g][b] = 0.f;
      for (int k = k0; k < k1; ++k) {
        const float* wk = s_w + k * U3 + du;
        const float wr = wk[0], wz = wk[U], wn = wk[2 * U];
        float hv[BT];
        if constexpr (BT % 4 == 0) {
          const float4* h4 = reinterpret_cast<const float4*>(hcur + k * BT);
#pragma unroll
          for (int q = 0; q < BT / 4; ++q) {
            const float4 v = h4[q];
            hv[4 * q] = v.x; hv[4 * q + 1] = v.y;
            hv[4 * q + 2] = v.z; hv[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < BT; ++b) hv[b] = hcur[k * BT + b];
        }
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          acc[0][b] = fmaf(hv[b], wr, acc[0][b]);
          acc[1][b] = fmaf(hv[b], wz, acc[1][b]);
          acc[2][b] = fmaf(hv[b], wn, acc[2][b]);
        }
      }
#pragma unroll
      for (int g = 0; g < 3; ++g)
#pragma unroll
        for (int b = 0; b < BT; ++b)
          s_red[((ds * 3 + g) * BT + b) * U + du] = acc[g][b];
    }
    __syncthreads();

    if (fin) {
      float ghr = 0.f, ghz = 0.f, ghn = 0.f;
      for (int s = 0; s < S; ++s) {
        const float* rs = s_red + (s * 3 * BT + fb) * U + fu;
        ghr += rs[0];
        ghz += rs[BT * U];
        ghn += rs[2 * BT * U];
      }
      ghr += bhr;
      ghz += bhz;
      ghn += bhn;
      const float hp = hcur[jr * BT + fb];
      const float r = sigmoidf(xr + ghr);
      const float z = sigmoidf(xz + ghz);
      const float n = tanhf(xn + r * ghn);
      const float hn = (1.f - z) * n + z * hp;
      if (row_ok) out_row[t * p.o_st] = hn;
      float* nxt = s_h + (cur ^ 1) * H * BT + jr * BT + fb;
#pragma unroll
      for (int q = 0; q < CLUSTER; ++q) *cluster.map_shared_rank(nxt, q) = hn;
    }
    cluster.sync();  // h_t complete everywhere; s_red free for the next step
    cur ^= 1;
  }
}

size_t smem_bytes(int H, int BT) {
  const int U = H / CLUSTER;
  const int S = NT / U;
  return sizeof(float) *
         ((size_t)H * 3 * U + 2 * (size_t)H * BT + (size_t)S * 3 * BT * U);
}

constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90

// Rows per cluster: the smallest power of two >= B, at most 8, small enough
// that every (row, unit) pair has its own thread and the shared arrays fit.
int rows_per_cluster(int B, int H) {
  const int U = H / CLUSTER;
  int bt = 1;
  while (bt < B && bt < 8) bt *= 2;
  while (bt > 1 && (bt * U > NT || smem_bytes(H, bt) > MAX_SMEM)) bt /= 2;
  return bt;
}

template <int BT>
cudaError_t launch(const GruParams& p, int ndir, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.H, BT);
  cudaError_t e = cudaFuncSetAttribute(
      gru_fwd_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(CLUSTER, ndir, (p.B + BT - 1) / BT);
  gru_fwd_kernel<BT><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int avs_gru_fwd(
    const float* gi0, const float* gi1, const float* w0, const float* w1,
    const float* b0, const float* b1, float* out,
    long long gi_sb, long long gi_st, long long w_sk, long long w_sc,
    long long o_sb, long long o_st, long long o_sd,
    int B, int T, int H, int ndir, int reverse_mask, int device,
    void* stream) {
  if (H % CLUSTER != 0 || H / CLUSTER > NT || ndir < 1 || ndir > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  GruParams p{{gi0, gi1}, {w0, w1}, {b0, b1}, out,
              gi_sb, gi_st, w_sk, w_sc, o_sb, o_st, o_sd,
              B, T, H, reverse_mask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (rows_per_cluster(B, H)) {
    case 8: e = launch<8>(p, ndir, s); break;
    case 4: e = launch<4>(p, ndir, s); break;
    case 2: e = launch<2>(p, ndir, s); break;
    default: e = launch<1>(p, ndir, s); break;
  }
  return static_cast<int>(e);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
