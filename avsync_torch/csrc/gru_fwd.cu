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
// the whole h_{t-1} from the step before, so the latency of one step times T
// is the floor that matters. The earlier design (a K-split product reduced
// through shared memory and __syncthreads, 2,048 scattered one-word DSMEM
// stores per CTA and a full cluster barrier per step) took ~5 us per step
// at B=8, of which ~2.5 us was the exchange (push + cluster barrier) and
// ~1.5 us the product, its weights read from shared memory.
//
// Design. w_hh and h stay on chip for all T steps; a thread-block cluster
// of 8 CTAs splits w_hh, and each CTA keeps its part in REGISTERS:
//   * one cluster per (direction, tile of BT batch rows); CTA k owns hidden
//     units [k*U, (k+1)*U), U = H/8. Warp w owns 4 of them; its lane
//     (kq = lane/4, uq = lane%4) holds the r, z, n weights of unit uq for
//     the H/8 rows k of w_hh in [kq*U, (kq+1)*U), the units of CTA kq (96
//     registers at H = 256);
//   * per step each lane multiplies its k values of h_{t-1}, CTA kq's slice
//     of the shared copy, read as float4 (slices padded so the 8 kq lanes
//     hit disjoint banks, 4 lanes per address), into 3 x BT partial sums.
//     (Reading k = i*8 + kq one float at a time, at 224 registers, left the
//     loads unbatched: ~0.6 us of each step.) A transposing
//     butterfly over the 8 kq lanes (shuffles, no shared memory, no CTA
//     barrier) leaves each lane with the full r, z, n sums of one (unit,
//     row), in a fixed order, so repeats give the same bits;
//   * that lane applies the gates and stores h_t into the next h buffer of
//     all 8 CTAs with st.async, each store completing 4 bytes of the
//     transaction count of that CTA's mbarrier for the buffer (the warp's
//     4 x BT values are consecutive: one coalesced store per peer and
//     warp). No fence and no arrival on the writer's side: a first version
//     that stored, then arrived with release semantics at cluster scope,
//     spent ~1.3 us of each step in that release;
//   * a CTA waits only on its own mbarrier for the buffer it is about to
//     read, whose phase completes when the bytes of the whole h_{t-1} have
//     landed (thread 0 posts that count once per phase); there is no
//     cluster-wide barrier in the loop. Double buffering is safe without an
//     "empty" barrier: a lane pushes h_t into buffer (t+1)&1 only after its
//     CTA has received all of h_{t-1}, which every CTA pushes only after
//     its last read of that buffer for step t-1;
//   * each step's gi values are loaded one step ahead, and the output is
//     stored after the pushes, so no global latency sits on the chain.
// Rows per cluster: the fewest (1, 2 or 4) for which every cluster of the
// launch is resident at once (the occupancy query, cached per device).
// Both directions of a bidirectional layer share one launch (grid.y is the
// direction) and write their halves of the (B, T, 2H) output directly.
// H above 256 (its w_hh part would not fit in registers) takes a generic
// kernel with the same exchange: one thread per (unit, row), the CTA's
// columns of w_hh in shared memory where they fit, else read through L2.
// The wrapper pads H to a multiple of 8 with zero units.
// Accuracy: expf / tanhf, no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_exchange.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // CTAs per cluster; each owns H/8 hidden units
constexpr int UPW = 4;      // hidden units per warp
constexpr int KQ = 8;       // K-slices per warp: lane = kq * UPW + uq
constexpr int MAX_KPL = 32; // k values per lane (H/8): H <= 256
constexpr int MAX_NT = 32 * (MAX_KPL / UPW);  // 8 warps at H = 256

struct GruParams {
  const float* gi[2];   // per direction; gi[d][b*gi_sb + t*gi_st + col]
  const float* w_hh[2]; // per direction; w[k*w_sk + col*w_sc], (H, 3H) logical
  const float* b_hh[2]; // per direction; (3H,), contiguous
  float* out;           // out[b*o_sb + t*o_st + d*o_sd + j]
  long long gi_sb, gi_st, w_sk, w_sc, o_sb, o_st, o_sd;
  int B, T, H, reverse_mask;  // bit d set: direction d walks time backwards
};

// BT: batch rows per cluster (1, 2 or 4). NK: k values per lane (H/8) when
// known at compile time, 0 = read H at run time (H/8 <= MAX_KPL).
template <int BT, int NK>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_NT, 1)
gru_fwd_kernel(const GruParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int H = p.H, T = p.T;
  const int U = H / CLUSTER;
  const int nk = NK ? NK : H / KQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kq = lane / UPW, uq = lane % UPW;
  const int ul = warp * UPW + uq;  // unit within the CTA
  const bool unit_ok = ul < U;
  const int j = rank * U + (unit_ok ? ul : 0);  // hidden unit
  const bool rev = (p.reverse_mask >> d) & 1;

  // after the reduction: the lane's batch row, and whether it is the one
  // lane of its duplicates that writes
  const int rb = row_of_lane<BT>(lane);
  const bool writer = unit_ok && first_of_row<BT>(lane);
  const int gb = b0 + rb;
  const bool row_ok = writer && gb < p.B;

  extern __shared__ float4 smem4[];
  // [2][8 CTA slices][slice]: slice r holds units [r*U, (r+1)*U) as [U][BT],
  // padded to a stride S = 4 (mod 32) floats so that the 8 kq lanes' float4
  // reads of 8 slices fall in 8 disjoint groups of 4 banks
  const int S = slice_stride(U * BT);
  float* s_h = reinterpret_cast<float*>(smem4);
  __shared__ alignas(8) uint64_t s_bar[2];        // one per h buffer

  float w[MAX_KPL][3];
  {
    const float* W = p.w_hh[d];
#pragma unroll
    for (int i = 0; i < MAX_KPL; ++i) {
      const bool ok = unit_ok && i < nk;
      const long long k = ok ? kq * U + i : 0;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        w[i][g] = ok ? W[k * p.w_sk + (long long)(g * H + j) * p.w_sc] : 0.f;
    }
  }
  float bh[3] = {0.f, 0.f, 0.f};
  if (writer)
#pragma unroll
    for (int g = 0; g < 3; ++g) bh[g] = p.b_hh[d][g * H + j];
  const float* gi_row = p.gi[d] + (row_ok ? gb : 0) * p.gi_sb;
  float* out_row = p.out + (row_ok ? gb : 0) * p.o_sb + d * p.o_sd + j;

  // a phase of a buffer's barrier: thread 0's arrival with the bytes of one
  // whole h (every CTA's slice), which the peers' stores then complete
  const uint32_t h_bytes = H * BT * sizeof(float);
  const uint32_t bar0 = smem_addr(&s_bar[0]);
  // h_0 = 0; the padding stays 0 (it meets zero weights in the product)
  for (int i = threadIdx.x; i < 2 * CLUSTER * S; i += blockDim.x) s_h[i] = 0.f;
  if (threadIdx.x == 0) {
    init_barriers(bar0);
    // buffer 1 is first filled by step 0's pushes, buffer 0 by step 1's
    if (T > 1) expect_bytes(bar0 + 8, h_bytes);
    if (T > 2) expect_bytes(bar0, h_bytes);
  }
  cluster.sync();  // barriers and h_0 initialised before any push

  // this lane's slot in every CTA's two h buffers
  const int own = rank * S + ul * BT + rb;
  const uint32_t slot0 = smem_addr(s_h + own);

  // this step's gi values, loaded during the step before
  float gi_t[3] = {0.f, 0.f, 0.f};
  if (row_ok)
#pragma unroll
    for (int q = 0; q < 3; ++q) gi_t[q] = gi_row[(rev ? T - 1 : 0) * p.gi_st + q * H + j];

  for (int i = 0; i < T; ++i) {
    const int t = rev ? T - 1 - i : i;
    const int cur = i & 1;
    if (i > 0) {
      wait_phase(bar0 + 8 * cur, ((i - 1) >> 1) & 1);
      // the buffer's next filling, by step i + 1's pushes, if there is one
      if (threadIdx.x == 0 && i + 2 < T) expect_bytes(bar0 + 8 * cur, h_bytes);
    }

    const float* hcur = s_h + cur * CLUSTER * S;
    float acc[BT][3];
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[b][g] = 0.f;
    // lane kq's k values [kq*U, (kq+1)*U) are slice kq: float4 c holds
    // PER k values x BT rows
    constexpr int PER = 4 / BT;
    const float4* hs = reinterpret_cast<const float4*>(hcur + kq * S);
#pragma unroll
    for (int c = 0; c < MAX_KPL / PER; ++c) {
      if (NK == 0 && c * PER >= nk) break;
      const float4 v = hs[c];
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int kk = 0; kk < PER; ++kk)
#pragma unroll
        for (int b = 0; b < BT; ++b)
#pragma unroll
          for (int g = 0; g < 3; ++g)
            acc[b][g] = fmaf(e[kk * BT + b], w[c * PER + kk][g], acc[b][g]);
    }

    float s[3];
    reduce_kq<BT, 3>(acc, lane, s);

    const bool push = i + 1 < T;  // the last h_t feeds no further step
    float hn = 0.f;
    if (writer) {
      const float hp = hcur[own];
      const float r = sigmoidf(gi_t[0] + (s[0] + bh[0]));
      const float z = sigmoidf(gi_t[1] + (s[1] + bh[1]));
      const float n = tanhf(gi_t[2] + r * (s[2] + bh[2]));
      hn = (1.f - z) * n + z * hp;
      if (push) {
        const uint32_t slot = slot0 + (cur ^ 1) * CLUSTER * S * sizeof(float);
        const uint32_t bar = bar0 + 8 * (cur ^ 1);
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) st_peer(peer_addr(slot, q), hn, peer_addr(bar, q));
      }
    }
    if (row_ok) {
      out_row[t * p.o_st] = hn;
      if (push) {
        const float* g = gi_row + (rev ? t - 1 : t + 1) * p.gi_st;
#pragma unroll
        for (int q = 0; q < 3; ++q) gi_t[q] = g[q * H + j];
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still touch its memory
}

size_t smem_bytes(int H, int BT) {
  return sizeof(float) * 2 * CLUSTER * (size_t)slice_stride(H / CLUSTER * BT);
}

// The generic kernel, any H divisible by 8: one thread per (unit, row), the
// whole h W_hh dot product in order; the CTA's columns of w_hh [H][3U] in
// shared memory when `w_in_smem`, else read from global memory (L2). The h
// buffers and their exchange are the register kernel's.
constexpr int GNT = 256;  // threads of the generic kernel

size_t generic_smem_bytes(int H, int BT, bool w_in_smem) {
  return smem_bytes(H, BT) + (w_in_smem ? sizeof(float) * (size_t)H * 3 * (H / CLUSTER) : 0);
}

template <int BT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(GNT, 1)
gru_fwd_generic_kernel(const GruParams p, int w_in_smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int H = p.H, T = p.T;
  const int U = H / CLUSTER;
  const bool rev = (p.reverse_mask >> d) & 1;

  extern __shared__ float4 smem4[];
  const int S = slice_stride(U * BT);
  float* s_h = reinterpret_cast<float*>(smem4);  // [2][8][S] h buffers
  float* s_w = s_h + 2 * CLUSTER * S;            // [H][3U] when w_in_smem
  __shared__ alignas(8) uint64_t s_bar[2];

  // w(k, gate g, unit ul) = W[k * wk + g * wg + ul * wu]
  const float* W = p.w_hh[d] + (long long)rank * U * p.w_sc;
  long long wk = p.w_sk, wg = (long long)H * p.w_sc, wu = p.w_sc;
  if (w_in_smem) {
    for (int e = threadIdx.x; e < H * 3 * U; e += GNT) {
      const int k = e / (3 * U), c = e % (3 * U);
      s_w[e] = W[k * p.w_sk + ((c / U) * H + c % U) * p.w_sc];
    }
    W = s_w;
    wk = 3 * U;
    wg = U;
    wu = 1;
  }
  const uint32_t h_bytes = H * BT * sizeof(float);
  const uint32_t bar0 = smem_addr(&s_bar[0]);
  for (int i = threadIdx.x; i < 2 * CLUSTER * S; i += GNT) s_h[i] = 0.f;
  if (threadIdx.x == 0) {
    init_barriers(bar0);
    if (T > 1) expect_bytes(bar0 + 8, h_bytes);
    if (T > 2) expect_bytes(bar0, h_bytes);
  }
  cluster.sync();

  for (int i = 0; i < T; ++i) {
    const int t = rev ? T - 1 - i : i;
    const int cur = i & 1;
    if (i > 0) {
      wait_phase(bar0 + 8 * cur, ((i - 1) >> 1) & 1);
      if (threadIdx.x == 0 && i + 2 < T) expect_bytes(bar0 + 8 * cur, h_bytes);
    }
    const float* hcur = s_h + cur * CLUSTER * S;
    for (int e = threadIdx.x; e < U * BT; e += GNT) {
      const int ul = e / BT, rb = e % BT;
      const int j = rank * U + ul, gb = b0 + rb;
      float acc[3] = {0.f, 0.f, 0.f};
      for (int q = 0; q < CLUSTER; ++q)
        for (int c = 0; c < U; ++c) {
          const float hv = hcur[q * S + c * BT + rb];
          const float* wr = W + (long long)(q * U + c) * wk + ul * wu;
#pragma unroll
          for (int g = 0; g < 3; ++g) acc[g] = fmaf(hv, wr[g * wg], acc[g]);
        }
      float x[3] = {0.f, 0.f, 0.f};
      if (gb < p.B)
#pragma unroll
        for (int g = 0; g < 3; ++g) x[g] = p.gi[d][gb * p.gi_sb + t * p.gi_st + g * H + j];
      const float* bh = p.b_hh[d] + j;
      const int own = rank * S + ul * BT + rb;
      const float r = sigmoidf(x[0] + (acc[0] + bh[0]));
      const float z = sigmoidf(x[1] + (acc[1] + bh[H]));
      const float n = tanhf(x[2] + r * (acc[2] + bh[2 * H]));
      const float hn = (1.f - z) * n + z * hcur[own];
      if (i + 1 < T) {
        const uint32_t slot = smem_addr(s_h + (cur ^ 1) * CLUSTER * S + own);
        const uint32_t bar = bar0 + 8 * (cur ^ 1);
        for (int q = 0; q < CLUSTER; ++q) st_peer(peer_addr(slot, q), hn, peer_addr(bar, q));
      }
      if (gb < p.B) p.out[gb * p.o_sb + t * p.o_st + d * p.o_sd + j] = hn;
    }
  }
  cluster.sync();
}

template <int BT, int NK>
cudaError_t launch(const GruParams& p, int ndir, cudaStream_t stream) {
  const int nt = 32 * ((p.H / CLUSTER + UPW - 1) / UPW);
  const dim3 grid(CLUSTER, ndir, (p.B + BT - 1) / BT);
  gru_fwd_kernel<BT, NK><<<grid, nt, smem_bytes(p.H, BT), stream>>>(p);
  return cudaGetLastError();
}

// Clusters of one instantiation that can be resident at once (8-warp CTAs:
// the most any H takes), queried once per device.
std::atomic<int> resident[3][MAX_DEVICES];  // [log2 BT][device]

template <int BT>
int resident_bt(int device) {
  return resident_clusters(resident[BT == 1 ? 0 : (BT == 2 ? 1 : 2)], device,
                           gru_fwd_kernel<BT, 0>, CLUSTER, MAX_NT,
                           smem_bytes(MAX_KPL * KQ, BT));
}

template <int BT>
cudaError_t launch_bt(const GruParams& p, int ndir, cudaStream_t stream) {
  return p.H == MAX_KPL * KQ ? launch<BT, MAX_KPL>(p, ndir, stream)
                             : launch<BT, 0>(p, ndir, stream);
}

std::atomic<bool> generic_opted_in[3][MAX_DEVICES];

template <int BT>
cudaError_t launch_generic(const GruParams& p, int ndir, int device, cudaStream_t stream) {
  cudaError_t e = opt_in_smem(generic_opted_in[BT == 1 ? 0 : (BT == 2 ? 1 : 2)], device,
                              gru_fwd_generic_kernel<BT>);
  if (e != cudaSuccess) return e;
  const bool w_in_smem = generic_smem_bytes(p.H, BT, true) <= MAX_DYN_SMEM;
  const dim3 grid(CLUSTER, ndir, (p.B + BT - 1) / BT);
  gru_fwd_generic_kernel<BT>
      <<<grid, GNT, generic_smem_bytes(p.H, BT, w_in_smem), stream>>>(p, w_in_smem);
  return cudaGetLastError();
}

}  // namespace

// The largest H (a multiple of 8) whose h buffers fit the card's shared memory.
extern "C" int avs_gru_fwd_max_hidden() {
  int h = 8;
  while (smem_bytes(h + 8, 1) <= MAX_DYN_SMEM) h += 8;
  return h;
}

extern "C" int avs_gru_fwd(
    const float* gi0, const float* gi1, const float* w0, const float* w1,
    const float* b0, const float* b1, float* out,
    long long gi_sb, long long gi_st, long long w_sk, long long w_sc,
    long long o_sb, long long o_st, long long o_sd,
    int B, int T, int H, int ndir, int reverse_mask, int device,
    void* stream) {
  if (H % KQ != 0 || H < KQ || ndir < 1 || ndir > 2 || B < 1 || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (T == 0) return 0;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  GruParams p{{gi0, gi1}, {w0, w1}, {b0, b1}, out,
              gi_sb, gi_st, w_sk, w_sc, o_sb, o_st, o_sd,
              B, T, H, reverse_mask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H > MAX_KPL * KQ) {
    // generic: the most rows (up to 4, at most B rounded up) whose buffers fit
    if (B > 2 && smem_bytes(H, 4) <= MAX_DYN_SMEM) return launch_generic<4>(p, ndir, device, s);
    if (B > 1 && smem_bytes(H, 2) <= MAX_DYN_SMEM) return launch_generic<2>(p, ndir, device, s);
    if (smem_bytes(H, 1) <= MAX_DYN_SMEM) return launch_generic<1>(p, ndir, device, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the fewest rows per cluster whose clusters all fit at once
  if (ndir * B <= resident_bt<1>(device)) {
    e = launch_bt<1>(p, ndir, s);
  } else if (ndir * ((B + 1) / 2) <= resident_bt<2>(device)) {
    e = launch_bt<2>(p, ndir, s);
  } else {
    e = launch_bt<4>(p, ndir, s);
  }
  return static_cast<int>(e);
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
