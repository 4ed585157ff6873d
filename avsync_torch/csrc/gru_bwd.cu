// Backward of the GRU recurrence over precomputed input projections, whole
// sequence in one launch, one or two directions at once, plus the weight
// gradient reduction.
//
// Replaces: avsync/ops/pallas/gru.py, `pallas_gru_bwd` (Pallas TPU kernels
// `_gru_bwd_kernel_vmem` / `_gru_bwd_kernel`, gate math `_gru_gate_grads`).
// Same function: given the forward's inputs gi (B, T, 3H), w_hh (H, 3H),
// b_hh (3H) and outputs out (B, T, H), and the output cotangent g (B, T, H),
// walk the steps in reverse order of the forward, recompute each step's
// gates from (gi_t, h_prev) with gh = h_prev W_hh + b_hh, and with
// a = g_t + dh (the gradient flowing into h_t):
//   dn = a (1 - z), dz = a (h_prev - n), dpre_n = dn (1 - n^2),
//   dpre_r = dpre_n gh_n r (1 - r), dpre_z = dz z (1 - z),
//   dgi = [dpre_r, dpre_z, dpre_n], dgh = [dpre_r, dpre_z, dpre_n r],
//   dh <- a z + dgh W_hh^T,
// and dW_hh = sum_t h_prev^T dgh, db_hh = sum_t dgh. h_prev of the first
// step of a direction is 0; otherwise it is out at the previous step of that
// direction (t - 1 forward, t + 1 reverse).
//
// What bounds it on the H100: at B=8, T=75, H=256 the three products per
// direction (gh recompute, dgh W_hh^T, dW_hh) are 1.42 GFLOP for both
// directions (0.021 ms at 67 TFLOP/s fp32) against about 13 MB of traffic.
// Neither is the limit: only dh carries the chain, so the latency of one
// step times T (75 dependent (B, 3H) x (3H, H) products, gate math and one
// exchange) is the floor. The earlier design (one cluster of 8 CTAs per 8
// rows) spent, per step at B=8: the gh recompute 1.6 us and the h_prev
// staging 1.3 us, though neither depends on the chain; the dh product 2.1
// us, w_hh read from shared memory; the K-split reduce and gates 1.2 us;
// the cluster barrier 1.0 us: 6.5 us per step, 0.49 ms of chain. Its dW_hh
// reduction (96 CTAs, synchronous loads) took 0.07-0.09 ms.
//
// Design, four kernels per launch:
//   (a) gh = h_prev W_hh + b_hh for every (row, step), a tiled fp32 product
//       (64 x 64 output tiles, cp.async double buffering), h_prev read from
//       `out` shifted by one step: the recompute leaves the chain;
//   (b) the chain, K2's scheme (gru_fwd.cu) run backwards. One cluster of 8
//       CTAs per (direction, tile of BT rows); CTA k owns hidden units
//       [k U, (k+1) U), U = H/8. The exchange broadcasts each CTA's dgh
//       slice (3U x BT values) to all 8 peers, so that each CTA multiplies
//       the whole dgh by its own units' rows of w_hh: the other choice,
//       sending each owner its partial dh (H x BT values out per CTA, 3x
//       fewer bytes), needs the CTA's own dgh complete in shared memory
//       before its product (a CTA barrier per step) and a second pass over
//       the received partials. With the broadcast, lane (kq, uq) of warp w
//       holds W_hh[j, cols of CTA kq] for its unit j (3U registers), reads
//       CTA kq's dgh slice as float4 (r, z, n, 0) per (unit, row) (slices
//       padded so the 8 kq lanes hit disjoint banks), and a fixed shuffle
//       tree over the kq lanes gives each lane the whole dh of one (unit,
//       row): no shared-memory reduction, no CTA barrier. That lane adds a
//       z, applies the gate math (gi, gh, g and h_prev of the step were
//       loaded during the step before), pushes its (r, z, n) dgh with one
//       16-byte st.async to each peer, completing the peer mbarrier's
//       transaction count, then stores dgi and dgh. A CTA waits only on its
//       own mbarrier for the buffer it reads; no cluster barrier in the loop.
//       Rows per cluster: the fewest (1, 2 or 4) whose clusters all fit at
//       once (occupancy query, cached per device);
//   (c) dW_hh = h_prev^T dgh and db_hh = sum dgh, the same tiled product
//       over K = B T split into a fixed number of chunks (more CTAs than
//       the 96 output tiles give), each writing a partial;
//   (d) a fixed-order sum of the chunks' partials, written through dW_hh's
//       strides (a torch-layout (3H, H) weight gets its gradient without a
//       transpose) and into db_hh.
// Every sum runs in a fixed order: no float atomics, a repeat launch gives
// the same bits. H above 256 (3U registers would not fit) takes a generic
// chain: one thread per (unit, row), w_hh's rows of the CTA's units in
// shared memory where they fit, else read through L2; the wrapper pads H to
// a multiple of 8. Accuracy: expf / tanhf, no fast-math.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "cluster_exchange.cuh"
#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;   // CTAs per cluster; each owns H/8 hidden units
constexpr int UPW = 4;       // hidden units per warp
constexpr int MAX_KPL = 32;  // units per CTA in registers (H/8): H <= 256
constexpr int MAX_NT = 32 * (MAX_KPL / UPW);  // 8 warps at H = 256
constexpr int NT = 256;      // threads of the product, sum and generic kernels

struct GruBwdParams {
  const float* gi[2];    // gi[d][b*gi_sb + t*gi_st + col], (B, T, 3H)
  const float* out[2];   // out[d][b*o_sb + t*o_st + j], forward outputs
  const float* g[2];     // g[d][b*g_sb + t*g_st + j], output cotangents
  const float* w_hh[2];  // w[k*w_sk + col*w_sc], (H, 3H) logical
  const float* b_hh[2];  // (3H,), contiguous
  float* dgi[2];         // (B, T, 3H), contiguous
  float* dw[2];          // dw[k*dw_sk + col*dw_sc], (H, 3H) logical
  float* db[2];          // (3H,), contiguous
  float* gh;             // [ndir][B][T][3H] scratch: h_prev W_hh + b_hh
  float* dgh;            // [ndir][B][T][3H] scratch
  float* partial;        // [ndir][n_chunks][H + 1][3H] scratch: dW_hh rows, db_hh
  long long gi_sb, gi_st, o_sb, o_st, g_sb, g_st, w_sk, w_sc, dw_sk, dw_sc;
  int B, T, H, ndir, reverse_mask, n_chunks, w_in_smem;  // reverse_mask bit d: backwards
};

// ---------------------------------------------------------------------------
// (a), (c): a 64 x 64 tile of C = A B over a range of K, fp32 FMAs
// ---------------------------------------------------------------------------

constexpr int TM = 64, TN = 64, TK = 16, TPAD = TM + 4;

struct Tiles {
  float a[2][TK][TPAD];  // a[buf][k][m]; rows padded: A's k-fast copies spread over banks
  float b[2][TK][TPAD];  // b[buf][k][n]
};

// acc[r][c] += sum over k in [k_begin, k_end), in order, of A(m0 + 4 ty + r, k)
// B(k, n0 + 4 tx + c), ty = tid / 16, tx = tid % 16. a_src(m, k, ok) and
// b_src(k, n, ok) give each element's address and whether it exists (else it
// is 0). A_M_FAST: consecutive threads copy consecutive m of A (else k), to
// follow A's contiguous index in memory; B is copied n-fast. With `colsum`,
// threads tid < 64 also sum B's column n0 + tid over the range.
template <bool A_M_FAST, class ASrc, class BSrc>
__device__ __forceinline__ void tile_product(ASrc a_src, BSrc b_src, int m0, int n0,
                                             int k_begin, int k_end, Tiles& s,
                                             float (&acc)[4][4], float* colsum) {
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  auto stage = [&](int k0, int buf) {
#pragma unroll
    for (int e = tid; e < TK * TM; e += NT) {
      const int kk = A_M_FAST ? e / TM : e % TK, mm = A_M_FAST ? e % TM : e / TK;
      bool ok;
      const float* src = a_src(m0 + mm, k0 + kk, ok);
      cp_async4(&s.a[buf][kk][mm], src, ok);
    }
#pragma unroll
    for (int e = tid; e < TK * TN; e += NT) {
      const int kk = e / TN, nn = e % TN;
      bool ok;
      const float* src = b_src(k0 + kk, n0 + nn, ok);
      cp_async4(&s.b[buf][kk][nn], src, ok);
    }
    cp_async_commit();
  };
  const int nk = (k_end - k_begin + TK - 1) / TK;
  if (nk > 0) stage(k_begin, 0);
  for (int c = 0; c < nk; ++c) {
    const int buf = c & 1;
    if (c + 1 < nk) {
      stage(k_begin + (c + 1) * TK, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s.a[buf][kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s.b[buf][kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(av[r], bv[q], acc[r][q]);
    }
    if (colsum != nullptr && tid < TN) {
#pragma unroll
      for (int kk = 0; kk < TK; ++kk) *colsum += s.b[buf][kk][tid];
    }
    __syncthreads();  // the buffer is staged again two chunks on
  }
}

// h_prev of (row b, time t) of direction d: out at the direction's previous
// step, or nothing (0) at its first step.
__device__ __forceinline__ const float* hprev_src(const GruBwdParams& p, int d, bool rev,
                                                  int m, int k, bool ok_mk, bool& ok) {
  const int b = m / p.T, t = m % p.T;
  const int tp = rev ? t + 1 : t - 1;
  ok = ok_mk && tp >= 0 && tp < p.T;
  return ok ? p.out[d] + b * p.o_sb + tp * p.o_st + k : p.out[d];
}

// (a) grid (3H / 64, B T / 64, ndir)
__global__ void __launch_bounds__(NT) gru_bwd_gh_kernel(const GruBwdParams p) {
  __shared__ __align__(16) Tiles s;
  const int d = blockIdx.z;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int H = p.H, H3 = 3 * H, M = p.B * p.T;
  const bool rev = (p.reverse_mask >> d) & 1;
  const float* W = p.w_hh[d];
  auto a_src = [&](int m, int k, bool& ok) {
    return hprev_src(p, d, rev, m, k, m < M && k < H, ok);
  };
  auto b_src = [&](int k, int n, bool& ok) {
    ok = k < H && n < H3;
    return ok ? W + k * p.w_sk + n * p.w_sc : W;
  };
  float acc[4][4] = {};
  tile_product<false>(a_src, b_src, m0, n0, 0, H, s, acc, nullptr);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n = n0 + tx * 4;
  if (n >= H3) return;  // H3 is a multiple of 24: a float4 is in or out whole
  const float* bias = p.b_hh[d] + n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + ty * 4 + r;
    if (m < M)
      *reinterpret_cast<float4*>(p.gh + ((size_t)d * M + m) * H3 + n) =
          make_float4(acc[r][0] + bias[0], acc[r][1] + bias[1], acc[r][2] + bias[2],
                      acc[r][3] + bias[3]);
  }
}

// (c) grid (3H / 64, H / 64, ndir * n_chunks): chunk k of K = B T
__global__ void __launch_bounds__(NT) gru_bwd_dw_kernel(const GruBwdParams p) {
  __shared__ __align__(16) Tiles s;
  const int d = blockIdx.z / p.n_chunks, chunk = blockIdx.z % p.n_chunks;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int H = p.H, H3 = 3 * H, M = p.B * p.T;
  const int len = (M + p.n_chunks - 1) / p.n_chunks;
  const int k_begin = min(M, chunk * len), k_end = min(M, k_begin + len);
  const bool rev = (p.reverse_mask >> d) & 1;
  const float* dgh = p.dgh + (size_t)d * M * H3;
  // A(unit m, (row, step) k) = h_prev; B(k, col n) = dgh
  auto a_src = [&](int m, int k, bool& ok) {
    return hprev_src(p, d, rev, k, m, m < H && k < k_end, ok);
  };
  auto b_src = [&](int k, int n, bool& ok) {
    ok = k < k_end && n < H3;
    return ok ? dgh + (size_t)k * H3 + n : dgh;
  };
  float acc[4][4] = {};
  float colsum = 0.f;
  tile_product<true>(a_src, b_src, m0, n0, k_begin, k_end, s, acc,
                     blockIdx.y == 0 ? &colsum : nullptr);
  float* part = p.partial + ((size_t)d * p.n_chunks + chunk) * (H + 1) * H3;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n = n0 + tx * 4;
  if (n < H3) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int m = m0 + ty * 4 + r;
      if (m < H)
        *reinterpret_cast<float4*>(part + (size_t)m * H3 + n) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    }
  }
  if (blockIdx.y == 0 && threadIdx.x < TN && n0 + threadIdx.x < H3)
    part[(size_t)H * H3 + n0 + threadIdx.x] = colsum;
}

// (d) one thread per output of dW_hh and db_hh: the chunks' partials in order
__global__ void __launch_bounds__(NT) gru_bwd_sum_kernel(const GruBwdParams p) {
  const int H3 = 3 * p.H;
  const long long per_dir = (long long)(p.H + 1) * H3;
  const long long i = (long long)blockIdx.x * NT + threadIdx.x;
  if (i >= p.ndir * per_dir) return;
  const int d = static_cast<int>(i / per_dir);
  const long long o = i % per_dir;
  const float* src = p.partial + (size_t)d * p.n_chunks * per_dir + o;
  float s = src[0];
  for (int c = 1; c < p.n_chunks; ++c) s += src[c * per_dir];
  const int k = static_cast<int>(o / H3), col = static_cast<int>(o % H3);
  if (k < p.H) {
    p.dw[d][k * p.dw_sk + col * p.dw_sc] = s;
  } else {
    p.db[d][col] = s;
  }
}

// ---------------------------------------------------------------------------
// (b) the chain
// ---------------------------------------------------------------------------

// Exchange buffers: [2][8 CTA slices][S]; slice q holds CTA q's dgh as
// [U][BT] float4 (r, z, n, 0), S = slice_stride(4 U BT).
size_t chain_smem_bytes(int H, int BT) {
  return sizeof(float) * 2 * CLUSTER * (size_t)slice_stride(4 * (H / CLUSTER) * BT);
}

// BT: batch rows per cluster (1, 2 or 4). NK: units per CTA (H/8) when known
// at compile time, 0 = read H at run time (H/8 <= MAX_KPL).
template <int BT, int NK>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(MAX_NT, 1)
gru_bwd_chain_kernel(const GruBwdParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int H = p.H, H3 = 3 * H, T = p.T;
  const int U = H / CLUSTER;
  const int nk = NK ? NK : U;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kq = lane / UPW, uq = lane % UPW;
  const int ul = warp * UPW + uq;  // unit within the CTA
  const bool unit_ok = ul < U;
  const int j = rank * U + (unit_ok ? ul : 0);  // hidden unit
  const bool rev = (p.reverse_mask >> d) & 1;
  const int rb = row_of_lane<BT>(lane);
  const bool writer = unit_ok && first_of_row<BT>(lane);
  const int gb = b0 + rb;
  const bool row_ok = writer && gb < p.B;

  extern __shared__ float4 smem4[];
  const int S = slice_stride(4 * U * BT);
  float* s_d = reinterpret_cast<float*>(smem4);
  __shared__ alignas(8) uint64_t s_bar[2];  // one per exchange buffer

  // W_hh[j, g H + kq U + i]: unit j's row, CTA kq's columns of gate g
  float w[MAX_KPL][3];
  {
    const float* W = p.w_hh[d] + (long long)j * p.w_sk;
#pragma unroll
    for (int i = 0; i < MAX_KPL; ++i) {
      const bool ok = unit_ok && i < nk;
#pragma unroll
      for (int g = 0; g < 3; ++g)
        w[i][g] = ok ? W[(long long)(g * H + kq * U + i) * p.w_sc] : 0.f;
    }
  }
  const int rr = row_ok ? gb : 0;
  const float* gi_row = p.gi[d] + rr * p.gi_sb + j;
  const float* gh_row = p.gh + ((size_t)d * p.B + rr) * T * H3 + j;
  const float* g_row = p.g[d] + rr * p.g_sb + j;
  const float* o_row = p.out[d] + rr * p.o_sb + j;
  float* dgi_row = p.dgi[d] + (size_t)rr * T * H3 + j;
  float* dgh_row = p.dgh + ((size_t)d * p.B + rr) * T * H3 + j;

  // a phase of a buffer's barrier: thread 0's arrival with the bytes of the
  // whole dgh (every CTA's slice), which the peers' stores then complete
  const uint32_t bytes = 16 * H * BT;
  const uint32_t bar0 = smem_addr(&s_bar[0]);
  if (threadIdx.x == 0) {
    init_barriers(bar0);
    // buffer 1 is first filled by iteration 0's pushes, buffer 0 by iteration 1's
    if (T > 1) expect_bytes(bar0 + 8, bytes);
    if (T > 2) expect_bytes(bar0, bytes);
  }
  cluster.sync();  // barriers initialised before any push

  // this lane's float4 slot in every CTA's two buffers
  const uint32_t slot0 = smem_addr(s_d + rank * S + (ul * BT + rb) * 4);

  // the step's inputs, loaded during the step before: gi, gh (r, z, n), g, h_prev
  float x[3] = {0.f, 0.f, 0.f}, gh[3] = {0.f, 0.f, 0.f}, gv = 0.f, hp = 0.f;
  auto load_step = [&](int i) {  // forward step i
    const int t = rev ? T - 1 - i : i;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      x[q] = gi_row[t * p.gi_st + q * H];
      gh[q] = gh_row[t * H3 + q * H];
    }
    gv = g_row[t * p.g_st];
    hp = i > 0 ? o_row[(rev ? t + 1 : t - 1) * p.o_st] : 0.f;
  };
  if (row_ok) load_step(T - 1);

  float az = 0.f;  // a z of the step after, for this lane's (unit, row)
  for (int s = 0; s < T; ++s) {
    const int i = T - 1 - s;  // forward step index, walked backwards
    const int t = rev ? T - 1 - i : i;
    const int cur = s & 1;
    float dh = 0.f;
    if (s > 0) {
      wait_phase(bar0 + 8 * cur, ((s - 1) >> 1) & 1);
      // the buffer's next filling, by iteration s + 1's pushes, if there is one
      if (threadIdx.x == 0 && s + 2 < T) expect_bytes(bar0 + 8 * cur, bytes);
      float acc[BT][1];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b][0] = 0.f;
      const float4* ds = reinterpret_cast<const float4*>(s_d + cur * CLUSTER * S + kq * S);
#pragma unroll
      for (int c = 0; c < MAX_KPL; ++c) {
        if (NK == 0 && c >= nk) break;
#pragma unroll
        for (int b = 0; b < BT; ++b) {
          const float4 v = ds[c * BT + b];
          acc[b][0] = fmaf(v.x, w[c][0], acc[b][0]);
          acc[b][0] = fmaf(v.y, w[c][1], acc[b][0]);
          acc[b][0] = fmaf(v.z, w[c][2], acc[b][0]);
        }
      }
      float sum[1];
      reduce_kq<BT, 1>(acc, lane, sum);
      dh = az + sum[0];
    }
    if (writer) {
      const float r = sigmoidf(x[0] + gh[0]);
      const float z = sigmoidf(x[1] + gh[1]);
      const float n = tanhf(x[2] + r * gh[2]);
      const float a = gv + dh;
      const float dn = a * (1.f - z);
      const float dz = a * (hp - n);
      const float dpre_n = dn * (1.f - n * n);
      const float dr = dpre_n * gh[2];
      const float dpre_r = dr * r * (1.f - r);
      const float dpre_z = dz * z * (1.f - z);
      const float dgh_n = dpre_n * r;
      if (s + 1 < T) {  // the first forward step's dgh feeds no further dh
        const uint32_t slot = slot0 + (cur ^ 1) * CLUSTER * S * sizeof(float);
        const uint32_t bar = bar0 + 8 * (cur ^ 1);
        const float4 v = make_float4(dpre_r, dpre_z, dgh_n, 0.f);
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) st_peer4(peer_addr(slot, q), v, peer_addr(bar, q));
      }
      az = a * z;
      if (row_ok) {
        const size_t o = (size_t)t * H3;
        dgi_row[o] = dpre_r;
        dgi_row[o + H] = dpre_z;
        dgi_row[o + 2 * H] = dpre_n;
        dgh_row[o] = dpre_r;
        dgh_row[o + H] = dpre_z;
        dgh_row[o + 2 * H] = dgh_n;
        if (i > 0) load_step(i - 1);
      }
    }
  }
  cluster.sync();  // no CTA leaves while a peer may still touch its memory
}

// The generic chain, any H divisible by 8: one thread per (unit, row), the
// whole dh dot product in order; w_hh's rows of the CTA's units [U][3H] in
// shared memory when `w_in_smem`, else read from global memory (L2).
size_t generic_smem_bytes(int H, int BT, bool w_in_smem) {
  const size_t U = H / CLUSTER;
  return chain_smem_bytes(H, BT) + sizeof(float) * (U * BT + (w_in_smem ? U * 3 * H : 0));
}

template <int BT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
gru_bwd_chain_generic_kernel(const GruBwdParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int H = p.H, H3 = 3 * H, T = p.T;
  const int U = H / CLUSTER;
  const bool rev = (p.reverse_mask >> d) & 1;

  extern __shared__ float4 smem4[];
  const int S = slice_stride(4 * U * BT);
  float* s_d = reinterpret_cast<float*>(smem4);  // [2][8][S] exchange buffers
  float* s_az = s_d + 2 * CLUSTER * S;           // [U * BT] a z of the step after
  float* s_w = s_az + U * BT;                    // [U][3H] when w_in_smem
  __shared__ alignas(8) uint64_t s_bar[2];

  const float* W = p.w_hh[d] + (long long)rank * U * p.w_sk;
  long long wj = p.w_sk, wc = p.w_sc;  // w(unit ul, col) = W[ul * wj + col * wc]
  if (p.w_in_smem) {
    for (int e = threadIdx.x; e < U * H3; e += NT)
      s_w[e] = W[(e / H3) * p.w_sk + (long long)(e % H3) * p.w_sc];
    W = s_w;
    wj = H3;
    wc = 1;
  }
  for (int e = threadIdx.x; e < U * BT; e += NT) s_az[e] = 0.f;
  const uint32_t bytes = 16 * H * BT;
  const uint32_t bar0 = smem_addr(&s_bar[0]);
  if (threadIdx.x == 0) {
    init_barriers(bar0);
    if (T > 1) expect_bytes(bar0 + 8, bytes);
    if (T > 2) expect_bytes(bar0, bytes);
  }
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int i = T - 1 - s;
    const int t = rev ? T - 1 - i : i;
    const int cur = s & 1;
    if (s > 0) {
      wait_phase(bar0 + 8 * cur, ((s - 1) >> 1) & 1);
      if (threadIdx.x == 0 && s + 2 < T) expect_bytes(bar0 + 8 * cur, bytes);
    }
    const float* buf = s_d + cur * CLUSTER * S;
    for (int e = threadIdx.x; e < U * BT; e += NT) {
      const int ul = e / BT, rb = e % BT;
      const int j = rank * U + ul, gb = b0 + rb;
      const bool ok = gb < p.B;
      float dh = 0.f;
      if (s > 0) {
        const float* wr = W + ul * wj;
        float acc = 0.f;
        for (int q = 0; q < CLUSTER; ++q)
          for (int c = 0; c < U; ++c) {
            const float4 v = *reinterpret_cast<const float4*>(buf + q * S + (c * BT + rb) * 4);
            const long long col = q * U + c;
            acc = fmaf(v.x, wr[col * wc], acc);
            acc = fmaf(v.y, wr[(col + H) * wc], acc);
            acc = fmaf(v.z, wr[(col + 2 * H) * wc], acc);
          }
        dh = s_az[e] + acc;
      }
      float x[3] = {0.f, 0.f, 0.f}, gh[3] = {0.f, 0.f, 0.f}, gv = 0.f, hp = 0.f;
      const size_t drow = ((size_t)gb * T + t) * H3 + j;
      const size_t hrow = (((size_t)d * p.B + gb) * T + t) * H3 + j;
      if (ok) {
        for (int q = 0; q < 3; ++q) {
          x[q] = p.gi[d][gb * p.gi_sb + t * p.gi_st + q * H + j];
          gh[q] = p.gh[hrow + q * H];
        }
        gv = p.g[d][gb * p.g_sb + t * p.g_st + j];
        if (i > 0) hp = p.out[d][gb * p.o_sb + (rev ? t + 1 : t - 1) * p.o_st + j];
      }
      const float r = sigmoidf(x[0] + gh[0]);
      const float z = sigmoidf(x[1] + gh[1]);
      const float n = tanhf(x[2] + r * gh[2]);
      const float a = gv + dh;
      const float dn = a * (1.f - z);
      const float dz = a * (hp - n);
      const float dpre_n = dn * (1.f - n * n);
      const float dpre_r = dpre_n * gh[2] * r * (1.f - r);
      const float dpre_z = dz * z * (1.f - z);
      const float dgh_n = dpre_n * r;
      if (s + 1 < T) {
        const uint32_t slot =
            smem_addr(s_d + (cur ^ 1) * CLUSTER * S + rank * S + (ul * BT + rb) * 4);
        const uint32_t bar = bar0 + 8 * (cur ^ 1);
        const float4 v = make_float4(dpre_r, dpre_z, dgh_n, 0.f);
        for (int q = 0; q < CLUSTER; ++q) st_peer4(peer_addr(slot, q), v, peer_addr(bar, q));
      }
      s_az[e] = a * z;
      if (ok) {
        float* dgi = p.dgi[d] + drow;
        float* dgh = p.dgh + hrow;
        dgi[0] = dpre_r;
        dgi[H] = dpre_z;
        dgi[2 * H] = dpre_n;
        dgh[0] = dpre_r;
        dgh[H] = dpre_z;
        dgh[2 * H] = dgh_n;
      }
    }
  }
  cluster.sync();
}

template <int BT, int NK>
cudaError_t launch_chain(const GruBwdParams& p, cudaStream_t stream) {
  const int nt = 32 * ((p.H / CLUSTER + UPW - 1) / UPW);
  const dim3 grid(CLUSTER, p.ndir, (p.B + BT - 1) / BT);
  gru_bwd_chain_kernel<BT, NK><<<grid, nt, chain_smem_bytes(p.H, BT), stream>>>(p);
  return cudaGetLastError();
}

template <int BT>
cudaError_t launch_chain_bt(const GruBwdParams& p, cudaStream_t stream) {
  return p.H == MAX_KPL * CLUSTER ? launch_chain<BT, MAX_KPL>(p, stream)
                                  : launch_chain<BT, 0>(p, stream);
}

std::atomic<int> resident[3][MAX_DEVICES];  // [log2 BT][device]

template <int BT>
int resident_bt(int device) {
  return resident_clusters(resident[BT == 1 ? 0 : (BT == 2 ? 1 : 2)], device,
                           gru_bwd_chain_kernel<BT, 0>, CLUSTER, MAX_NT,
                           chain_smem_bytes(MAX_KPL * CLUSTER, BT));
}

std::atomic<bool> generic_opted_in[3][MAX_DEVICES];

template <int BT>
cudaError_t launch_generic(GruBwdParams p, int device, cudaStream_t stream) {
  cudaError_t e = opt_in_smem(generic_opted_in[BT == 1 ? 0 : (BT == 2 ? 1 : 2)], device,
                              gru_bwd_chain_generic_kernel<BT>);
  if (e != cudaSuccess) return e;
  p.w_in_smem = generic_smem_bytes(p.H, BT, true) <= MAX_DYN_SMEM;
  const dim3 grid(CLUSTER, p.ndir, (p.B + BT - 1) / BT);
  gru_bwd_chain_generic_kernel<BT>
      <<<grid, NT, generic_smem_bytes(p.H, BT, p.w_in_smem), stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_chain_any(const GruBwdParams& p, int device, cudaStream_t stream) {
  if (p.H <= MAX_KPL * CLUSTER) {
    // the fewest rows per cluster whose clusters all fit at once
    if (p.ndir * p.B <= resident_bt<1>(device)) return launch_chain_bt<1>(p, stream);
    if (p.ndir * ((p.B + 1) / 2) <= resident_bt<2>(device)) return launch_chain_bt<2>(p, stream);
    return launch_chain_bt<4>(p, stream);
  }
  // generic: the most rows (up to 4, at most B rounded up) whose buffers fit
  if (p.B > 2 && generic_smem_bytes(p.H, 4, false) <= MAX_DYN_SMEM)
    return launch_generic<4>(p, device, stream);
  if (p.B > 1 && generic_smem_bytes(p.H, 2, false) <= MAX_DYN_SMEM)
    return launch_generic<2>(p, device, stream);
  if (generic_smem_bytes(p.H, 1, false) <= MAX_DYN_SMEM) return launch_generic<1>(p, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The largest H (a multiple of 8) whose chain fits the card's shared memory.
extern "C" int avs_gru_bwd_max_hidden() {
  int h = 8;
  while (generic_smem_bytes(h + 8, 1, false) <= MAX_DYN_SMEM) h += 8;
  return h;
}

// Scratch: gh and dgh (ndir * B * T * 3H floats each) and `partial`
// (ndir * n_chunks * (H + 1) * 3H floats), allocated by the wrapper.
extern "C" int avs_gru_bwd(
    const float* gi0, const float* gi1, const float* out0, const float* out1,
    const float* g0, const float* g1, const float* w0, const float* w1,
    const float* b0, const float* b1, float* dgi0, float* dgi1, float* dw0, float* dw1,
    float* db0, float* db1, float* gh, float* dgh, float* partial,
    long long gi_sb, long long gi_st, long long o_sb, long long o_st,
    long long g_sb, long long g_st, long long w_sk, long long w_sc,
    long long dw_sk, long long dw_sc,
    int B, int T, int H, int ndir, int reverse_mask, int n_chunks, int device, void* stream) {
  if (H % CLUSTER != 0 || H < CLUSTER || ndir < 1 || ndir > 2 || B < 1 || T < 1 ||
      n_chunks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const GruBwdParams p{{gi0, gi1}, {out0, out1}, {g0, g1}, {w0, w1}, {b0, b1},
                       {dgi0, dgi1}, {dw0, dw1}, {db0, db1}, gh, dgh, partial,
                       gi_sb, gi_st, o_sb, o_st, g_sb, g_st, w_sk, w_sc, dw_sk, dw_sc,
                       B, T, H, ndir, reverse_mask, n_chunks, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int H3 = 3 * H, M = B * T;
  gru_bwd_gh_kernel<<<dim3((H3 + TN - 1) / TN, (M + TM - 1) / TM, ndir), NT, 0, s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if ((e = launch_chain_any(p, device, s)) != cudaSuccess) return static_cast<int>(e);
  gru_bwd_dw_kernel<<<dim3((H3 + TN - 1) / TN, (H + TM - 1) / TM, ndir * n_chunks), NT, 0,
                      s>>>(p);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long n_out = (long long)ndir * (H + 1) * H3;
  gru_bwd_sum_kernel<<<(unsigned)((n_out + NT - 1) / NT), NT, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
