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
// directions (0.021 ms at 67 TFLOP/s fp32) against about 13 MB of traffic
// (0.004 ms). Neither is the limit: only dh carries the chain, and the 75
// dependent steps (each a (B, H) x (H, 3H) and a (B, 3H) x (3H, H) product,
// the gate math and one exchange of dh) set the floor, as for the forward.
//
// Design, two kernels per launch:
//   (a) the chain. Like gru_fwd.cu, one thread-block cluster of 8 CTAs per
//       (direction, tile of BT batch rows); CTA k owns hidden units
//       [k U, (k+1) U), U = H / 8, and keeps their r, z and n columns of
//       w_hh in shared memory for the whole launch (rows padded by one
//       float so that both products read it without bank conflicts). Per
//       step each CTA
//         * recomputes gh for its 3U columns from h_prev, which it reads
//           from `out` (the next step's h_prev is copied in with cp.async
//           while this step computes: it does not depend on the chain);
//         * forms a, the gate gradients, dgi and dgh for its units
//           (one (row, unit) per thread; that thread keeps dh and a z in
//           registers from step to step) and writes dgi and dgh;
//         * computes its partial dh_prev = dgh[:, cols_k] W_hh[:, cols_k]^T
//           over all H units and sends each unit's partial to the CTA that
//           owns the unit through distributed shared memory;
//       one cluster barrier ends the step; the receive buffers are double
//       buffered, so that one barrier per step is enough. The owner sums the
//       8 partials in rank order: no float atomics, the same sum every run.
//   (b) the reduction: dW_hh = h_prev^T dgh and db_hh = sum dgh over the
//       K = B T (row, step) pairs, a tiled fp32 product (64 x 64 output tile
//       per CTA, 4 x 4 per thread). Each output element is summed by one
//       thread in a fixed order, so two runs give bit-identical dW_hh.
//       h_prev is read from `out` shifted by one step, zero at the
//       direction's first step; dW_hh is written through strides, so a
//       torch-layout (3H, H) weight gets its gradient without a transpose.
// Accuracy: expf / tanhf, no fast-math.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;  // CTAs per cluster; each owns H/8 hidden units
constexpr int NT = 256;     // threads per CTA

struct GruBwdParams {
  const float* gi[2];    // gi[d][b*gi_sb + t*gi_st + col], (B, T, 3H)
  const float* out[2];   // out[d][b*o_sb + t*o_st + j], forward outputs
  const float* g[2];     // g[d][b*g_sb + t*g_st + j], output cotangents
  const float* w_hh[2];  // w[k*w_sk + col*w_sc], (H, 3H) logical
  const float* b_hh[2];  // (3H,), contiguous
  float* dgi[2];         // (B, T, 3H), contiguous
  float* dgh[2];         // (B, T, 3H), contiguous scratch for the reduction
  float* dw[2];          // dw[k*dw_sk + col*dw_sc], (H, 3H) logical
  float* db[2];          // (3H,), contiguous
  long long gi_sb, gi_st, o_sb, o_st, g_sb, g_st, w_sk, w_sc, dw_sk, dw_sc;
  int B, T, H, reverse_mask;  // bit d set: direction d ran backwards in time
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// (a) the chain
// ---------------------------------------------------------------------------

template <int BT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(NT, 1)
gru_bwd_chain_kernel(const GruBwdParams p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int d = blockIdx.y;
  const int b0 = blockIdx.z * BT;
  const int H = p.H, T = p.T;
  const int U = H / CLUSTER;
  const int U3 = 3 * U;
  const int WS = U3 + 1;             // padded row of the w_hh slice
  const int S = NT / U;              // K-slices of the h W_hh product
  const int L = (H + S - 1) / S;     // slice length
  const int tid = threadIdx.x;
  const bool rev = (p.reverse_mask >> d) & 1;

  extern __shared__ float4 smem4[];
  float* s_w = reinterpret_cast<float*>(smem4);  // [H][WS]: r | z | n columns
  float* s_h = s_w + H * WS;                     // [2][H][BT] h_prev
  float* s_red = s_h + 2 * H * BT;               // [S][3][BT][U]
  float* s_dgh = s_red + S * 3 * BT * U;         // [3U][BT]
  float* s_rcv = s_dgh + U3 * BT;                // [2][CLUSTER][BT][U]

  const float* W = p.w_hh[d];
  for (int i = tid; i < H * U3; i += NT) {
    const int k = i / U3, c = i % U3;
    const int col = (c / U) * H + rank * U + (c % U);
    s_w[k * WS + c] = W[k * p.w_sk + col * p.w_sc];
  }

  const float* outd = p.out[d];
  // h_prev of iteration i (the forward's i-th step) into s_h[buf]: out at
  // the direction's previous step, or 0 at its first step and past B.
  auto stage_hprev = [&](int i, int buf, bool async) {
    float* dst = s_h + buf * H * BT;
    const int tp = rev ? T - i : i - 1;  // time index of step i - 1
    for (int e = tid; e < H * BT; e += NT) {
      const int b = e / H, k = e % H;
      float* s = dst + k * BT + b;
      if (i > 0 && b0 + b < p.B) {
        const float* src = outd + (b0 + b) * p.o_sb + tp * p.o_st + k;
        if (async) {
          __pipeline_memcpy_async(s, src, sizeof(float));
        } else {
          *s = *src;
        }
      } else {
        *s = 0.f;
      }
    }
  };
  stage_hprev(T - 1, 0, false);

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
  const int rb = row_ok ? gb : 0;
  const float* gi_row = p.gi[d] + rb * p.gi_sb;
  const float* g_row = p.g[d] + rb * p.g_sb + jr;
  const long long drow = (long long)rb * T * 3 * H;
  float* dgi_row = p.dgi[d] + drow + jr;
  float* dgh_row = p.dgh[d] + drow + jr;

  // product role: column u, K-slice s
  const int du = tid % U, ds = tid / U;
  const bool dot = ds < S;
  const int k0 = ds * L;
  const int k1 = min(H, k0 + L);

  float dh = 0.f;  // gradient into h_t from later steps, for (fb, jr)
  float az = 0.f;  // a * z of the previous iteration (the direct term)

  cluster.sync();  // w_hh slices and the first h_prev are in place

  int cur = 0;
  for (int s = 0; s < T; ++s) {
    const int i = T - 1 - s;  // forward step index, walked backwards
    const int t = rev ? T - 1 - i : i;
    if (i > 0) stage_hprev(i - 1, cur ^ 1, true);  // overlaps this step
    __pipeline_commit();

    float xr = 0.f, xz = 0.f, xn = 0.f, gv = 0.f;
    if (row_ok) {
      const float* gt = gi_row + t * p.gi_st;
      xr = gt[jr];
      xz = gt[H + jr];
      xn = gt[2 * H + jr];
      gv = g_row[t * p.g_st];
    }
    const float* hcur = s_h + cur * H * BT;

    if (dot) {
      float acc[3][BT];
#pragma unroll
      for (int gg = 0; gg < 3; ++gg)
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[gg][b] = 0.f;
      for (int k = k0; k < k1; ++k) {
        const float* wk = s_w + k * WS + du;
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
      for (int gg = 0; gg < 3; ++gg)
#pragma unroll
        for (int b = 0; b < BT; ++b)
          s_red[((ds * 3 + gg) * BT + b) * U + du] = acc[gg][b];
    }
    __syncthreads();

    if (fin) {
      if (s > 0) {  // the partials the cluster sent at the previous step
        const float* rcv = s_rcv + ((s - 1) & 1) * CLUSTER * BT * U + fb * U + fu;
        float sum = az;
#pragma unroll
        for (int q = 0; q < CLUSTER; ++q) sum += rcv[q * BT * U];
        dh = sum;
      }
      float ghr = 0.f, ghz = 0.f, ghn = 0.f;
      for (int sl = 0; sl < S; ++sl) {
        const float* rs = s_red + (sl * 3 * BT + fb) * U + fu;
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
      const float a = gv + dh;
      const float dn = a * (1.f - z);
      const float dz = a * (hp - n);
      const float dpre_n = dn * (1.f - n * n);
      const float dr = dpre_n * ghn;
      const float dpre_r = dr * r * (1.f - r);
      const float dpre_z = dz * z * (1.f - z);
      const float dgh_n = dpre_n * r;
      if (row_ok) {
        const long long o = (long long)t * 3 * H;
        dgi_row[o] = dpre_r;
        dgi_row[o + H] = dpre_z;
        dgi_row[o + 2 * H] = dpre_n;
        dgh_row[o] = dpre_r;
        dgh_row[o + H] = dpre_z;
        dgh_row[o + 2 * H] = dgh_n;
      }
      s_dgh[fu * BT + fb] = dpre_r;
      s_dgh[(U + fu) * BT + fb] = dpre_z;
      s_dgh[(2 * U + fu) * BT + fb] = dgh_n;
      az = a * z;
    }
    __syncthreads();

    // partial dh_prev[j] = sum over this CTA's 3U columns of dgh W_hh[j, col]
    float* snd = s_rcv + (s & 1) * CLUSTER * BT * U + rank * BT * U;
    for (int j = tid; j < H; j += NT) {
      float acc[BT];
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[b] = 0.f;
      const float* wj = s_w + j * WS;
      for (int c = 0; c < U3; ++c) {
        const float w = wj[c];
        float dv[BT];
        if constexpr (BT % 4 == 0) {
          const float4* d4 = reinterpret_cast<const float4*>(s_dgh + c * BT);
#pragma unroll
          for (int q = 0; q < BT / 4; ++q) {
            const float4 v = d4[q];
            dv[4 * q] = v.x; dv[4 * q + 1] = v.y;
            dv[4 * q + 2] = v.z; dv[4 * q + 3] = v.w;
          }
        } else {
#pragma unroll
          for (int b = 0; b < BT; ++b) dv[b] = s_dgh[c * BT + b];
        }
#pragma unroll
        for (int b = 0; b < BT; ++b) acc[b] = fmaf(dv[b], w, acc[b]);
      }
      const int owner = j / U;
#pragma unroll
      for (int b = 0; b < BT; ++b)
        *cluster.map_shared_rank(snd + b * U + (j % U), owner) = acc[b];
    }
    __pipeline_wait_prior(0);  // the next h_prev has landed
    cluster.sync();  // partials delivered everywhere; buffers free to reuse
    cur ^= 1;
  }
}

size_t chain_smem_bytes(int H, int BT) {
  const int U = H / CLUSTER;
  const int S = NT / U;
  return sizeof(float) *
         ((size_t)H * (3 * U + 1) + 2 * (size_t)H * BT +
          (size_t)S * 3 * BT * U + (size_t)3 * U * BT +
          2 * (size_t)CLUSTER * BT * U);
}

constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90

// Rows per cluster: the smallest power of two >= B, at most 8, small enough
// that every (row, unit) pair has its own thread and the shared arrays fit.
int rows_per_cluster(int B, int H) {
  const int U = H / CLUSTER;
  int bt = 1;
  while (bt < B && bt < 8) bt *= 2;
  while (bt > 1 && (bt * U > NT || chain_smem_bytes(H, bt) > MAX_SMEM)) bt /= 2;
  return bt;
}

template <int BT>
cudaError_t launch_chain(const GruBwdParams& p, int ndir, cudaStream_t stream) {
  const size_t smem = chain_smem_bytes(p.H, BT);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gru_bwd_chain_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(CLUSTER, ndir, (p.B + BT - 1) / BT);
  gru_bwd_chain_kernel<BT><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// (b) dW_hh = h_prev^T dgh, db_hh = sum dgh
// ---------------------------------------------------------------------------

constexpr int RT = 64;  // output tile: RT rows (k) x RT columns (col)
constexpr int RK = 16;  // (row, step) pairs per shared-memory chunk

__global__ void __launch_bounds__(NT)
gru_bwd_reduce_kernel(const GruBwdParams p) {
  const int d = blockIdx.z;
  const int c0 = blockIdx.x * RT, k0 = blockIdx.y * RT;
  const int H = p.H, T = p.T, H3 = 3 * H;
  const int M = p.B * T;
  const bool rev = (p.reverse_mask >> d) & 1;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;

  __shared__ __align__(16) float s_a[RK][RT];  // h_prev[m][k0 + kk]
  __shared__ __align__(16) float s_b[RK][RT];  // dgh[m][c0 + cc]

  const float* outd = p.out[d];
  const float* dghd = p.dgh[d];
  float acc[4][4] = {};
  float dbacc = 0.f;
  const bool do_db = blockIdx.y == 0 && tid < RT && c0 + tid < H3;

  for (int m0 = 0; m0 < M; m0 += RK) {
    for (int e = tid; e < RK * RT; e += NT) {
      const int mm = e / RT, kk = e % RT;
      const int m = m0 + mm;
      float va = 0.f, vb = 0.f;
      if (m < M) {
        const int b = m / T, t = m % T;
        const int tp = rev ? t + 1 : t - 1;
        if (k0 + kk < H && tp >= 0 && tp < T)
          va = outd[b * p.o_sb + tp * p.o_st + k0 + kk];
        if (c0 + kk < H3) vb = dghd[(long long)m * H3 + c0 + kk];
      }
      s_a[mm][kk] = va;
      s_b[mm][kk] = vb;
    }
    __syncthreads();
#pragma unroll
    for (int mm = 0; mm < RK; ++mm) {
      const float4 a4 = *reinterpret_cast<const float4*>(&s_a[mm][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&s_b[mm][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
    if (do_db) {
#pragma unroll
      for (int mm = 0; mm < RK; ++mm) dbacc += s_b[mm][tid];
    }
    __syncthreads();
  }

  float* dw = p.dw[d];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int k = k0 + ty * 4 + r;
    if (k >= H) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = c0 + tx * 4 + c;
      if (col < H3) dw[k * p.dw_sk + col * p.dw_sc] = acc[r][c];
    }
  }
  if (do_db) p.db[d][c0 + tid] = dbacc;
}

}  // namespace

extern "C" int avs_gru_bwd(
    const float* gi0, const float* gi1, const float* out0, const float* out1,
    const float* g0, const float* g1, const float* w0, const float* w1,
    const float* b0, const float* b1, float* dgi0, float* dgi1, float* dgh0,
    float* dgh1, float* dw0, float* dw1, float* db0, float* db1,
    long long gi_sb, long long gi_st, long long o_sb, long long o_st,
    long long g_sb, long long g_st, long long w_sk, long long w_sc,
    long long dw_sk, long long dw_sc,
    int B, int T, int H, int ndir, int reverse_mask, int device, void* stream) {
  if (H % CLUSTER != 0 || H / CLUSTER > NT || ndir < 1 || ndir > 2 || B < 1 ||
      T < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GruBwdParams p{{gi0, gi1}, {out0, out1}, {g0, g1}, {w0, w1}, {b0, b1},
                 {dgi0, dgi1}, {dgh0, dgh1}, {dw0, dw1}, {db0, db1},
                 gi_sb, gi_st, o_sb, o_st, g_sb, g_st, w_sk, w_sc, dw_sk, dw_sc,
                 B, T, H, reverse_mask};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  switch (rows_per_cluster(B, H)) {
    case 8: e = launch_chain<8>(p, ndir, s); break;
    case 4: e = launch_chain<4>(p, ndir, s); break;
    case 2: e = launch_chain<2>(p, ndir, s); break;
    default: e = launch_chain<1>(p, ndir, s); break;
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((3 * H + RT - 1) / RT, (H + RT - 1) / RT, ndir);
  gru_bwd_reduce_kernel<<<grid, NT, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* avs_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
