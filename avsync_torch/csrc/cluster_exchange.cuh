// Device helpers shared by the GRU kernels (gru_fwd.cu, gru_bwd.cu): the
// CTAs of a thread-block cluster exchange one step's values through
// distributed shared memory with st.async stores, each completing bytes of
// the receiving CTA's mbarrier transaction count, and reduce a K split over
// lanes with a fixed shuffle tree.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr size_t MAX_SMEM = 232448;  // per-block opt-in limit on sm_90
// what the dynamic shared memory of a kernel with a few static barriers may take
constexpr size_t MAX_DYN_SMEM = MAX_SMEM - 64;
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Address of the same shared variable in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(local), "r"(rank));
  return out;
}

// Store v into a peer's shared memory; the store completes 4 bytes of the
// transaction count of the peer's mbarrier `bar` when it has landed (no
// fence on the writer's side).
__device__ __forceinline__ void st_peer(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];"
               ::"r"(addr), "f"(v), "r"(bar) : "memory");
}

// The same for 16 bytes at a 16-byte aligned address.
__device__ __forceinline__ void st_peer4(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(addr), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}

// The barrier's next phase completes when `bytes` more have landed.
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes) : "memory");
}

// Thread 0: two mbarriers (one per exchange buffer) with one arrival each,
// visible to the cluster. Call before the cluster.sync() that precedes the
// first push.
__device__ __forceinline__ void init_barriers(uint32_t bar0) {
#pragma unroll
  for (int q = 0; q < 2; ++q)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar0 + 8 * q) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Wait until the phase of `bar` with this parity has completed (acquire at
// cluster scope: the data came from the peers). A phase that never completes
// (a broken invariant) traps after ~seconds instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint32_t bar, uint32_t parity) {
  for (long long spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{ .reg .pred p;\n"
        "  mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "  selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin > (1ll << 22)) __trap();
  }
}

// Sum over the 8 kq lanes (lane bits 2-4) of v[N][G]: halving the rows over
// bit `mask` while more than one row is held, then a butterfly. Each add is
// (own + partner's) of the same pair, so both lanes of a pair get the same
// bits and the tree is fixed.
template <int N, int G>
__device__ __forceinline__ void halve(float (&v)[N][G], int lane, int mask) {
  const bool hi = lane & mask;
#pragma unroll
  for (int r = 0; r < N / 2; ++r)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float send = hi ? v[r][g] : v[r + N / 2][g];
      const float keep = hi ? v[r + N / 2][g] : v[r][g];
      v[r][g] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
    }
}

template <int N, int G>
__device__ __forceinline__ void butterfly(float (&v)[N][G], int mask) {
#pragma unroll
  for (int g = 0; g < G; ++g) v[0][g] += __shfl_xor_sync(0xffffffffu, v[0][g], mask);
}

// The full sums of the 8 kq lanes of acc[BT][G], one (row, gate values) per
// lane: row ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1) for BT = 4, (lane >> 4)
// & 1 for BT = 2, 0 for BT = 1 (see row_of_lane).
template <int BT, int G>
__device__ __forceinline__ void reduce_kq(float (&acc)[BT][G], int lane, float (&s)[G]) {
  if constexpr (BT == 4) {
    halve<4>(acc, lane, 16);
    float (&a2)[2][G] = reinterpret_cast<float (&)[2][G]>(acc);
    halve<2>(a2, lane, 8);
    butterfly<2>(a2, 4);
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = a2[0][g];
  } else if constexpr (BT == 2) {
    halve<2>(acc, lane, 16);
    butterfly<2>(acc, 8);
    butterfly<2>(acc, 4);
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = acc[0][g];
  } else {
    butterfly<1>(acc, 16);
    butterfly<1>(acc, 8);
    butterfly<1>(acc, 4);
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = acc[0][g];
  }
}

// The batch row a lane holds after reduce_kq, and whether it is the one lane
// of its duplicates (the kq lanes) that acts on it.
template <int BT>
__device__ __forceinline__ int row_of_lane(int lane) {
  return BT == 4 ? ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1) : (BT == 2 ? (lane >> 4) & 1 : 0);
}
template <int BT>
__device__ __forceinline__ bool first_of_row(int lane) {
  return BT == 4 ? !(lane & 4) : (BT == 2 ? !(lane & 12) : !(lane & 28));
}

// Shared-memory stride of one CTA's slice of `n` floats in an exchange
// buffer: padded to 4 (mod 32) floats, so that float4 reads of 8 slices by
// the 8 kq lanes fall in 8 disjoint groups of 4 banks.
__host__ __device__ __forceinline__ int slice_stride(int n) {
  return n + (36 - n % 32) % 32;
}

// Clusters of `kernel` that can be resident at once on `device` with this
// block size and dynamic shared memory, asked once per device and cached in
// `cache` (0 = not asked yet).
template <typename Kernel>
int resident_clusters(std::atomic<int> (&cache)[MAX_DEVICES], int device, Kernel* kernel,
                      int cluster, int threads, size_t smem) {
  int n = device < MAX_DEVICES ? cache[device].load() : 0;
  if (n > 0) return n;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess || n < 1) {
    cudaGetLastError();
    n = 1;
  }
  if (device < MAX_DEVICES) cache[device].store(n);
  return n;
}

// Opt `kernel` in to MAX_DYN_SMEM of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t opt_in_smem(std::atomic<bool> (&done)[MAX_DEVICES], int device, Kernel* kernel) {
  if (device < MAX_DEVICES && done[device].load()) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_DYN_SMEM);
  if (e == cudaSuccess && device < MAX_DEVICES) done[device].store(true);
  return e;
}

// cudaSetDevice only when the calling thread's device differs.
inline cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t e = cudaGetDevice(&cur);
  if (e == cudaSuccess && cur != device) e = cudaSetDevice(device);
  return e;
}

}  // namespace
