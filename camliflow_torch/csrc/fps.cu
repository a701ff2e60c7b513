// Furthest-point sampling.
//
// Replaces camliflow_tpu/ops/pallas_fps.py::furthest_point_sampling_pallas
// (called for both frames at once: [2,8192] -> [2,4096]).
//
// Semantics: start at index 0; each step records the current index, lowers
// every point's running distance to min(dist, |p - cur|^2) with the 1e10
// initial value, and moves to the first index of the maximum. The distance
// is ((dx*dx + dy*dy) + dz*dz) with one rounding per operation, exactly as
// the plain version computes it, so the indices agree bit for bit.
//
// Bound: the 4096 steps are serial, so the kernel is bound by the latency of
// one step (a distance update over the cloud, an argmax, one exchange), not
// by arithmetic or bandwidth (4096 x 8192 x 10 operations are ~10 us of the
// card's f32 rate spread over every SM; one step's chain of dependent
// instructions and one barrier cost far more).
//
// Design: one cluster of 4 thread blocks of 128 threads per cloud, on
// neighbouring SMs. Block r keeps the points of its slice [r * ceil(N/4),
// ...) and their running distances in registers, 16 a thread (so N <= 8192),
// and the slice's coordinates in shared memory. One step:
// - each thread lowers its distances and keeps its best (distance bits,
//   index): the first index of its maximum;
// - a warp's argmax is two redux instructions: __reduce_max_sync on the
//   distance bits (a non-negative float orders like its unsigned bits), then
//   __reduce_min_sync on the index over the lanes that hold the maximum;
// - the winning lane pushes (bits, index, x, y, z), its coordinates read
//   from the slice in shared memory, into slot [parity][r * W + warp] of
//   every block of the cluster by st.async stores, each completing bytes on
//   the receiving block's mbarrier, which that block waits on: one-way, no
//   block waits for another to arrive, and the next centre needs no global
//   load;
// - every warp reads the 16 slots from its own shared memory and reduces
//   them the same way, identically in every block, to the next centre.
// Measured on an H100 (PERF.md), 4 blocks with the push were the fastest of
// the forms tried (1 block of 1024 threads; 2, 4, 8 or 16 blocks; a cluster
// barrier instead of the push): more blocks shorten the update and lengthen
// the exchange.
// The slots are double-buffered by the step's parity: a block writes slot
// set p again two steps later, after every block has passed the exchange in
// between, which it does only after reading set p.
// Tie rule across slices, warps and lanes: candidates are ordered by
// (distance desc, index asc), so the winner is the first index of the
// maximum, exactly as one scan gives it, wherever the points lie. A thread
// walks its points in ascending index and keeps a strictly larger distance;
// the padding of a short slice has distance 0 and index INT_MAX, so it never
// beats a real point (a real point always has distance >= 0 and a lower
// index). tests/test_torch_fps.py emulates the split argmax in numpy.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;     // blocks a cloud
constexpr int kThreads = 128;   // threads a block
constexpr int kPer = 16;        // points a thread
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = kCluster * kWarps;
constexpr int kChunk = kThreads * kPer;  // the most points a block holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the shared::cluster address of `addr` (this block's) in block `rank`
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One-way store into a peer's shared memory, completing `bytes` on its mbarrier.
__device__ __forceinline__ void push4(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void push1(uint32_t addr, uint32_t v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];" ::"r"(addr),
      "r"(v), "r"(bar)
      : "memory");
}

// (bits, idx) better than (best_bits, best_idx): larger distance, then lower index
__device__ __forceinline__ bool better(unsigned bits, unsigned idx, unsigned best_bits,
                                       unsigned best_idx) {
  return bits > best_bits || (bits == best_bits && idx < best_idx);
}

// The lane whose (bits, idx) is the warp's first index of the maximum; the
// maximum's bits and index in wb, wi.
__device__ __forceinline__ int warp_argmax(unsigned bits, unsigned idx, unsigned& wb,
                                           unsigned& wi) {
  wb = __reduce_max_sync(kFull, bits);
  wi = __reduce_min_sync(kFull, bits == wb ? idx : 0xffffffffu);
  return __ffs(__ballot_sync(kFull, bits == wb && idx == wi)) - 1;
}

// A thread's running best is only (distance bits, index); a warp's winning
// lane finds its coordinates in the block's slice in shared memory.
__global__ void __launch_bounds__(kThreads) fps_kernel(const float* __restrict__ xyz,
                                                       int32_t* __restrict__ out, int n,
                                                       int n_samples) {
  __shared__ float4 slice[kChunk];
  __shared__ __align__(16) uint4 key[2][kSlots];  // (bits, index, x, y)
  __shared__ float zs[2][kSlots];
  __shared__ __align__(8) unsigned long long bar[2];  // the slot sets' mbarriers
  const int rank = blockIdx.x % kCluster;
  const int b = blockIdx.x / kCluster;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const float* pts = xyz + (size_t)b * n * 3;

  const int chunk = (n + kCluster - 1) / kCluster;
  const int begin = rank * chunk;
  const int end = min(n, begin + chunk);
  float px[kPer], py[kPer], pz[kPer], dist[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = begin + tid + j * kThreads;
    if (i < end) {
      px[j] = pts[3 * i];
      py[j] = pts[3 * i + 1];
      pz[j] = pts[3 * i + 2];
      dist[j] = 1e10f;
      slice[i - begin] = make_float4(px[j], py[j], pz[j], 0.f);
    } else {
      px[j] = py[j] = pz[j] = 0.f;
      dist[j] = 0.f;  // stays 0 (fminf with a distance >= 0): never beats a real point
    }
  }
  if (tid == 0) {
    mbar_init(smem_addr(&bar[0]), 1);
    mbar_init(smem_addr(&bar[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cg::this_cluster().sync();  // the slice is stored; the peers' barriers exist

  float cx = pts[0], cy = pts[1], cz = pts[2];
  int farthest = 0;
  for (int s = 0;; ++s) {
    if (rank == 0 && tid == 0) out[(size_t)b * n_samples + s] = farthest;
    if (s + 1 == n_samples) break;
    const int par = s & 1;

    // this thread's best: points in ascending index, a strictly larger distance wins
    unsigned bb = 0, bi = 0xffffffffu;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = begin + tid + j * kThreads;
      dist[j] = fminf(dist[j], camli::sq_dist(px[j], py[j], pz[j], cx, cy, cz));
      const unsigned bits = __float_as_uint(dist[j]);
      if (j == 0 || bits > bb) bb = bits, bi = i < end ? (unsigned)i : 0x7fffffffu;
    }
    // its coordinates (read while the warp reduces; a thread of padding
    // alone reads the slice's first point, which never wins)
    const float4 mine = slice[bi < (unsigned)end ? bi - begin : 0];
    unsigned wb, wi;
    const int winner = warp_argmax(bb, bi, wb, wi);
    if (lane == winner) {
      const uint4 v = make_uint4(bb, bi, __float_as_uint(mine.x), __float_as_uint(mine.y));
      const int slot = rank * kWarps + warp;
      const uint32_t k_addr = smem_addr(&key[par][slot]);
      const uint32_t z_addr = smem_addr(&zs[par][slot]);
      const uint32_t b_addr = smem_addr(&bar[par]);
      for (int r = 0; r < kCluster; ++r) {
        const uint32_t pb = peer_addr(b_addr, r);
        push4(peer_addr(k_addr, r), v, pb);
        push1(peer_addr(z_addr, r), __float_as_uint(mine.z), pb);
      }
    }
    if (tid == 0) mbar_expect(smem_addr(&bar[par]), kSlots * 20);
    mbar_wait(smem_addr(&bar[par]), (s >> 1) & 1);

    // the next centre: the best of the slots, in every warp alike
    bb = 0, bi = 0xffffffffu;
    float bx = 0.f, by = 0.f, bz = 0.f;
    if (lane < kSlots) {
      const uint4 v = key[par][lane];
      if (better(v.x, v.y, bb, bi)) {
        bb = v.x, bi = v.y, bx = __uint_as_float(v.z), by = __uint_as_float(v.w);
        bz = zs[par][lane];
      }
    }
    const int from = warp_argmax(bb, bi, wb, wi);
    farthest = (int)wi;
    cx = __shfl_sync(kFull, bx, from);
    cy = __shfl_sync(kFull, by, from);
    cz = __shfl_sync(kFull, bz, from);
  }
  cg::this_cluster().sync();  // no block leaves while a peer may push
}

}  // namespace

// A cloud holds at most kCluster * kChunk = 8192 points.
extern "C" int camli_fps(const float* xyz, int32_t* out, int batch, int n, int n_samples,
                         cudaStream_t stream) {
  if (n > kCluster * kChunk) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(batch * kCluster);
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, fps_kernel, xyz, out, n, n_samples);
  cudaGetLastError();  // a refused launch is reported once, here
  return (int)err;
}
