// Correlation3D neighbour selection, with or without cost extraction.
//
// Replaces camliflow_tpu/ops/pallas_corr3d.py::correlation3d_knn_pallas
// (exact mode, with_cost=True and with_cost=False). On the CamLiRAFT and
// CamLiRAFT-L eval paths it runs every refinement iteration with the cost:
// xyz1 [1,2048,3], warped frame 2 [1,2048,3], levels (2048, 1024, 512,
// 256), k=16, pyramid [1,2048,3840]. Training runs the index-only form
// (pyramid and cost_out null): the same selection, bit for bit, without
// reading the pyramid; the differentiable cost gather follows in PyTorch.
//
// Semantics: for each level l, the k nearest of the first m_l warped points
// (the frame-2 levels are row-prefixes of one FPS order), ascending distance
// and lowest index first; the level's cost is read at column
// offset_l + idx of the query's row of the concatenated pyramid.
//
// Bound: arithmetic over query-candidate pairs (2048 x 2048 at the flagship
// shape: 0.56 us at 67 TFLOP/s of f32), plus L*k scattered 4-byte reads of
// the pyramid row per query; launch latency and the merge set the floor.
//
// Design: a split scan. Each query's candidates [0, m_0) are cut into
// slices that follow the levels: every level range [m_{l+1}, m_l) (and
// [0, m_{L-1})) is split evenly into slices of at most 128 candidates
// (ops/corr3d.py::scan_plan), so no slice straddles a level boundary. A
// block takes `queries` queries (16 at the flagship shape: 128 blocks for
// 2048 queries, where one thread per query filled 16) and one thread per
// (query, slice): each scans its slice in ascending index with the strictly
// smaller insert, so equal distances keep the lowest index first. Then a
// warp per query merges the slices' sorted lists in ascending order
// (camli::merge_sorted, by (distance, index)); once the merge has taken
// every slice below m_l it holds level l's k nearest, which it writes out,
// then goes on; the costs of all levels are read at the end, their loads in
// flight together (the index-only form skips that read and its shared
// list). The selection is bit-identical to the plain version's stable sort,
// ties included. The warped prefix sits in shared memory as
// float4 (x, y, z, 0): a warp's lanes are 16 queries of one slice, so each
// quarter-warp's 128-bit load is one broadcast.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxLevels = 8;
constexpr int kMaxSlices = 256;

struct Plan {
  int start[kMaxSlices + 1];  // slice s scans the candidates [start[s], start[s + 1])
  int level_end[kMaxLevels];  // level l's k nearest: the merge of slices [0, level_end[l])
  int offset[kMaxLevels];     // column offset of each level in the pyramid
  int n_slices, n_levels;
  int queries;  // per block
};

template <int KL, bool kCost>
__global__ void __launch_bounds__(kMaxThreads) corr3d_kernel(
    const float* __restrict__ xyz1, const float* __restrict__ xyz2,
    const float* __restrict__ pyramid, int32_t* __restrict__ idx_out,
    float* __restrict__ cost_out, int n, int m_rows, int m_total, int k,
    const __grid_constant__ Plan plan) {
  extern __shared__ float4 pts[];  // [m_0], then the lists, then the selection
  const int m0 = plan.start[plan.n_slices];
  const int stride = plan.n_slices * KL + 1;  // one query's lists (+1: no bank conflicts)
  const int lk = plan.n_levels * k;
  float* list_d = reinterpret_cast<float*>(pts + m0);  // [queries][stride]
  int* list_i = reinterpret_cast<int*>(list_d + plan.queries * stride);
  int* selected = list_i + plan.queries * stride;  // [queries][lk]
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * plan.queries;
  const float* sp = xyz2 + (size_t)b * m_rows * 3;
  for (int t = threadIdx.x; t < m0; t += blockDim.x) {
    pts[t] = make_float4(sp[3 * t], sp[3 * t + 1], sp[3 * t + 2], 0.f);
  }
  __syncthreads();

  // 1. thread (slice s, query ql), queries fastest, scans its slice
  const int ql = threadIdx.x % plan.queries;
  const int s = threadIdx.x / plan.queries;
  if (s < plan.n_slices && q0 + ql < n) {
    const float* qp = xyz1 + ((size_t)b * n + q0 + ql) * 3;
    const float qx = qp[0], qy = qp[1], qz = qp[2];
    float D[KL];
    int I[KL];
    camli::init_list(D, I);
    const int end = plan.start[s + 1];
    for (int j = plan.start[s]; j < end; ++j) {
      const float4 p = pts[j];
      camli::insert_sorted(D, I, camli::sq_dist(qx, qy, qz, p.x, p.y, p.z), j);
    }
    float* ld = list_d + ql * stride + s * KL;
    int* li = list_i + ql * stride + s * KL;
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      ld[j] = D[j];
      li[j] = I[j];
    }
  }
  __syncthreads();

  // 2. a warp per query merges the slices in ascending order into slice 0's
  // list, and writes each level's indices out when its last slice is in;
  // then the costs, every level's loads at once
  const int lane = threadIdx.x % 32;
  for (int qi = threadIdx.x / 32; qi < plan.queries && q0 + qi < n; qi += blockDim.x / 32) {
    float* md = list_d + qi * stride;
    int* mi = list_i + qi * stride;
    int* sel = selected + qi * lk;
    const size_t row = (size_t)b * n + q0 + qi;
    int32_t* io = idx_out + row * lk;
    int level = plan.n_levels - 1;
    for (int merged = 1;; ++merged) {
      for (; level >= 0 && plan.level_end[level] == merged; --level) {
        if (lane < k) {
          io[level * k + lane] = mi[lane];
          if (kCost) sel[level * k + lane] = mi[lane];
        }
      }
      if (merged == plan.n_slices) break;
      camli::merge_sorted<KL>(md, mi, md + merged * KL, mi + merged * KL);
    }
    if (!kCost) continue;
    __syncwarp();
    const float* costs = pyramid + row * m_total;
    for (int e = lane; e < lk; e += 32) {
      cost_out[row * lk + e] = costs[plan.offset[e / k] + sel[e]];
    }
  }
}

}  // namespace

// level_sizes: descending prefix lengths; slice_starts [n_slices + 1]: from
// 0, ascending, ending at level_sizes[0], every level size among them;
// queries per block, at most kMaxThreads / n_slices. pyramid and cost_out
// both null: the index-only form (m_total is then not read).
extern "C" int camli_corr3d(const float* xyz1, const float* xyz2, const float* pyramid,
                            int32_t* idx_out, float* cost_out, int batch, int n, int m_rows,
                            int m_total, int n_levels, const int* level_sizes, int n_slices,
                            const int* slice_starts, int queries, int k, cudaStream_t stream) {
  const bool with_cost = pyramid != nullptr;
  if (n_levels < 1 || n_levels > kMaxLevels || n_slices < 1 || n_slices > kMaxSlices ||
      queries < 1 || queries * n_slices > kMaxThreads || k < 1 || k > 32 ||
      slice_starts[0] != 0 || slice_starts[n_slices] != level_sizes[0] ||
      with_cost != (cost_out != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Plan plan = {};
  for (int s = 0; s <= n_slices; ++s) {
    if (s > 0 && slice_starts[s] <= slice_starts[s - 1]) return (int)cudaErrorInvalidValue;
    plan.start[s] = slice_starts[s];
  }
  int off = 0;
  for (int l = 0; l < n_levels; ++l) {
    plan.level_end[l] = -1;
    for (int s = 1; s <= n_slices; ++s) {
      if (slice_starts[s] == level_sizes[l]) plan.level_end[l] = s;
    }
    if (plan.level_end[l] < 0) return (int)cudaErrorInvalidValue;
    plan.offset[l] = off;
    off += level_sizes[l];
  }
  plan.n_slices = n_slices;
  plan.n_levels = n_levels;
  plan.queries = queries;
  const int threads = (queries * n_slices + 31) / 32 * 32;
  const dim3 grid((n + queries - 1) / queries, batch);
  CAMLI_DISPATCH_K(k, {
    const size_t smem =
        (size_t)level_sizes[0] * sizeof(float4) +
        sizeof(float) * queries *
            (2 * ((size_t)n_slices * KL + 1) + (with_cost ? n_levels * k : 0));
    auto kernel = with_cost ? corr3d_kernel<KL, true> : corr3d_kernel<KL, false>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<grid, threads, smem, stream>>>(xyz1, xyz2, pyramid, idx_out, cost_out, n, m_rows,
                                            m_total, k, plan);
  });
  return (int)cudaGetLastError();
}
