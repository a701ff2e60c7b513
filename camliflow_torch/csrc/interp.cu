// Inverse-distance k-NN interpolation (knn_interpolation / backwarp_3d).
//
// Replaces camliflow_tpu/ops/pallas_interp.py::knn_interpolation_pallas.
// On the main paths it warps frame 2 every refinement iteration (support
// [1,2048,3], features [1,2048,3], queries [1,2048,3], k=3) and, on
// CamLiRAFT-L, upsamples the final flow to the full cloud (queries
// [1,8192,3]).
//
// Semantics: the k nearest supports (ascending distance, lowest index first
// on ties), weights 1 / max(|support - query|, 1e-8) normalised to sum 1,
// and the weighted sum of the supports' features.
//
// Bound: like the KNN kernel, arithmetic over query-support pairs (4 M pairs
// per call); the feature reads are k rows per query.
//
// Design: the KNN kernel's split scan and warp merge (camli::split_select,
// planned by ops/knn.py::select_plan), so the selection is the plain
// version's, ties included; then the merging warp forms the weights, a lane
// a neighbour, and the sums, a lane a channel, in the plain version's
// order: a correctly rounded square root, the clamp, a correctly rounded
// reciprocal, the total in list order, the division, and each channel's sum
// in list order.
#include "common.cuh"

namespace {

template <int KL, int R>
__global__ void __launch_bounds__(camli::kSelectMaxWarps * 32, 1) interp_kernel(
    const float* __restrict__ support, const float* __restrict__ feats,
    const float* __restrict__ query, float* __restrict__ out, int m, int n, int c, int k,
    int n_slices, int queries) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * queries;
  const int lane = threadIdx.x % 32;
  const float* sp = support + (size_t)b * m * 3;
  const float* qp = query + ((size_t)b * n + q0) * 3;
  const float* fp = feats + (size_t)b * m * c;
  float* op = out + ((size_t)b * n + q0) * c;
  camli::split_select<KL, R>(
      sp, m, qp, min(queries, n - q0), queries, n_slices, smem,
      [&](int q, const float*, const int* mi) {
        const int i = lane < k ? mi[lane] : 0;  // neighbour `lane`
        float w = 0.f;
        if (lane < k) {
          const float* s = sp + (size_t)i * 3;
          const float dist = fmaxf(
              __fsqrt_rn(camli::sq_dist(s[0], s[1], s[2], qp[3 * q], qp[3 * q + 1],
                                        qp[3 * q + 2])),
              1e-8f);
          w = __fdiv_rn(1.f, dist);
        }
        float total = 0.f;
        for (int j = 0; j < k; ++j) total = __fadd_rn(total, __shfl_sync(camli::kFullMask, w, j));
        w = __fdiv_rn(w, total);
        for (int ch0 = 0; ch0 < c; ch0 += 32) {
          const int ch = ch0 + lane;
          float acc = 0.f;
          for (int j = 0; j < k; ++j) {
            const int ij = __shfl_sync(camli::kFullMask, i, j);
            const float wj = __shfl_sync(camli::kFullMask, w, j);
            if (ch < c) acc = __fadd_rn(acc, __fmul_rn(fp[(size_t)ij * c + ch], wj));
          }
          if (ch < c) op[(size_t)q * c + ch] = acc;
        }
      });
}

}  // namespace

// The plan as for camli_knn (ops/knn.py::select_plan).
extern "C" int camli_interp(const float* support, const float* feats, const float* query,
                            float* out, int batch, int m, int n, int c, int k, int n_slices,
                            int queries, int group, cudaStream_t stream) {
  if (k < 1 || k > 32 || k > m || n_slices < 1 || n_slices > m || queries < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || batch == 0) return (int)cudaSuccess;
  const dim3 grid((n + queries - 1) / queries, batch);
  int code = (int)cudaErrorInvalidValue;
  CAMLI_DISPATCH_K(k, CAMLI_DISPATCH_GROUP(group, code = camli::launch_select(
                               interp_kernel<KL, R>, KL, R, m, queries, n_slices, grid, stream,
                               support, feats, query, out, m, n, c, k, n_slices, queries)));
  return code;
}
