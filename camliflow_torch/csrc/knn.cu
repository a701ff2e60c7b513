// Brute-force k-nearest-neighbour selection.
//
// Replaces camliflow_tpu/ops/pallas_knn.py::k_nearest_neighbor_pallas.
// On the CamLiRAFT-L path it serves the encoder KNN ([2,4096] <- [2,8192]
// and [2,2048] <- [2,4096], k=16), the cost-pyramid pooling (k=3) and the
// update neighbours ([1,2048] <- [1,2048], k=32); on the flagship's also
// the 2048 -> 8192 upsample (k=3) and CLFM's pixel-grid cache ([2,8160]
// <- [2,2048], k=1), whose 2-D points the wrapper gives a zero z.
//
// Bound: about 8 flops and a compare per query-candidate pair and no
// device-memory traffic beyond the points and the indices, so the kernel is
// bound by the SM's arithmetic (67 M pairs for the largest call, 9 us at
// the f32 peak); in practice by the sorted inserts, about 100 a query at
// k = 16 over 8192 candidates, each a chain of shuffles.
//
// Design: a split scan (camli::split_select). Each query's candidates are
// cut into n_slices contiguous slices; a block takes `queries` queries and
// a warp per (slice, 1 or 2 queries), which scans its slice 128 candidates
// a step, 4 a lane, from shared memory, and keeps each query's sorted list
// spread over its lanes: a lane holding a candidate nearer than the list's
// last entry inserts it (and its other passing ones) by a ballot and a few
// shuffles each, in ascending index, after every entry not farther. (Not
// #4's thread per (query, slice) with a KL-step register insert: a warp's
// 32 queries almost always hold one lane that inserts, so every lane would
// pay the whole insert for nearly every candidate. That form was reasoned
// out, not timed on the card.)
// A warp per query then merges the slices' sorted lists by (distance,
// index) and writes the k first. The selection is bit-identical to the
// plain version's stable sort, ties included. ops/knn.py::select_plan
// sizes the slices, blocks and pairs for each call.
#include "common.cuh"

namespace {

template <int KL, int R>
__global__ void __launch_bounds__(camli::kSelectMaxWarps * 32, 1) knn_kernel(
    const float* __restrict__ support, const float* __restrict__ query,
    int32_t* __restrict__ out, int m, int n, int k, int n_slices, int queries) {
  extern __shared__ float smem[];
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * queries;
  const int lane = threadIdx.x % 32;
  int32_t* op = out + ((size_t)b * n + q0) * k;
  camli::split_select<KL, R>(support + (size_t)b * m * 3, m, query + ((size_t)b * n + q0) * 3,
                             min(queries, n - q0), queries, n_slices, smem,
                             [&](int q, const float*, const int* mi) {
                               if (lane < k) op[q * k + lane] = mi[lane];
                             });
}

}  // namespace

// The plan (ops/knn.py::select_plan): n_slices in [1, m], queries a block,
// group (1 or 2) queries a warp, queries / group * n_slices <= 32 warps.
extern "C" int camli_knn(const float* support, const float* query, int32_t* out, int batch,
                         int m, int n, int k, int n_slices, int queries, int group,
                         cudaStream_t stream) {
  if (k < 1 || k > 32 || k > m || n_slices < 1 || n_slices > m || queries < 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0 || batch == 0) return (int)cudaSuccess;
  const dim3 grid((n + queries - 1) / queries, batch);
  int code = (int)cudaErrorInvalidValue;
  CAMLI_DISPATCH_K(k, CAMLI_DISPATCH_GROUP(group, code = camli::launch_select(
                               knn_kernel<KL, R>, KL, R, m, queries, n_slices, grid, stream,
                               support, query, out, m, n, k, n_slices, queries)));
  return code;
}

extern "C" const char* camli_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
