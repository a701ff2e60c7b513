// Brute-force k-nearest-neighbour selection.
//
// Replaces camliflow_tpu/ops/pallas_knn.py::k_nearest_neighbor_pallas.
// On the CamLiRAFT-L path it serves the encoder KNN ([2,4096] <- [2,8192]
// and [2,2048] <- [2,4096], k=16), the cost-pyramid pooling (k=3) and the
// update neighbours ([1,2048] <- [1,2048], k=32); on the flagship's also
// the 2048 -> 8192 upsample (k=3) and CLFM's pixel-grid cache ([2,8160]
// <- [2,2048], k=1), whose 2-D points the wrapper gives a zero z.
//
// Bound: about 8 flops per query-candidate pair and no device-memory traffic
// beyond reading the points once per block, so the kernel is bound by the
// SM's arithmetic and the sorted-insertion branches, not by bandwidth
// (67 M pairs for the largest call). Design: one thread per query; the
// support set is staged through shared memory in tiles of 1024 points that
// every thread of the block scans in ascending index, keeping a sorted
// register list of the k best (lowest index first on equal distances).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 1024;

template <int KL>
__global__ void knn_kernel(const float* __restrict__ support,
                           const float* __restrict__ query,
                           int32_t* __restrict__ out, int m, int n, int k) {
  __shared__ float tile[kTile * 3];
  const int b = blockIdx.y;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = q < n;
  const float* sp = support + (size_t)b * m * 3;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = query + ((size_t)b * n + q) * 3;
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  float D[KL];
  int I[KL];
  camli::init_list(D, I);

  for (int base = 0; base < m; base += kTile) {
    const int count = min(kTile, m - base);
    __syncthreads();
    for (int t = threadIdx.x; t < count * 3; t += blockDim.x) {
      tile[t] = sp[(size_t)base * 3 + t];
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < count; ++j) {
        const float d = camli::sq_dist(qx, qy, qz, tile[3 * j],
                                       tile[3 * j + 1], tile[3 * j + 2]);
        camli::insert_sorted(D, I, d, base + j);
      }
    }
  }
  if (active) {
    int32_t* op = out + ((size_t)b * n + q) * k;
#pragma unroll
    for (int j = 0; j < KL; ++j) {
      if (j < k) op[j] = I[j];
    }
  }
}

}  // namespace

extern "C" int camli_knn(const float* support, const float* query,
                         int32_t* out, int batch, int m, int n, int k,
                         cudaStream_t stream) {
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  CAMLI_DISPATCH_K(k, knn_kernel<KL><<<grid, kThreads, 0, stream>>>(
                          support, query, out, m, n, k));
  return (int)cudaGetLastError();
}

extern "C" const char* camli_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
