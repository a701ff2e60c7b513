// Correlation3D's tail: the cost MLP over each selected neighbour, the
// per-level sums and the merge layer.
//
// camli_corr3d_tail replaces
//   camliflow_tpu/ops/pallas_corr3d.py::corr3d_tail_pallas on its exact path
//   (f32 costs, no dequantisation scale). Per query q, for each of the L*k
//   neighbours t that kernel #4 (corr3d.cu) selected, level by level:
//     rel = xyz2[idx[q, t]] - xyz1[q]
//     h   = relu(W1 [rel, cost[q, t]] + b1)                      4 -> C1
//     h2  = relu(W2 h + b2)                                     C1 -> C1
//     acc_l = the sum of h2 over level l's k neighbours
//     out[q] = leaky_relu_0.1(Wm [acc_0, ..., acc_{L-1}] + bm)  L*C1 -> Cout
//   The products are in the kernel's body, as in the TPU kernel.
//
// Bound on the card at the main-path shape (2048 queries, L = 4, k = 16,
// C1 = 32, Cout = 128): 64 taps x 1,152 multiply-adds plus the merge's
// 16,384 per query, 0.37 GFLOP against ~2.1 MB moved, so bound by
// operations (5.5 us at 67 TFLOP/s of f32).
//
// Design: one warp per query, one lane per hidden channel (C1 <= 32). Lane c
// keeps column c of W1 and of W2 in registers; each tap's h is spread over
// the warp and h2[c] collects it with C1 shuffles. The level sums never leave
// registers: when a level's k taps are summed, each lane broadcasts its
// channel of acc_l and every lane adds that level's share of the merge to its
// outputs o = lane + 32 r (Cout <= 128), so [acc_0, ..., acc_{L-1}] is never
// formed. The merge weights, L*C1 x Cout f32 (64 KB on the main path), live
// in shared memory, which is above the 48 KB that a launch gets by default:
// the entry point first raises the kernel's dynamic shared-memory limit, and
// a refused launch returns its error (the wrapper raises). Blocks of 8 warps
// walk over the queries. Sums are explicit __fmaf_rn/__fadd_rn in f32, in
// another order than the plain version's matmuls.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxHidden = 32;   // C1: one lane per channel
constexpr int kOutPerLane = 4;   // Cout <= 128
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

__global__ void __launch_bounds__(kThreads) corr3d_tail_kernel(
    const float* __restrict__ xyz1, const float* __restrict__ xyz2,
    const int32_t* __restrict__ idx, const float* __restrict__ cost,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ wm, const float* __restrict__ bm,
    float* __restrict__ out, int queries, int n, int m_rows, int n_levels, int k,
    int c1, int c_out) {
  extern __shared__ float merge_w[];  // [n_levels * c1, c_out]
  const int merge_size = n_levels * c1 * c_out;
  for (int t = threadIdx.x; t < merge_size; t += kThreads) merge_w[t] = wm[t];
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const bool hidden = lane < c1;
  float w1c[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) w1c[r] = hidden ? w1[r * c1 + lane] : 0.f;
  float w2c[kMaxHidden];
#pragma unroll
  for (int i = 0; i < kMaxHidden; ++i) w2c[i] = hidden && i < c1 ? w2[i * c1 + lane] : 0.f;
  const float b1c = hidden ? b1[lane] : 0.f;
  const float b2c = hidden ? b2[lane] : 0.f;
  const int taps = n_levels * k;

  // the loop is uniform across a warp: every lane works on the same query
  for (int q = blockIdx.x * kWarps + threadIdx.x / 32; q < queries; q += gridDim.x * kWarps) {
    const float* p2 = xyz2 + (size_t)(q / n) * m_rows * 3;
    const int32_t* iq = idx + (size_t)q * taps;
    const float* cq = cost + (size_t)q * taps;
    const float qx = xyz1[(size_t)q * 3];
    const float qy = xyz1[(size_t)q * 3 + 1];
    const float qz = xyz1[(size_t)q * 3 + 2];
    float acc[kOutPerLane] = {0.f, 0.f, 0.f, 0.f};
    for (int l = 0; l < n_levels; ++l) {
      float sum = 0.f;  // lane c: channel c of acc_l
      for (int j = 0; j < k; ++j) {
        const int t = l * k + j;
        const float* s = p2 + (size_t)iq[t] * 3;
        float h = __fmaf_rn(w1c[0], __fsub_rn(s[0], qx), b1c);
        h = __fmaf_rn(w1c[1], __fsub_rn(s[1], qy), h);
        h = __fmaf_rn(w1c[2], __fsub_rn(s[2], qz), h);
        h = relu(__fmaf_rn(w1c[3], cq[t], h));
        float h2 = b2c;
#pragma unroll
        for (int i = 0; i < kMaxHidden; ++i) {
          if (i < c1) h2 = __fmaf_rn(w2c[i], __shfl_sync(kAll, h, i), h2);
        }
        sum = __fadd_rn(sum, relu(h2));
      }
      // level l's share of the merge: rows l*c1 .. l*c1 + c1 - 1
      const float* wl = merge_w + (size_t)l * c1 * c_out;
#pragma unroll
      for (int i = 0; i < kMaxHidden; ++i) {
        if (i < c1) {
          const float v = __shfl_sync(kAll, sum, i);
#pragma unroll
          for (int r = 0; r < kOutPerLane; ++r) {
            const int o = lane + 32 * r;
            if (o < c_out) acc[r] = __fmaf_rn(wl[i * c_out + o], v, acc[r]);
          }
        }
      }
    }
    float* oq = out + (size_t)q * c_out;
#pragma unroll
    for (int r = 0; r < kOutPerLane; ++r) {
      const int o = lane + 32 * r;
      if (o < c_out) {
        float v = __fadd_rn(acc[r], bm[o]);
        if (!(v > 0.f)) v = __fmul_rn(0.1f, v);
        oq[o] = v;
      }
    }
  }
}

}  // namespace

// w1 [4, c1], w2 [c1, c1], wm [n_levels * c1, c_out], each [in, out] f32.
extern "C" int camli_corr3d_tail(const float* xyz1, const float* xyz2, const int32_t* idx,
                                 const float* cost, const float* w1, const float* b1,
                                 const float* w2, const float* b2, const float* wm,
                                 const float* bm, float* out, int batch, int n, int m_rows,
                                 int n_levels, int k, int c1, int c_out, cudaStream_t stream) {
  if (c1 < 1 || c1 > kMaxHidden || c_out < 1 || c_out > 32 * kOutPerLane || n_levels < 1 ||
      k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int queries = batch * n;
  if (queries == 0) return 0;
  const size_t smem = (size_t)n_levels * c1 * c_out * sizeof(float);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // above 48 KB of shared memory only after this; refused if above the card's limit
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr3d_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not to the next launch
    return (int)err;
  }
  int blocks = (queries + kWarps - 1) / kWarps;
  if (blocks > 2 * sms) blocks = 2 * sms;
  corr3d_tail_kernel<<<blocks, kThreads, smem, stream>>>(xyz1, xyz2, idx, cost, w1, b1, w2, b2,
                                                         wm, bm, out, queries, n, m_rows,
                                                         n_levels, k, c1, c_out);
  return (int)cudaGetLastError();
}
