// Correlation3D's tail: the cost MLP over each selected neighbour, the
// per-level sums and the merge layer.
//
// camli_corr3d_tail replaces
//   camliflow_tpu/ops/pallas_corr3d.py::corr3d_tail_pallas, with or without
//   its dequantisation scale. Per query q, for each of the L*k neighbours t
//   that kernel #4 (corr3d.cu) selected, level by level:
//     rel = xyz2[idx[q, t]] - xyz1[q]
//     c   = cost[q, t], times scale[q] on the fast path (the int8 pyramid's
//           row scale; one rounded multiply, as the JAX dequantisation)
//     h   = relu(W1 [rel, c] + b1)                                4 -> C1
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
// Design, tap-parallel: nothing on a tap's path waits on another lane.
// - Per-tap stage: one thread per (query, tap). It gathers rel and the
//   cost and computes h and h2 in registers, C1 <= 32 independent
//   accumulators (the layers are zero-padded to 32 channels in shared
//   memory, so the loops unroll without branches). W1, W2 and the biases
//   sit in shared memory, read as warp-wide broadcasts (every lane the same
//   address, 16-byte loads). The thread writes relu(h2) to a row of shared
//   memory (stride 33: conflict-free).
// - Level sums: one thread per (query, level, channel) adds its level's k
//   rows in tap order, for any k; a level that straddles two chunks of
//   taps is carried in shared memory from one chunk to the next. No float
//   atomics: two runs give the same bits.
// - Merge: [queries x L*C1] x [L*C1 x Cout] against the merge weights in
//   shared memory, each thread 2 queries x 2 outputs, then bias and leaky
//   ReLU.
// - Blocks are persistent: each loads the weights once (the merge's are
//   64 KB on the main path, above a launch's default 48 KB: the entry point
//   raises the kernel's limit first, and a refused launch returns its
//   error, on which the wrapper raises) and walks over groups of up to 8
//   queries, taps in chunks of 256. The merge weights arrive by cp.async
//   while the first group's per-tap stage runs.
// Sums are explicit __fmaf_rn/__fadd_rn in f32: h and h2 over their inputs
// in order, the level sums in tap order, the merge in row order; another
// order than the plain version's matmuls.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;     // a block; also the taps of one chunk
constexpr int kHidden = 32;       // C1 at most: the padded width of W1, W2
constexpr int kRow = kHidden + 1;  // a tap's row of relu(h2) in shared memory
constexpr int kMaxGroup = 8;      // queries a block takes at once
constexpr int kMaxOut = 128;      // Cout at most: 2 output slots of 64
constexpr int kGroupTaps = 512;   // a group spans about this many taps
constexpr int kLayerFloats = 4 * kHidden + kHidden + kHidden * kHidden + kHidden;

__device__ __forceinline__ float relu(float v) { return v < 0.f ? 0.f : v; }

// 16 bytes global -> shared, asynchronously
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// queries a block takes at once
__host__ __device__ __forceinline__ int group_queries(int taps) {
  const int q = kGroupTaps / taps;
  return q < 1 ? 1 : (q > kMaxGroup ? kMaxGroup : q);
}

size_t smem_bytes(int n_levels, int c1, int c_out) {
  const size_t lc = (size_t)n_levels * c1;
  return (kLayerFloats + lc * c_out + (size_t)kThreads * kRow + kMaxGroup * lc) * sizeof(float);
}

__global__ void __launch_bounds__(kThreads, 2) corr3d_tail_kernel(
    const float* __restrict__ xyz1, const float* __restrict__ xyz2,
    const int32_t* __restrict__ idx, const float* __restrict__ cost,
    const float* __restrict__ scale, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2,
    const float* __restrict__ wm, const float* __restrict__ bm,
    float* __restrict__ out, int queries, int n, int m_rows, int n_levels, int k,
    int c1, int c_out) {
  // [W1 4 x 32 | b1 32 | W2 32 x 32 | b2 32] (zero past c1), the merge
  // weights [L*c1][c_out], the taps' rows [256][33], the level sums
  // [kMaxGroup][L*c1]
  extern __shared__ __align__(16) float smem[];
  float* w1s = smem;
  float* b1s = w1s + 4 * kHidden;
  float* w2s = b1s + kHidden;
  float* b2s = w2s + kHidden * kHidden;
  float* wms = smem + kLayerFloats;
  const int lc = n_levels * c1;
  float* rows = wms + lc * c_out;
  float* sums = rows + kThreads * kRow;
  const int tid = threadIdx.x;

  for (int i = tid; i < kLayerFloats; i += kThreads) {
    float v = 0.f;
    if (i < 4 * kHidden) {
      const int r = i / kHidden, c = i % kHidden;
      if (c < c1) v = w1[r * c1 + c];
    } else if (i < 5 * kHidden) {
      const int c = i - 4 * kHidden;
      if (c < c1) v = b1[c];
    } else if (i < 5 * kHidden + kHidden * kHidden) {
      const int r = (i - 5 * kHidden) / kHidden, c = (i - 5 * kHidden) % kHidden;
      if (r < c1 && c < c1) v = w2[r * c1 + c];
    } else {
      const int c = i - 5 * kHidden - kHidden * kHidden;
      if (c < c1) v = b2[c];
    }
    smem[i] = v;
  }
  // the merge weights stay in flight while the first group's taps run:
  // 16-byte copies (wm is 16-byte aligned, which the wrapper checks), the
  // last few floats by plain loads
  const int merge = lc * c_out;
  for (int i = tid; i < merge / 4; i += kThreads) cp_async16(wms + 4 * i, wm + 4 * i);
  for (int i = merge / 4 * 4 + tid; i < merge; i += kThreads) wms[i] = wm[i];
  __syncthreads();
  bool merge_ready = false;  // uniform across the block

  const float4* w1v = reinterpret_cast<const float4*>(w1s);
  const float4* b1v = reinterpret_cast<const float4*>(b1s);
  const float4* w2v = reinterpret_cast<const float4*>(w2s);
  const float4* b2v = reinterpret_cast<const float4*>(b2s);
  const int taps = n_levels * k;
  const int group = group_queries(taps);
  const int groups = (queries + group - 1) / group;

  for (int g = blockIdx.x; g < groups; g += gridDim.x) {
    const int q0 = g * group;
    const int nq = queries - q0 < group ? queries - q0 : group;
    const int pairs = nq * taps;
    for (int c0 = 0; c0 < pairs; c0 += kThreads) {
      // the per-tap stage: pair c0 + tid = (query q0 + qq, tap t)
      const int p = c0 + tid;
      if (p < pairs) {
        const int qq = p / taps;
        const int q = q0 + qq;
        const size_t at = (size_t)q * taps + (p - qq * taps);
        const float* s = xyz2 + ((size_t)(q / n) * m_rows + idx[at]) * 3;
        const float rx = __fsub_rn(s[0], xyz1[(size_t)q * 3]);
        const float ry = __fsub_rn(s[1], xyz1[(size_t)q * 3 + 1]);
        const float rz = __fsub_rn(s[2], xyz1[(size_t)q * 3 + 2]);
        const float cv = scale != nullptr ? __fmul_rn(cost[at], scale[q]) : cost[at];
        float h[kHidden];
#pragma unroll
        for (int i = 0; i < kHidden / 4; ++i) {
          const float4 b = b1v[i], wx = w1v[i], wy = w1v[8 + i], wz = w1v[16 + i],
                       wc = w1v[24 + i];
          const float bb[4] = {b.x, b.y, b.z, b.w}, ax[4] = {wx.x, wx.y, wx.z, wx.w},
                      ay[4] = {wy.x, wy.y, wy.z, wy.w}, az[4] = {wz.x, wz.y, wz.z, wz.w},
                      ac[4] = {wc.x, wc.y, wc.z, wc.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v = __fmaf_rn(ax[j], rx, bb[j]);
            v = __fmaf_rn(ay[j], ry, v);
            v = __fmaf_rn(az[j], rz, v);
            h[4 * i + j] = relu(__fmaf_rn(ac[j], cv, v));
          }
        }
        float h2[kHidden];
#pragma unroll
        for (int c = 0; c < kHidden / 4; ++c) {
          const float4 b = b2v[c];
          h2[4 * c] = b.x, h2[4 * c + 1] = b.y, h2[4 * c + 2] = b.z, h2[4 * c + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < kHidden; ++i) {
#pragma unroll
          for (int c = 0; c < kHidden / 4; ++c) {
            const float4 w = w2v[i * (kHidden / 4) + c];
            h2[4 * c] = __fmaf_rn(w.x, h[i], h2[4 * c]);
            h2[4 * c + 1] = __fmaf_rn(w.y, h[i], h2[4 * c + 1]);
            h2[4 * c + 2] = __fmaf_rn(w.z, h[i], h2[4 * c + 2]);
            h2[4 * c + 3] = __fmaf_rn(w.w, h[i], h2[4 * c + 3]);
          }
        }
        float* row = rows + tid * kRow;
#pragma unroll
        for (int c = 0; c < kHidden; ++c) row[c] = relu(h2[c]);
      }
      __syncthreads();
      // the level sums: (query, level, channel) adds its taps in this chunk
      for (int e = tid; e < nq * lc; e += kThreads) {
        const int qq = e / lc;
        const int l = (e - qq * lc) / c1;
        const int ch = e - qq * lc - l * c1;
        const int first = qq * taps + l * k;
        const int lo = first > c0 ? first : c0;
        const int hi = first + k < c0 + kThreads ? first + k : c0 + kThreads;
        float sum = c0 == 0 ? 0.f : sums[e];
        for (int t = lo; t < hi; ++t) sum = __fadd_rn(sum, rows[(t - c0) * kRow + ch]);
        sums[e] = sum;
      }
      __syncthreads();
    }
    if (!merge_ready) {
      cp_async_wait_all();
      __syncthreads();
      merge_ready = true;
    }
    // the merge: queries r and r + 4, outputs o and o + 64
    const int o = tid % 64;
    const int r = tid / 64;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    for (int i = 0; i < lc; ++i) {
      const float wa = o < c_out ? wms[i * c_out + o] : 0.f;
      const float wb = o + 64 < c_out ? wms[i * c_out + o + 64] : 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float v = sums[(r + 4 * j) * lc + i];  // past nq: unused
        acc[j][0] = __fmaf_rn(wa, v, acc[j][0]);
        acc[j][1] = __fmaf_rn(wb, v, acc[j][1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (r + 4 * j >= nq) continue;
      float* oq = out + (size_t)(q0 + r + 4 * j) * c_out;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int co = o + 64 * u;
        if (co < c_out) {
          float v = __fadd_rn(acc[j][u], bm[co]);
          if (!(v > 0.f)) v = __fmul_rn(0.1f, v);
          oq[co] = v;
        }
      }
    }
    // the next group's per-tap stage writes only `rows`, and its level sums
    // come after a barrier: no barrier needed here
  }
}

}  // namespace

// w1 [4, c1], w2 [c1, c1], wm [n_levels * c1, c_out], each [in, out] f32;
// scale [batch * n] (one a query) or null.
extern "C" int camli_corr3d_tail(const float* xyz1, const float* xyz2, const int32_t* idx,
                                 const float* cost, const float* scale, const float* w1,
                                 const float* b1,
                                 const float* w2, const float* b2, const float* wm,
                                 const float* bm, float* out, int batch, int n, int m_rows,
                                 int n_levels, int k, int c1, int c_out, cudaStream_t stream) {
  if (c1 < 1 || c1 > kHidden || c_out < 1 || c_out > kMaxOut || n_levels < 1 || k < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int queries = batch * n;
  if (queries == 0) return 0;
  const size_t smem = smem_bytes(n_levels, c1, c_out);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // above 48 KB of shared memory only after this; refused if above the card's limit
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(corr3d_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, corr3d_tail_kernel, kThreads,
                                                        smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // reported here, not to the next launch
    return (int)err;
  }
  const int group = group_queries(n_levels * k);
  int blocks = (queries + group - 1) / group;
  if (per_sm > 0 && blocks > per_sm * sms) blocks = per_sm * sms;
  corr3d_tail_kernel<<<blocks, kThreads, smem, stream>>>(xyz1, xyz2, idx, cost, scale, w1, b1,
                                                         w2, b2, wm, bm, out, queries, n, m_rows,
                                                         n_levels, k, c1, c_out);
  return (int)cudaGetLastError();
}
