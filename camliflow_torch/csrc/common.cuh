// Shared device helpers for the point-cloud selection kernels: the
// distance, the sorted insert of one scan, the merge of the sorted lists of
// a scan split into slices, and the whole split selection of KNN (#1) and
// the interpolation (#3).
//
// Every squared distance is written out per coordinate with round-to-nearest
// intrinsics, in the order ((dx*dx + dy*dy) + dz*dz). The plain PyTorch
// versions compute the same expression with one rounding per operation, so a
// kernel and its plain version see bit-identical distances and select the
// same neighbours, ties included. (The library is also built with
// -fmad=false, so no multiply-add is contracted anywhere.)
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace camli {

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Insert (d, i) into the ascending list (D, I) of K entries, dropping the
// last. Candidates arrive in ascending index order and an entry moves back
// only for a strictly smaller distance, so equal distances keep the lowest
// index first, as lax.top_k and a stable sort do. Every index is a
// compile-time constant after unrolling, so the list lives in registers.
template <int K>
__device__ __forceinline__ void insert_sorted(float (&D)[K], int (&I)[K],
                                              float d, int i) {
  if (!(d < D[K - 1])) return;
#pragma unroll
  for (int j = K - 1; j > 0; --j) {
    if (D[j - 1] > d) {
      D[j] = D[j - 1];
      I[j] = I[j - 1];
    } else if (D[j] > d) {
      D[j] = d;
      I[j] = i;
    }
  }
  if (D[0] > d) {
    D[0] = d;
    I[0] = i;
  }
}

template <int K>
__device__ __forceinline__ void init_list(float (&D)[K], int (&I)[K]) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    D[j] = CUDART_INF_F;
    I[j] = 0;
  }
}

// One merge step of a split scan, by the 32 lanes of a warp: the ascending
// K-lists (ad, ai) and (bd, bi) in shared memory, each kept by
// insert_sorted over its own slice of the candidates, every index of a's
// slices below every index of b's, become in (ad, ai) the K first of their
// union in (distance, index) order. Entry e of a takes place
// e + #{b : d_b < d_a}, entry e of b place e + #{a : d_a <= d_b}: on equal
// distances list a, the lower indices, comes first. So the places are
// distinct, and the merge of a scan's slices in ascending order keeps what
// one insert_sorted over all of them would keep, ties included.
template <int K>
__device__ __forceinline__ void merge_sorted(float* ad, int* ai, const float* bd,
                                             const int* bi) {
  constexpr int kPer = (2 * K + 31) / 32;  // entries a lane places
  const int lane = threadIdx.x % 32;
  float d[kPer];
  int id[kPer], place[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int e = lane + 32 * r;
    const bool in_a = e < K;
    const int pos = in_a ? e : e - K;
    d[r] = 0.f;
    id[r] = 0;
    place[r] = K;  // dropped
    if (e < 2 * K) {
      d[r] = in_a ? ad[pos] : bd[pos];
      id[r] = in_a ? ai[pos] : bi[pos];
      const float* other = in_a ? bd : ad;
      int before = pos;
#pragma unroll
      for (int j = 0; j < K; ++j) before += in_a ? (other[j] < d[r]) : (other[j] <= d[r]);
      place[r] = before;
    }
  }
  __syncwarp();  // every lane has read both lists
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (place[r] < K) {
      ad[place[r]] = d[r];
      ai[place[r]] = id[r];
    }
  }
  __syncwarp();
}

// Slice s of a split scan over m candidates in n_slices slices covers
// [slice_start(m, s, n), slice_start(m, s + 1, n)): even lengths in whole
// warp steps of 128 candidates (kSelectStep), the last slice ending at m.
__host__ __device__ inline int slice_start(int m, int s, int n_slices) {
  const int start = 128 * (int)((long long)((m + 127) / 128) * s / n_slices);
  return start < m ? start : m;
}

constexpr int kSelectChunk = 8192;  // candidates split_select stages at once
constexpr int kSelectLane = 4;  // consecutive candidates a lane takes a step
constexpr int kSelectStep = 32 * kSelectLane;  // candidates a warp takes a step
constexpr int kSelectMaxWarps = 32;  // a split_select block's (query group, slice) warps
constexpr unsigned kFullMask = 0xffffffffu;

// A staged plane of split_select: a chunk padded to whole steps.
__host__ __device__ inline int split_select_plane(int m) {
  return ((m < kSelectChunk ? m : kSelectChunk) + kSelectStep - 1) / kSelectStep * kSelectStep;
}

// The shared memory split_select takes: the staged candidates' planes and
// both lists of every (query, slice).
__host__ __device__ inline size_t split_select_smem(int m, int queries, int n_slices, int kl) {
  return sizeof(float) * (3 * (size_t)split_select_plane(m) +
                          2 * (size_t)queries * ((size_t)n_slices * kl + 1));
}

// Insert a candidate of a warp's step (distance d in lane src, index
// `index`) into a sorted list spread over the warp's lanes, entry e in lane
// e (D, I), after every entry not farther, dropping the last. `last`, in
// every lane, is the list's last distance or a larger one: a candidate not
// nearer than it is skipped, and one not nearer than the true last finds
// every entry not farther (pos = KL) and changes nothing.
template <int KL>
__device__ __forceinline__ void warp_insert(float& D, int& I, float last, float d, int src,
                                            int index) {
  const int lane = threadIdx.x % 32;
  const float dn = __shfl_sync(kFullMask, d, src);
  if (!(dn < last)) return;
  const int pos = __popc(__ballot_sync(kFullMask, lane < KL && D <= dn));
  const float up_d = __shfl_up_sync(kFullMask, D, 1);
  const int up_i = __shfl_up_sync(kFullMask, I, 1);
  if (lane == pos) {
    D = dn;
    I = index;
  } else if (lane > pos && lane < KL) {
    D = up_d;
    I = up_i;
  }
}

// The KL-th smallest of the 32 lanes' values v (KL <= 32), in every lane: a
// bitonic sort across the warp.
template <int KL>
__device__ __forceinline__ float warp_kth(float v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const float other = __shfl_xor_sync(kFullMask, v, stride);
      const bool ascending = (lane & size) == 0;
      const bool lower = (lane & stride) == 0;
      v = lower == ascending ? fminf(v, other) : fmaxf(v, other);
    }
  }
  return __shfl_sync(kFullMask, v, KL - 1);
}

// The KL nearest of m candidates (sp [m][3], global) for `count` <= queries
// queries (qp [count][3], global) by one block of (queries / R) * n_slices
// warps: a split scan, then a warp merge.
//
// Warp w scans slice w / (queries / R) for the R queries of group
// w % (queries / R) in ascending index, 128 candidates a step, 4
// consecutive ones a lane, from shared memory (the candidates are staged
// there as x, y, z planes, kSelectChunk at a time, padded to whole steps
// with points at infinity, which never enter a list; a lane's 4 candidates
// are one 16-byte load a plane, and a step's loads serve R queries). For
// each query the warp keeps a sorted list spread over its lanes, entry e in
// lane e: a step's candidates nearer than the list's last entry enter one
// by one in ascending index (the lowest lane with one, its passing ones in
// order, then a new ballot against the new last entry), each after every
// entry not farther, the last dropped. That is camli::insert_sorted over the slice,
// ties included, at a few warp instructions an insert instead of a KL-step
// insert a lane; and inserts are rare once the list is full. While the list
// is not full, a step's candidates farther than the KL-th smallest of its
// lanes' nearest (KL other candidates of the step beat them) are skipped,
// so the first step does not insert all 128.
// A slice shorter than KL leaves (inf, 0) entries, which every real
// candidate precedes. The lists go to shared memory; then a warp per query
// merges its slices' lists in ascending order with merge_sorted and calls
// emit(q, d, i) with every lane, where (d, i) hold the query's KL nearest
// in (distance, index) order: the stable sort's selection, ties included.
template <int KL, int R, typename Emit>
__device__ __forceinline__ void split_select(const float* __restrict__ sp, int m,
                                             const float* __restrict__ qp, int count,
                                             int queries, int n_slices, float* smem,
                                             Emit emit) {
  const int chunk = min(m, kSelectChunk);
  const int plane = split_select_plane(m);
  float* xs = smem;
  float* ys = xs + plane;
  float* zs = ys + plane;
  const int stride = n_slices * KL + 1;  // one query's lists (+1: no bank conflicts)
  float* list_d = zs + plane;
  int* list_i = reinterpret_cast<int*>(list_d + queries * stride);
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int groups = queries / R;
  const int q0 = (warp % groups) * R;  // the warp's first query
  const int s = warp / groups;
  const bool active = s < n_slices && q0 < count;  // the same in every lane of the warp
  const int lo = slice_start(m, s, n_slices);
  const int hi = slice_start(m, s + 1, n_slices);
  float qx[R], qy[R], qz[R], D[R], last[R];
  int I[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool real = active && q0 + r < count;
    qx[r] = real ? qp[3 * (q0 + r)] : 0.f;
    qy[r] = real ? qp[3 * (q0 + r) + 1] : 0.f;
    qz[r] = real ? qp[3 * (q0 + r) + 2] : 0.f;
    D[r] = CUDART_INF_F;  // entry `lane` of query r's list (lanes < KL)
    I[r] = 0;
    last[r] = real ? CUDART_INF_F : -CUDART_INF_F;  // the list's last distance; none enter
  }
  for (int c0 = 0; c0 < m; c0 += chunk) {
    const int c1 = min(m, c0 + chunk);
    __syncthreads();  // the previous chunk is scanned
    for (int f = threadIdx.x; f < 3 * (c1 - c0); f += blockDim.x) {
      const float v = __ldg(sp + 3 * (size_t)c0 + f);
      const int j = f / 3;
      const int axis = f - 3 * j;
      (axis == 0 ? xs : axis == 1 ? ys : zs)[j] = v;
    }
    for (int j = c1 - c0 + threadIdx.x; j < plane; j += blockDim.x) {
      xs[j] = ys[j] = zs[j] = CUDART_INF_F;  // the last step's padding
    }
    __syncthreads();
    if (!active) continue;
    // the slice's steps in this chunk, in float4s (lo and c0 are whole steps)
    const int first = (max(lo, c0) - c0) / kSelectLane;
    const int stop = (min(hi, c1) - c0 + kSelectLane - 1) / kSelectLane;
    const float4* xv = reinterpret_cast<const float4*>(xs) + lane;
    const float4* yv = reinterpret_cast<const float4*>(ys) + lane;
    const float4* zv = reinterpret_cast<const float4*>(zs) + lane;
    for (int t = first; t < stop; t += 32) {
      const float4 px = xv[t], py = yv[t], pz = zv[t];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d[kSelectLane] = {sq_dist(qx[r], qy[r], qz[r], px.x, py.x, pz.x),
                                      sq_dist(qx[r], qy[r], qz[r], px.y, py.y, pz.y),
                                      sq_dist(qx[r], qy[r], qz[r], px.z, py.z, pz.z),
                                      sq_dist(qx[r], qy[r], qz[r], px.w, py.w, pz.w)};
        float near = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
        if (!(near == near)) near = CUDART_INF_F;  // four NaNs
        // the bar a lane's nearest must pass: below the last entry, or while
        // the list is not full, not above the KL-th nearest lane of the step
        float bar = last[r];
        bool pass_equal = false;
        if (bar == CUDART_INF_F) {
          bar = warp_kth<KL>(near);
          pass_equal = bar != CUDART_INF_F;
        }
        unsigned pass = __ballot_sync(kFullMask, near < bar || (pass_equal && near == bar));
        unsigned below[kSelectLane];  // the lanes whose u-th candidate passes the bar
#pragma unroll
        for (int u = 0; u < kSelectLane; ++u) below[u] = __ballot_sync(kFullMask, d[u] <= bar);
        while (pass) {
          const int src = __ffs(pass) - 1;
          const int index = c0 + kSelectLane * (t + src);  // its first candidate
#pragma unroll
          for (int u = 0; u < kSelectLane; ++u) {
            if (below[u] >> src & 1u) warp_insert<KL>(D[r], I[r], last[r], d[u], src, index + u);
          }
          last[r] = __shfl_sync(kFullMask, D[r], KL - 1);
          // the lanes above src whose nearest still passes
          const bool still = near < last[r] && (near < bar || (pass_equal && near == bar));
          pass = __ballot_sync(kFullMask, still) & ~(0xffffffffu >> (31 - src));
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (active && q0 + r < count && lane < KL) {
      list_d[(q0 + r) * stride + s * KL + lane] = D[r];
      list_i[(q0 + r) * stride + s * KL + lane] = I[r];
    }
  }
  __syncthreads();
  for (int qi = warp; qi < count; qi += blockDim.x / 32) {
    float* md = list_d + qi * stride;
    int* mi = list_i + qi * stride;
    for (int t = 1; t < n_slices; ++t) {
      merge_sorted<KL>(md, mi, md + t * KL, mi + t * KL);
    }
    emit(qi, md, mi);
  }
}

// Launch a split_select kernel, kernel<KL, R>, at list length kl and R =
// group queries a warp: the shared memory it takes, raised past 48 KB where
// needed, then the launch on queries / group * n_slices warps a block.
// Returns a cudaError_t.
template <typename... Params, typename... Args>
inline int launch_select(void (*kernel)(Params...), int kl, int group, int m, int queries,
                         int n_slices, dim3 grid, cudaStream_t stream, Args... args) {
  if (queries % group || (long long)(queries / group) * n_slices > kSelectMaxWarps) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = split_select_smem(m, queries, n_slices, kl);
  if (smem > 232448) return (int)cudaErrorInvalidValue;  // 227 KB, a block's most
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // reported here; leave it for no later check
      return (int)err;
    }
  }
  kernel<<<grid, 32 * (queries / group) * n_slices, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace camli

// Dispatch a runtime group of queries a warp (1 or 2) to R.
#define CAMLI_DISPATCH_GROUP(group, ...) \
  if ((group) == 1) {                    \
    constexpr int R = 1;                 \
    __VA_ARGS__;                         \
  } else if ((group) == 2) {             \
    constexpr int R = 2;                 \
    __VA_ARGS__;                         \
  }

// Dispatch a runtime k (<= 32) to the smallest compiled list length that
// holds it. The first k entries of a sorted K-list are the k nearest.
#define CAMLI_DISPATCH_K(k, ...)            \
  if ((k) <= 4) {                           \
    constexpr int KL = 4;                   \
    __VA_ARGS__;                            \
  } else if ((k) <= 8) {                    \
    constexpr int KL = 8;                   \
    __VA_ARGS__;                            \
  } else if ((k) <= 16) {                   \
    constexpr int KL = 16;                  \
    __VA_ARGS__;                            \
  } else {                                  \
    constexpr int KL = 32;                  \
    __VA_ARGS__;                            \
  }
