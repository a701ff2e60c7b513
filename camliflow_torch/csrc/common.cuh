// Shared device helpers for the point-cloud selection kernels: the
// distance, the sorted insert of one scan, and the merge of the sorted lists
// of a scan split into slices.
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

}  // namespace camli

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
