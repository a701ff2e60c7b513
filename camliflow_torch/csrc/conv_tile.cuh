// The f32 implicit-GEMM convolution tile of update2d.cu's fused RAFT
// iteration (#10), and the convolution description (Conv, the epilogues)
// that conv_tile_tc.cuh's tensor-core tile shares.
//
// A block computes 64 pixels x 64 output channels with 256 threads, each a
// 4x4 register tile; the reduction runs over (tap, input channel) in chunks
// of 16 staged in shared memory, so every loaded value feeds 4 fused
// multiply-adds per thread from registers. Zero padding at the borders is a
// predicate on the load (a horizontal tap at x = 0 or W-1 reads zero, never
// the neighbouring row). Up to three NHWC inputs are read as one virtual
// channel concat. Epilogues fuse the bias and the activation, or the GRU
// gates: the z|r conv writes z and r*h, the q conv writes
// h' = (1-z)*h + z*tanh(q). Weights arrive repacked once per request as
// [K_pad, N_pad] (row (ky*kw + kx)*Cin + ci, zero rows up to a multiple of 16
// and zero columns up to a multiple of 64), so the weight tile loads need no
// bounds checks. Every product-sum is an explicit __fmaf_rn (the library is
// built with -fmad=false, which does not touch explicit fused multiply-adds).
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction chunk
constexpr int kThreads = 256;

enum Epilogue { EPI_RELU = 0, EPI_NONE = 1, EPI_ZR = 2, EPI_GATE = 3, EPI_LEAKY = 4 };

struct Conv {
  const float* in0;  // virtual concat of up to three NHWC inputs
  const float* in1;
  const float* in2;
  int c0, c1, c2;
  const float* w;     // [K_pad, N_pad]
  const float* bias;  // [N_pad]
  int pixels, height, width, kh, kw;
  int cout, n_pad, k_total;
  float* out;  // out[p * out_stride + co]
  int out_stride;
  const float* h;  // ZR: r is applied to h; GATE: the previous state
  const float* z;  // GATE: the update gate
  float* out2;     // ZR: r * h
  int half;        // ZR: hidden channels (z in [0, half), r in [half, 2 half))
  const float* tail;  // copied to out[p, cout + j] for j < tail_c
  int tail_c;
  int nan_fix;  // nan_to_num on the stored value
};

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  return fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

typedef float TileA[BM + 4];
typedef float TileB[BN];

// One 64-pixel x 64-channel output tile at (p0, n0) of one convolution.
template <int EPI>
__device__ __forceinline__ void conv_tile(const Conv& a, int p0, int n0, TileA* As,
                                          TileB* Bs) {
  const int tid = threadIdx.x;
  const int cin = a.c0 + a.c1 + a.c2;
  const int hw = a.height * a.width;

  // load roles: A element (k = a_k, pixel rows a_m + 16 i), B float4
  const int a_k = tid % BK;
  const int a_m = tid / BK;
  int a_base[4], a_y[4], a_x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + a_m + 16 * i;
    const int b = p / hw;
    const int r = p - b * hw;
    a_y[i] = p < a.pixels ? r / a.width : -1000000;  // an invalid row
    a_x[i] = r - (r / a.width) * a.width;
    a_base[i] = b * hw;
  }
  const int b_row = tid / 16;
  const int b_col = (tid % 16) * 4;
  // compute role: pixels ty*4 + i, channels tx*4 + j
  const int tx = tid % 16;
  const int ty = tid / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < a.k_total; k0 += BK) {
    float va[4] = {0.f, 0.f, 0.f, 0.f};
    const int k = k0 + a_k;
    if (k < a.k_total) {
      const int tap = k / cin;
      const int ci = k - tap * cin;
      const int dy = tap / a.kw - (a.kh - 1) / 2;
      const int dx = tap % a.kw - (a.kw - 1) / 2;
      const float* src = a.in0;
      int cs = a.c0, cc = ci;
      if (ci >= a.c0 + a.c1) {
        src = a.in2;
        cs = a.c2;
        cc = ci - a.c0 - a.c1;
      } else if (ci >= a.c0) {
        src = a.in1;
        cs = a.c1;
        cc = ci - a.c0;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int iy = a_y[i] + dy;
        const int ix = a_x[i] + dx;
        if (iy >= 0 && iy < a.height && ix >= 0 && ix < a.width) {
          va[i] = src[((size_t)a_base[i] + (size_t)iy * a.width + ix) * cs + cc];
        }
      }
    }
    const float4 wv = *reinterpret_cast<const float4*>(
        a.w + (size_t)(k0 + b_row) * a.n_pad + n0 + b_col);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < 4; ++i) As[a_k][a_m + 16 * i] = va[i];
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = wv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(ar[i], br[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = p0 + ty * 4 + i;
    if (p >= a.pixels) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= a.cout) continue;
      float v = acc[i][j] + a.bias[co];
      if (EPI == EPI_RELU) {
        v = v < 0.f ? 0.f : v;
      } else if (EPI == EPI_ZR) {
        v = sigmoid(v);
        if (co < a.half) {
          a.out[(size_t)p * a.half + co] = v;
        } else {
          const size_t at = (size_t)p * a.half + (co - a.half);
          a.out2[at] = v * a.h[at];
        }
        continue;
      } else if (EPI == EPI_GATE) {
        const size_t at = (size_t)p * a.cout + co;
        const float zv = a.z[at];
        v = (1.f - zv) * a.h[at] + zv * tanhf(v);
      }
      if (a.nan_fix) v = nan_to_num(v);
      a.out[(size_t)p * a.out_stride + co] = v;
    }
  }
  if (a.tail_c > 0 && n0 == 0) {
    for (int t = tid; t < BM * a.tail_c; t += kThreads) {
      const int p = p0 + t / a.tail_c;
      const int j = t % a.tail_c;
      if (p < a.pixels) {
        a.out[(size_t)p * a.out_stride + a.cout + j] = a.tail[(size_t)p * a.tail_c + j];
      }
    }
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ __forceinline__ int tile_count(const Conv& a) {
  return (a.pixels + BM - 1) / BM * (a.n_pad / BN);
}

// Fills the shape fields of a convolution.
Conv shaped(Conv a, int kh, int kw, int cout) {
  a.kh = kh;
  a.kw = kw;
  a.cout = cout;
  a.n_pad = round_up(cout, BN);
  a.k_total = kh * kw * (a.c0 + a.c1 + a.c2);
  if (a.out_stride == 0) a.out_stride = cout;
  return a;
}

Conv input(int pixels, int height, int width, const float* in0, int c0,
           const float* in1 = nullptr, int c1 = 0, const float* in2 = nullptr,
           int c2 = 0) {
  Conv a = {};
  a.pixels = pixels;
  a.height = height;
  a.width = width;
  a.in0 = in0;
  a.c0 = c0;
  a.in1 = in1;
  a.c1 = c1;
  a.in2 = in2;
  a.c2 = c2;
  return a;
}

}  // namespace
