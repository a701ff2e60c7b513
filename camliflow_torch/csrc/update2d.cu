// The 2D update chain: direct-convolution stages of one templated tile.
//
// camli_motion_encoder_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::motion_encoder_2d_pallas:
//   conv_c1 1x1 (324->256), conv_c2 3x3 (256->192), conv_f2 3x3 (128->64),
//   merge 3x3 over [cf, ff] (256->126), all ReLU, nan_to_num, then the flow
//   appended as the last 2 channels. conv_f1 (7x7, 2->128) runs outside, in
//   the wrapper, as the JAX wrapper leaves it to XLA. 4 launches.
// camli_gru_flowhead_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::gru_flowhead_2d_pallas:
//   the separable ConvGRU (1x5 then 5x1; z and r from one conv whose output
//   stacks both weights, then q) over hx = [h, x2d, motion], nan_to_num of
//   the new hidden state after both directions (as models/raft.py::GRU2D),
//   then the flow head 3x3 (128->256) ReLU, 3x3 (256->2), nan_to_num.
//   6 launches.
// camli_update_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::update_2d_pallas: the whole RAFT
//   iteration (the motion encoder, then the GRU and the flow head) as ONE
//   launch, so that the motion features never leave the kernel's scratch
//   (at 68x120 the whole scratch, 33 MB, fits in the 50 MB L2). It is a
//   persistent cooperative kernel (cudaLaunchCooperativeKernel, a grid no
//   larger than the co-resident block count): 9 stages, [c1 | f2] -> c2 ->
//   merge (+ flow tail) -> zr1 -> q1 -> zr2 -> q2 -> head1 -> head2, each a
//   loop of the block over the stage's 64 x 64 tiles, with a grid-wide
//   barrier between dependent stages. The barrier is written by hand (one
//   arrival word in global memory whose top bit flips when the last block
//   arrives, as cooperative_groups does it), which a cooperative launch
//   makes safe: every block of the grid is resident. Tiles are dealt to the
//   blocks SM by SM (`spread_rank`), so that a stage with fewer tiles than
//   blocks spreads over the card. A refused launch returns its error; the
//   wrapper raises.
//
// Numerics: f32 operands, f32 accumulation, every product-sum an explicit
// __fmaf_rn (the library is built with -fmad=false, which does not touch
// explicit fused multiply-adds). This is the port's exact path; the TPU
// kernels' bf16 operands belong to its fast path, not ported yet.
//
// Bound on the card, at the flagship shape (1 x 68 x 120 = 8160 pixels):
// the motion encoder is 14.5 GFLOP per call (c1 1.35, c2 7.22, f2 1.20,
// merge 4.74) and moves ~18 MB (corr 10.6 MB, weights 3.6 MB, output
// 4.2 MB); the GRU + flow head is 29.0 GFLOP (zr 2 x 8.02, q 2 x 4.01,
// head 4.81 + 0.08) over ~24 MB. At 67 TFLOP/s of f32 outside the tensor
// cores that is 0.22 ms and 0.43 ms against ~7 us of memory traffic at
// 3.35 TB/s: both are bound by operations, and so is the fused iteration
// (43.5 GFLOP, 0.65 ms).
//
// Design, for that bound: implicit GEMM on NHWC f32. A block computes 64
// pixels x 64 output channels with 256 threads, each a 4x4 register tile;
// the reduction runs over (tap, input channel) in chunks of 16 staged in
// shared memory, so every loaded value feeds 4 (A) or 4 (B) fused
// multiply-adds per thread from registers. Zero padding at the borders is a
// predicate on the load (a horizontal tap at x = 0 or W-1 reads zero, never
// the neighbouring row). Up to three NHWC inputs are read as one virtual
// channel concat, so hx, [r*h, x2d, motion] and [cf, ff] are never formed.
// Epilogues fuse the bias and ReLU, or the GRU gates: the z|r conv writes z
// and r*h, the q conv writes h' = (1-z)*h + z*tanh(q). Weights arrive
// repacked once per request as [K_pad, N_pad] (row (ky*kw + kx)*Cin + ci,
// zero rows up to a multiple of 16 and zero columns up to a multiple of
// 64), so the weight tile loads need no bounds checks.
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction chunk
constexpr int kThreads = 256;

enum Epilogue { EPI_RELU = 0, EPI_NONE = 1, EPI_ZR = 2, EPI_GATE = 3 };

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

template <int EPI>
__global__ void __launch_bounds__(kThreads) conv_kernel(const Conv a) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  conv_tile<EPI>(a, blockIdx.x * BM, blockIdx.y * BN, As, Bs);
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

__host__ __device__ __forceinline__ int tile_count(const Conv& a) {
  return (a.pixels + BM - 1) / BM * (a.n_pad / BN);
}

// One stage of the fused iteration: the block with rank `rank` walks tiles
// rank, rank + grid, ... of `a`, then of `b` when `two` (two independent
// convolutions in one stage).
template <int EPI>
__device__ __forceinline__ void stage(int rank, const Conv& a, const Conv& b, bool two,
                                      TileA* As, TileB* Bs) {
  const int m_a = (a.pixels + BM - 1) / BM;
  const int t_a = tile_count(a);
  const int total = t_a + (two ? tile_count(b) : 0);
  for (int t = rank; t < total; t += gridDim.x) {
    if (t < t_a) {
      conv_tile<EPI>(a, (t % m_a) * BM, (t / m_a) * BN, As, Bs);
    } else {
      const int m_b = (b.pixels + BM - 1) / BM;
      const int u = t - t_a;
      conv_tile<EPI>(b, (u % m_b) * BM, (u / m_b) * BN, As, Bs);
    }
  }
}

// Grid-wide barrier for a cooperative launch: every block's thread 0 adds
// to one arrival word, block 0 adds 0x80000000 - (blocks - 1) and the others
// 1, so the word's top bit flips once all have arrived and its low bits come
// back to where they were. The fences make the stage's stores visible to
// every block's loads after the barrier.
__device__ __forceinline__ void grid_barrier(unsigned int* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(arrived, add);
    volatile unsigned int* word = arrived;
    while (((old ^ *word) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ unsigned sm_id() {
  unsigned v;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(v));
  return v;
}

__device__ __forceinline__ unsigned sm_id_count() {
  unsigned v;
  asm volatile("mov.u32 %0, %%nsmid;" : "=r"(v));
  return v;
}

constexpr unsigned kMaxSmIds = 1024;  // per-SM block counts after the barrier word

// The block's rank in the order (slot on its SM, SM): tiles are dealt by
// rank, so consecutive tiles go to different SMs. A cooperative grid is
// placed SM by SM (consecutive blocks share an SM), and in blockIdx order a
// stage with fewer tiles than blocks would crowd onto a few SMs. Each block
// counts itself on its SM, and after a barrier its rank is the number of
// blocks before it: sum over SMs of min(count, slot), plus the SMs before
// its own that hold more than `slot` blocks.
__device__ __forceinline__ int spread_rank(unsigned int* barrier) {
  __shared__ int rank;
  unsigned int* counts = barrier + 1;
  const unsigned n_ids = sm_id_count();
  unsigned sm = 0, slot = 0;
  if (threadIdx.x == 0 && n_ids <= kMaxSmIds) {
    sm = sm_id();
    slot = atomicAdd(&counts[sm], 1u);
  }
  grid_barrier(barrier);
  if (threadIdx.x == 0) {
    int r = blockIdx.x;  // the blockIdx order where the SM ids do not fit
    if (n_ids <= kMaxSmIds) {
      r = 0;
      const volatile unsigned int* c = counts;
      for (unsigned s = 0; s < n_ids; ++s) {
        const unsigned n = c[s];
        r += n < slot ? n : slot;
        r += s < sm && n > slot;
      }
    }
    rank = r;
  }
  __syncthreads();
  return rank;
}

struct Update2D {
  Conv c1, f2, c2, merge, zr[2], q[2], head1, head2;
  unsigned int* barrier;  // [1 + kMaxSmIds], zeroed: the arrival word, counts
};

__global__ void __launch_bounds__(kThreads) update2d_kernel(const Update2D u) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int r = spread_rank(u.barrier);
  stage<EPI_RELU>(r, u.c1, u.f2, true, As, Bs);  // independent: one stage
  grid_barrier(u.barrier);
  stage<EPI_RELU>(r, u.c2, u.c2, false, As, Bs);
  grid_barrier(u.barrier);
  stage<EPI_RELU>(r, u.merge, u.merge, false, As, Bs);
  grid_barrier(u.barrier);
  stage<EPI_ZR>(r, u.zr[0], u.zr[0], false, As, Bs);
  grid_barrier(u.barrier);
  stage<EPI_GATE>(r, u.q[0], u.q[0], false, As, Bs);
  grid_barrier(u.barrier);
  stage<EPI_ZR>(r, u.zr[1], u.zr[1], false, As, Bs);
  grid_barrier(u.barrier);
  stage<EPI_GATE>(r, u.q[1], u.q[1], false, As, Bs);
  grid_barrier(u.barrier);
  stage<EPI_RELU>(r, u.head1, u.head1, false, As, Bs);
  grid_barrier(u.barrier);
  stage<EPI_NONE>(r, u.head2, u.head2, false, As, Bs);
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

// One convolution as its own launch.
int run_conv(Conv a, int epi, int kh, int kw, int cout, cudaStream_t stream) {
  a = shaped(a, kh, kw, cout);
  const dim3 grid((a.pixels + BM - 1) / BM, a.n_pad / BN);
  switch (epi) {
    case EPI_RELU:
      conv_kernel<EPI_RELU><<<grid, kThreads, 0, stream>>>(a);
      break;
    case EPI_NONE:
      conv_kernel<EPI_NONE><<<grid, kThreads, 0, stream>>>(a);
      break;
    case EPI_ZR:
      conv_kernel<EPI_ZR><<<grid, kThreads, 0, stream>>>(a);
      break;
    default:
      conv_kernel<EPI_GATE><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
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

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

extern "C" int camli_motion_encoder_2d(
    const float* flow, const float* ff1, const float* corr, const float* w_c1,
    const float* b_c1, const float* w_c2, const float* b_c2, const float* w_f2,
    const float* b_f2, const float* w_m, const float* b_m, float* cf1, float* cf,
    float* ff, float* out, int batch, int height, int width, int c_corr,
    int c_c1, int c_c2, int c_f1, int c_f2, int c_m, cudaStream_t stream) {
  const int pixels = batch * height * width;
  Conv a = input(pixels, height, width, corr, c_corr);
  a.w = w_c1, a.bias = b_c1, a.out = cf1;
  CAMLI_TRY(run_conv(a, EPI_RELU, 1, 1, c_c1, stream));
  a = input(pixels, height, width, cf1, c_c1);
  a.w = w_c2, a.bias = b_c2, a.out = cf;
  CAMLI_TRY(run_conv(a, EPI_RELU, 3, 3, c_c2, stream));
  a = input(pixels, height, width, ff1, c_f1);
  a.w = w_f2, a.bias = b_f2, a.out = ff;
  CAMLI_TRY(run_conv(a, EPI_RELU, 3, 3, c_f2, stream));
  a = input(pixels, height, width, cf, c_c2, ff, c_f2);
  a.w = w_m, a.bias = b_m, a.out = out, a.out_stride = c_m + 2;
  a.tail = flow, a.tail_c = 2, a.nan_fix = 1;
  return run_conv(a, EPI_RELU, 3, 3, c_m, stream);
}

extern "C" int camli_gru_flowhead_2d(
    const float* h, const float* x2d, const float* motion, const float* w_zr1,
    const float* b_zr1, const float* w_q1, const float* b_q1, const float* w_zr2,
    const float* b_zr2, const float* w_q2, const float* b_q2, const float* w_h1,
    const float* b_h1, const float* w_h2, const float* b_h2, float* z, float* rh,
    float* h1, float* mid, float* h_out, float* delta, int batch, int height,
    int width, int c_h, int c_x, int c_m, int c_mid, cudaStream_t stream) {
  const int pixels = batch * height * width;
  const float* state = h;
  const float* w_zr[2] = {w_zr1, w_zr2};
  const float* b_zr[2] = {b_zr1, b_zr2};
  const float* w_q[2] = {w_q1, w_q2};
  const float* b_q[2] = {b_q1, b_q2};
  float* next[2] = {h1, h_out};
  for (int d = 0; d < 2; ++d) {
    const int kh = d == 0 ? 1 : 5;
    const int kw = d == 0 ? 5 : 1;
    Conv a = input(pixels, height, width, state, c_h, x2d, c_x, motion, c_m);
    a.w = w_zr[d], a.bias = b_zr[d], a.out = z, a.out2 = rh, a.h = state;
    a.half = c_h;
    CAMLI_TRY(run_conv(a, EPI_ZR, kh, kw, 2 * c_h, stream));
    a = input(pixels, height, width, rh, c_h, x2d, c_x, motion, c_m);
    a.w = w_q[d], a.bias = b_q[d], a.out = next[d], a.h = state, a.z = z;
    a.nan_fix = d == 1;  // nan_to_num once, after both directions
    CAMLI_TRY(run_conv(a, EPI_GATE, kh, kw, c_h, stream));
    state = next[d];
  }
  Conv a = input(pixels, height, width, h_out, c_h);
  a.w = w_h1, a.bias = b_h1, a.out = mid;
  CAMLI_TRY(run_conv(a, EPI_RELU, 3, 3, c_mid, stream));
  a = input(pixels, height, width, mid, c_mid);
  a.w = w_h2, a.bias = b_h2, a.out = delta, a.nan_fix = 1;
  return run_conv(a, EPI_NONE, 3, 3, 2, stream);
}

extern "C" int camli_update_2d(
    const float* h, const float* x2d, const float* flow, const float* ff1,
    const float* corr, const float* w_c1, const float* b_c1, const float* w_c2,
    const float* b_c2, const float* w_f2, const float* b_f2, const float* w_m,
    const float* b_m, const float* w_zr1, const float* b_zr1, const float* w_q1,
    const float* b_q1, const float* w_zr2, const float* b_zr2, const float* w_q2,
    const float* b_q2, const float* w_h1, const float* b_h1, const float* w_h2,
    const float* b_h2, float* scratch, unsigned int* barrier, float* h_out,
    float* delta, int batch, int height, int width, int c_corr, int c_c1,
    int c_c2, int c_f1, int c_f2, int c_m, int c_h, int c_x, int c_mid,
    int grid_blocks, cudaStream_t stream) {
  // barrier: [1 + kMaxSmIds] words of scratch (the wrapper allocates them)
  const int pixels = batch * height * width;
  // scratch, channels per pixel: [max(c_c1, c_mid) | c_c2 | c_f2 | c_m + 2 |
  // 3 x c_h]; the first region holds cf1, then the flow head's mid
  const size_t p = pixels;
  float* wide = scratch;
  float* cf = wide + p * (c_c1 > c_mid ? c_c1 : c_mid);
  float* ff = cf + p * c_c2;
  float* motion = ff + p * c_f2;
  float* z = motion + p * (c_m + 2);
  float* rh = z + p * c_h;
  float* h1 = rh + p * c_h;

  Update2D u;
  Conv a = input(pixels, height, width, corr, c_corr);
  a.w = w_c1, a.bias = b_c1, a.out = wide;
  u.c1 = shaped(a, 1, 1, c_c1);
  a = input(pixels, height, width, ff1, c_f1);
  a.w = w_f2, a.bias = b_f2, a.out = ff;
  u.f2 = shaped(a, 3, 3, c_f2);
  a = input(pixels, height, width, wide, c_c1);
  a.w = w_c2, a.bias = b_c2, a.out = cf;
  u.c2 = shaped(a, 3, 3, c_c2);
  a = input(pixels, height, width, cf, c_c2, ff, c_f2);
  a.w = w_m, a.bias = b_m, a.out = motion, a.out_stride = c_m + 2;
  a.tail = flow, a.tail_c = 2, a.nan_fix = 1;
  u.merge = shaped(a, 3, 3, c_m);
  const float* state = h;
  const float* w_zr[2] = {w_zr1, w_zr2};
  const float* b_zr[2] = {b_zr1, b_zr2};
  const float* w_q[2] = {w_q1, w_q2};
  const float* b_q[2] = {b_q1, b_q2};
  float* next[2] = {h1, h_out};
  for (int d = 0; d < 2; ++d) {
    const int kh = d == 0 ? 1 : 5;
    const int kw = d == 0 ? 5 : 1;
    a = input(pixels, height, width, state, c_h, x2d, c_x, motion, c_m + 2);
    a.w = w_zr[d], a.bias = b_zr[d], a.out = z, a.out2 = rh, a.h = state;
    a.half = c_h;
    u.zr[d] = shaped(a, kh, kw, 2 * c_h);
    a = input(pixels, height, width, rh, c_h, x2d, c_x, motion, c_m + 2);
    a.w = w_q[d], a.bias = b_q[d], a.out = next[d], a.h = state, a.z = z;
    a.nan_fix = d == 1;  // nan_to_num once, after both directions
    u.q[d] = shaped(a, kh, kw, c_h);
    state = next[d];
  }
  a = input(pixels, height, width, h_out, c_h);
  a.w = w_h1, a.bias = b_h1, a.out = wide;
  u.head1 = shaped(a, 3, 3, c_mid);
  a = input(pixels, height, width, wide, c_mid);
  a.w = w_h2, a.bias = b_h2, a.out = delta, a.nan_fix = 1;
  u.head2 = shaped(a, 3, 3, 2);
  u.barrier = barrier;

  int grid = grid_blocks;  // > 0: asked for (the tests ask for too many)
  if (grid <= 0) {
    int device = 0, sms = 0, per_sm = 0;
    CAMLI_TRY(cudaGetDevice(&device));
    CAMLI_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device));
    CAMLI_TRY(cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, update2d_kernel,
                                                            kThreads, 0));
    const Conv* stages[] = {&u.c2, &u.merge, &u.zr[0], &u.q[0], &u.head1, &u.head2};
    int most = tile_count(u.c1) + tile_count(u.f2);
    for (const Conv* c : stages) most = tile_count(*c) > most ? tile_count(*c) : most;
    grid = per_sm * sms < most ? per_sm * sms : most;
  }
  CAMLI_TRY(cudaMemsetAsync(barrier, 0, (1 + kMaxSmIds) * sizeof(unsigned int), stream));
  void* args[] = {&u};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      (const void*)update2d_kernel, dim3(grid), dim3(kThreads), args, 0, stream);
  cudaGetLastError();  // a refused launch is reported once, here, not to the next launch
  return (int)err;
}
