// The 2D update chain.
//
// camli_motion_encoder_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::motion_encoder_2d_pallas:
//   conv_c1 1x1 (324->256), conv_c2 3x3 (256->192), conv_f2 3x3 (128->64),
//   merge 3x3 over [cf, ff] (256->126), all ReLU, nan_to_num, then the flow
//   appended as the last 2 channels. conv_f1 (7x7, 2->128) runs outside, in
//   the wrapper, as the JAX wrapper leaves it to XLA. 4 launches.
// camli_gru_flowhead_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::gru_flowhead_2d_pallas: its two
//   halves in sequence. camli_gru_2d is the separable ConvGRU (1x5 then
//   5x1; z and r from one conv whose output stacks both weights, then q)
//   over hx = [h, x2d, motion], nan_to_num of the new hidden state after
//   both directions (as models/raft.py::GRU2D), 4 launches;
//   camli_flow_head_2d the flow head 3x3 (128->256) ReLU, 3x3 (256->2),
//   nan_to_num, 2 launches. With fuse_hidden, CLFM sits between them and
//   the model calls each half on its own.
// These run on conv_tile_tc.cuh's 3xTF32 tensor-core tile (see its note for
// the design and the numerics), on weights packed and split once per
// request.
// camli_update_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::update_2d_pallas: the whole RAFT
//   iteration (the motion encoder, then the GRU and the flow head) as ONE
//   launch, so that the motion features never leave the kernel's scratch
//   (at 68x120 the whole scratch, 33 MB, fits in the 50 MB L2). It is a
//   persistent cooperative kernel (cudaLaunchCooperativeKernel, a grid no
//   larger than the co-resident block count): 9 stages, [c1 | f2] -> c2 ->
//   merge (+ flow tail) -> zr1 -> q1 -> zr2 -> q2 -> head1 -> head2, each a
//   loop of the block over the stage's 64 x 64 tiles of conv_tile.cuh, with
//   a grid-wide barrier between dependent stages. The barrier is written by
//   hand (one arrival word in global memory whose top bit flips when the
//   last block arrives, as cooperative_groups does it), which a cooperative
//   launch makes safe: every block of the grid is resident. Tiles are dealt
//   to the blocks SM by SM (`spread_rank`), so that a stage with fewer tiles
//   than blocks spreads over the card. A refused launch returns its error;
//   the wrapper raises. Its numerics are conv_tile.cuh's: f32 operands, f32
//   accumulation, every product-sum an explicit __fmaf_rn (the library is
//   built with -fmad=false, which does not touch explicit fused
//   multiply-adds).
//
// All three compute the port's exact path; the TPU kernels' bf16 operands
// belong to its fast path, not ported yet.
//
// Bound on the card, at the flagship shape (1 x 68 x 120 = 8160 pixels):
// the motion encoder is 14.5 GFLOP per call (c1 1.35, c2 7.22, f2 1.20,
// merge 4.74) and moves ~18 MB (corr 10.6 MB, weights 3.6 MB, output
// 4.2 MB); the GRU + flow head is 29.0 GFLOP (zr 2 x 8.02, q 2 x 4.01,
// head 4.81 + 0.08) over ~24 MB. At 67 TFLOP/s of f32 outside the tensor
// cores that is 0.22 ms and 0.43 ms, and at 495 TFLOP/s of TF32 with three
// products per f32 product 0.088 ms and 0.176 ms, against ~7 us of memory
// traffic at 3.35 TB/s: all are bound by operations, and so is the fused
// iteration (43.5 GFLOP, 0.65 ms in f32).
#include "conv_tile.cuh"
#include "conv_tile_tc.cuh"

namespace {

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

// One convolution as its own launch. The weight planes are [N_pad][K_pad]
// with N_pad = round_up(cout, 64) and K_pad = round_up(kh*kw*cin, 16), zero
// past (cout, kh*kw*cin). A conv of at most 8 output channels and no
// epilogue (the flow head's last) takes the narrow split-reduction variant;
// one of 256 channels or more the 64 x 128 tile.
int run_conv_tc(Conv a, const float* hi, const float* lo, int epi, int kh, int kw, int cout,
                cudaStream_t stream) {
  a = shaped(a, kh, kw, cout);
  const int k_pad = round_up(a.k_total, kTcBk);
  if (cout <= 8 && epi == EPI_NONE) {
    return launch_tc<32, 8, 1, 1, 4, EPI_NONE>(a, hi, lo, k_pad, 1, stream);
  }
  if (cout >= 256 && a.n_pad % 128 == 0) {
    const int n_tiles = a.n_pad / 128;
    switch (epi) {
      case EPI_RELU:
        return launch_tc<64, 128, 2, 2, 1, EPI_RELU>(a, hi, lo, k_pad, n_tiles, stream);
      case EPI_ZR:
        return launch_tc<64, 128, 2, 2, 1, EPI_ZR>(a, hi, lo, k_pad, n_tiles, stream);
      default:
        break;  // the other epilogues take the 64 x 64 tile
    }
  }
  const int n_tiles = a.n_pad / 64;
  switch (epi) {
    case EPI_RELU:
      return launch_tc<64, 64, 2, 2, 1, EPI_RELU>(a, hi, lo, k_pad, n_tiles, stream);
    case EPI_NONE:
      return launch_tc<64, 64, 2, 2, 1, EPI_NONE>(a, hi, lo, k_pad, n_tiles, stream);
    case EPI_ZR:
      return launch_tc<64, 64, 2, 2, 1, EPI_ZR>(a, hi, lo, k_pad, n_tiles, stream);
    default:
      return launch_tc<64, 64, 2, 2, 1, EPI_GATE>(a, hi, lo, k_pad, n_tiles, stream);
  }
}

}  // namespace

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

// convs: (hi, lo, bias) of conv_c1, conv_c2, conv_f2, the merge conv;
// cf1, cf, ff: [pixels, c_c1 | c_c2 | c_f2] scratch
extern "C" int camli_motion_encoder_2d(const float* flow, const float* ff1, const float* corr,
                                       const float* const* convs, float* cf1, float* cf,
                                       float* ff, float* out, int batch, int height, int width,
                                       int c_corr, int c_c1, int c_c2, int c_f1, int c_f2,
                                       int c_m, cudaStream_t stream) {
  const int pixels = batch * height * width;
  Conv a = input(pixels, height, width, corr, c_corr);
  a.bias = convs[2], a.out = cf1;
  CAMLI_TRY(run_conv_tc(a, convs[0], convs[1], EPI_RELU, 1, 1, c_c1, stream));
  a = input(pixels, height, width, cf1, c_c1);
  a.bias = convs[5], a.out = cf;
  CAMLI_TRY(run_conv_tc(a, convs[3], convs[4], EPI_RELU, 3, 3, c_c2, stream));
  a = input(pixels, height, width, ff1, c_f1);
  a.bias = convs[8], a.out = ff;
  CAMLI_TRY(run_conv_tc(a, convs[6], convs[7], EPI_RELU, 3, 3, c_f2, stream));
  a = input(pixels, height, width, cf, c_c2, ff, c_f2);
  a.bias = convs[11], a.out = out, a.out_stride = c_m + 2;
  a.tail = flow, a.tail_c = 2, a.nan_fix = 1;
  return run_conv_tc(a, convs[9], convs[10], EPI_RELU, 3, 3, c_m, stream);
}

// convs: (hi, lo, bias) of zr1, q1, zr2, q2; z, rh: [pixels, c_h] scratch
extern "C" int camli_gru_2d(const float* h, const float* x2d, const float* motion,
                            const float* const* convs, float* z, float* rh, float* h1,
                            float* h_out, int batch, int height, int width, int c_h, int c_x,
                            int c_m, cudaStream_t stream) {
  const int pixels = batch * height * width;
  const float* state = h;
  float* next[2] = {h1, h_out};
  for (int d = 0; d < 2; ++d) {
    const int kh = d == 0 ? 1 : 5;
    const int kw = d == 0 ? 5 : 1;
    const float* const* zr = convs + 6 * d;
    const float* const* q = zr + 3;
    Conv a = input(pixels, height, width, state, c_h, x2d, c_x, motion, c_m);
    a.bias = zr[2], a.out = z, a.out2 = rh, a.h = state;
    a.half = c_h;
    CAMLI_TRY(run_conv_tc(a, zr[0], zr[1], EPI_ZR, kh, kw, 2 * c_h, stream));
    a = input(pixels, height, width, rh, c_h, x2d, c_x, motion, c_m);
    a.bias = q[2], a.out = next[d], a.h = state, a.z = z;
    a.nan_fix = d == 1;  // nan_to_num once, after both directions
    CAMLI_TRY(run_conv_tc(a, q[0], q[1], EPI_GATE, kh, kw, c_h, stream));
    state = next[d];
  }
  return 0;
}

// convs: (hi, lo, bias) of head1, head2; mid: [pixels, c_mid] scratch
extern "C" int camli_flow_head_2d(const float* h, const float* const* convs, float* mid,
                                  float* delta, int batch, int height, int width, int c_h,
                                  int c_mid, cudaStream_t stream) {
  const int pixels = batch * height * width;
  Conv a = input(pixels, height, width, h, c_h);
  a.bias = convs[2], a.out = mid;
  CAMLI_TRY(run_conv_tc(a, convs[0], convs[1], EPI_RELU, 3, 3, c_mid, stream));
  a = input(pixels, height, width, mid, c_mid);
  a.bias = convs[5], a.out = delta, a.nan_fix = 1;
  return run_conv_tc(a, convs[3], convs[4], EPI_NONE, 3, 3, 2, stream);
}

// convs: (hi, lo, bias) of zr1, q1, zr2, q2, head1, head2
extern "C" int camli_gru_flowhead_2d(const float* h, const float* x2d, const float* motion,
                                     const float* const* convs, float* z, float* rh, float* h1,
                                     float* mid, float* h_out, float* delta, int batch,
                                     int height, int width, int c_h, int c_x, int c_m,
                                     int c_mid, cudaStream_t stream) {
  CAMLI_TRY(camli_gru_2d(h, x2d, motion, convs, z, rh, h1, h_out, batch, height, width, c_h,
                         c_x, c_m, stream));
  return camli_flow_head_2d(h_out, convs + 12, mid, delta, batch, height, width, c_h, c_mid,
                            stream);
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
