// One in-loop CLFM call (bidirectional camera-LiDAR fusion, SK heads), with
// the interp score and the bilinear taps hoisted out of the loop.
//
// camli_clfm replaces camliflow_tpu/ops/pallas_clfm.py::clfm_fused_pallas on
// the port's exact path (f32 throughout, where the TPU kernel ran bf16):
//   2D side: g = f3d[nn_idx], the pixel's nearest projected point (k = 1)
//            interp = leaky(out_conv(score * g))                    C3 -> C3
//            a = leaky(align1(f2d)), b = leaky(align2(interp))      -> C2
//            w = pair softmax of sigmoid(fc_out(relu(fc_mid(mean_HW(a + b)))))
//            out_2d = a * w0 + b * w1
//   3D side: samp = sum_t f2d[tap_idx_t] * tap_w_t, the bilinear sample
//            sm = leaky(mlps3d(samp))                               C2 -> C2
//            a3 = leaky(align1(sm)), b3 = leaky(align2(f3d))        -> C3
//            then the same SK fusion with fuse3d's weights, mean over N.
// The score MLP and the taps are computed outside, once per request, as in
// the JAX package; the dense layers are in the kernels.
//
// Bound on the card (the flagship's corr call: C2 = 324, C3 = 128,
// HW = 8160 pixels, N = 2048 points, bs=1): 1.66 G multiply-adds in the six
// dense layers against ~27 MB moved, so bound by operations (50 us at 67
// TFLOP/s of f32); the motion and hidden calls (C2 = C3 = 128) do 0.50 G.
//
// Design: six launches of small kernels from this one entry point, on one
// scratch buffer.
//   1. gather: score * f3d[nn] at every pixel and the 4-tap bilinear sample
//      at every point, each written once (one rounded product; the sample
//      summed in the plain version's order, so both are bit-identical to it);
//   2. dense, four layers in one grid: interp, a, sm, b3;
//   3. dense, two layers in one grid: b over interp, a3 over sm;
//   4. per batch item, column sums of a + b over fixed chunks of 256 rows;
//   5. one block per batch item and side: the chunk sums in a fixed order,
//      the mean, fc_mid, fc_out, sigmoid and the pair softmax;
//   6. the blend of both sides.
// The dense layers are 1x1 convolutions over [rows, C] on conv_tile.cuh's
// tile (64 rows x 64 channels; the widths 324 and 128 are padded to the tile
// in the packed weights, and the row edge is a predicate), for the pixels
// and for the points alike. The mean over all pixels (or points) of a batch
// item is the one reduction across blocks: it goes through partial sums and
// a second pass in a fixed order, with no float atomics, so two runs give the
// same bits. Stage launches rather than one cooperative launch: each stage
// gets the grid it needs, and no grid barrier is needed.
#include "conv_tile.cuh"

namespace {

constexpr int kChunk = 256;   // rows per partial column sum
constexpr int kMaxC = 1024;   // widest fused feature (the head's shared arrays)

struct Sizes {
  int batch, hw, n, c2, c3;
};

__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ f2d, const float* __restrict__ f3d,
    const float* __restrict__ score, const int32_t* __restrict__ nn,
    const int32_t* __restrict__ tap, const float* __restrict__ tap_w, float* __restrict__ g,
    float* __restrict__ samp, const Sizes s) {
  const size_t n_g = (size_t)s.batch * s.hw * s.c3;
  const size_t n_s = (size_t)s.batch * s.n * s.c2;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e < n_g) {
    const size_t p = e / s.c3;
    const size_t c = e - p * s.c3;
    const size_t b = p / s.hw;
    g[e] = __fmul_rn(score[e], f3d[(b * s.n + nn[p]) * s.c3 + c]);
  } else if (e < n_g + n_s) {
    const size_t u = e - n_g;
    const size_t q = u / s.c2;
    const size_t c = u - q * s.c2;
    const float* image = f2d + (q / s.n) * s.hw * s.c2 + c;
    const int32_t* tq = tap + q * 4;
    const float* wq = tap_w + q * 4;
    float v = __fmul_rn(image[(size_t)tq[0] * s.c2], wq[0]);
    for (int t = 1; t < 4; ++t) v = __fadd_rn(v, __fmul_rn(image[(size_t)tq[t] * s.c2], wq[t]));
    samp[u] = v;
  }
}

__device__ __forceinline__ bool dense_tile(const Conv& a, int& t, TileA* As, TileB* Bs) {
  const int tiles = tile_count(a);
  if (t >= tiles) {
    t -= tiles;
    return false;
  }
  const int m_tiles = (a.pixels + BM - 1) / BM;
  conv_tile<EPI_LEAKY>(a, (t % m_tiles) * BM, (t / m_tiles) * BN, As, Bs);
  return true;
}

// Up to four independent dense layers in one grid (pixels == 0: no layer).
__global__ void __launch_bounds__(kThreads) dense_kernel(const Conv a, const Conv b,
                                                         const Conv c, const Conv d) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  int t = blockIdx.x;
  if (dense_tile(a, t, As, Bs) || dense_tile(b, t, As, Bs) || dense_tile(c, t, As, Bs)) return;
  dense_tile(d, t, As, Bs);
}

struct Side {
  const float* a;       // [batch * rows, c], after the align layers
  const float* b;
  const float* mid_w;   // fc_mid [c, c_mid]
  const float* out_w;   // fc_out [c_mid, 2c]: columns 2o and 2o + 1 pair up
  float* partial;       // [batch, chunks, c]
  float* weights;       // [batch, c, 2]
  float* out;           // [batch * rows, c]
  int rows, c, c_mid, chunks, groups;  // groups of 32 channels
};

// Block `blk` of the side's partial sums: 32 channels x 8 row lanes over one
// chunk of one batch item; each lane sums its rows in order, then lane 0 of
// the rows adds the 8 in order.
__device__ __forceinline__ void partial_sum(const Side& s, int blk) {
  __shared__ float part[kThreads / 32][33];
  const int group = blk % s.groups;
  const int chunk = (blk / s.groups) % s.chunks;
  const int b = blk / (s.groups * s.chunks);
  const int lane = threadIdx.x % 32;
  const int row_lane = threadIdx.x / 32;
  const int c = group * 32 + lane;
  float sum = 0.f;
  if (c < s.c) {
    const int end = min((chunk + 1) * kChunk, s.rows);
    for (int r = chunk * kChunk + row_lane; r < end; r += kThreads / 32) {
      const size_t at = ((size_t)b * s.rows + r) * s.c + c;
      sum = __fadd_rn(sum, __fadd_rn(s.a[at], s.b[at]));
    }
  }
  part[row_lane][lane] = sum;
  __syncthreads();
  if (row_lane == 0 && c < s.c) {
    float total = part[0][lane];
    for (int i = 1; i < kThreads / 32; ++i) total = __fadd_rn(total, part[i][lane]);
    s.partial[((size_t)b * s.chunks + chunk) * s.c + c] = total;
  }
}

__global__ void __launch_bounds__(kThreads) partial_kernel(const Side two, const Side three,
                                                           int blocks_two) {
  if ((int)blockIdx.x < blocks_two) {
    partial_sum(two, blockIdx.x);
  } else {
    partial_sum(three, blockIdx.x - blocks_two);
  }
}

// The SK head of batch item b: mean, fc_mid + ReLU, fc_out + sigmoid, and the
// softmax over each channel's pair, as torch.softmax computes it.
__device__ __forceinline__ void head(const Side& s, int b) {
  __shared__ float mean[kMaxC];
  __shared__ float mid[kMaxC];
  for (int c = threadIdx.x; c < s.c; c += kThreads) {
    const float* p = s.partial + (size_t)b * s.chunks * s.c + c;
    float sum = p[0];
    for (int i = 1; i < s.chunks; ++i) sum = __fadd_rn(sum, p[(size_t)i * s.c]);
    mean[c] = __fdiv_rn(sum, (float)s.rows);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < s.c_mid; j += kThreads) {
    float v = 0.f;
    for (int c = 0; c < s.c; ++c) v = __fmaf_rn(mean[c], s.mid_w[(size_t)c * s.c_mid + j], v);
    mid[j] = v < 0.f ? 0.f : v;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < s.c; c += kThreads) {
    float s0 = 0.f, s1 = 0.f;
    for (int j = 0; j < s.c_mid; ++j) {
      const float* row = s.out_w + (size_t)j * 2 * s.c + 2 * c;
      s0 = __fmaf_rn(mid[j], row[0], s0);
      s1 = __fmaf_rn(mid[j], row[1], s1);
    }
    s0 = sigmoid(s0);
    s1 = sigmoid(s1);
    const float top = fmaxf(s0, s1);
    const float e0 = expf(__fsub_rn(s0, top));
    const float e1 = expf(__fsub_rn(s1, top));
    const float total = __fadd_rn(e0, e1);
    s.weights[((size_t)b * s.c + c) * 2] = __fdiv_rn(e0, total);
    s.weights[((size_t)b * s.c + c) * 2 + 1] = __fdiv_rn(e1, total);
  }
}

__global__ void __launch_bounds__(kThreads) head_kernel(const Side two, const Side three,
                                                        int batch) {
  if ((int)blockIdx.x < batch) {
    head(two, blockIdx.x);
  } else {
    head(three, blockIdx.x - batch);
  }
}

__device__ __forceinline__ void blend(const Side& s, size_t e) {
  const size_t p = e / s.c;
  const size_t c = e - p * s.c;
  const float* w = s.weights + ((p / s.rows) * s.c + c) * 2;
  s.out[e] = __fadd_rn(__fmul_rn(s.a[e], w[0]), __fmul_rn(s.b[e], w[1]));
}

__global__ void __launch_bounds__(kThreads) blend_kernel(const Side two, const Side three,
                                                         size_t n_two, size_t n_three) {
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e < n_two) {
    blend(two, e);
  } else if (e < n_two + n_three) {
    blend(three, e - n_two);
  }
}

// A 1x1 convolution over [rows, cin] with a leaky ReLU.
Conv dense(int rows, const float* in, int cin, const float* w, const float* bias, int cout,
           float* out) {
  Conv a = input(rows, rows, 1, in, cin);
  a.w = w, a.bias = bias, a.out = out;
  return shaped(a, 1, 1, cout);
}

Side side(const float* a, const float* b, const float* mid_w, const float* out_w,
          float* partial, float* weights, float* out, int rows, int c, int c_mid) {
  Side s = {a, b, mid_w, out_w, partial, weights, out, rows, c, c_mid,
            (rows + kChunk - 1) / kChunk, (c + 31) / 32};
  return s;
}

unsigned blocks_for(size_t elements) { return (unsigned)((elements + kThreads - 1) / kThreads); }

}  // namespace

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

// Every dense weight is a packed [K_pad, N_pad] matrix with an [N_pad] bias
// (ops/update3d.py::pack_linears); fc_mid [c, c_mid] and fc_out [c_mid, 2c]
// are unpadded. scratch holds, in floats:
//   rows2 = batch * hw and rows3 = batch * n;
//   g, interp [rows2, c3]; samp, sm [rows3, c2]; a, b [rows2, c2];
//   b3, a3 [rows3, c3]; partial sums [batch, ceil(hw / 256), c2] and
//   [batch, ceil(n / 256), c3]; SK weights [batch, c2, 2] and [batch, c3, 2].
extern "C" int camli_clfm(
    const float* f2d, const float* f3d, const float* score, const int32_t* nn_idx,
    const int32_t* tap_idx, const float* tap_w, const float* w_oc, const float* b_oc,
    const float* w_a1, const float* b_a1, const float* w_a2, const float* b_a2,
    const float* mid_2d, const float* fc_out_2d, const float* w_m3, const float* b_m3,
    const float* w_a13, const float* b_a13, const float* w_a23, const float* b_a23,
    const float* mid_3d, const float* fc_out_3d, float* scratch, float* out_2d, float* out_3d,
    int batch, int hw, int n, int c2, int c3, int c2_mid, int c3_mid, cudaStream_t stream) {
  if (c2 > kMaxC || c3 > kMaxC || c2_mid > kMaxC || c3_mid > kMaxC) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t rows2 = (size_t)batch * hw;
  const size_t rows3 = (size_t)batch * n;
  float* g = scratch;
  float* interp = g + rows2 * c3;
  float* samp = interp + rows2 * c3;
  float* sm = samp + rows3 * c2;
  float* a = sm + rows3 * c2;
  float* b = a + rows2 * c2;
  float* b3 = b + rows2 * c2;
  float* a3 = b3 + rows3 * c3;
  float* partial2 = a3 + rows3 * c3;
  float* partial3 = partial2 + (size_t)batch * ((hw + kChunk - 1) / kChunk) * c2;
  float* weights2 = partial3 + (size_t)batch * ((n + kChunk - 1) / kChunk) * c3;
  float* weights3 = weights2 + (size_t)batch * c2 * 2;
  const Side two = side(a, b, mid_2d, fc_out_2d, partial2, weights2, out_2d, hw, c2, c2_mid);
  const Side three = side(a3, b3, mid_3d, fc_out_3d, partial3, weights3, out_3d, n, c3, c3_mid);

  const Sizes sizes = {batch, hw, n, c2, c3};
  gather_kernel<<<blocks_for(rows2 * c3 + rows3 * c2), kThreads, 0, stream>>>(
      f2d, f3d, score, nn_idx, tap_idx, tap_w, g, samp, sizes);
  CAMLI_TRY((int)cudaGetLastError());

  const Conv interp_l = dense((int)rows2, g, c3, w_oc, b_oc, c3, interp);
  const Conv a_l = dense((int)rows2, f2d, c2, w_a1, b_a1, c2, a);
  const Conv sm_l = dense((int)rows3, samp, c2, w_m3, b_m3, c2, sm);
  const Conv b3_l = dense((int)rows3, f3d, c3, w_a23, b_a23, c3, b3);
  dense_kernel<<<tile_count(interp_l) + tile_count(a_l) + tile_count(sm_l) + tile_count(b3_l),
                 kThreads, 0, stream>>>(interp_l, a_l, sm_l, b3_l);
  CAMLI_TRY((int)cudaGetLastError());

  const Conv b_l = dense((int)rows2, interp, c3, w_a2, b_a2, c2, b);
  const Conv a3_l = dense((int)rows3, sm, c2, w_a13, b_a13, c3, a3);
  const Conv none = {};
  dense_kernel<<<tile_count(b_l) + tile_count(a3_l), kThreads, 0, stream>>>(b_l, a3_l, none,
                                                                            none);
  CAMLI_TRY((int)cudaGetLastError());

  const int blocks_two = batch * two.chunks * two.groups;
  partial_kernel<<<blocks_two + batch * three.chunks * three.groups, kThreads, 0, stream>>>(
      two, three, blocks_two);
  CAMLI_TRY((int)cudaGetLastError());

  head_kernel<<<2 * batch, kThreads, 0, stream>>>(two, three, batch);
  CAMLI_TRY((int)cudaGetLastError());

  blend_kernel<<<blocks_for(rows2 * c2 + rows3 * c3), kThreads, 0, stream>>>(
      two, three, rows2 * c2, rows3 * c3);
  return (int)cudaGetLastError();
}
