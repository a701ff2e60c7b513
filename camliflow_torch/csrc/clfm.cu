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
// dense layers against ~27 MB moved, so bound by operations: 20 us on the
// tensor cores at 495 TFLOP/s of TF32 with three products per f32 product
// (50 us at 67 TFLOP/s of f32 outside them); the motion and hidden calls
// (C2 = C3 = 128) do 0.50 G.
//
// Design: six launches of small kernels from this one entry point, on one
// scratch buffer.
//   1. gather: score * f3d[nn] at every pixel and the 4-tap bilinear sample
//      at every point, each written once (one rounded product; the sample
//      summed in the plain version's order, so both are bit-identical to it);
//   2. dense, four layers in one grid: a, interp, sm, b3;
//   3. dense, two layers in one grid: b over interp, a3 over sm;
//   4. per batch item, column sums of a + b over fixed chunks of 256 rows;
//   5. the SK heads: per side and batch item, kHeadParts blocks of 1024
//      threads; each sums the chunks in a fixed order (the mean), then
//      fc_mid and its share of fc_out as matrix-vector products with a warp
//      per 6 rows and the lanes over the row, 4 (fc_mid) or 2 (fc_out)
//      floats a load (weights stored transposed, so the loads are
//      coalesced), each dot product summed over the lanes by shuffles in a
//      fixed order; then sigmoid and the pair softmax;
//   6. the blend of both sides.
// The dense layers are 1x1 convolutions over [rows, C] on conv_tile_tc.cuh's
// 3xTF32 tensor-core tile (64 rows x 64 channels; the widths 324 and 128 are
// padded to the tile in the packed weight planes, which ops/clfm.py splits
// into tf32 hi and lo once per request; the row edge is a predicate), for
// the pixels and for the points alike, with the leaky ReLU in the epilogue.
// The tile copies 4 channels at a time, so C2 and C3 are multiples of 4.
// The mean over all pixels (or points) of a batch item is the one reduction
// across blocks: it goes through partial sums and a second pass in a fixed
// order, with no float atomics, so two runs give the same bits. Stage
// launches rather than one cooperative launch: each stage gets the grid it
// needs, and no grid barrier is needed.
//
// The bf16 form (bf16 != 0; fast_inference=on with CAMLIFLOW_CLFM=1, the
// corr and motion fusions) computes the TPU kernel's own numerics
// (pallas_clfm.py's _clfm_kernel and _sk_fuse) on the same six launches:
// the score a bf16 tensor; f2d and f3d rounded to bf16 as they are read
// (cvt.rn), so g = score * f3d[nn] is a bf16 product (exact in f32, then
// one rounding) and the sample sums bf16 rows times the f32 tap weights in
// tap order in f32; the dense layers on the tile's bf16 mode (weights
// rounded to bf16 once per request, one bf16 plane; activations rounded as
// they are taken); the SK mean over a + b in f32 as in the exact form,
// fc_mid and fc_out on bf16 operands (the mean and the ReLU's output
// rounded, the weights rounded by the wrapper) with f32 sums, and the pair
// weight w1 = sigmoid(sigmoid(s1) - sigmoid(s2)) of channel c's logits 2c
// and 2c + 1 in place of the exact form's softmax; the blend a w1 +
// b (1 - w1) in f32.
#include "conv_tile_tc.cuh"

namespace {

constexpr int kThreads = 256;  // the elementwise and partial-sum kernels' blocks
constexpr int kChunk = 256;   // rows per partial column sum
constexpr int kMaxC = 1024;   // widest fused feature (the head's shared arrays)

struct Sizes {
  int batch, hw, n, c2, c3;
};

// A feature value as the form reads it: f32, or (BF) rounded to bf16.
template <bool BF>
__device__ __forceinline__ float feature(float v) {
  return BF ? round_bf16(v) : v;
}

// score: f32, or (BF) bf16 values
template <bool BF>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ f2d, const float* __restrict__ f3d,
    const void* __restrict__ score, const int32_t* __restrict__ nn,
    const int32_t* __restrict__ tap, const float* __restrict__ tap_w, float* __restrict__ g,
    float* __restrict__ samp, const Sizes s) {
  const size_t n_g = (size_t)s.batch * s.hw * s.c3;
  const size_t n_s = (size_t)s.batch * s.n * s.c2;
  const size_t e = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (e < n_g) {
    const size_t p = e / s.c3;
    const size_t c = e - p * s.c3;
    const size_t b = p / s.hw;
    const float f = feature<BF>(f3d[(b * s.n + nn[p]) * s.c3 + c]);
    if constexpr (BF) {  // two bf16 values: the f32 product is exact, one rounding
      const float sc = __uint_as_float((uint32_t)static_cast<const unsigned short*>(score)[e]
                                       << 16);
      g[e] = round_bf16(__fmul_rn(sc, f));
    } else {
      g[e] = __fmul_rn(static_cast<const float*>(score)[e], f);
    }
  } else if (e < n_g + n_s) {
    const size_t u = e - n_g;
    const size_t q = u / s.c2;
    const size_t c = u - q * s.c2;
    const float* image = f2d + (q / s.n) * s.hw * s.c2 + c;
    const int32_t* tq = tap + q * 4;
    const float* wq = tap_w + q * 4;
    float v = __fmul_rn(feature<BF>(image[(size_t)tq[0] * s.c2]), wq[0]);
    for (int t = 1; t < 4; ++t) {
      v = __fadd_rn(v, __fmul_rn(feature<BF>(image[(size_t)tq[t] * s.c2]), wq[t]));
    }
    samp[u] = v;
  }
}

constexpr int kHeadThreads = 1024;
constexpr int kHeadParts = 4;  // blocks per side and batch item, each a share of fc_out

struct Side {
  const float* a;       // [batch * rows, c], after the align layers
  const float* b;
  const float* mid_t;   // fc_mid transposed, [c_mid, c]
  const float* out_t;   // fc_out transposed, [2c, c_mid]: rows 2o and 2o + 1 pair up
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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o /= 2) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// V consecutive floats from a 4V-byte aligned address, in one load.
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

// y[r - r0] = x . w[r] for rows r0 <= r < r1 of w [*, len], x [len] in
// shared memory, len a multiple of V and w's rows 4V-byte aligned: a warp
// per 6 rows (the corr call's 162 fc_mid rows, or its part's 162 fc_out rows,
// in one pass of the 32 warps), the lanes over the row, V floats a load
// (coalesced), each dot product summed over the lanes in a fixed order.
template <int V>
__device__ __forceinline__ void rows_dot(const float* __restrict__ w, int len, int r0, int r1,
                                         const float* x, float* y) {
  constexpr int kRows = 6;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int r = r0 + warp * kRows; r < r1; r += kHeadThreads / 32 * kRows) {
    float acc[kRows] = {};
#pragma unroll 2
    for (int c = V * lane; c < len; c += 32 * V) {
      float xv[V];
      load<V>(x + c, xv);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (r + i < r1) {
          float wv[V];
          load<V>(w + (size_t)(r + i) * len + c, wv);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[i] = __fmaf_rn(xv[j], wv[j], acc[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float sum = warp_sum(acc[i]);
      if (lane == 0 && r + i < r1) y[r + i - r0] = sum;
    }
  }
}

// Share `part` of the SK head of batch item b: the mean, fc_mid + ReLU (both
// computed alike by every part), then fc_out + sigmoid and the softmax over
// each channel's pair, as torch.softmax computes it, for the part's channels.
// BF: the mean and the ReLU's output rounded to bf16 as fc_mid's and
// fc_out's operands, and the pair weight sigmoid(s1 - s2) (the TPU kernel's).
template <bool BF>
__device__ __forceinline__ void head(const Side& s, int b, int part) {
  __shared__ __align__(16) float mean[kMaxC];
  __shared__ __align__(16) float mid[kMaxC];
  __shared__ float logit[2 * kMaxC];
  const int per = (s.c + kHeadParts - 1) / kHeadParts;
  const int c0 = min(s.c, part * per), c1 = min(s.c, c0 + per);
  for (int c = threadIdx.x; c < s.c; c += kHeadThreads) {
    const float* p = s.partial + (size_t)b * s.chunks * s.c + c;
    float sum = p[0];
#pragma unroll 8
    for (int i = 1; i < s.chunks; ++i) sum = __fadd_rn(sum, p[(size_t)i * s.c]);
    mean[c] = feature<BF>(__fdiv_rn(sum, (float)s.rows));
  }
  __syncthreads();
  rows_dot<4>(s.mid_t, s.c, 0, s.c_mid, mean, mid);  // c: a multiple of 4
  __syncthreads();
  for (int j = threadIdx.x; j < s.c_mid; j += kHeadThreads) {
    mid[j] = feature<BF>(fmaxf(mid[j], 0.f));
  }
  __syncthreads();
  rows_dot<2>(s.out_t, s.c_mid, 2 * c0, 2 * c1, mid, logit);  // c_mid = c / 2: even
  __syncthreads();
  for (int c = c0 + threadIdx.x; c < c1; c += kHeadThreads) {
    const float s0 = sigmoid(logit[2 * (c - c0)]);
    const float s1 = sigmoid(logit[2 * (c - c0) + 1]);
    if constexpr (BF) {
      const float w1 = sigmoid(__fsub_rn(s0, s1));
      s.weights[((size_t)b * s.c + c) * 2] = w1;
      s.weights[((size_t)b * s.c + c) * 2 + 1] = __fsub_rn(1.f, w1);
      continue;
    }
    const float top = fmaxf(s0, s1);
    const float e0 = expf(__fsub_rn(s0, top));
    const float e1 = expf(__fsub_rn(s1, top));
    const float total = __fadd_rn(e0, e1);
    s.weights[((size_t)b * s.c + c) * 2] = __fdiv_rn(e0, total);
    s.weights[((size_t)b * s.c + c) * 2 + 1] = __fdiv_rn(e1, total);
  }
}

// blocks [0, batch * kHeadParts) the 2D side's heads, then the 3D side's
template <bool BF>
__global__ void __launch_bounds__(kHeadThreads) head_kernel(const Side two, const Side three,
                                                            int batch) {
  const int per_side = batch * kHeadParts;
  if ((int)blockIdx.x < per_side) {
    head<BF>(two, blockIdx.x / kHeadParts, blockIdx.x % kHeadParts);
  } else {
    const int blk = blockIdx.x - per_side;
    head<BF>(three, blk / kHeadParts, blk % kHeadParts);
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

// Dense layers (1x1 convolutions over [rows, cin] -> [rows, cout]) in a
// grouped launch take the 64 x 64 tile.
constexpr int kDenseBM = 64, kDenseBN = 64;

// A dense layer with its planes ([>= round_up(cout, 64)] rows of
// round_up(cin, kTcBk) floats, K-major) for run_dense_group_tc.
TcLayer dense_layer(int rows, const float* in, int cin, const float* hi, const float* lo,
                    const float* bias, int cout, float* out) {
  TcLayer l = {};
  l.a = input(rows, rows, 1, in, cin);
  l.a.bias = bias;
  l.a.out = out;
  l.a = shaped(l.a, 1, 1, cout);
  l.hi = hi;
  l.lo = lo;
  l.k_pad = round_up(cin, kTcBk);
  l.m_tiles = (rows + kDenseBM - 1) / kDenseBM;
  l.n_tiles = (cout + kDenseBN - 1) / kDenseBN;
  return l;
}

// Up to four dense layers with a leaky ReLU in one launch (a default
// TcLayer is none); bf16: the tile's bf16 mode.
int run_dense_group_tc(const TcGroup& g, bool bf16, cudaStream_t stream) {
  using S = TcShape<kDenseBM, kDenseBN, 2, 2, 1>;
  static_assert(S::kSmemBytes <= 48 * 1024, "no cudaFuncSetAttribute needed");
  int blocks = 0;
  for (const TcLayer& l : g.layer) blocks += l.m_tiles * l.n_tiles;
  const auto kernel = bf16 ? conv_tc_group_kernel<kDenseBM, kDenseBN, 2, 2, EPI_LEAKY, true>
                           : conv_tc_group_kernel<kDenseBM, kDenseBN, 2, 2, EPI_LEAKY, false>;
  kernel<<<blocks, S::kThreads, S::kSmemBytes, stream>>>(g);
  return (int)cudaGetLastError();
}

Side side(const float* a, const float* b, const float* mid_t, const float* out_t,
          float* partial, float* weights, float* out, int rows, int c, int c_mid) {
  Side s = {a, b, mid_t, out_t, partial, weights, out, rows, c, c_mid,
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

// dense: (hi, lo, bias) of out_conv, align1_2d, align2_2d, mlps3d,
// align1_3d, align2_3d in that order, each a packed layer's tf32 weight
// planes [round_up(cout, 64), round_up(cin, 16)] and its bias
// (ops/clfm.py::prepare_clfm_params; bf16 != 0: the weights rounded to
// bf16, hi the one plane, lo null); mid_t [c_mid, c] and out_t [2c, c_mid]
// the SK heads' fc_mid and fc_out, transposed; score f32, or bf16 with
// bf16 != 0 (the bf16 form). scratch holds, in floats:
//   rows2 = batch * hw and rows3 = batch * n;
//   g, interp [rows2, c3]; samp, sm [rows3, c2]; a, b [rows2, c2];
//   b3, a3 [rows3, c3]; partial sums [batch, ceil(hw / 256), c2] and
//   [batch, ceil(n / 256), c3]; SK weights [batch, c2, 2] and [batch, c3, 2].
extern "C" int camli_clfm(const float* f2d, const float* f3d, const void* score,
                          const int32_t* nn_idx, const int32_t* tap_idx, const float* tap_w,
                          const float* const* dense, const float* mid_t_2d,
                          const float* out_t_2d, const float* mid_t_3d, const float* out_t_3d,
                          float* scratch, float* out_2d, float* out_3d, int bf16, int batch,
                          int hw, int n, int c2, int c3, int c2_mid, int c3_mid,
                          cudaStream_t stream) {
  if (c2 > kMaxC || c3 > kMaxC || c2_mid > kMaxC || c3_mid > kMaxC || c2 % 4 || c3 % 4 ||
      c2_mid % 2 || c3_mid % 2) {
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
  const Side two = side(a, b, mid_t_2d, out_t_2d, partial2, weights2, out_2d, hw, c2, c2_mid);
  const Side three = side(a3, b3, mid_t_3d, out_t_3d, partial3, weights3, out_3d, n, c3, c3_mid);

  const Sizes sizes = {batch, hw, n, c2, c3};
  const bool bf = bf16 != 0;
  const auto gather = bf ? gather_kernel<true> : gather_kernel<false>;
  gather<<<blocks_for(rows2 * c3 + rows3 * c2), kThreads, 0, stream>>>(
      f2d, f3d, score, nn_idx, tap_idx, tap_w, g, samp, sizes);
  CAMLI_TRY((int)cudaGetLastError());

  // layer i of `dense` over [rows, cin] -> [rows, cout]
  const auto layer = [&](int i, size_t rows, const float* in, int cin, int cout, float* out) {
    return dense_layer((int)rows, in, cin, dense[3 * i], dense[3 * i + 1], dense[3 * i + 2],
                       cout, out);
  };
  const TcGroup first = {{layer(1, rows2, f2d, c2, c2, a), layer(0, rows2, g, c3, c3, interp),
                          layer(3, rows3, samp, c2, c2, sm), layer(5, rows3, f3d, c3, c3, b3)}};
  CAMLI_TRY(run_dense_group_tc(first, bf, stream));
  const TcGroup second = {{layer(2, rows2, interp, c3, c2, b), layer(4, rows3, sm, c2, c3, a3)}};
  CAMLI_TRY(run_dense_group_tc(second, bf, stream));

  const int blocks_two = batch * two.chunks * two.groups;
  partial_kernel<<<blocks_two + batch * three.chunks * three.groups, kThreads, 0, stream>>>(
      two, three, blocks_two);
  CAMLI_TRY((int)cudaGetLastError());

  const auto heads = bf ? head_kernel<true> : head_kernel<false>;
  heads<<<2 * batch * kHeadParts, kHeadThreads, 0, stream>>>(two, three, batch);
  CAMLI_TRY((int)cudaGetLastError());

  blend_kernel<<<blocks_for(rows2 * c2 + rows3 * c3), kThreads, 0, stream>>>(
      two, three, rows2 * c2, rows3 * c3);
  return (int)cudaGetLastError();
}
