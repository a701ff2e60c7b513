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
//   6. the blend of both sides, four channels a thread (C % 4 == 0).
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
// (pallas_clfm.py's _clfm_kernel and _sk_fuse): the score a bf16 tensor;
// f2d and f3d rounded to bf16 as they are read (cvt.rn), so g = score *
// f3d[nn] is a bf16 product (exact in f32, then one rounding) and the
// sample sums bf16 rows times the f32 tap weights in tap order in f32; every
// dense layer on bf16 operands (weights rounded to bf16 once per request, a
// bf16 plane [N_pad][K_pad], K_pad a multiple of 64) with f32 sums; the SK
// mean over a + b in f32, fc_mid and fc_out on bf16 operands (the mean and
// the ReLU's output rounded, the weights rounded by the wrapper) with f32
// sums, and the pair weight w1 = sigmoid(sigmoid(s1) - sigmoid(s2)) of
// channel c's logits 2c and 2c + 1 in place of the exact form's softmax; the
// blend a w1 + b (1 - w1) in f32.
//
// Its design: one chain a row tile, 3 launches. Everything but the two
// gathers (g and the sample) and the SK mean is row-local, and interp and sm
// are only ever taken as bf16 operands, so a block holds 64 rows of one side
// and runs that side's three layers over them in shared memory:
//   2D: A0 = g (gathered), interp = leaky(out_conv(A0)) -> A1 (bf16),
//       A2 = f2d; a = leaky(align1_2d(A2)), b = leaky(align2_2d(A1));
//   3D: A0 = the sample (gathered), sm = leaky(mlps3d(A0)) -> A1 (bf16),
//       A2 = f3d; a3 = leaky(align1_3d(A1)), b3 = leaky(align2_3d(A2)).
// Each A is [64 rows][K_pad] bf16 in 64-deep chunks of 128-byte rows, in
// the 128-byte swizzle wgmma reads (conv_tile_bf16.cuh's layout). The
// weights come as tiles of 128 outputs x 64 reduction values by TMA into a
// ring of kChainStages slots, which a producer warp refills as the
// consumers' warps free them (a full and an empty barrier a slot).
// Warpgroups 0 and 1 multiply, each its 64 outputs of every tile (wgmma
// m64n64k16 on its half of the tile; 324 outputs take three tiles' width);
// their epilogues write interp (or sm) into A1, then for each 64 outputs
// hold a and b in registers, store them once in f32 for the blend, and
// write the tile's column sums of a + b to partial[batch, tile, c] in a
// fixed order (two columns a lane, the rows by shuffles, then the four
// warps in order). First all three warpgroups gather A0 (g: one f3d row a
// pixel times its score; the sample: four f2d rows a point, weighted in tap
// order; each row's indices read once into shared memory), then A2, each
// rounded as the exact form's gathers round, kFillBatch quads' loads in
// flight a thread. The SK heads then sum the tiles in a fixed order
// (head_kernel), and the exact form's blend_kernel reads a and b once.
// Tiles never straddle batch items (a batch item's last tile is partial), so
// the partial sums are a batch item's. `python -m camliflow_torch.csrc.clfm_forms` times its
// parts; one multiplying warpgroup, 4 or 8 quads in flight and a ring of 4
// were slower on an H100, and so was a blend that recomputes a and b from
// f2d and interp kept as bf16 rows instead of reading them (PERF.md).
#define CAMLI_BF16_PRIMITIVES_ONLY  // the wgmma, TMA and barrier primitives
#include "conv_tile_bf16.cuh"  // (and conv_tile_tc.cuh, the exact form's tile)

namespace {

constexpr int kThreads = 256;  // the elementwise and partial-sum kernels' blocks
constexpr int kChunk = 256;   // rows per partial column sum
constexpr int kMaxC = 1024;   // widest fused feature (the head's shared arrays)

struct Sizes {
  int batch, hw, n, c2, c3;
};

// A head's operand as the form takes it: f32, or (BF) rounded to bf16.
template <bool BF>
__device__ __forceinline__ float feature(float v) {
  return BF ? round_bf16(v) : v;
}

// The exact form's gathers: g = score * f3d[nn] at every pixel, the 4-tap
// sample at every point.
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
// BF: the chain's 64-row tiles summed by up to 8 groups of threads, then the
// groups in order; the mean and the ReLU's output rounded to bf16 as
// fc_mid's and fc_out's operands, and the pair weight sigmoid(s1 - s2) (the
// TPU kernel's).
template <bool BF>
__device__ __forceinline__ void head(const Side& s, int b, int part) {
  __shared__ __align__(16) float mean[kMaxC];
  __shared__ __align__(16) float mid[kMaxC];
  __shared__ float logit[2 * kMaxC];
  const int per = (s.c + kHeadParts - 1) / kHeadParts;
  const int c0 = min(s.c, part * per), c1 = min(s.c, c0 + per);
  if constexpr (BF) {  // 64-row tiles: the chunks in groups of threads, then the groups in order
    const int groups = min(8, kHeadThreads / s.c);
    for (int e = threadIdx.x; e < groups * s.c; e += kHeadThreads) {
      const int c = e % s.c, grp = e / s.c;
      const float* p = s.partial + (size_t)b * s.chunks * s.c + c;
      float sum = 0.f;
#pragma unroll 8
      for (int i = grp; i < s.chunks; i += groups) sum = __fadd_rn(sum, p[(size_t)i * s.c]);
      logit[grp * s.c + c] = sum;  // free until the logits
    }
    __syncthreads();
    for (int c = threadIdx.x; c < s.c; c += kHeadThreads) {
      float sum = logit[c];
      for (int grp = 1; grp < groups; ++grp) sum = __fadd_rn(sum, logit[grp * s.c + c]);
      mean[c] = feature<BF>(__fdiv_rn(sum, (float)s.rows));
    }
  } else {
    for (int c = threadIdx.x; c < s.c; c += kHeadThreads) {
      const float* p = s.partial + (size_t)b * s.chunks * s.c + c;
      float sum = p[0];
#pragma unroll 8
      for (int i = 1; i < s.chunks; ++i) sum = __fadd_rn(sum, p[(size_t)i * s.c]);
      mean[c] = feature<BF>(__fdiv_rn(sum, (float)s.rows));
    }
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

// elements 4 q .. 4 q + 3 of a side (c % 4 == 0: one row, one load each of
// a, b and out, two of the weights), each as a w1 + b w2 in f32
__device__ __forceinline__ void blend(const Side& s, size_t q) {
  const size_t e = 4 * q;
  const size_t p = e / s.c;
  const size_t c = e - p * s.c;
  const float* w = s.weights + ((p / s.rows) * s.c + c) * 2;
  const float4 a = *reinterpret_cast<const float4*>(s.a + e);
  const float4 b = *reinterpret_cast<const float4*>(s.b + e);
  const float4 w0 = reinterpret_cast<const float4*>(w)[0];
  const float4 w1 = reinterpret_cast<const float4*>(w)[1];
  *reinterpret_cast<float4*>(s.out + e) =
      make_float4(__fadd_rn(__fmul_rn(a.x, w0.x), __fmul_rn(b.x, w0.y)),
                  __fadd_rn(__fmul_rn(a.y, w0.z), __fmul_rn(b.y, w0.w)),
                  __fadd_rn(__fmul_rn(a.z, w1.x), __fmul_rn(b.z, w1.y)),
                  __fadd_rn(__fmul_rn(a.w, w1.z), __fmul_rn(b.w, w1.w)));
}

// groups of 4 elements [0, n_two) of the 2D side, then the 3D side's
__global__ void __launch_bounds__(kThreads) blend_kernel(const Side two, const Side three,
                                                         size_t n_two, size_t n_three) {
  const size_t q = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (q < n_two) {
    blend(two, q);
  } else if (q < n_two + n_three) {
    blend(three, q - n_two);
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
// TcLayer is none).
int run_dense_group_tc(const TcGroup& g, cudaStream_t stream) {
  using S = TcShape<kDenseBM, kDenseBN, 2, 2, 1>;
  static_assert(S::kSmemBytes <= 48 * 1024, "no cudaFuncSetAttribute needed");
  int blocks = 0;
  for (const TcLayer& l : g.layer) blocks += l.m_tiles * l.n_tiles;
  conv_tc_group_kernel<kDenseBM, kDenseBN, 2, 2, EPI_LEAKY, false>
      <<<blocks, S::kThreads, S::kSmemBytes, stream>>>(g);
  return (int)cudaGetLastError();
}

// a side's SK head and blend; its partial sums over chunks of `chunk` rows
Side side(const float* a, const float* b, const float* mid_t, const float* out_t,
          float* partial, float* weights, float* out, int rows, int c, int c_mid,
          int chunk = kChunk) {
  Side s = {a, b, mid_t, out_t, partial, weights, out, rows, c, c_mid,
            (rows + chunk - 1) / chunk, (c + 31) / 32};
  return s;
}

unsigned blocks_for(size_t elements) { return (unsigned)((elements + kThreads - 1) / kThreads); }

// --- the bf16 form: one chain a row tile on the wgmma tile -----------------

constexpr int kChainRows = 64;      // rows a block: one wgmma m64
constexpr int kChainConsumers = 2;  // warpgroups multiplying, each 64 of a tile's outputs
constexpr int kTileN = 64 * kChainConsumers;  // outputs a weight tile
constexpr int kChainStages = 6;     // weight tiles in flight
constexpr int kChainGather = 128;   // a warpgroup that only gathers
constexpr int kChainFill = 128 * kChainConsumers + kChainGather;  // threads that gather
constexpr int kFillBatch = 6;       // quads a gathering thread loads before it stores any
constexpr int kChainThreads = kChainFill + 32;  // and a warp issues the weight tiles
constexpr int kChunkBytes = kChainRows * 128;   // 64 rows of 64 bf16: an A chunk
constexpr int kTileBytes = kTileN * 128;        // a weight tile: 128 outputs of 64 bf16

__host__ __device__ __forceinline__ int chunks64(int v) { return (v + 63) / 64; }
__host__ __device__ __forceinline__ int steps(int v) { return (v + kTileN - 1) / kTileN; }

// One side of the chain: its rows, widths, layers and outputs.
struct ChainSide {
  int rows, tiles;         // a batch item's rows (pixels or points), ceil(rows / 64)
  int w0, w2, c_out;       // A0's (and A1's) width, A2's, the output's
  int map0, map_a, map_b;  // the first layer's, a's and b's weights (ChainArgs::map)
  const float* bias0;      // biases, each padded to a multiple of 64
  const float* bias_a;
  const float* bias_b;
  const float* direct;     // A2's rows: f2d [batch * hw, c2] or f3d [batch * n, c3]
  float* a;                // a, b [batch * rows, c_out] f32, for the blend
  float* b;
  float* partial;          // [batch, tiles, c_out]: each tile's column sums of a + b
};

struct ChainArgs {
  CUtensorMap map[6];  // out_conv, align1_2d, align2_2d, mlps3d, align1_3d, align2_3d
  const float* f2d;
  const float* f3d;
  const unsigned short* score;  // bf16 [batch * hw, c3]
  const int32_t* nn;
  const int32_t* tap;
  const float* tap_w;
  int hw, n, c2, c3;
  int blocks2;  // the 2D side's blocks come first
  ChainSide side[2];
};

// The dynamic shared memory of a chain block: A0, A1 and A2 of the wider
// side (8 KB a 64-column chunk), the ring of weight tiles, its full and
// empty barriers and the two A barriers, the rows' gather indices (32 bytes
// a row), the column sums' exchange, room to align.
int chain_smem_bytes(int c2, int c3) {
  const int k2 = chunks64(c2), k3 = chunks64(c3);
  const int chunks = max(2 * k3 + k2, 2 * k2 + k3);
  return chunks * kChunkBytes + kChainStages * kTileBytes + (2 * kChainStages + 2) * 8 +
         kChainRows * 32 + kChainConsumers * 4 * 64 * 4 + 1024;
}

__device__ __forceinline__ float leaky_relu(float v) { return v > 0.f ? v : __fmul_rn(0.1f, v); }

// the 128 threads of consumer warpgroup w (named barriers 1 and 2), and both
// (named barrier 3)
__device__ __forceinline__ void group_sync(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, %0;\n" ::"n"(128 * kChainConsumers) : "memory");
}

// 4 bf16 values into an A operand at row r, columns c .. c + 3 (c % 4 == 0):
// chunk c / 64, 16-byte unit (c % 64) / 8 swizzled by the row, half c % 8 / 4
__device__ __forceinline__ void put_quad(uint8_t* a, int r, int c, uint2 v) {
  *reinterpret_cast<uint2*>(a + (c >> 6) * kChunkBytes + r * 128 +
                            ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 4) << 1)) = v;
}

__device__ __forceinline__ float bf16_at(uint32_t word, int half) {
  return __uint_as_float(half ? word & 0xffff0000u : word << 16);
}

// The gathering threads (t < kChainFill) fill an A operand of `width`
// columns (zero past it and past the tile's valid rows): quad i of the tile
// is row i / quads, columns 4 (i % quads) ..; `quad(r, c)` makes one from
// global memory. kFillBatch quads' loads are issued before any is stored.
template <typename F>
__device__ __forceinline__ void fill(uint8_t* a, int width, int valid, int t, F quad) {
  const int quads = chunks64(width) * 16;
  for (int i0 = t; i0 < kChainRows * quads; i0 += kFillBatch * kChainFill) {
    uint2 v[kFillBatch];
#pragma unroll
    for (int u = 0; u < kFillBatch; ++u) {
      const int i = i0 + u * kChainFill;
      const int r = i / quads, c = 4 * (i - r * quads);
      v[u] = make_uint2(0u, 0u);
      if (i < kChainRows * quads && r < valid && c < width) v[u] = quad(r, c);
    }
#pragma unroll
    for (int u = 0; u < kFillBatch; ++u) {
      const int i = i0 + u * kChainFill;
      const int r = i / quads, c = 4 * (i - r * quads);
      if (i < kChainRows * quads) put_quad(a, r, c, v[u]);
    }
  }
}

// A0 and A2, each rounded to bf16 and announced on its barrier. A0: the 2D
// side's g = score * bf16(f3d[nn]), one bf16 product a value; the 3D side's
// sample, four bf16 f2d rows times their f32 weights in tap order (the
// rows' indices and tap weights wait in `rows`, read once a row). A2: f2d's
// (f3d's) rows.
__device__ __forceinline__ void chain_gather(const ChainArgs& g, const ChainSide& s, int side,
                                             int b, int valid, size_t row0, const int4* rows,
                                             uint8_t* a0, uint8_t* a2, uint64_t* ready, int t) {
  if (side == 0) {
    const float* f3d = g.f3d + (size_t)b * g.n * g.c3;
    fill(a0, g.c3, valid, t, [&](int r, int c) {
      const float4 f =
          __ldg(reinterpret_cast<const float4*>(f3d + (size_t)rows[2 * r].x * g.c3 + c));
      const uint2 sc = __ldg(reinterpret_cast<const uint2*>(g.score + (row0 + r) * g.c3 + c));
      const float v0 = round_bf16(__fmul_rn(bf16_at(sc.x, 0), round_bf16(f.x)));
      const float v1 = round_bf16(__fmul_rn(bf16_at(sc.x, 1), round_bf16(f.y)));
      const float v2 = round_bf16(__fmul_rn(bf16_at(sc.y, 0), round_bf16(f.z)));
      const float v3 = round_bf16(__fmul_rn(bf16_at(sc.y, 1), round_bf16(f.w)));
      return make_uint2(pack_bf16x2(v0, v1), pack_bf16x2(v2, v3));
    });
  } else {
    const float* image = g.f2d + (size_t)b * g.hw * g.c2;
    fill(a0, g.c2, valid, t, [&](int r, int c) {
      const int4 tq = rows[2 * r];
      const int4 wb = rows[2 * r + 1];
      const int taps[4] = {tq.x, tq.y, tq.z, tq.w};
      const float ws[4] = {__int_as_float(wb.x), __int_as_float(wb.y), __int_as_float(wb.z),
                           __int_as_float(wb.w)};
      float4 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = __ldg(reinterpret_cast<const float4*>(image + (size_t)taps[i] * g.c2 + c));
      }
      float v[4] = {__fmul_rn(round_bf16(x[0].x), ws[0]), __fmul_rn(round_bf16(x[0].y), ws[0]),
                    __fmul_rn(round_bf16(x[0].z), ws[0]), __fmul_rn(round_bf16(x[0].w), ws[0])};
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        v[0] = __fadd_rn(v[0], __fmul_rn(round_bf16(x[i].x), ws[i]));
        v[1] = __fadd_rn(v[1], __fmul_rn(round_bf16(x[i].y), ws[i]));
        v[2] = __fadd_rn(v[2], __fmul_rn(round_bf16(x[i].z), ws[i]));
        v[3] = __fadd_rn(v[3], __fmul_rn(round_bf16(x[i].w), ws[i]));
      }
      return make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    });
  }
  fence_proxy_async();  // the generic writes, for wgmma's reads
  mbar_arrive(&ready[0]);
  fill(a2, s.w2, valid, t, [&](int r, int c) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(s.direct + (row0 + r) * s.w2 + c));
    return make_uint2(pack_bf16x2(x.x, x.y), pack_bf16x2(x.z, x.w));
  });
  fence_proxy_async();
  mbar_arrive(&ready[1]);
}

// The weight tiles of a side's schedule, in the order the consumers take
// them: the first layer's (128 outputs at a time, each over A0's chunks),
// then for each 128 outputs of the side, b's chunks and a's. Tile u sits in
// ring slot u % kChainStages.
struct ChainTiles {
  int t0, k0, ka, kb, total;
  int map0, map_a, map_b;

  __device__ __forceinline__ void at(int u, int& map, int& x, int& y) const {
    if (u < t0) {
      map = map0, x = (u % k0) * 64, y = (u / k0) * kTileN;
      return;
    }
    const int v = u - t0, per = kb + ka, r = v % per;
    y = (v / per) * kTileN;
    map = r < kb ? map_b : map_a;
    x = (r < kb ? r : r - kb) * 64;
  }
};

// The producer warp's first lane: each tile once its slot is free (the
// consumers' warps have retired the tile before it there; a fresh slot's
// parity-1 wait returns at once). Rows of a tile past a plane's N_pad are
// zeros (the tensor map's out-of-bounds fill).
__device__ __forceinline__ void chain_produce(const ChainTiles& tiles, const CUtensorMap* maps,
                                              uint8_t* ring, uint64_t* full, uint64_t* empty) {
  for (int u = 0; u < tiles.total; ++u) {
    const int slot = u % kChainStages;
    mbar_wait(&empty[slot], ((u / kChainStages) & 1) ^ 1);
    int map, x, y;
    tiles.at(u, map, x, y);
    mbar_arrive_tx(&full[slot], kTileBytes);
    tma_load_2d(ring + slot * kTileBytes, maps + map, &full[slot], x, y);
  }
}

// acc = A [64 rows][chunks of 64] times the next `chunks` weight tiles (the
// warpgroup's 64 outputs of each, at byte `half`), from tile t on; each
// tile's slot freed once its products have retired.
__device__ __forceinline__ void chain_layer(float (&acc)[32], const uint8_t* a, int chunks, int& t,
                                            const uint8_t* ring, int half, uint64_t* full,
                                            uint64_t* empty, int lane) {
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kc = 0; kc < chunks; ++kc, ++t) {
    const int slot = t % kChainStages;
    mbar_wait(&full[slot], (t / kChainStages) & 1);
    const uint64_t da = smem_desc(a + kc * kChunkBytes);
    const uint64_t db = smem_desc(ring + slot * kTileBytes + half);
    __syncwarp();  // converged for the .aligned wgmma instructions
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) Wgmma<64>::mma(acc, da + 2 * ks, db + 2 * ks);
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();  // the tile before is multiplied: free its slot
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % kChainStages]);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  if (lane == 0) mbar_arrive(&empty[(t - 1) % kChainStages]);
}

// Consumer warpgroup w (thread tid of it): the side's three layers and
// epilogues for outputs 64 w .. 64 w + 63 of each 128. A thread holds rows
// 16 warp + lane / 4 (+ 8) and columns 8 j + 2 (lane % 4) (+ 1) of its 64
// (wgmma's accumulator layout).
__device__ __forceinline__ void chain_consume(const ChainArgs& g, const ChainSide& s, int side,
                                              int b, int tile, int valid, size_t row0,
                                              uint8_t* a0, uint8_t* a1, uint8_t* a2,
                                              const uint8_t* ring, uint64_t* full,
                                              uint64_t* empty, uint64_t* ready, float* red, int w,
                                              int tid) {
  const int warp = tid / 32, lane = tid % 32;
  const int k0 = chunks64(s.w0), ka = chunks64(g.c2), kb = chunks64(g.c3);
  const int half = w * kChunkBytes;  // the warpgroup's 64 rows of a weight tile
  red += w * 4 * 64;
  float acc_a[32], acc_b[32];
  int t = 0;

  // interp (sm) = leaky(first layer(A0)), as bf16 into A1
  mbar_wait(&ready[0], 0);
  for (int step = 0; step < steps(s.w0); ++step) {
    chain_layer(acc_a, a0, k0, t, ring, half, full, empty, lane);
    const int chunk = step * kChainConsumers + w;
    if (chunk >= k0) continue;  // past A1 (its weights, zeros)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = chunk * 64 + 8 * j + 2 * (lane % 4);
      const float2 bias = __ldg(reinterpret_cast<const float2*>(s.bias0 + col));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + lane / 4 + 8 * hr;
        *reinterpret_cast<uint32_t*>(a1 + chunk * kChunkBytes + r * 128 + ((j ^ (r & 7)) << 4) +
                                     4 * (lane % 4)) =
            pack_bf16x2(leaky_relu(acc_a[4 * j + 2 * hr] + bias.x),
                        leaky_relu(acc_a[4 * j + 2 * hr + 1] + bias.y));
      }
    }
  }
  fence_proxy_async();  // A1's generic writes, for wgmma's reads
  consumers_sync();     // both warpgroups' halves of A1

  // 2D: a over A2 (f2d), b over A1 (interp); 3D: a over A1 (sm), b over A2 (f3d)
  const uint8_t* a_in = side == 0 ? a2 : a1;
  const uint8_t* b_in = side == 0 ? a1 : a2;
  for (int step = 0; step < steps(s.c_out); ++step) {
    if (side == 1) mbar_wait(&ready[1], 0);  // A2 (a completed phase returns at once)
    chain_layer(acc_b, b_in, kb, t, ring, half, full, empty, lane);
    if (side == 0) mbar_wait(&ready[1], 0);
    chain_layer(acc_a, a_in, ka, t, ring, half, full, empty, lane);
    const int base = (step * kChainConsumers + w) * 64;
    float sums[16];  // columns 8 j + 2 (lane % 4) + e of the tile's valid rows: a + b
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = base + 8 * j + 2 * (lane % 4);
      const bool live = col < s.c_out;  // c_out % 4 == 0: both columns or neither
      sums[2 * j] = sums[2 * j + 1] = 0.f;
      if (!live) continue;  // past the biases too
      const float2 ba = __ldg(reinterpret_cast<const float2*>(s.bias_a + col));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(s.bias_b + col));
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = 16 * warp + lane / 4 + 8 * hr;
        if (r >= valid) continue;
        const float va0 = leaky_relu(acc_a[4 * j + 2 * hr] + ba.x);
        const float va1 = leaky_relu(acc_a[4 * j + 2 * hr + 1] + ba.y);
        const float vb0 = leaky_relu(acc_b[4 * j + 2 * hr] + bb.x);
        const float vb1 = leaky_relu(acc_b[4 * j + 2 * hr + 1] + bb.y);
        const size_t at = (row0 + r) * s.c_out + col;
        *reinterpret_cast<float2*>(s.a + at) = make_float2(va0, va1);
        *reinterpret_cast<float2*>(s.b + at) = make_float2(vb0, vb1);
        sums[2 * j] = __fadd_rn(sums[2 * j], __fadd_rn(va0, vb0));
        sums[2 * j + 1] = __fadd_rn(sums[2 * j + 1], __fadd_rn(va1, vb1));
      }
    }
    // the rows of the warp by shuffles, then the warps in order
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int o = 4; o < 32; o *= 2) {
        sums[i] = __fadd_rn(sums[i], __shfl_xor_sync(0xffffffffu, sums[i], o));
      }
    }
    if (lane < 4) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        red[warp * 64 + 8 * j + 2 * lane] = sums[2 * j];
        red[warp * 64 + 8 * j + 2 * lane + 1] = sums[2 * j + 1];
      }
    }
    group_sync(w);
    const int col = base + tid;
    if (tid < 64 && col < s.c_out) {
      const float total =
          __fadd_rn(__fadd_rn(__fadd_rn(red[tid], red[64 + tid]), red[128 + tid]), red[192 + tid]);
      s.partial[((size_t)b * s.tiles + tile) * s.c_out + col] = total;
    }
    group_sync(w);  // red is read before the next columns overwrite it
  }
}

// One block: 64 rows of one side (the 2D side's blocks first), tile `tile`
// of batch item b: the chain, a and b out, and the tile's column sums.
// Warpgroups 0 and 1 multiply, each 64 of every 128 outputs; they and
// warpgroup 2 gather A0 and A2 first; the last warp issues the weight tiles.
__global__ void __launch_bounds__(kChainThreads, 1)
    clfm_chain_kernel(const __grid_constant__ ChainArgs g) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (shared_address(smem_raw) & 1023)) & 1023);
  const int side = (int)blockIdx.x < g.blocks2 ? 0 : 1;
  const ChainSide s = side == 0 ? g.side[0] : g.side[1];  // no dynamic index into the params
  const int blk = side == 0 ? (int)blockIdx.x : (int)blockIdx.x - g.blocks2;
  const int b = blk / s.tiles, tile = blk - b * s.tiles;
  const int valid = min(kChainRows, s.rows - tile * kChainRows);
  const size_t row0 = (size_t)b * s.rows + (size_t)tile * kChainRows;
  const int k0 = chunks64(s.w0);
  uint8_t* ring = smem;  // 1024-aligned tiles first
  uint8_t* a0 = ring + kChainStages * kTileBytes;
  uint8_t* a1 = a0 + k0 * kChunkBytes;
  uint8_t* a2 = a1 + k0 * kChunkBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(a2 + chunks64(s.w2) * kChunkBytes);
  uint64_t* empty = full + kChainStages;
  uint64_t* ready = empty + kChainStages;  // A0, A2
  int4* rows = reinterpret_cast<int4*>(ready + 2);  // [64][2]: a row's nn (or taps, weights)
  float* red = reinterpret_cast<float*>(rows + 2 * kChainRows);  // [warpgroup][4 warps][64]
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kChainStages; ++i) {
      mbar_init(&full[i], 1);                     // the TMA's byte count
      mbar_init(&empty[i], 4 * kChainConsumers);  // the consumers' warps
    }
    mbar_init(&ready[0], kChainFill);
    mbar_init(&ready[1], kChainFill);
    mbar_init_fence();
  }
  if (tid < kChainRows && tid < valid) {  // the rows' gather indices, once a row
    const size_t p = row0 + tid;
    if (side == 0) {
      rows[2 * tid] = make_int4(__ldg(g.nn + p), 0, 0, 0);
    } else {
      rows[2 * tid] = __ldg(reinterpret_cast<const int4*>(g.tap) + p);
      rows[2 * tid + 1] = __ldg(reinterpret_cast<const int4*>(g.tap_w) + p);
    }
  }
  __syncthreads();
  if (tid >= kChainFill) {  // the producer warp
    if (tid == kChainFill) {
      const int ka = chunks64(g.c2), kb = chunks64(g.c3);
      const ChainTiles tiles = {steps(s.w0) * k0, k0, ka, kb,
                                steps(s.w0) * k0 + steps(s.c_out) * (ka + kb), s.map0, s.map_a,
                                s.map_b};
      chain_produce(tiles, g.map, ring, full, empty);
    }
    return;
  }
  chain_gather(g, s, side, b, valid, row0, rows, a0, a2, ready, tid);
  if (tid < 128 * kChainConsumers) {
    chain_consume(g, s, side, b, tile, valid, row0, a0, a1, a2, ring, full, empty, ready, red,
                  tid / 128, tid % 128);
  }
}

// The chain's launch over both sides' tiles (the attribute set once a size).
int launch_chain(const ChainArgs& g, int batch, cudaStream_t stream) {
  const int bytes = chain_smem_bytes(g.c2, g.c3);
  static int sized = 0;  // the largest size the attribute allows so far
  if (bytes > sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        clfm_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    sized = bytes;
  }
  const int blocks = g.blocks2 + batch * g.side[1].tiles;
  clfm_chain_kernel<<<blocks, kChainThreads, bytes, stream>>>(g);
  return (int)cudaGetLastError();
}

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

// The bf16 form's three launches: the chains of both sides, the SK heads,
// the blend (see the note at the top). scratch holds, in floats, each part
// 16-byte aligned: a, b [rows2, c2] and a3, b3 [rows3, c3]; the partial sums
// [batch, ceil(hw / 64), c2] and [batch, ceil(n / 64), c3]; the SK weights
// [batch, c2, 2] and [batch, c3, 2].
int run_bf16(const float* f2d, const float* f3d, const void* score, const int32_t* nn_idx,
             const int32_t* tap_idx, const float* tap_w, const float* const* dense,
             const float* mid_t_2d, const float* out_t_2d, const float* mid_t_3d,
             const float* out_t_3d, float* scratch, float* out_2d, float* out_3d, int batch,
             int hw, int n, int c2, int c3, int c2_mid, int c3_mid, cudaStream_t stream) {
  if (chain_smem_bytes(c2, c3) > 232448) return (int)cudaErrorInvalidValue;  // 227 KB a block
  ChainArgs g = {};
  const int cin[6] = {c3, c2, c3, c2, c2, c3}, cout[6] = {c3, c2, c2, c2, c3, c3};
  for (int i = 0; i < 6; ++i) {
    CAMLI_TRY(weight_map(&g.map[i], dense[3 * i], round_up(cin[i], 64), round_up(cout[i], 64),
                         kTileN));
  }
  g.f2d = f2d, g.f3d = f3d, g.score = static_cast<const unsigned short*>(score);
  g.nn = nn_idx, g.tap = tap_idx, g.tap_w = tap_w;
  g.hw = hw, g.n = n, g.c2 = c2, g.c3 = c3;
  const size_t rows2 = (size_t)batch * hw, rows3 = (size_t)batch * n;
  float* at = scratch;
  const auto take = [&](size_t floats) {
    float* part = at;
    at += (floats + 3) / 4 * 4;
    return part;
  };
  ChainSide& two = g.side[0];
  ChainSide& three = g.side[1];
  two.rows = hw, two.tiles = chunks64(hw), two.w0 = c3, two.w2 = c2, two.c_out = c2;
  two.map0 = 0, two.map_a = 1, two.map_b = 2, two.direct = f2d;
  three.rows = n, three.tiles = chunks64(n), three.w0 = c2, three.w2 = c3, three.c_out = c3;
  three.map0 = 3, three.map_a = 4, three.map_b = 5, three.direct = f3d;
  for (int i = 0; i < 2; ++i) {
    ChainSide& sd = g.side[i];
    sd.bias0 = dense[9 * i + 2], sd.bias_a = dense[9 * i + 5], sd.bias_b = dense[9 * i + 8];
  }
  two.a = take(rows2 * c2), two.b = take(rows2 * c2);
  three.a = take(rows3 * c3), three.b = take(rows3 * c3);
  two.partial = take((size_t)batch * two.tiles * c2);
  three.partial = take((size_t)batch * three.tiles * c3);
  float* weights2 = take((size_t)batch * c2 * 2);
  float* weights3 = take((size_t)batch * c3 * 2);
  g.blocks2 = batch * two.tiles;
  CAMLI_TRY(launch_chain(g, batch, stream));

  const Side h2 = side(two.a, two.b, mid_t_2d, out_t_2d, two.partial, weights2, out_2d, hw, c2,
                       c2_mid, kChainRows);
  const Side h3 = side(three.a, three.b, mid_t_3d, out_t_3d, three.partial, weights3, out_3d, n,
                       c3, c3_mid, kChainRows);
  head_kernel<true><<<2 * batch * kHeadParts, kHeadThreads, 0, stream>>>(h2, h3, batch);
  CAMLI_TRY((int)cudaGetLastError());
  blend_kernel<<<blocks_for((rows2 * c2 + rows3 * c3) / 4), kThreads, 0, stream>>>(
      h2, h3, rows2 * c2 / 4, rows3 * c3 / 4);
  return (int)cudaGetLastError();
}

}  // namespace

// dense: (hi, lo, bias) of out_conv, align1_2d, align2_2d, mlps3d,
// align1_3d, align2_3d in that order, each a packed layer's tf32 weight
// planes [round_up(cout, 64), round_up(cin, 16)] and its bias
// (ops/clfm.py::prepare_clfm_params; bf16 != 0: hi the one bf16 plane
// [round_up(cout, 64), round_up(cin, 64)], lo null); mid_t [c_mid, c] and
// out_t [2c, c_mid] the SK heads' fc_mid and fc_out, transposed; score f32,
// or bf16 with bf16 != 0 (the bf16 form, whose scratch run_bf16 lists).
// The exact form's scratch holds, in floats:
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
  if (bf16 != 0) {
    return run_bf16(f2d, f3d, score, nn_idx, tap_idx, tap_w, dense, mid_t_2d, out_t_2d, mid_t_3d,
                    out_t_3d, scratch, out_2d, out_3d, batch, hw, n, c2, c3, c2_mid, c3_mid,
                    stream);
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
  gather_kernel<<<blocks_for(rows2 * c3 + rows3 * c2), kThreads, 0, stream>>>(
      f2d, f3d, static_cast<const float*>(score), nn_idx, tap_idx, tap_w, g, samp, sizes);
  CAMLI_TRY((int)cudaGetLastError());

  // layer i of `dense` over [rows, cin] -> [rows, cout]
  const auto layer = [&](int i, size_t rows, const float* in, int cin, int cout, float* out) {
    return dense_layer((int)rows, in, cin, dense[3 * i], dense[3 * i + 1], dense[3 * i + 2],
                       cout, out);
  };
  const TcGroup first = {{layer(1, rows2, f2d, c2, c2, a), layer(0, rows2, g, c3, c3, interp),
                          layer(3, rows3, samp, c2, c2, sm), layer(5, rows3, f3d, c3, c3, b3)}};
  CAMLI_TRY(run_dense_group_tc(first, stream));
  const TcGroup second = {{layer(2, rows2, interp, c3, c2, b), layer(4, rows3, sm, c2, c3, a3)}};
  CAMLI_TRY(run_dense_group_tc(second, stream));

  const int blocks_two = batch * two.chunks * two.groups;
  partial_kernel<<<blocks_two + batch * three.chunks * three.groups, kThreads, 0, stream>>>(
      two, three, blocks_two);
  CAMLI_TRY((int)cudaGetLastError());

  head_kernel<false><<<2 * batch * kHeadParts, kHeadThreads, 0, stream>>>(two, three, batch);
  CAMLI_TRY((int)cudaGetLastError());

  blend_kernel<<<blocks_for((rows2 * c2 + rows3 * c3) / 4), kThreads, 0, stream>>>(
      two, three, rows2 * c2 / 4, rows3 * c3 / 4);
  return (int)cudaGetLastError();
}
