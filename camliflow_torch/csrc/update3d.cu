// The 3D update chain of the refinement loop.
//
// camli_motion_encoder_3d replaces
//   camliflow_tpu/ops/pallas_update3d.py::motion_encoder_3d_pallas:
//   MotionEncoder3D's four PointConvDW (conv_c1 k=16 on corr, conv_f1 k=32
//   and conv_f2 k=16 on the flow, the merge conv k=16 over [corr_feat,
//   flow_feat]), then the flow appended. 4 launches of the stage kernel.
// camli_gru_flowhead_3d replaces
//   camliflow_tpu/ops/pallas_update3d.py::gru_flowhead_3d_pallas: GRU3D
//   (z|r and q PointConvDW at k=4 over hx = [h, x3d, motion], h' = (1-z) h
//   + z tanh(q)) and FlowHead3D (two PointConvDW at k=32, then fc 64->3),
//   returning (h', delta). Its own steps, below ("#7").
// camli_dw_max replaces camliflow_tpu/ops/pallas_ohg.py::dw_conv_ohg: one
//   PointConvDW tail (gather, multiply, max over k) as one gather-only
//   stage, for the flagship's fuse_hidden path, where CLFM sits between
//   GRU3D and FlowHead3D. 1 launch of the stage kernel.
//
// A PointConvDW is out[q, c] = max_j table[idx[q, j], c] * w[q, j, c], where
// table is the conv's MLP (one Linear, leaky ReLU or none) over every point
// and w the geometric weights hoisted out of the loop ([B, N, k, C] f32).
// The gather reads other points' rows, so a table must be complete before
// its gather starts: that is where the launches split. The JAX chain
// (camliflow_tpu/models/camliraft_l.py) applies no nan_to_num anywhere in
// it, and neither does this one.
//
// Numerics: f32 throughout. A gathered product is one rounded multiply and
// the max is exact and taken in neighbour order, so the gathers equal the
// plain versions bit for bit (NaN propagates as in torch.amax); the MLPs
// sum in another order than the plain versions' matmuls (#7's dense steps
// on the tensor cores by the 3xTF32 split, conv_tile_tc.cuh).
//
// The stage kernel (#6, #13): a stage gathers for its 16 points into shared
// memory and feeds the gathered rows straight into the next MLP, a tile of
// 16 points x 64 channels, 256 threads, 1 x 4 outputs a thread, f32 FMA on
// weights packed once per request as [K_pad, N_pad].
//   #6: [MLP c1 | MLP f1] -> [gather c1 -> corr_feat | gather f1 -> MLP f2]
//       -> [gather f2 -> merge MLP over (corr_feat, flow_feat)]
//       -> [gather merge -> out, flow]
//
// #7: bound on the card at the main-path shape (N = 2048 points, bs=1): a
// call reads its hoisted weights once, 7,680 floats a point (4x256 + 4x128
// + 32x128 + 32x64; 62.9 MB), ~20 us at 3.35 TB/s; its 0.35 G
// multiply-adds are ~4.3 us as 3xTF32 on the tensor cores. Bound by bytes.
// Design (see "#7" below): the gathers as their own steps, built for bytes
// (a warp a point, 16-byte loads over channels, the point's neighbour
// indices read once, 8 rows of the table and of the weights in flight a
// lane, each result written once to an L2-resident scratch after its post
// op); z|r's and q's dense layers on the 3xTF32 tensor-core tile; q's
// x3d/motion part moved into the first dense step; conv1 and conv2 as f32
// FMA epilogues of the gathers before them. 6 launches, one a step. Measured
// on an H100 (PERF.md), one cooperative launch with grid barriers between the
// steps cost more than the launch gaps it replaces, and conv1/conv2 on the
// tile (8 launches) gained about 5% at 16,384 points and lost at 2048.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile_tc.cuh"

namespace {
// The stage kernel of #6 and #13.
namespace staged {

constexpr int ROWS = 1;  // points per thread in the MLP tile
constexpr int BM = 16 * ROWS;  // points per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 16;   // reduction chunk
constexpr int GMAX = 128;  // gathered channels a block stages for its MLP
constexpr int kThreads = 256;

enum Post { POST_NONE = 0, POST_ZR = 1, POST_GATE = 2 };
enum Act { ACT_NONE = 0, ACT_LEAKY = 1 };

struct Stage {
  int points, n;  // B*N, and N (a batch item's points; indices are local)
  // the gather, g[p, c] = max_j table[idx[p, j], c] * dw[p, j, c], c < t_c
  // (k == 0: none)
  const float* table;  // [B * t_n, t_c]
  const float* dw;     // [points, k, t_c]
  const int* idx;      // [points, idx_stride], the first k columns
  int idx_stride, k, t_c, t_n, post;  // t_n: table rows per batch item
  const float* h;  // ZR: g = r*h is staged; GATE: h' = (1-z) h + z tanh(g)
  const float* z;  // GATE: the update gate
  float* side;     // ZR: z out; GATE: h' out
  int half;        // ZR, GATE: hidden channels
  // the MLP over the virtual concat of in0..in2, the part g_slot being the
  // staged gather (cout == 0: no MLP, the gather itself is the output)
  const float* in0;
  const float* in1;
  const float* in2;
  int c0, c1, c2, g_slot;
  const float* w;     // [K_pad, N_pad]
  const float* bias;  // [N_pad]
  int cout, n_pad, k_total, act;
  float* out;  // out[p * out_stride + co]
  int out_stride;
  const float* tail;  // gather-only stage: copied to out[p, t_c + j], j < tail_c
  int tail_c;
};

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// max_j table[idx[p, j], c] * dw[p, j, c]
__device__ __forceinline__ float dw_max(const Stage& s, int p, int c) {
  const int b = p / s.n;
  const int* nb = s.idx + (size_t)p * s.idx_stride;
  const float* wp = s.dw + (size_t)p * s.k * s.t_c + c;
  const float* tb = s.table + (size_t)b * s.t_n * s.t_c + c;
  float m = __fmul_rn(tb[(size_t)nb[0] * s.t_c], wp[0]);
#pragma unroll 4
  for (int j = 1; j < s.k; ++j) {
    const float v = __fmul_rn(tb[(size_t)nb[j] * s.t_c], wp[(size_t)j * s.t_c]);
    m = (v > m || isnan(v)) ? v : m;
  }
  return m;
}

// The gather of the block's BM points into shared memory (after the post
// op); the tile at n0 == 0 also writes the side output.
__device__ __forceinline__ void gather_rows(const Stage& s, int p0, bool side,
                                            float (*G)[GMAX + 1]) {
  for (int e = threadIdx.x; e < BM * s.t_c; e += kThreads) {
    const int row = e / s.t_c;
    const int c = e - row * s.t_c;
    const int p = p0 + row;
    if (p >= s.points) continue;
    const float v = dw_max(s, p, c);
    if (s.post == POST_NONE) {
      G[row][c] = v;
    } else if (s.post == POST_ZR) {
      const float g = sigmoid(v);
      if (c < s.half) {
        if (side) s.side[(size_t)p * s.half + c] = g;
      } else {
        const size_t at = (size_t)p * s.half + (c - s.half);
        G[row][c - s.half] = __fmul_rn(g, s.h[at]);
      }
    } else {
      const size_t at = (size_t)p * s.half + c;
      const float zv = s.z[at];
      const float hn = __fadd_rn(__fmul_rn(__fsub_rn(1.f, zv), s.h[at]),
                                 __fmul_rn(zv, tanhf(v)));
      G[row][c] = hn;
      if (side) s.side[at] = hn;
    }
  }
}

// A gather-only stage: BM points x 64 channels of the gather to `out`.
__device__ __forceinline__ void gather_out(const Stage& s, int p0, int n0) {
  for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
    const int p = p0 + e / BN;
    const int c = n0 + e % BN;
    if (p < s.points && c < s.t_c) s.out[(size_t)p * s.out_stride + c] = dw_max(s, p, c);
  }
  if (s.tail_c > 0 && n0 == 0) {
    for (int e = threadIdx.x; e < BM * s.tail_c; e += kThreads) {
      const int p = p0 + e / s.tail_c;
      const int j = e % s.tail_c;
      if (p < s.points) {
        s.out[(size_t)p * s.out_stride + s.t_c + j] = s.tail[(size_t)p * s.tail_c + j];
      }
    }
  }
}

// One BM-point x 64-channel tile of the MLP at (p0, n0).
__device__ __forceinline__ void mlp_tile(const Stage& s, int p0, int n0,
                                         float (*G)[GMAX + 1], float (*As)[BM + 4],
                                         float (*Bs)[BN]) {
  const int tid = threadIdx.x;
  const int a_k = tid % BK;  // load roles: A element (k, point rows a_m + 16 i)
  const int a_m = tid / BK;
  const int b_row = tid / 16;  // B float4
  const int b_col = (tid % 16) * 4;
  const int tx = tid % 16;  // compute role: points ty*ROWS + i, channels tx*4 + j
  const int ty = tid / 16;
  float acc[ROWS][4];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < s.k_total; k0 += BK) {
    float va[ROWS] = {};
    const int k = k0 + a_k;
    if (k < s.k_total) {
      const float* src = s.in0;
      int part = 0, cs = s.c0, cc = k;
      if (k >= s.c0 + s.c1) {
        src = s.in2, part = 2, cs = s.c2, cc = k - s.c0 - s.c1;
      } else if (k >= s.c0) {
        src = s.in1, part = 1, cs = s.c1, cc = k - s.c0;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = a_m + 16 * i;
        if (p0 + row < s.points) {
          va[i] = part == s.g_slot ? G[row][cc] : src[(size_t)(p0 + row) * cs + cc];
        }
      }
    }
    const float4 wv = *reinterpret_cast<const float4*>(
        s.w + (size_t)(k0 + b_row) * s.n_pad + n0 + b_col);
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int i = 0; i < ROWS; ++i) As[a_k][a_m + 16 * i] = va[i];
    *reinterpret_cast<float4*>(&Bs[b_row][b_col]) = wv;
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(As[kk][ty * ROWS + i], br[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int p = p0 + ty * ROWS + i;
    if (p >= s.points) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= s.cout) continue;
      float v = __fadd_rn(acc[i][j], s.bias[co]);
      if (s.act == ACT_LEAKY && !(v > 0.f)) v = __fmul_rn(0.1f, v);
      s.out[(size_t)p * s.out_stride + co] = v;
    }
  }
}

__host__ __device__ __forceinline__ int tile_count(const Stage& s) {
  const int n_tiles = s.cout > 0 ? s.n_pad / BN : (s.t_c + BN - 1) / BN;
  return (s.points + BM - 1) / BM * n_tiles;
}

__device__ __forceinline__ void run_tile(const Stage& s, int t, float (*G)[GMAX + 1],
                                         float (*As)[BM + 4], float (*Bs)[BN]) {
  const int m_tiles = (s.points + BM - 1) / BM;
  const int p0 = (t % m_tiles) * BM;
  const int n0 = (t / m_tiles) * BN;
  if (s.cout == 0) {
    gather_out(s, p0, n0);
    return;
  }
  if (s.k > 0) {
    gather_rows(s, p0, n0 == 0, G);
    __syncthreads();
  }
  mlp_tile(s, p0, n0, G, As, Bs);
}

// One launch runs the tiles of `a`, then those of `b` (tiles_b may be 0).
__global__ void __launch_bounds__(kThreads) stage_kernel(const Stage a, const Stage b,
                                                         int tiles_a) {
  __shared__ float G[BM][GMAX + 1];
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[BK][BN];
  const int t = blockIdx.x;
  if (t < tiles_a) {
    run_tile(a, t, G, As, Bs);
  } else {
    run_tile(b, t - tiles_a, G, As, Bs);
  }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

Stage points(int batch, int n) {
  Stage s = {};
  s.points = batch * n;
  s.n = n;
  s.g_slot = -1;
  return s;
}

// The gather part of a stage.
Stage& gather(Stage& s, const float* table, const float* dw, const int* idx,
              int idx_stride, int k, int t_c) {
  s.table = table, s.dw = dw, s.idx = idx;
  s.idx_stride = idx_stride, s.k = k, s.t_c = t_c, s.t_n = s.n;
  return s;
}

// The MLP part of a stage over [in0 (c0), in1 (c1), in2 (c2)].
Stage& mlp(Stage& s, const float* w, const float* bias, int cout, int act, float* out,
           const float* in0, int c0, const float* in1 = nullptr, int c1 = 0,
           const float* in2 = nullptr, int c2 = 0) {
  s.w = w, s.bias = bias, s.cout = cout, s.act = act, s.out = out;
  s.out_stride = cout;
  s.n_pad = round_up(cout, BN);
  s.in0 = in0, s.c0 = c0, s.in1 = in1, s.c1 = c1, s.in2 = in2, s.c2 = c2;
  s.k_total = c0 + c1 + c2;
  return s;
}

int launch(const Stage& a, const Stage* b, cudaStream_t stream) {
  const int tiles_a = tile_count(a);
  const int tiles = tiles_a + (b ? tile_count(*b) : 0);
  stage_kernel<<<tiles, kThreads, 0, stream>>>(a, b ? *b : a, tiles_a);
  return (int)cudaGetLastError();
}

}  // namespace staged

// --- #7: GRU3D + FlowHead3D ---------------------------------------------------
//
// The chain as phases. A dense phase runs conv_tile_tc.cuh's 3xTF32 tile
// over the points (a 1x1 conv, EPI_NONE: the table before its activation);
// a tail phase gathers (gather, multiply, max over k), applies its post op
// and writes the result once to an L2-resident scratch. q's input
// [r*h, x3d, motion] is split: its x3d and motion part does not wait for
// the z|r gather, so the first dense phase computes it beside z|r (one
// [384 -> 384] product), and q's own dense phase reduces over r*h alone
// (128 deep instead of 384):
//   dense [z|r | q_xm] over [h, x3d, motion]
//   tail z|r -> z = sigmoid, r*h = sigmoid * h
//   dense q_h over r*h
//   tail q (table q_h + q_xm) -> h' = (1-z) h + z tanh(q), then conv1 over h'
//   tail conv1 (leaky ReLU on read), then conv2 over it
//   tail conv2 (leaky ReLU on read) -> fc 64->3 -> delta
// conv1's and conv2's dense layers run as the f32 FMA epilogue of the tail
// before them: its block's rows (one point a warp) in shared memory, each
// weight read once a block. A gather reads other points' rows, so each phase
// waits for the one before: one launch a phase.

constexpr int kGfThreads = 128;  // the tile's 4 warps; a tail's 4 warps
constexpr int kGfWarps = kGfThreads / 32;
constexpr int kGfBM = 32, kGfBN = 64;  // the tile: 32 points x 64 channels, 2 x 2 warps
using GfTile = TcShape<kGfBM, kGfBN, 2, 2, 1>;
constexpr int kGfRows = 8;   // float4 neighbour rows (table + weights) a lane keeps in flight
constexpr int kGruK = 8;     // the most neighbours of GRU3D's convs (the model's: 4)
constexpr int kHeadK = 32;   // of FlowHead3D's (the model's: 32)
constexpr int kMaxFc = 4;    // fc outputs (the model's: 3)
constexpr int kMaxRow = 128; // a fused layer's input and output channels
constexpr int kGfSteps = 6;

enum GfPost { GP_ZR = 0, GP_GATE = 1, GP_PLAIN = 2, GP_FC = 3 };

// One tail: g[p, c] = max_j act(table[idx[p, j], c]) * dw[p, j, c], c < c,
// then the post op.
struct GfTail {
  const float* table;  // [B * n, ld], the dense layer's output before its activation
  const float* table2; // GATE: added to the table (q's x3d/motion part), [B * n, ld2]
  int ld, ld2;
  const float* dw;     // [points, k, c]
  int k, c, leaky;     // leaky: the table's leaky ReLU, applied as a row is read
  float* out;          // ZR: z [points, half]; GATE: h'; PLAIN: g [points, c] (or none)
  float* out2;         // ZR: r * h
  const float* h;      // ZR, GATE: the hidden state [points, half]
  const float* z;      // GATE: the update gate
  int half;            // ZR, GATE: hidden channels
  const float* fc_w;   // FC: [>= c, fc_npad], and its bias
  const float* fc_b;
  int fc_out, fc_npad;
  const float* mlp_w;  // GATE, PLAIN: the next dense layer [>= c, mlp_npad]
  const float* mlp_b;
  float* mlp_out;      // its output before the activation [points, mlp_cout]
  int mlp_cout, mlp_npad;
};

struct GfLayer {  // a dense layer: a 1x1 conv on the tile, and its tf32 planes
  Conv a;
  const float* hi;
  const float* lo;
  int k_pad;
};

struct Gru3D {
  int points, n;  // B*N, and N (neighbour indices are local to a batch item)
  const int* idx;  // [points, idx_stride], the first k columns
  int idx_stride;
  GfLayer layer[2];  // [z|r | q_xm], q_h
  GfTail tail[4];    // z|r, q, conv1, conv2
};

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : __fmul_rn(0.1f, v); }

// dw_max's step: the larger, and NaN once one is NaN (torch.amax)
__device__ __forceinline__ float take_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z),
                     __fmul_rn(a.w, b.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float gate(float z, float h, float q) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), h), __fmul_rn(z, tanhf(q)));
}

// A dense layer: the block takes tiles rank, rank + blocks, ...
__device__ __forceinline__ void gf_dense(const GfLayer& l, int rank, int blocks) {
  const int m_tiles = (l.a.pixels + kGfBM - 1) / kGfBM;
  const int tiles = m_tiles * (l.a.n_pad / kGfBN);
  for (int t = rank; t < tiles; t += blocks) {
    conv_tc_tile<kGfBM, kGfBN, 2, 2, 1, EPI_NONE>(l.a, l.hi, l.lo, l.k_pad,
                                                  (t % m_tiles) * kGfBM, (t / m_tiles) * kGfBN);
    __syncthreads();  // the next tile's copies refill the ring
  }
}

// A fused dense layer over the block's rows (one point a warp, points p0 +
// warp): out[p, o] = sum_k rows[warp][k] * w[k, o] + bias[o], f32 FMA in k
// order. A thread takes one output channel of kGfThreads / cout rows, so
// each weight is read once a block.
__device__ __forceinline__ void gf_rows_dense(const GfTail& g, const float (*rows)[kMaxRow],
                                              int p0, int points) {
  const int cout = g.mlp_cout;
  const int per = kGfThreads / cout;  // rows a weight serves at once
  const int t = threadIdx.x;
  if (t >= per * cout) return;
  const int o = t % cout, r0 = t / cout;
  float acc[kGfWarps];
#pragma unroll
  for (int i = 0; i < kGfWarps; ++i) acc[i] = 0.f;
  for (int k = 0; k < g.c; k += 4) {  // c is a multiple of 4
    const float* wk = g.mlp_w + (size_t)k * g.mlp_npad + o;
    const float w[4] = {__ldg(wk), __ldg(wk + g.mlp_npad), __ldg(wk + 2 * g.mlp_npad),
                        __ldg(wk + 3 * g.mlp_npad)};
#pragma unroll
    for (int i = 0; i < kGfWarps; ++i) {
      const int r = r0 + i * per;
      if (r < kGfWarps) {
        const float4 x = *reinterpret_cast<const float4*>(&rows[r][k]);
        acc[i] = __fmaf_rn(x.x, w[0], acc[i]);
        acc[i] = __fmaf_rn(x.y, w[1], acc[i]);
        acc[i] = __fmaf_rn(x.z, w[2], acc[i]);
        acc[i] = __fmaf_rn(x.w, w[3], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kGfWarps; ++i) {
    const int r = r0 + i * per;
    if (r < kGfWarps && p0 + r < points) {
      g.mlp_out[(size_t)(p0 + r) * cout + o] = acc[i] + g.mlp_b[o];
    }
  }
}

// A tail: LANES lanes a point (32 / LANES points a warp at once), VEC float4
// of channels a lane (channel 4 * (lane + LANES * v)), up to KMAX neighbours.
// A lane holds the point's neighbour indices l, l + LANES, ... (read once)
// and hands row j to the others by a shuffle; it keeps kGfRows / VEC rows of
// the table and of the weights in flight (16-byte loads, the weights
// streamed once), then takes their products and the max in neighbour
// order, bit for bit as dw_max does. The block's warps walk the points
// together (the fused layer synchronises them).
template <int LANES, int VEC, int KMAX, int POST>
__device__ __forceinline__ void gf_tail(const Gru3D& u, const GfTail& g, int rank, int blocks) {
  constexpr int kPer = 32 / LANES;
  constexpr int kNb = (KMAX + LANES - 1) / LANES;
  constexpr int kGroup = KMAX < kGfRows / VEC ? KMAX : kGfRows / VEC;
  constexpr bool kFusable = (POST == GP_GATE || POST == GP_PLAIN) && LANES == 32 && VEC == 1;
  static_assert(KMAX % kGroup == 0, "whole groups of neighbour rows");
  __shared__ __align__(16) float rows[kFusable ? kGfWarps : 1][kMaxRow];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane / LANES, l = lane % LANES;
  const int stride = blocks * kGfWarps * kPer;
  for (int p0 = rank * kGfWarps * kPer; p0 < u.points; p0 += stride) {
    const int p = p0 + warp * kPer + sub;
    const bool live = p < u.points;
    const int b = live ? p / u.n : 0;
    int nb[kNb];
#pragma unroll
    for (int i = 0; i < kNb; ++i) {
      const int j = l + LANES * i;
      nb[i] = live && j < g.k ? __ldg(u.idx + (size_t)p * u.idx_stride + j) : 0;
    }
    const float* tb = g.table + (size_t)b * u.n * g.ld;
    const float* tb2 = POST == GP_GATE ? g.table2 + (size_t)b * u.n * g.ld2 : nullptr;
    const float* wp = g.dw + (size_t)(live ? p : 0) * g.k * g.c;
    float4 m[VEC];
#pragma unroll
    for (int j0 = 0; j0 < KMAX; j0 += kGroup) {
      float4 tv[kGroup][VEC], wv[kGroup][VEC];
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int j = j0 + jj;
        const int row = __shfl_sync(0xffffffffu, nb[j / LANES], sub * LANES + j % LANES);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int c = 4 * (l + LANES * v);
          tv[jj][v] = wv[jj][v] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (live && j < g.k && c < g.c) {
            tv[jj][v] = __ldcg(reinterpret_cast<const float4*>(tb + (size_t)row * g.ld + c));
            if (POST == GP_GATE) {
              tv[jj][v] = add4(tv[jj][v], __ldcg(reinterpret_cast<const float4*>(
                                              tb2 + (size_t)row * g.ld2 + c)));
            }
            wv[jj][v] = __ldcs(reinterpret_cast<const float4*>(wp + (size_t)j * g.c + c));
          }
        }
      }
#pragma unroll
      for (int jj = 0; jj < kGroup; ++jj) {
        const int j = j0 + jj;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float4 t = tv[jj][v];
          if (g.leaky) t = make_float4(leaky(t.x), leaky(t.y), leaky(t.z), leaky(t.w));
          const float4 x = mul4(t, wv[jj][v]);
          if (j == 0) {
            m[v] = x;
          } else if (j < g.k) {
            m[v] = make_float4(take_max(m[v].x, x.x), take_max(m[v].y, x.y),
                               take_max(m[v].z, x.z), take_max(m[v].w, x.w));
          }
        }
      }
    }

    if (POST == GP_FC) {  // fc over the point's channels: lane sums, then the group's
      float acc[kMaxFc];
#pragma unroll
      for (int o = 0; o < kMaxFc; ++o) {
        acc[o] = 0.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const int c = 4 * (l + LANES * v);
          if (c < g.c && o < g.fc_out) {
            const float* w = g.fc_w + (size_t)c * g.fc_npad + o;
            acc[o] = __fmaf_rn(m[v].x, w[0], acc[o]);
            acc[o] = __fmaf_rn(m[v].y, w[g.fc_npad], acc[o]);
            acc[o] = __fmaf_rn(m[v].z, w[2 * g.fc_npad], acc[o]);
            acc[o] = __fmaf_rn(m[v].w, w[3 * g.fc_npad], acc[o]);
          }
        }
#pragma unroll
        for (int off = LANES / 2; off > 0; off >>= 1) {
          acc[o] += __shfl_xor_sync(0xffffffffu, acc[o], off);
        }
      }
      if (live && l == 0) {
#pragma unroll
        for (int o = 0; o < kMaxFc; ++o) {
          if (o < g.fc_out) g.out[(size_t)p * g.fc_out + o] = acc[o] + g.fc_b[o];
        }
      }
      continue;  // block-uniform: FC takes no fused layer
    }
    float4 res[VEC];  // the post op's result, the fused layer's input
#pragma unroll
    for (int v = 0; v < VEC; ++v) {
      const int c = 4 * (l + LANES * v);
      res[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (!live || c >= g.c) continue;
      if (POST == GP_ZR) {
        const float4 s = make_float4(sigmoid(m[v].x), sigmoid(m[v].y), sigmoid(m[v].z),
                                     sigmoid(m[v].w));
        if (c < g.half) {
          *reinterpret_cast<float4*>(g.out + (size_t)p * g.half + c) = s;
        } else {
          const size_t at = (size_t)p * g.half + (c - g.half);
          *reinterpret_cast<float4*>(g.out2 + at) =
              mul4(s, __ldg(reinterpret_cast<const float4*>(g.h + at)));
        }
      } else if (POST == GP_GATE) {
        const size_t at = (size_t)p * g.half + c;
        const float4 z = __ldcg(reinterpret_cast<const float4*>(g.z + at));
        const float4 h = __ldg(reinterpret_cast<const float4*>(g.h + at));
        res[v] = make_float4(gate(z.x, h.x, m[v].x), gate(z.y, h.y, m[v].y),
                             gate(z.z, h.z, m[v].z), gate(z.w, h.w, m[v].w));
        *reinterpret_cast<float4*>(g.out + at) = res[v];
      } else {
        res[v] = m[v];
        if (g.out) *reinterpret_cast<float4*>(g.out + (size_t)p * g.c + c) = m[v];
      }
    }
    if (kFusable && g.mlp_w != nullptr) {
      const int c = 4 * l;
      if (c < g.c) *reinterpret_cast<float4*>(&rows[warp][c]) = res[0];
      __syncthreads();
      gf_rows_dense(g, rows, p0, u.points);
      __syncthreads();  // the rows are read before the next points overwrite them
    }
  }
}

// Step `s` of the chain, one launch: dense z|r | q_xm, tail z|r, dense q_h,
// tail q (+ conv1), tail conv1 (+ conv2), tail conv2 (+ fc).
__global__ void __launch_bounds__(kGfThreads, 4)
    gru_flowhead_3d_kernel(const __grid_constant__ Gru3D u, int s) {
  const int rank = blockIdx.x, blocks = gridDim.x;
  if (s == 0 || s == 2) {
    gf_dense(u.layer[s / 2], rank, blocks);
  } else if (s == 1) {
    gf_tail<32, 2, kGruK, GP_ZR>(u, u.tail[0], rank, blocks);
  } else if (s == 3) {
    gf_tail<32, 1, kGruK, GP_GATE>(u, u.tail[1], rank, blocks);
  } else if (s == 4) {
    gf_tail<32, 1, kHeadK, GP_PLAIN>(u, u.tail[2], rank, blocks);
  } else {
    gf_tail<16, 1, kHeadK, GP_FC>(u, u.tail[3], rank, blocks);
  }
}

// The blocks a step can keep busy: its tiles, or its points over a block's
// warps.
int gf_blocks(const Gru3D& u, int s) {
  if (s == 0 || s == 2) {
    const Conv& a = u.layer[s / 2].a;
    return (a.pixels + kGfBM - 1) / kGfBM * (a.n_pad / kGfBN);
  }
  const int per_block = kGfWarps * (s == 5 ? 2 : 1);
  return (u.points + per_block - 1) / per_block;
}

GfLayer gf_layer(Conv a, const float* const* planes, int cout) {
  a.bias = planes[2];
  a = shaped(a, 1, 1, cout);
  return GfLayer{a, planes[0], planes[1], round_up(a.k_total, kTcBk)};
}

}  // namespace

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

extern "C" int camli_motion_encoder_3d(
    const float* flow, const float* corr, const int* idx, const float* dw_c1,
    const float* dw_f1, const float* dw_f2, const float* dw_m, const float* w_c1,
    const float* b_c1, const float* w_f1, const float* b_f1, const float* w_f2,
    const float* b_f2, const float* w_m, const float* b_m, float* scratch, float* out,
    int batch, int n, int idx_stride, int c_flow, int c_corr, int c_c1, int c_f1,
    int c_f2, int c_m, int k_c1, int k_f1, int k_f2, int k_m, cudaStream_t stream) {
  // scratch, channels per point: [c_c1 table | c_f1 table | corr_feat (c_c1) |
  // c_f2 table | c_m table]
  const size_t p = (size_t)batch * n;
  float* t_c1 = scratch;
  float* t_f1 = t_c1 + p * c_c1;
  float* corr_feat = t_f1 + p * c_f1;
  float* t_f2 = corr_feat + p * c_c1;
  float* t_m = t_f2 + p * c_f2;

  staged::Stage a = staged::points(batch, n), b = staged::points(batch, n);
  staged::mlp(a, w_c1, b_c1, c_c1, staged::ACT_LEAKY, t_c1, corr, c_corr);
  staged::mlp(b, w_f1, b_f1, c_f1, staged::ACT_LEAKY, t_f1, flow, c_flow);
  CAMLI_TRY(staged::launch(a, &b, stream));

  a = staged::points(batch, n), b = staged::points(batch, n);
  staged::gather(a, t_c1, dw_c1, idx, idx_stride, k_c1, c_c1);
  a.out = corr_feat, a.out_stride = c_c1;
  staged::gather(b, t_f1, dw_f1, idx, idx_stride, k_f1, c_f1);
  staged::mlp(b, w_f2, b_f2, c_f2, staged::ACT_LEAKY, t_f2, nullptr, c_f1).g_slot = 0;
  CAMLI_TRY(staged::launch(a, &b, stream));

  a = staged::points(batch, n);
  staged::gather(a, t_f2, dw_f2, idx, idx_stride, k_f2, c_f2);
  staged::mlp(a, w_m, b_m, c_m, staged::ACT_LEAKY, t_m, corr_feat, c_c1, nullptr, c_f2)
      .g_slot = 1;
  CAMLI_TRY(staged::launch(a, nullptr, stream));

  a = staged::points(batch, n);
  staged::gather(a, t_m, dw_m, idx, idx_stride, k_m, c_m);
  a.out = out, a.out_stride = c_m + c_flow, a.tail = flow, a.tail_c = c_flow;
  return staged::launch(a, nullptr, stream);
}

// planes: (hi, lo, bias) of [z|r | q_xm] and q_h (tf32 planes [N_pad][K_pad]);
// w_1, b_1, w_2, b_2: conv1's and conv2's f32 weights [K_pad, npad] and
// biases; w_fc [>= c_2, fc_npad].
extern "C" int camli_gru_flowhead_3d(
    const float* h, const float* x3d, const float* motion, const int* idx,
    const float* dw_zr, const float* dw_q, const float* dw_1, const float* dw_2,
    const float* const* planes, const float* w_1, const float* b_1, const float* w_2,
    const float* b_2, const float* w_fc, const float* b_fc, float* scratch, float* h_out,
    float* delta, int batch, int n, int idx_stride, int c_h, int c_x, int c_m, int c_1,
    int c_2, int c_out, int k_zr, int k_q, int k_1, int k_2, int npad_1, int npad_2,
    int fc_npad, cudaStream_t stream) {
  // scratch, channels per point: [[z|r | q_xm] table (3 c_h) | z (c_h) |
  // r*h (c_h) | q_h table (c_h) | conv1 table (c_1) | conv2 table (c_2)]
  const int points = batch * n;
  const size_t p = points;
  float* t_zrq = scratch;
  float* z = t_zrq + p * 3 * c_h;
  float* rh = z + p * c_h;
  float* t_qh = rh + p * c_h;
  float* t_1 = t_qh + p * c_h;
  float* t_2 = t_1 + p * c_1;

  Gru3D u = {};
  u.points = points, u.n = n, u.idx = idx, u.idx_stride = idx_stride;
  Conv a = input(points, points, 1, h, c_h, x3d, c_x, motion, c_m);
  a.out = t_zrq;
  u.layer[0] = gf_layer(a, planes, 3 * c_h);
  a = input(points, points, 1, rh, c_h);
  a.out = t_qh;
  u.layer[1] = gf_layer(a, planes + 3, c_h);

  GfTail& zr = u.tail[0];
  zr.table = t_zrq, zr.ld = 3 * c_h, zr.dw = dw_zr, zr.k = k_zr, zr.c = 2 * c_h;
  zr.out = z, zr.out2 = rh, zr.h = h, zr.half = c_h;
  GfTail& q = u.tail[1];
  q.table = t_qh, q.ld = c_h, q.table2 = t_zrq + 2 * c_h, q.ld2 = 3 * c_h;
  q.dw = dw_q, q.k = k_q, q.c = c_h, q.out = h_out, q.h = h, q.z = z, q.half = c_h;
  q.mlp_w = w_1, q.mlp_b = b_1, q.mlp_out = t_1, q.mlp_cout = c_1, q.mlp_npad = npad_1;
  GfTail& c1 = u.tail[2];
  c1.table = t_1, c1.ld = c_1, c1.dw = dw_1, c1.k = k_1, c1.c = c_1, c1.leaky = 1;
  c1.mlp_w = w_2, c1.mlp_b = b_2, c1.mlp_out = t_2, c1.mlp_cout = c_2, c1.mlp_npad = npad_2;
  GfTail& c2 = u.tail[3];
  c2.table = t_2, c2.ld = c_2, c2.dw = dw_2, c2.k = k_2, c2.c = c_2, c2.leaky = 1;
  c2.out = delta, c2.fc_w = w_fc, c2.fc_b = b_fc, c2.fc_out = c_out, c2.fc_npad = fc_npad;

  for (int s = 0; s < kGfSteps; ++s) {
    const int smem = s == 0 || s == 2 ? GfTile::kSmemBytes : 0;
    gru_flowhead_3d_kernel<<<gf_blocks(u, s), kGfThreads, smem, stream>>>(u, s);
    CAMLI_TRY((int)cudaGetLastError());
  }
  return 0;
}

// One PointConvDW tail on its own: out[b, q, c] = max_j table[b, idx[b, q, j],
// c] * dw[b, q, j, c] for m queries against a table of n_table rows, as one
// gather-only stage. It replaces camliflow_tpu/ops/pallas_ohg.py::dw_conv_ohg
// (whose one-hot selection is a TPU device; here the gather is a load), on
// the flagship's fuse_hidden path: GRU3D's z|r and q, FlowHead3D's conv1 and
// conv2, with their MLPs outside, as dw_conv_ohg leaves them. Bound by
// reading the hoisted weights (m x k x c floats).
extern "C" int camli_dw_max(const float* table, const float* dw, const int* idx, float* out,
                            int batch, int n_table, int m, int idx_stride, int k, int c,
                            cudaStream_t stream) {
  staged::Stage a = staged::points(batch, m);
  staged::gather(a, table, dw, idx, idx_stride, k, c);
  a.t_n = n_table;
  a.out = out, a.out_stride = c;
  return staged::launch(a, nullptr, stream);
}
