// The 3D update chain of the refinement loop: two entry points, each a short
// sequence of launches of one stage kernel.
//
// camli_motion_encoder_3d replaces
//   camliflow_tpu/ops/pallas_update3d.py::motion_encoder_3d_pallas:
//   MotionEncoder3D's four PointConvDW (conv_c1 k=16 on corr, conv_f1 k=32
//   and conv_f2 k=16 on the flow, the merge conv k=16 over [corr_feat,
//   flow_feat]), then the flow appended. 4 launches.
// camli_gru_flowhead_3d replaces
//   camliflow_tpu/ops/pallas_update3d.py::gru_flowhead_3d_pallas: GRU3D
//   (z|r and q PointConvDW at k=4 over hx = [h, x3d, motion]) and FlowHead3D
//   (two PointConvDW at k=32, then fc 64->3), returning (h', delta).
//   5 launches.
// camli_dw_max replaces camliflow_tpu/ops/pallas_ohg.py::dw_conv_ohg: one
//   PointConvDW tail (gather, multiply, max over k) as one gather-only
//   stage, for the flagship's fuse_hidden path, where CLFM sits between
//   GRU3D and FlowHead3D. 1 launch.
//
// A PointConvDW is out[q, c] = max_j table[idx[q, j], c] * w[q, j, c], where
// table is the conv's MLP (one Linear, leaky ReLU or none) over every point
// and w the geometric weights hoisted out of the loop ([B, N, k, C] f32).
// The gather reads other points' rows, so a table must be complete before
// its gather starts: that is where the launches split. Per-point work fuses:
// a stage gathers for its 16 points into shared memory and feeds the gathered
// rows straight into the next MLP, so the gathered features of conv_f1,
// conv_f2, z|r, q, conv1 and conv2 never reach device memory. Stages:
//   #6: [MLP c1 | MLP f1] -> [gather c1 -> corr_feat | gather f1 -> MLP f2]
//       -> [gather f2 -> merge MLP over (corr_feat, flow_feat)]
//       -> [gather merge -> out, flow]
//   #7: [MLP z|r over (h, x3d, motion)]
//       -> [gather z|r -> z, r*h -> MLP q over (r*h, x3d, motion)]
//       -> [gather q -> h' = (1-z) h + z tanh(q) -> MLP conv1]
//       -> [gather conv1 -> MLP conv2] -> [gather conv2 -> fc]
// The JAX chain (camliflow_tpu/models/camliraft_l.py) applies no nan_to_num
// anywhere in it, and neither does this one.
//
// Numerics: f32 throughout. A gathered product is one rounded multiply and
// the max is exact, so the gathers equal the plain versions bit for bit (NaN
// propagates as in torch.amax); the MLPs accumulate in f32 with explicit
// __fmaf_rn in another order than the plain versions' matmuls.
//
// Bound on the card at the main-path shape (N = 2048 points, bs=1): each
// call reads its hoisted weights once, 5,328 floats per point for #6
// (16x128 + 32x32 + 16x16 + 16x125; 43.6 MB) and 7,680 for #7 (4x256 +
// 4x128 + 32x128 + 32x64; 62.9 MB), against ~0.2 GFLOP of MLPs: 13 us and
// 19 us at 3.35 TB/s, bound by bytes. The gather loop reads the weights
// coalesced over channels, one point's k x C block per row of threads. At
// N = 2048 the work is too small to fill the card with large tiles, and a
// gather is a chain of dependent loads per thread, so a block takes 16
// points (128 blocks a stage, not 32) and the gather loop is unrolled for
// loads in flight. The MLP tile is the 2D chain's with one point per thread
// (16 points x 64 channels, 256 threads, 1 x 4 per thread, reduction chunks
// of 16 in shared memory) on weights packed once per request as
// [K_pad, N_pad].
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

  Stage a = points(batch, n), b = points(batch, n);
  mlp(a, w_c1, b_c1, c_c1, ACT_LEAKY, t_c1, corr, c_corr);
  mlp(b, w_f1, b_f1, c_f1, ACT_LEAKY, t_f1, flow, c_flow);
  CAMLI_TRY(launch(a, &b, stream));

  a = points(batch, n), b = points(batch, n);
  gather(a, t_c1, dw_c1, idx, idx_stride, k_c1, c_c1);
  a.out = corr_feat, a.out_stride = c_c1;
  gather(b, t_f1, dw_f1, idx, idx_stride, k_f1, c_f1);
  mlp(b, w_f2, b_f2, c_f2, ACT_LEAKY, t_f2, nullptr, c_f1).g_slot = 0;
  CAMLI_TRY(launch(a, &b, stream));

  a = points(batch, n);
  gather(a, t_f2, dw_f2, idx, idx_stride, k_f2, c_f2);
  mlp(a, w_m, b_m, c_m, ACT_LEAKY, t_m, corr_feat, c_c1, nullptr, c_f2).g_slot = 1;
  CAMLI_TRY(launch(a, nullptr, stream));

  a = points(batch, n);
  gather(a, t_m, dw_m, idx, idx_stride, k_m, c_m);
  a.out = out, a.out_stride = c_m + c_flow, a.tail = flow, a.tail_c = c_flow;
  return launch(a, nullptr, stream);
}

extern "C" int camli_gru_flowhead_3d(
    const float* h, const float* x3d, const float* motion, const int* idx,
    const float* dw_zr, const float* dw_q, const float* dw_1, const float* dw_2,
    const float* w_zr, const float* b_zr, const float* w_q, const float* b_q,
    const float* w_1, const float* b_1, const float* w_2, const float* b_2,
    const float* w_fc, const float* b_fc, float* scratch, float* h_out, float* delta,
    int batch, int n, int idx_stride, int c_h, int c_x, int c_m, int c_1, int c_2,
    int c_out, int k_zr, int k_q, int k_1, int k_2, cudaStream_t stream) {
  // scratch, channels per point: [z|r table (2 c_h) | z (c_h) | q table (c_h) |
  // conv1 table (c_1) | conv2 table (c_2)]
  const size_t p = (size_t)batch * n;
  float* t_zr = scratch;
  float* z = t_zr + p * 2 * c_h;
  float* t_q = z + p * c_h;
  float* t_1 = t_q + p * c_h;
  float* t_2 = t_1 + p * c_1;

  Stage a = points(batch, n);
  mlp(a, w_zr, b_zr, 2 * c_h, ACT_NONE, t_zr, h, c_h, x3d, c_x, motion, c_m);
  CAMLI_TRY(launch(a, nullptr, stream));

  a = points(batch, n);
  gather(a, t_zr, dw_zr, idx, idx_stride, k_zr, 2 * c_h);
  a.post = POST_ZR, a.h = h, a.side = z, a.half = c_h;
  mlp(a, w_q, b_q, c_h, ACT_NONE, t_q, nullptr, c_h, x3d, c_x, motion, c_m).g_slot = 0;
  CAMLI_TRY(launch(a, nullptr, stream));

  a = points(batch, n);
  gather(a, t_q, dw_q, idx, idx_stride, k_q, c_h);
  a.post = POST_GATE, a.h = h, a.z = z, a.side = h_out, a.half = c_h;
  mlp(a, w_1, b_1, c_1, ACT_LEAKY, t_1, nullptr, c_h).g_slot = 0;
  CAMLI_TRY(launch(a, nullptr, stream));

  a = points(batch, n);
  gather(a, t_1, dw_1, idx, idx_stride, k_1, c_1);
  mlp(a, w_2, b_2, c_2, ACT_LEAKY, t_2, nullptr, c_1).g_slot = 0;
  CAMLI_TRY(launch(a, nullptr, stream));

  a = points(batch, n);
  gather(a, t_2, dw_2, idx, idx_stride, k_2, c_2);
  mlp(a, w_fc, b_fc, c_out, ACT_NONE, delta, nullptr, c_2).g_slot = 0;
  return launch(a, nullptr, stream);
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
  Stage a = points(batch, m);
  gather(a, table, dw, idx, idx_stride, k, c);
  a.t_n = n_table;
  a.out = out, a.out_stride = c;
  return launch(a, nullptr, stream);
}
