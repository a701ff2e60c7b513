// The 3D update chain of the refinement loop, and the PointConvDW tail.
//
// camli_motion_encoder_3d replaces
//   camliflow_tpu/ops/pallas_update3d.py::motion_encoder_3d_pallas:
//   MotionEncoder3D's four PointConvDW (conv_c1 k=16 on corr, conv_f1 k=32
//   and conv_f2 k=16 on the flow, the merge conv k=16 over [corr_feat,
//   flow_feat]), then the flow appended. 5 launches ("#6" below).
// camli_gru_flowhead_3d replaces
//   camliflow_tpu/ops/pallas_update3d.py::gru_flowhead_3d_pallas: GRU3D
//   (z|r and q PointConvDW at k=4 over hx = [h, x3d, motion], h' = (1-z) h
//   + z tanh(q)) and FlowHead3D (two PointConvDW at k=32, then fc 64->3),
//   returning (h', delta). 6 launches ("#7" below).
// camli_dw_max replaces camliflow_tpu/ops/pallas_ohg.py::dw_conv_ohg: one
//   PointConvDW tail (gather, multiply, max over k) on its own, for the
//   flagship's fuse_hidden path, where CLFM sits between GRU3D and
//   FlowHead3D and the MLPs run outside. 1 launch.
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
// the max is exact and taken in neighbour order, so a tail equals the plain
// version's gather bit for bit (NaN propagates as in torch.amax); the dense
// layers sum in another order than the plain versions' matmuls (on the
// tensor cores by the 3xTF32 split, conv_tile_tc.cuh, or in f32 FMA).
//
// The bf16 form (dw_kind DW_BF16; fast_inference=on) reads bf16 hoisted weights
// and computes the JAX package's PointConvDW with fast=True
// (camliflow_tpu/nn/point_conv.py): the table value, after its activation,
// rounded to bf16 (the MLP output cast to bf16 before the gather), its
// product with the weight rounded to bf16 (nearest, ties to even: the
// product of two bf16 values is exact in f32, so one rounding, as a bf16
// multiply), the max over k in neighbour order, the result as f32. So a fast
// tail equals dw_max_plain on bf16 weights bit for bit. The dense layers
// (f32 sums) and the post ops stay f32. #6 and #7 keep their tables in bf16:
// every producer of a gathered table (the tile's dense steps, EPI_TABLE;
// f1's FMA blocks; the fused FMA epilogues) writes it once, its activation
// applied and rounded (q's table: q_h + q_xm summed in f32 first, in q_h's
// epilogue), so a tail reads table rows and weights alike as bf16 words, 16
// bytes (8 channels) a load (8 bytes, 4 channels, in a launch that fits in a
// wave: SH_LANES), or 4 bytes (2 channels) on #6's 32- and 16-channel
// tails, and takes mul.rn.bf16x2 on the words as loaded: 2
// products an instruction, widened to f32 (a shift, a mask) for the max,
// whose neighbour order and NaN rule (take_max) packed bf16 max
// instructions do not give. A lane keeps as many bytes of neighbour rows in
// flight as the f32 form, so twice the rows at the same channels (kGfRows).
// #13's fast form (dw_max) reads an f32 table, rounded into bf16 words as a
// row is read (cvt.rn.bf16x2), and its bf16 weights as packed words: where
// C is a multiple of 8 and the rows are 16-byte aligned, a lane takes 8
// channels, the table in two 16-byte loads and the weights in one, and the
// words go to mul.rn.bf16x2 as loaded (dw_max_words: C / 8 lanes across a
// point's channels, 16 at 128, 8 at 64, in rounds of 256 past that, and
// where k is more than a lane keeps in flight the warp's other lanes split
// the neighbours); elsewhere the f32 form's shapes, each weight widened to
// f32 and repacked with its table value (bf16_products).
//
// The int8 form (dw_kind DW_INT8; CAMLIFLOW_UPDATE3D=1 with fast_inference
// on) computes the TPU kernels' own numerics (pallas_update3d.py's _matmul
// and _dw_conv): int8 hoisted weights, whose scale a channel the wrapper
// folded into the conv's MLP (|w| <= 127 is a bf16 value exactly), so the
// products and the max are the bf16 form's; and every dense layer on bf16
// operands with f32 sums: the tile's steps in its bf16 mode
// (conv_tile_tc.cuh, the weights' one bf16 plane), the FMA layers (f1, and
// the epilogues f2, conv1, conv2 and fc) on weights the wrapper rounded to
// bf16 and inputs rounded to bf16 as they are taken. The weight stream is a
// quarter of the f32 form's. #6's and #7's int8 forms work as the bf16 form
// does: bf16 tables written once by their producers (the tile's dense steps
// in its bf16 mode through EPI_TABLE, f1's FMA blocks, the FMA epilogues), a
// lane's 8 channels of table in one 16-byte load and of int8 weights in one
// 8-byte load (or 4 channels in 8 and 4 bytes: SH_LANES, and #6's own rows
// SH_I8_WIDE / SH_I8_LANES, whose f1 and f2 tails take 8 or 4 channels a
// lane), each pair of int8 weights widened exactly into a bf16 word after
// the group's loads (word_products), then mul.rn.bf16x2: the same table
// rounding and products as the f32 tables they had before, so the same
// bits.
//
// All three kernels are chains of two kinds of step, one launch a step:
// - a dense step runs conv_tile_tc.cuh's 3xTF32 tile over the points (a 1x1
//   conv, EPI_NONE: the table before its activation), as a kernel of its
//   own;
// - a tail (`tail` below) gathers for its points, built for bytes: a warp,
//   or LANES lanes of it, a point; the point's neighbour indices read once
//   and handed to the other lanes by shuffles; narrow f32 rows (#6's f1
//   and f2, #13 up to 64 channels) a lane a channel, or two (4-byte loads,
//   a point a warp, so that a step keeps enough points in flight); wider
//   rows 16-byte loads (4 channels a load) where the channel count is a
//   multiple of 4 and the rows are aligned, else 4-byte loads of channel
//   lane + 32 v (a warp still reads 128 contiguous bytes a row); kGfRows
//   16-byte rows of the table and of the weights in
//   flight a lane (as many bytes in 4-byte loads, at most 16 rows; bf16
//   tables 32), the weights streamed once (__ldcs); the table's activation
//   applied as a row is read (bf16 tables: by their producer); each result
//   written once, after its post op, to an L2-resident scratch or the
//   output. A small dense layer that follows may run as its f32 FMA
//   epilogue over the block's rows in shared memory. Each tail launch is a
//   kernel of its own (the step a template argument), with its own
//   registers; its shape (lanes a point, loads a lane, values a load) is in
//   kGfShape / kMeShape, by form.
// Bound on the card: every kernel here reads its hoisted weights once, and
// these dominate its bytes; its dense layers are ~4-20 us as 3xTF32.
//   #7 at N = 2048 points, bs=1: 7,680 floats a point (4x256 + 4x128 +
//   32x128 + 32x64; 62.9 MB), ~20 us at 3.35 TB/s.
//   #6: 5,328 floats a point (16x128 + 32x32 + 16x16 + 16x125; 43.6 MB),
//   ~14 us. The bf16 form's weights take half: 31.5 and 21.8 MB, ~9 and
//   ~7 us.
//   #13: M x k x C floats (fuse_hidden: z|r 8.4 MB, q 4.2, conv1 33.6,
//   conv2 16.8).
// Measured on an H100 (PERF.md): one cooperative launch with grid barriers
// between #7's steps cost more than the launch gaps it replaces, and
// conv1/conv2 on the tile (8 launches) gained about 5% at 16,384 points and
// lost at 2048. The earlier stage kernel of #6 and #13 (16-point tiles,
// 4-byte gathers a thread per (point, channel), its MLPs on f32 FMA) ran
// 6-10x above their bounds.
#include <cuda_runtime.h>
#include <stdint.h>

#include "conv_tile_tc.cuh"

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

namespace {

constexpr int kGfThreads = 128;  // the tile's 4 warps; a tail's 4 warps
constexpr int kGfWarps = kGfThreads / 32;
constexpr int kGfBM = 32, kGfBN = 64;  // the tile: 32 points x 64 channels, 2 x 2 warps
using GfTile = TcShape<kGfBM, kGfBN, 2, 2, 1>;
constexpr int kGfRows = 8;   // 16-byte neighbour rows (table + weights) a lane keeps in flight
constexpr int kB16Group = 32;  // bf16 tables: the most neighbour rows a lane keeps in flight
constexpr int kGruK = 8;     // the neighbours GRU3D's tails unroll (the model's: 4)
constexpr int kHeadK = 32;   // FlowHead3D's, #6's and #13's (the model's: 16 or 32)
constexpr int kMaxFc = 4;    // fc outputs (the model's: 3)
constexpr int kMaxRow = 128; // a fused layer's input channels, and its outputs
constexpr int kTailAlign = 16;  // bytes: the 16-byte form's alignment of every row it reads

enum GfPost { GP_ZR = 0, GP_GATE = 1, GP_PLAIN = 2, GP_FC = 3 };
enum DwKind { DW_F32 = 0, DW_BF16 = 1, DW_INT8 = 2 };  // the hoisted weights' dtype

// A tail's shape: `lanes` lanes a point, `vec` loads a lane and row, of `w`
// values each (f32 tables: floats, 16 or 4 bytes; bf16 tables: bf16 values,
// 8 in 16 bytes, 4 in 8 or 2 in 4). By shape row and step. Rows: SH_F32
// (f32 tables: the exact form); the bf16 form's SH_WIDE (16-byte loads) and
// SH_LANES (8-byte loads on the 64- and 128-channel tails, twice the lanes
// a point), which a launch takes while its grid fits in one wave of
// resident blocks (`one_wave`): there each lane's chain of loads bounds it,
// and more lanes cut the chain; past a wave, SH_WIDE's fewer, wider loads
// were faster on an H100 (PERF.md). #7's int8 form takes the same two rows
// by the same rule (bf16 tables; the int8 weights of a lane's channels in
// one load of half the table's bytes: 8 bytes in SH_WIDE, 4 in SH_LANES).
// #6's int8 form takes rows of its own by that rule, SH_I8_WIDE and
// SH_I8_LANES: c1 and the merge as the bf16 form's, f1 and f2 8 channels a
// lane (8-byte int8 loads) or 4 (4-byte), so that no int8 load is narrower
// than 4 bytes.
struct TailShape {
  int lanes, vec, w;
};
enum ShapeRow { SH_F32 = 0, SH_WIDE = 1, SH_LANES = 2, SH_I8_WIDE = 3, SH_I8_LANES = 4 };
// #7: z|r (256 channels), q (128), conv1 (128), conv2 (64)
constexpr TailShape kGfShape[3][4] = {{{32, 2, 4}, {32, 1, 4}, {32, 1, 4}, {16, 1, 4}},
                                      {{32, 1, 8}, {16, 1, 8}, {16, 1, 8}, {8, 1, 8}},
                                      {{32, 1, 8}, {32, 1, 4}, {32, 1, 4}, {16, 1, 4}}};
// #6: c1 (128), f1 (32), f2 (16), merge (125, rows of 128)
constexpr TailShape kMeShape[5][4] = {{{32, 1, 4}, {32, 1, 1}, {32, 1, 1}, {32, 1, 4}},
                                      {{16, 1, 8}, {16, 1, 2}, {8, 1, 2}, {16, 1, 8}},
                                      {{32, 1, 4}, {16, 1, 2}, {8, 1, 2}, {32, 1, 4}},
                                      {{16, 1, 8}, {4, 1, 8}, {2, 1, 8}, {16, 1, 8}},
                                      {{32, 1, 4}, {8, 1, 4}, {4, 1, 4}, {32, 1, 4}}};

// One tail: g[p, c] = max_j act(table[idx[p, j], c]) * dw[p, j, c], c < c,
// then the post op.
struct Tail {
  int points, n, n_table;  // B*M points; M a batch item's points, n_table its table's rows
  const int* idx;          // [points, idx_stride], the first k columns, local to a batch item
  int idx_stride;
  const void* table;    // [B * n_table, ld], the dense layer's output before its activation
                        // (f32), or after it, rounded (bf16 tables)
  const float* table2;  // GATE, f32 tables: added to the table (q's x3d/motion part),
                        // [B * n_table, ld2]
  int ld, ld2;
  const void* dw;       // [points, k, dw_ld] f32, bf16 or int8 (DwKind), the first c of a row
  int dw_ld, k, c, leaky;  // leaky: the table's leaky ReLU, applied as a row is read
  float* out;           // ZR: z [points, half]; GATE: h'; PLAIN: g [points, out_ld] (or none)
  int out_ld;
  float* out2;          // ZR: r * h
  const float* h;       // ZR, GATE: the hidden state [points, half]
  const float* z;       // GATE: the update gate
  int half;             // ZR, GATE: hidden channels
  const float* copy;    // PLAIN: copy[p, j] to out[p, c + j], j < copy_c
  int copy_c;
  const float* fc_w;    // FC: [>= c, fc_npad], and its bias
  const float* fc_b;
  int fc_out, fc_npad;
  const float* mlp_w;   // fused: the next dense layer [>= c, mlp_npad]
  const float* mlp_b;
  void* mlp_out;        // its output before the activation [points, mlp_cout] (f32), or
                        // its leaky ReLU rounded, the next bf16 table (bf16 tables)
  int mlp_cout, mlp_npad;
};

struct GfLayer {  // a dense layer: a 1x1 conv on the tile, and its tf32 planes
  Conv a;
  const float* hi;
  const float* lo;
  int k_pad;
};

__device__ __forceinline__ float leaky(float v) { return v > 0.f ? v : __fmul_rn(0.1f, v); }

// dw_max's step: the larger, and NaN once one is NaN (torch.amax)
__device__ __forceinline__ float take_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}

// neighbour j's products x into the running max m, in neighbour order
template <int E>
__device__ __forceinline__ void max_step(float (&m)[E], const float (&x)[E], int j, int k) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (j == 0) {
      m[e] = x[e];
    } else if (j < k) {
      m[e] = take_max(m[e], x[e]);
    }
  }
}

__device__ __forceinline__ float gate(float z, float h, float q) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.f, z), h), __fmul_rn(z, tanhf(q)));
}

// W consecutive floats (W = 4: one 16-byte load; 8: two; 2: one 8-byte load)
// to and from registers
template <int W>
struct Vec {
  float x[W];
};

enum Cache { LD_CG = 0, LD_CS = 1, LD_G = 2 };

template <int CACHE, typename T>
__device__ __forceinline__ T ld(const T* p) {
  return CACHE == LD_CG ? __ldcg(p) : CACHE == LD_CS ? __ldcs(p) : __ldg(p);
}

template <int W, int CACHE>
__device__ __forceinline__ Vec<W> load(const float* p) {
  Vec<W> r;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const float4 v = ld<CACHE>(reinterpret_cast<const float4*>(p) + i);
      r.x[4 * i] = v.x, r.x[4 * i + 1] = v.y, r.x[4 * i + 2] = v.z, r.x[4 * i + 3] = v.w;
    }
  } else if constexpr (W == 2) {
    const float2 v = ld<CACHE>(reinterpret_cast<const float2*>(p));
    r.x[0] = v.x, r.x[1] = v.y;
  } else {
    r.x[0] = ld<CACHE>(p);
  }
  return r;
}

// W consecutive bf16 values (W = 8: one 16-byte load; 4: one 8-byte load;
// 2: one 4-byte load), as loaded: W / 2 words, element 2i in word i's low
// half
template <int W>
struct Words {
  uint32_t x[W / 2];
};

template <int W, int CACHE>
__device__ __forceinline__ Words<W> load_words(const unsigned short* p) {
  static_assert(W == 8 || W == 4 || W == 2, "16-, 8- or 4-byte loads");
  Words<W> r;
  if constexpr (W == 8) {
    const uint4 v = ld<CACHE>(reinterpret_cast<const uint4*>(p));
    r.x[0] = v.x, r.x[1] = v.y, r.x[2] = v.z, r.x[3] = v.w;
  } else if constexpr (W == 4) {
    const uint2 v = ld<CACHE>(reinterpret_cast<const uint2*>(p));
    r.x[0] = v.x, r.x[1] = v.y;
  } else {
    r.x[0] = ld<CACHE>(reinterpret_cast<const unsigned int*>(p));
  }
  return r;
}

// two bf16 products, each rounded to bf16 (nearest, ties to even)
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// The fast form's products: bf16(t) * w, each rounded to bf16 (w is a bf16
// value, so the f32 product is exact and one rounding makes it the bf16
// product), as f32. Two at a time: t0, t1 rounded by one cvt, w0, w1
// repacked (their high halves), one mul.rn.bf16x2 (sm_90), the two products
// unpacked.
__device__ __forceinline__ float bf16_product(float t, float w) {
  return round_bf16(__fmul_rn(round_bf16(t), w));
}

__device__ __forceinline__ void bf16_products(float t0, float t1, float w0, float w1,
                                              float& x0, float& x1) {
  uint32_t t2, p2;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(t2) : "f"(t1), "f"(t0));
  const uint32_t w2 = __byte_perm(__float_as_uint(w0), __float_as_uint(w1), 0x7632);
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(p2) : "r"(t2), "r"(w2));
  x0 = __uint_as_float(p2 << 16);
  x1 = __uint_as_float(p2 & 0xffff0000u);
}

// int8 value e (0-3) of a word xor 0x80808080 (`biased`) as f32, exactly:
// the biased byte as the low byte of 2^23 + (w + 128), less 2^23 + 128
__device__ __forceinline__ float int8_f32(uint32_t biased, int e) {
  return __fsub_rn(__uint_as_float(__byte_perm(biased, 0x4b000000u, 0x7540 + e)), 8388736.f);
}

// W consecutive hoisted weights as words, streamed once (__ldcs), as
// loaded: bf16 W / 2 words, element 2i in word i's low half; int8 in one
// W-byte load, W / 4 words, element 4i + e in byte e of word i
template <int W, int DW>
__device__ __forceinline__ Words<W> load_dw_words(const void* base, size_t at) {
  if constexpr (DW == DW_INT8) {
    static_assert(W == 8 || W == 4, "8- or 4-byte loads");
    const signed char* p = static_cast<const signed char*>(base) + at;
    uint32_t raw[W / 4];
    if constexpr (W == 8) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      raw[0] = v.x, raw[1] = v.y;
    } else {
      raw[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
    }
    Words<W> r = {};
#pragma unroll
    for (int i = 0; i < W / 4; ++i) r.x[i] = raw[i];
    return r;
  } else {
    return load_words<W, LD_CS>(static_cast<const unsigned short*>(base) + at);
  }
}

// One neighbour row's products x[e] of the lane's E channels, from its
// table words and weight words as loaded, for take_max: mul.rn.bf16x2 on
// bf16 words, each product rounded to bf16, widened to f32 (a shift, a
// mask). int8 weights become bf16 words here, after the group's loads: each
// pair exactly (int8_f32, |w| <= 127 is a bf16 value) into one word by a
// byte permute. Widening them at each load instead (as the loads arrive)
// took #7's int8 form 1.24-1.43x as long on an H100; each bf16 table value
// times its int8 weight in f32 (exact) with the max rounded to bf16 once,
// the same bits, ran within 1.5% of this (PERF.md; update3d_forms'
// int8_f32).
template <int E, int DW>
__device__ __forceinline__ void word_products(const uint32_t (&tw)[E / 2],
                                              const uint32_t (&ww)[E / 2], float (&x)[E]) {
  uint32_t w2[E / 2];
  if constexpr (DW == DW_INT8) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const uint32_t biased = ww[i] ^ 0x80808080u;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        w2[2 * i + h] = __byte_perm(__float_as_uint(int8_f32(biased, 2 * h)),
                                    __float_as_uint(int8_f32(biased, 2 * h + 1)), 0x7632);
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < E / 2; ++e) w2[e] = ww[e];
  }
#pragma unroll
  for (int e = 0; e < E / 2; ++e) {
    const uint32_t prod = mul_bf16x2(tw[e], w2[e]);
    x[2 * e] = __uint_as_float(prod << 16);
    x[2 * e + 1] = __uint_as_float(prod & 0xffff0000u);
  }
}

// W consecutive hoisted weights, f32 or bf16 (DW), streamed once (__ldcs),
// as f32 values (the f32-table tails; int8 weights take bf16 tables)
template <int W, int DW>
__device__ __forceinline__ Vec<W> load_w(const void* base, size_t at) {
  static_assert(DW != DW_INT8, "int8 weights: load_dw_words");
  if constexpr (DW == DW_BF16) {
    const unsigned short* p = static_cast<const unsigned short*>(base) + at;
    Vec<W> r;
    if constexpr (W == 4) {  // one 8-byte load; element 0 in the low half
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      r.x[0] = __uint_as_float(v.x << 16), r.x[1] = __uint_as_float(v.x & 0xffff0000u);
      r.x[2] = __uint_as_float(v.y << 16), r.x[3] = __uint_as_float(v.y & 0xffff0000u);
    } else {
      r.x[0] = __uint_as_float((uint32_t)__ldcs(p) << 16);
    }
    return r;
  } else {
    return load<W, LD_CS>(static_cast<const float*>(base) + at);
  }
}

template <int W>
__device__ __forceinline__ void store(float* p, const Vec<W>& r) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      reinterpret_cast<float4*>(p)[i] =
          make_float4(r.x[4 * i], r.x[4 * i + 1], r.x[4 * i + 2], r.x[4 * i + 3]);
    }
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(r.x[0], r.x[1]);
  } else {
    p[0] = r.x[0];
  }
}

// A dense layer: the block takes tiles rank, rank + blocks, ... (BF: the
// tile's bf16 mode, the int8 form's; TB: its output a bf16 table, EPI_TABLE)
template <bool BF, bool TB>
__device__ __forceinline__ void gf_dense(const GfLayer& l, int rank, int blocks) {
  const int m_tiles = (l.a.pixels + kGfBM - 1) / kGfBM;
  const int tiles = m_tiles * (l.a.n_pad / kGfBN);
  for (int t = rank; t < tiles; t += blocks) {
    conv_tc_tile<kGfBM, kGfBN, 2, 2, 1, TB ? EPI_TABLE : EPI_NONE, BF>(
        l.a, l.hi, l.lo, l.k_pad, (t % m_tiles) * kGfBM, (t / m_tiles) * kGfBN);
    __syncthreads();  // the next tile's copies refill the ring
  }
}

// A fused dense layer over the block's R rows (points p0 + r): out[p, o] =
// sum_k rows[r][k] * w[k, o] + bias[o], f32 FMA in k order (TB: stored as
// the next tail's bf16 table, its leaky ReLU applied and rounded). A thread
// takes one output channel of kGfThreads / cout rows, so each weight is
// read once a block.
template <int R, bool TB>
__device__ __forceinline__ void rows_dense(const Tail& g, const float (*rows)[kMaxRow], int p0) {
  const int cout = g.mlp_cout;
  const int per = kGfThreads / cout;  // rows a weight serves at once
  const int t = threadIdx.x;
  if (t >= per * cout) return;
  const int o = t % cout, r0 = t / cout;
  float acc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
  int k = 0;
  for (; k + 16 <= g.c; k += 16) {  // 16 weights in flight, then their products in k order
    float w[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) w[q] = __ldg(g.mlp_w + (size_t)(k + q) * g.mlp_npad + o);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + i * per;
      if (r < R) {
#pragma unroll
        for (int q = 0; q < 16; q += 4) {
          const float4 x = *reinterpret_cast<const float4*>(&rows[r][k + q]);
          acc[i] = __fmaf_rn(x.x, w[q], acc[i]);
          acc[i] = __fmaf_rn(x.y, w[q + 1], acc[i]);
          acc[i] = __fmaf_rn(x.z, w[q + 2], acc[i]);
          acc[i] = __fmaf_rn(x.w, w[q + 3], acc[i]);
        }
      }
    }
  }
  for (; k < g.c; k += 4) {  // c is a multiple of 4
    const float* wk = g.mlp_w + (size_t)k * g.mlp_npad + o;
    const float w[4] = {__ldg(wk), __ldg(wk + g.mlp_npad), __ldg(wk + 2 * g.mlp_npad),
                        __ldg(wk + 3 * g.mlp_npad)};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + i * per;
      if (r < R) {
        const float4 x = *reinterpret_cast<const float4*>(&rows[r][k]);
        acc[i] = __fmaf_rn(x.x, w[0], acc[i]);
        acc[i] = __fmaf_rn(x.y, w[1], acc[i]);
        acc[i] = __fmaf_rn(x.z, w[2], acc[i]);
        acc[i] = __fmaf_rn(x.w, w[3], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i * per;
    if (r < R && p0 + r < g.points) {
      const float v = acc[i] + g.mlp_b[o];
      const size_t at = (size_t)(p0 + r) * cout + o;
      if constexpr (TB) {
        static_cast<unsigned short*>(g.mlp_out)[at] = bf16_bits(leaky(v));
      } else {
        static_cast<float*>(g.mlp_out)[at] = v;
      }
    }
  }
}

// A dense layer of few inputs as f32 FMA, a thread an output:
// out[p, o] = sum_i x[p, i] w[i, o] + bias[o] (#6's f1, 3 -> 32). BF: x
// rounded to bf16 as it is read (the int8 form; w arrives rounded). TB: out
// a bf16 table, the leaky ReLU applied and rounded.
template <bool BF, bool TB>
__device__ __forceinline__ void fma_dense(const float* x, int cin, const float* w,
                                          const float* bias, int npad, void* out, int cout,
                                          int points, int rank, int blocks) {
  const int total = points * cout;
  for (int e = rank * kGfThreads + threadIdx.x; e < total; e += blocks * kGfThreads) {
    const int p = e / cout, o = e - (e / cout) * cout;
    float acc = 0.f;
    for (int i = 0; i < cin; ++i) {
      float xv = __ldg(x + (size_t)p * cin + i);
      if (BF) xv = round_bf16(xv);
      acc = __fmaf_rn(xv, __ldg(w + (size_t)i * npad + o), acc);
    }
    const float v = __fadd_rn(acc, bias[o]);
    if constexpr (TB) {
      static_cast<unsigned short*>(out)[(size_t)p * cout + o] = bf16_bits(leaky(v));
    } else {
      static_cast<float*>(out)[(size_t)p * cout + o] = v;
    }
  }
}

// The tail. LANES lanes a point (32 / LANES points a warp), VEC loads of W
// values a lane and row: channel c0 + W * (lane + LANES * v) + e of the
// chunk at c0 (a chunk is LANES * VEC * W channels; wider tails take
// several). A lane holds the point's neighbour indices l, l + LANES, ... of
// the KMAX at jb (read once; more than KMAX neighbours take several
// rounds) and hands row j to the others by a shuffle; it keeps kGroup rows
// of the table and of the weights in flight, then takes their products and
// the max in neighbour order, bit for bit as dw_max_plain does. FUSE: the
// post op's result also goes to the block's rows in shared memory, and the
// next dense layer runs over them (the block's warps walk the points
// together). DW: the hoisted weights' dtype; bf16 and int8 take the fast
// forms' bf16 products, and int8 also rounds the fused layers' inputs (the
// rows, fc's) to bf16. TB (bf16 or int8 weights): the table is bf16, its
// activation applied by its producer, and the fused layer writes the next
// one so; the table and the weights arrive as words (load_words,
// load_dw_words) for word_products.
template <int LANES, int VEC, int W, int KMAX, int POST, bool FUSE, int DW, bool TB = false>
__device__ __forceinline__ void tail(const Tail& g, int rank, int blocks) {
  static_assert(!TB || DW != DW_F32, "bf16 tables take bf16 or int8 weights");
  static_assert(TB || DW != DW_INT8, "int8 weights take bf16 tables");
  static_assert(DW != DW_INT8 || VEC == 1, "a lane's int8 words: one load a row");
  constexpr int kPer = 32 / LANES;
  constexpr int kRowsB = kGfWarps * kPer;  // points a block takes at once
  constexpr int kNb = (KMAX + LANES - 1) / LANES;
  constexpr int kE = VEC * W;  // channels a lane holds of a row
  constexpr int kCw = LANES * kE;
  // rows in flight: kGfRows 16-byte rows' worth of bytes a lane
  constexpr int kFitB = kGfRows * 16 / (kE * (TB ? 2 : 4));
  constexpr int kMost = TB ? kB16Group : 16;
  constexpr int kFit = kFitB > kMost ? kMost : (kFitB > 0 ? kFitB : 1);
  constexpr int kGroup = KMAX < kFit ? KMAX : kFit;
  static_assert(KMAX % kGroup == 0, "whole groups of neighbour rows");
  static_assert(!FUSE || POST == GP_GATE || POST == GP_PLAIN, "a fused layer follows a row");
  __shared__ __align__(16) float rows[FUSE ? kRowsB : 1][FUSE ? kMaxRow : 4];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int sub = lane / LANES, l = lane % LANES;
  const int r = warp * kPer + sub;  // the point's row of the block
  const int stride = blocks * kRowsB;
  for (int p0 = rank * kRowsB; p0 < g.points; p0 += stride) {
    const int p = p0 + r;
    const bool live = p < g.points;
    const int b = live ? p / g.n : 0;
    const size_t tb = (size_t)b * g.n_table * g.ld;  // the batch item's first table value
    const float* tb2 =
        POST == GP_GATE && !TB ? g.table2 + (size_t)b * g.n_table * g.ld2 : nullptr;
    const size_t wp = (size_t)(live ? p : 0) * g.k * g.dw_ld;  // the point's first weight
    const int* ip = g.idx + (size_t)(live ? p : 0) * g.idx_stride;
    // FC: a lane's sums over each 4 channels it holds, as a lane of 4-byte
    // or 16-byte f32 loads sums them, so that every form adds fc's
    // products in one order
    constexpr int kSub = W > 4 ? W / 4 : 1;
    float acc[kSub][POST == GP_FC ? kMaxFc : 1];
#pragma unroll
    for (int s = 0; s < kSub; ++s) {
#pragma unroll
      for (int o = 0; o < (POST == GP_FC ? kMaxFc : 1); ++o) acc[s][o] = 0.f;
    }

    for (int c0 = 0; c0 < g.c; c0 += kCw) {
      float m[kE];
      for (int jb = 0; jb < g.k; jb += KMAX) {
        int nb[kNb];
#pragma unroll
        for (int i = 0; i < kNb; ++i) {
          const int j = jb + l + LANES * i;
          nb[i] = live && j < g.k ? __ldg(ip + j) : 0;
        }
#pragma unroll
        for (int j0 = 0; j0 < KMAX; j0 += kGroup) {
          if (jb + j0 >= g.k) break;  // warp-uniform
          if constexpr (TB) {  // words, as loaded, into the products
            uint32_t tw[kGroup][kE / 2], ww[kGroup][kE / 2];
#pragma unroll
            for (int jj = 0; jj < kGroup; ++jj) {
              const int jl = j0 + jj, j = jb + jl;
              const int row = __shfl_sync(0xffffffffu, nb[jl / LANES], sub * LANES + jl % LANES);
              const bool ok = live && j < g.k;
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const int c = c0 + W * (l + LANES * v);
                Words<W> t = {}, w = {};
                if (ok && c < g.c) {
                  t = load_words<W, LD_CG>(static_cast<const unsigned short*>(g.table) + tb +
                                           (size_t)row * g.ld + c);
                  w = load_dw_words<W, DW>(g.dw, wp + (size_t)j * g.dw_ld + c);
                }
#pragma unroll
                for (int e = 0; e < W / 2; ++e) {
                  tw[jj][v * W / 2 + e] = t.x[e], ww[jj][v * W / 2 + e] = w.x[e];
                }
              }
            }
#pragma unroll
            for (int jj = 0; jj < kGroup; ++jj) {
              const int j = jb + j0 + jj;
              float x[kE];
              word_products<kE, DW>(tw[jj], ww[jj], x);
              max_step<kE>(m, x, j, g.k);
            }
          } else {
            float tv[kGroup][kE], wv[kGroup][kE];
#pragma unroll
            for (int jj = 0; jj < kGroup; ++jj) {
              const int jl = j0 + jj, j = jb + jl;
              const int row = __shfl_sync(0xffffffffu, nb[jl / LANES], sub * LANES + jl % LANES);
              const bool ok = live && j < g.k;
#pragma unroll
              for (int v = 0; v < VEC; ++v) {
                const int c = c0 + W * (l + LANES * v);
#pragma unroll
                for (int e = 0; e < W; ++e) {
                  tv[jj][v * W + e] = wv[jj][v * W + e] = 0.f;
                }
                if (ok && c < g.c) {
                  Vec<W> t = load<W, LD_CG>(static_cast<const float*>(g.table) + tb +
                                            (size_t)row * g.ld + c);
                  if constexpr (POST == GP_GATE) {
                    const Vec<W> t2 = load<W, LD_CG>(tb2 + (size_t)row * g.ld2 + c);
#pragma unroll
                    for (int e = 0; e < W; ++e) t.x[e] = __fadd_rn(t.x[e], t2.x[e]);
                  }
#pragma unroll
                  for (int e = 0; e < W; ++e) tv[jj][v * W + e] = t.x[e];
                  const Vec<W> w = load_w<W, DW>(g.dw, wp + (size_t)j * g.dw_ld + c);
#pragma unroll
                  for (int e = 0; e < W; ++e) wv[jj][v * W + e] = w.x[e];
                }
              }
            }
#pragma unroll
            for (int jj = 0; jj < kGroup; ++jj) {
              const int j = jb + j0 + jj;
              float x[kE];
#pragma unroll
              for (int e = 0; e < kE; ++e) {
                float t = tv[jj][e];
                if (g.leaky) t = leaky(t);
                tv[jj][e] = t;
              }
              if constexpr (DW != DW_F32) {  // the bf16 products, two at a time where the lane holds two
#pragma unroll
                for (int e = 0; e + 1 < kE; e += 2) {
                  bf16_products(tv[jj][e], tv[jj][e + 1], wv[jj][e], wv[jj][e + 1], x[e], x[e + 1]);
                }
                if constexpr (kE % 2) x[kE - 1] = bf16_product(tv[jj][kE - 1], wv[jj][kE - 1]);
              } else {
#pragma unroll
                for (int e = 0; e < kE; ++e) x[e] = __fmul_rn(tv[jj][e], wv[jj][e]);
              }
              max_step<kE>(m, x, j, g.k);
            }
          }
        }
      }

      // the post op of the chunk
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int c = c0 + W * (l + LANES * v);
        if constexpr (POST == GP_FC) {  // the lane's sums of fc over its channels
#pragma unroll
          for (int o = 0; o < kMaxFc; ++o) {
#pragma unroll
            for (int e = 0; e < W; ++e) {
              if (c + e < g.c && o < g.fc_out) {
                const float x = DW == DW_INT8 ? round_bf16(m[v * W + e]) : m[v * W + e];
                float& a = acc[kSub > 1 ? e / 4 : 0][o];
                a = __fmaf_rn(x, g.fc_w[(size_t)(c + e) * g.fc_npad + o], a);
              }
            }
          }
          continue;
        }
        if (!live || c >= g.c) continue;
        Vec<W> res;
        if constexpr (POST == GP_ZR) {
#pragma unroll
          for (int e = 0; e < W; ++e) res.x[e] = sigmoid(m[v * W + e]);
          if (c < g.half) {
            store<W>(g.out + (size_t)p * g.half + c, res);
          } else {
            const size_t at = (size_t)p * g.half + (c - g.half);
            Vec<W> h = load<W, LD_G>(g.h + at);
#pragma unroll
            for (int e = 0; e < W; ++e) h.x[e] = __fmul_rn(res.x[e], h.x[e]);
            store<W>(g.out2 + at, h);
          }
        } else if constexpr (POST == GP_GATE) {
          const size_t at = (size_t)p * g.half + c;
          const Vec<W> z = load<W, LD_CG>(g.z + at);
          const Vec<W> h = load<W, LD_G>(g.h + at);
#pragma unroll
          for (int e = 0; e < W; ++e) res.x[e] = gate(z.x[e], h.x[e], m[v * W + e]);
          store<W>(g.out + at, res);
        } else {
#pragma unroll
          for (int e = 0; e < W; ++e) res.x[e] = m[v * W + e];
          if (g.out != nullptr && c + W <= g.c) {
            store<W>(g.out + (size_t)p * g.out_ld + c, res);
          } else if (g.out != nullptr) {  // the last channels of a row of c % W != 0
#pragma unroll
            for (int e = 0; e < W; ++e) {
              if (c + e < g.c) g.out[(size_t)p * g.out_ld + c + e] = res.x[e];
            }
          }
        }
        if constexpr (FUSE) {
          if constexpr (DW == DW_INT8) {
#pragma unroll
            for (int e = 0; e < W; ++e) res.x[e] = round_bf16(res.x[e]);
          }
          if (c < kMaxRow) store<W>(&rows[r][c], res);
        }
      }
    }

    if constexpr (POST == GP_FC) {  // the point's lanes add their sums
      static_assert(VEC == 1 && kSub <= 2, "fc: one load a lane, of up to 8 channels");
#pragma unroll
      for (int o = 0; o < kMaxFc; ++o) {
#pragma unroll
        for (int s = 0; s < kSub; ++s) {
#pragma unroll
          for (int off = LANES / 2; off > 0; off >>= 1) {
            acc[s][o] += __shfl_xor_sync(0xffffffffu, acc[s][o], off);
          }
        }
        // the lane's two sums last: each is a lane of 4 channels' butterfly
        if constexpr (kSub == 2) acc[0][o] += acc[1][o];
      }
      if (live && l == 0) {
#pragma unroll
        for (int o = 0; o < kMaxFc; ++o) {
          if (o < g.fc_out) g.out[(size_t)p * g.fc_out + o] = acc[0][o] + g.fc_b[o];
        }
      }
    }
    if (POST == GP_PLAIN && g.copy != nullptr && live) {
      for (int j = l; j < g.copy_c; j += LANES) {
        g.out[(size_t)p * g.out_ld + g.c + j] = g.copy[(size_t)p * g.copy_c + j];
      }
    }
    if constexpr (FUSE) {
      __syncthreads();
      rows_dense<kRowsB, TB>(g, rows, p0);
      __syncthreads();  // the rows are read before the next points overwrite them
    }
  }
}

// The blocks a tail of `lanes` lanes a point keeps busy: one round of its
// points over a block's warps.
int tail_blocks(const Tail& g, int lanes) {
  const int per_block = kGfWarps * (32 / lanes);
  return (g.points + per_block - 1) / per_block;
}

// The blocks of `kernel` the card holds at once: one wave. Each caller keeps
// it in a static of its own instantiation, so each tail reads its own
// registers' occupancy (a process's cards are taken to be of one kind).
template <typename K>
int one_wave(K kernel) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kGfThreads, 0);
  return sms * per_sm;
}

GfLayer gf_layer(Conv a, const float* const* planes, int cout) {
  a.bias = planes[2];
  a = shaped(a, 1, 1, cout);
  return GfLayer{a, planes[0], planes[1], round_up(a.k_total, kTcBk)};
}

Tail gather_of(int points, int n, const int* idx, int idx_stride, const void* table, int ld,
               const void* dw, int k, int c) {
  Tail g = {};
  g.points = points, g.n = n, g.n_table = n, g.idx = idx, g.idx_stride = idx_stride;
  g.table = table, g.ld = ld, g.dw = dw, g.dw_ld = c, g.k = k, g.c = c;
  return g;
}

// A dense step: a layer on the tile, and beside it, on blocks of their own,
// a layer of few inputs as f32 FMA (x == nullptr: none).
struct DenseStep {
  GfLayer layer;
  const float* x;  // [points, cin]
  const float* w;  // [>= cin, npad]
  const float* bias;
  void* out;       // [points, cout], f32 (bf16 tables: bf16)
  int points, cin, cout, npad;
};

template <bool BF, bool TB>
__device__ __forceinline__ void dense_step(const DenseStep& d) {
  const int tiles = (d.layer.a.pixels + kGfBM - 1) / kGfBM * (d.layer.a.n_pad / kGfBN);
  if ((int)blockIdx.x < tiles) {
    gf_dense<BF, TB>(d.layer, blockIdx.x, tiles);
  } else {
    fma_dense<BF, TB>(d.x, d.cin, d.w, d.bias, d.npad, d.out, d.cout, d.points,
                      blockIdx.x - tiles, gridDim.x - tiles);
  }
}

int dense_blocks(const DenseStep& d) {
  const int tiles = (d.layer.a.pixels + kGfBM - 1) / kGfBM * (d.layer.a.n_pad / kGfBN);
  return tiles + (d.x ? (d.points * d.cout + kGfThreads - 1) / kGfThreads : 0);
}

// The dense steps of #7 and of #6 are kernels of their own, apart from the
// tails: the tile keeps its registers (in one kernel with #6's tails it
// spilled). BF: bf16 operands (the int8 form); TB: bf16 tables out (the
// bf16 form).
template <bool BF, bool TB>
__global__ void __launch_bounds__(kGfThreads, 4)
    gru_flowhead_3d_dense(const __grid_constant__ DenseStep d) {
  dense_step<BF, TB>(d);
}

template <bool BF, bool TB>
__global__ void __launch_bounds__(kGfThreads, 4)
    motion_encoder_3d_dense(const __grid_constant__ DenseStep d) {
  dense_step<BF, TB>(d);
}

// (bf16 tables: the bf16 and int8 forms)
template <int DW>
int launch_dense(bool me, const DenseStep& d, cudaStream_t stream) {
  constexpr bool kBf = DW == DW_INT8, kTb = DW != DW_F32;
  const auto kernel = me ? motion_encoder_3d_dense<kBf, kTb> : gru_flowhead_3d_dense<kBf, kTb>;
  kernel<<<dense_blocks(d), kGfThreads, GfTile::kSmemBytes, stream>>>(d);
  return (int)cudaGetLastError();
}

// --- #7: GRU3D + FlowHead3D ---------------------------------------------------
//
// The chain as steps. q's input [r*h, x3d, motion] is split: its x3d and
// motion part does not wait for the z|r gather, so the first dense step
// computes it beside z|r (one [384 -> 384] product), and q's own dense step
// reduces over r*h alone (128 deep instead of 384):
//   dense [z|r | q_xm] over [h, x3d, motion]
//   tail z|r -> z = sigmoid, r*h = sigmoid * h
//   dense q_h over r*h
//   tail q (table q_h + q_xm) -> h' = (1-z) h + z tanh(q), then conv1 over h'
//   tail conv1 (leaky ReLU on read), then conv2 over it
//   tail conv2 (leaky ReLU on read) -> fc 64->3 -> delta
// conv1's and conv2's dense layers run as the FMA epilogue of the tail
// before them. The bf16 and int8 forms' tables are bf16: the first dense
// step writes z|r's (q_xm stays f32, [points, c_h]), q_h's adds q_xm and
// writes q's, and the epilogues write conv1's and conv2's with the leaky
// ReLU applied; the int8 form's dense steps on bf16 operands.

struct Gru3D {
  Tail tail[4];  // z|r, q, conv1, conv2
};

// step T of the chain's tails, for hoisted weights of dtype DW (bf16 and
// int8: on bf16 tables), in shape SH
template <int DW, int T, int SH>
__global__ void __launch_bounds__(kGfThreads, 4)
    gru_flowhead_3d_tail(const __grid_constant__ Gru3D u) {
  constexpr bool kTb = DW != DW_F32;
  constexpr TailShape s = kGfShape[SH][T];
  const int rank = blockIdx.x, blocks = gridDim.x;
  if constexpr (T == 0) {
    tail<s.lanes, s.vec, s.w, kGruK, GP_ZR, false, DW, kTb>(u.tail[0], rank, blocks);
  } else if constexpr (T == 1) {
    tail<s.lanes, s.vec, s.w, kGruK, GP_GATE, true, DW, kTb>(u.tail[1], rank, blocks);
  } else if constexpr (T == 2) {
    tail<s.lanes, s.vec, s.w, kHeadK, GP_PLAIN, true, DW, kTb>(u.tail[2], rank, blocks);
  } else {
    tail<s.lanes, s.vec, s.w, kHeadK, GP_FC, false, DW, kTb>(u.tail[3], rank, blocks);
  }
}

template <int DW, int T, int SH>
int launch_gf_tail(const Gru3D& u, cudaStream_t stream) {
  gru_flowhead_3d_tail<DW, T, SH>
      <<<tail_blocks(u.tail[T], kGfShape[SH][T].lanes), kGfThreads, 0, stream>>>(u);
  return (int)cudaGetLastError();
}

// step T in its form's shape: on bf16 tables (the bf16 and int8 forms)
// SH_LANES while it fits in a wave, else SH_WIDE
template <int DW, int T>
int launch_gf_tail(const Gru3D& u, cudaStream_t stream) {
  if constexpr (DW != DW_F32) {
    static const int wave = one_wave(gru_flowhead_3d_tail<DW, T, SH_LANES>);
    if (tail_blocks(u.tail[T], kGfShape[SH_LANES][T].lanes) <= wave) {
      return launch_gf_tail<DW, T, SH_LANES>(u, stream);
    }
    return launch_gf_tail<DW, T, SH_WIDE>(u, stream);
  } else {
    return launch_gf_tail<DW, T, SH_F32>(u, stream);
  }
}

// dense z|r | q_xm, tail z|r, dense q_h, tails q, conv1, conv2: 6 launches
template <int DW>
int gf_chain(const DenseStep& zrq, const DenseStep& qh, const Gru3D& u, cudaStream_t stream) {
  CAMLI_TRY(launch_dense<DW>(false, zrq, stream));
  CAMLI_TRY((launch_gf_tail<DW, 0>(u, stream)));
  CAMLI_TRY(launch_dense<DW>(false, qh, stream));
  CAMLI_TRY((launch_gf_tail<DW, 1>(u, stream)));
  CAMLI_TRY((launch_gf_tail<DW, 2>(u, stream)));
  return launch_gf_tail<DW, 3>(u, stream);
}

// --- #6: MotionEncoder3D ------------------------------------------------------
//
//   dense c1 over corr (the tile) | f1 over the flow (FMA; 3 inputs)
//   tail f1 (leaky on read), then f2's dense layer as its FMA epilogue
//   tail f2 (leaky on read) -> flow_feat | tail c1 (leaky on read) -> corr_feat
//   dense merge over [corr_feat, flow_feat] (the tile)
//   tail merge (leaky on read) -> out[:, :c_m], the flow copied to out[:, c_m:]
// c1's tail and f2's share a launch (c1's ready since the first step; beside
// f1's it ran slower on an H100, PERF.md). In the f32 form tails of at most
// 32 channels (f1 32, f2 16) take 32 lanes a point and 4-byte loads, so a
// step keeps one point a warp in flight; c1's and the merge's 16-byte
// loads, 32 lanes x 1.
// The merge conv's hoisted weights arrive with their 125 channels padded
// to 128 a row (models/camliraft_l.py; int8: 128 bytes), so its rows are
// 16-byte aligned: read 4 bytes at a time they took 190 registers and 1.7x
// the time. The bf16 form's tables are bf16, each written by its producer
// with the leaky ReLU applied (the tile's c1 and merge, f1's FMA blocks,
// f2's FMA epilogue), the merge's rows round_up(c_m, 8) values apart (its
// weights' too); its f1 and f2 tails take 2 channels a lane (4-byte loads;
// 16 and 8 lanes a point), c1 and the merge 8 (16 bytes; 16 lanes), or 4 (8
// bytes; 32 lanes) in a launch that fits in a wave. The int8 form's tables
// are the bf16 form's, written by the same producers on bf16 operands; its
// tails take c1 and the merge as the bf16 form does, f1 and f2 8 channels a
// lane (16 bytes of table, 8 of int8 weights; 4 and 2 lanes a point), or 4
// (8 and 4 bytes; 8 and 4 lanes) in a launch that fits in a wave.

struct Me3D {
  Tail tail[4];  // c1, f1, f2, merge
  int c1_blocks;  // the launch of f2's and c1's tails: c1's first
};

// tail launch T (1: f1; 2: c1 and f2; 3: the merge) in shape SH
template <int DW, int T, int SH>
__global__ void __launch_bounds__(kGfThreads, 4)
    motion_encoder_3d_tail(const __grid_constant__ Me3D u) {
  constexpr bool kTb = DW != DW_F32;
  constexpr TailShape c1 = kMeShape[SH][0], f1 = kMeShape[SH][1], f2 = kMeShape[SH][2],
                      mg = kMeShape[SH][3];
  if constexpr (T == 1) {
    tail<f1.lanes, f1.vec, f1.w, kHeadK, GP_PLAIN, true, DW, kTb>(u.tail[1], blockIdx.x,
                                                                  gridDim.x);
  } else if constexpr (T == 2) {
    if ((int)blockIdx.x < u.c1_blocks) {
      tail<c1.lanes, c1.vec, c1.w, kHeadK, GP_PLAIN, false, DW, kTb>(u.tail[0], blockIdx.x,
                                                                     u.c1_blocks);
    } else {
      tail<f2.lanes, f2.vec, f2.w, kHeadK, GP_PLAIN, false, DW, kTb>(
          u.tail[2], blockIdx.x - u.c1_blocks, gridDim.x - u.c1_blocks);
    }
  } else {
    tail<mg.lanes, mg.vec, mg.w, kHeadK, GP_PLAIN, false, DW, kTb>(u.tail[3], blockIdx.x,
                                                                   gridDim.x);
  }
}

// tail launch T in shape SH: its blocks, c1's first in launch 2
template <int T, int SH>
int me_blocks(Me3D& u) {
  if (T == 2) {
    u.c1_blocks = tail_blocks(u.tail[0], kMeShape[SH][0].lanes);
    return u.c1_blocks + tail_blocks(u.tail[2], kMeShape[SH][2].lanes);
  }
  return tail_blocks(u.tail[T], kMeShape[SH][T].lanes);
}

// tail launch T in its form's shape: on bf16 tables (the bf16 and int8
// forms, each in rows of its own) the narrower loads while the launch fits
// in a wave
template <int DW, int T>
int launch_me_tail(Me3D u, cudaStream_t stream) {
  if constexpr (DW != DW_F32) {
    constexpr int kLanes = DW == DW_INT8 ? SH_I8_LANES : SH_LANES;
    constexpr int kWide = DW == DW_INT8 ? SH_I8_WIDE : SH_WIDE;
    static const int wave = one_wave(motion_encoder_3d_tail<DW, T, kLanes>);
    int blocks = me_blocks<T, kLanes>(u);
    if (blocks <= wave) {
      motion_encoder_3d_tail<DW, T, kLanes><<<blocks, kGfThreads, 0, stream>>>(u);
    } else {
      blocks = me_blocks<T, kWide>(u);
      motion_encoder_3d_tail<DW, T, kWide><<<blocks, kGfThreads, 0, stream>>>(u);
    }
  } else {
    const int blocks = me_blocks<T, SH_F32>(u);
    motion_encoder_3d_tail<DW, T, SH_F32><<<blocks, kGfThreads, 0, stream>>>(u);
  }
  return (int)cudaGetLastError();
}

// dense c1 | f1, tail f1, tails c1 | f2, dense merge, tail merge: 5 launches
template <int DW>
int me_chain(const DenseStep& c1_f1, const DenseStep& merge, const Me3D& u,
             cudaStream_t stream) {
  CAMLI_TRY(launch_dense<DW>(true, c1_f1, stream));
  CAMLI_TRY((launch_me_tail<DW, 1>(u, stream)));
  CAMLI_TRY((launch_me_tail<DW, 2>(u, stream)));
  CAMLI_TRY(launch_dense<DW>(true, merge, stream));
  return launch_me_tail<DW, 3>(u, stream);
}

// --- #13: one tail on its own ---------------------------------------------------

template <int LANES, int VEC, int W, int DW>
__global__ void __launch_bounds__(kGfThreads) dw_max_tail(const __grid_constant__ Tail g) {
  tail<LANES, VEC, W, kHeadK, GP_PLAIN, false, DW>(g, blockIdx.x, gridDim.x);
}

template <int LANES, int VEC, int W>
int launch_dw_max(const Tail& g, bool bf16, cudaStream_t stream) {
  if (bf16) {
    dw_max_tail<LANES, VEC, W, DW_BF16><<<tail_blocks(g, LANES), kGfThreads, 0, stream>>>(g);
  } else {
    dw_max_tail<LANES, VEC, W, DW_F32><<<tail_blocks(g, LANES), kGfThreads, 0, stream>>>(g);
  }
  return (int)cudaGetLastError();
}

// #13's bf16 form on packed words: CL lanes across a point's channels (8 a
// lane) times S lanes across its neighbours, 32 / (CL S) points a warp.
// Lane (s, cl) takes channels c0 + 8 cl .. + 7 of rounds of 8 CL channels
// and the neighbours of split s, a contiguous run of ceil(k / S),
// kWordRows rows in flight: each row's index (one load the split's lanes
// share), its 8 table values in two 16-byte loads through L1 (a neighbour's
// row serves the points near it) rounded into bf16 words (cvt.rn.bf16x2)
// and its 8 weights in one 16-byte load, as words into mul.rn.bf16x2,
// widened for take_max in neighbour order. The splits' maxima then meet by
// a butterfly, each pair taken in neighbour order (the earlier run first),
// which is the max over all k in neighbour order bit for bit: take_max
// keeps the earlier of equal values and the later NaN. Where a lane cannot
// keep a point's neighbours in flight at once (k > kWordRows) the split
// takes the whole warp (S = 32 / CL: conv1 2, conv2 4), else S = 1 (z|r
// and q, k = 4). On an H100 (PERF.md; update3d_forms' word_* forms) 4 rows
// in flight beat 8 at bs 8 and lost to it at bs 1; the split over the warp
// won at bs 1 (fewer rows a lane, more lanes a point) and lost ≈ 8% at bs
// 8 at k = 32; the table through L1 beat L2 alone (ld.global.cg) at both.
constexpr int kWordRows = 4;

template <int CL, int S>
__global__ void __launch_bounds__(kGfThreads) dw_max_words(const __grid_constant__ Tail g) {
  constexpr int kLanes = CL * S, kPer = 32 / kLanes;  // lanes a point, points a warp
  static_assert(kLanes <= 32 && 32 % kLanes == 0, "whole points a warp");
  const int lane = threadIdx.x % 32;
  const int sub = lane / kLanes, cl = lane % CL, s = lane % kLanes / CL;
  const int per = (g.k + S - 1) / S;  // a split's neighbours
  const int lo = min(g.k, s * per), hi = min(g.k, lo + per);
  const int stride = gridDim.x * kGfWarps * kPer;
  for (int p0 = (blockIdx.x * kGfWarps + (int)threadIdx.x / 32) * kPer; p0 < g.points;
       p0 += stride) {  // warp-uniform
    const int p = p0 + sub;
    const bool live = p < g.points;
    const float* table = static_cast<const float*>(g.table) +
                         (size_t)(live ? p / g.n : 0) * g.n_table * g.ld;
    const unsigned short* dw =
        static_cast<const unsigned short*>(g.dw) + (size_t)(live ? p : 0) * g.k * g.dw_ld;
    const int* ip = g.idx + (size_t)(live ? p : 0) * g.idx_stride;
    for (int c0 = 0; c0 < g.c; c0 += 8 * CL) {
      const int c = c0 + 8 * cl;
      const bool on = live && c < g.c;
      float m[8] = {};
      for (int j0 = lo; j0 < hi; j0 += kWordRows) {
        uint32_t tw[kWordRows][4], ww[kWordRows][4];
#pragma unroll
        for (int jj = 0; jj < kWordRows; ++jj) {
          const int j = j0 + jj;
#pragma unroll
          for (int e = 0; e < 4; ++e) tw[jj][e] = ww[jj][e] = 0u;
          if (on && j < hi) {
            const float4* t =
                reinterpret_cast<const float4*>(table + (size_t)__ldg(ip + j) * g.ld + c);
            const float4 t0 = __ldg(t), t1 = __ldg(t + 1);
            tw[jj][0] = pack_bf16x2(t0.x, t0.y), tw[jj][1] = pack_bf16x2(t0.z, t0.w);
            tw[jj][2] = pack_bf16x2(t1.x, t1.y), tw[jj][3] = pack_bf16x2(t1.z, t1.w);
            const uint4 w = __ldcs(reinterpret_cast<const uint4*>(dw + (size_t)j * g.dw_ld + c));
            ww[jj][0] = w.x, ww[jj][1] = w.y, ww[jj][2] = w.z, ww[jj][3] = w.w;
          }
        }
#pragma unroll
        for (int jj = 0; jj < kWordRows; ++jj) {
          float x[8];
          word_products<8, DW_BF16>(tw[jj], ww[jj], x);
          max_step<8>(m, x, j0 + jj - lo, hi - lo);
        }
      }
      // the splits' maxima, the earlier run's first (an empty split, k < S,
      // gives way)
      int empty = lo >= hi;
#pragma unroll
      for (int off = CL; off < kLanes; off <<= 1) {
        const bool later = s & (off / CL);
        const int other_empty = __shfl_xor_sync(0xffffffffu, empty, off);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float other = __shfl_xor_sync(0xffffffffu, m[e], off);
          if (empty) {
            m[e] = other;
          } else if (!other_empty) {
            m[e] = later ? take_max(other, m[e]) : take_max(m[e], other);
          }
        }
        empty = empty && other_empty;
      }
      if (on && s == 0) {
        float* o = g.out + (size_t)p * g.out_ld + c;
        reinterpret_cast<float4*>(o)[0] = make_float4(m[0], m[1], m[2], m[3]);
        reinterpret_cast<float4*>(o)[1] = make_float4(m[4], m[5], m[6], m[7]);
      }
    }
  }
}

template <int CL, int S>
int launch_dw_max_words(const Tail& g, cudaStream_t stream) {
  constexpr int kPoints = kGfWarps * 32 / (CL * S);  // a block's
  dw_max_words<CL, S><<<(g.points + kPoints - 1) / kPoints, kGfThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// the neighbours split over the warp where a lane cannot keep them in flight
template <int CL>
int launch_dw_max_words(const Tail& g, cudaStream_t stream) {
  return g.k > kWordRows ? launch_dw_max_words<CL, 32 / CL>(g, stream)
                         : launch_dw_max_words<CL, 1>(g, stream);
}

bool aligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % kTailAlign == 0; }

}  // namespace

// planes: (hi, lo, bias) of c1 and of the merge (tf32 planes [N_pad][K_pad]);
// w_f1, b_f1, w_f2, b_f2: f1's and f2's f32 weights [K_pad, npad] and
// biases (the int8 form: rounded to bf16, and the planes the one bf16
// plane). dw_m's rows hold round_up(c_m, 4) values (bf16: round_up(c_m, 8);
// int8: round_up(c_m, 16); the first c_m read); the other hoisted weights'
// rows c values. The hoisted weights are f32, bf16 or int8 as dw_kind
// (DwKind) says. scratch holds per_point floats a point.
extern "C" int camli_motion_encoder_3d(
    const float* flow, const float* corr, const int* idx, const void* dw_c1,
    const void* dw_f1, const void* dw_f2, const void* dw_m, const float* const* planes,
    const float* w_f1, const float* b_f1, const float* w_f2, const float* b_f2,
    float* scratch, float* out, int dw_kind, int batch, int n, int idx_stride, int c_flow,
    int c_corr, int c_c1, int c_f1, int c_f2, int c_m, int k_c1, int k_f1, int k_f2, int k_m,
    int npad_f1, int npad_f2, int per_point, cudaStream_t stream) {
  // scratch, channels per point: f32 tables [c1 table (c_c1) | f1 table
  // (c_f1) | corr_feat (c_c1) | f2 table (c_f2) | flow_feat (c_f2) | merge
  // table (ld_m)]; bf16 tables [corr_feat (c_c1) | flow_feat (c_f2)] in f32,
  // then [c1 table | f1 table | f2 table | merge table (ld_m)] in bf16 (the
  // bf16 and int8 forms); every part starts 16-byte aligned
  const bool tb = dw_kind != DW_F32;
  const int ld_m = round_up(c_m, tb ? 8 : 4);
  const int need = tb ? c_c1 + c_f2 + (c_c1 + c_f1 + c_f2 + ld_m) / 2
                      : 2 * c_c1 + c_f1 + 2 * c_f2 + ld_m;
  if (per_point < need || (c_c1 | c_f1 | c_f2 | c_corr) % 4 || (tb && (c_c1 | c_f1 | c_f2) % 8) ||
      c_f1 > kMaxRow || c_f2 > kGfThreads || dw_kind < DW_F32 || dw_kind > DW_INT8) {
    return (int)cudaErrorInvalidValue;
  }
  const int points = batch * n;
  const size_t p = points;
  void *t_c1, *t_f1, *t_f2, *t_m;
  float *corr_feat, *flow_feat;
  if (tb) {
    corr_feat = scratch;
    flow_feat = corr_feat + p * c_c1;
    unsigned short* t16 = reinterpret_cast<unsigned short*>(flow_feat + p * c_f2);
    t_c1 = t16, t_f1 = t16 + p * c_c1, t_f2 = t16 + p * (c_c1 + c_f1);
    t_m = t16 + p * (c_c1 + c_f1 + c_f2);
  } else {
    t_c1 = scratch;
    t_f1 = scratch + p * c_c1;
    corr_feat = scratch + p * (c_c1 + c_f1);
    t_f2 = corr_feat + p * c_c1;
    flow_feat = corr_feat + p * (c_c1 + c_f2);
    t_m = flow_feat + p * c_f2;
  }

  DenseStep c1_f1 = {};
  Conv a = input(points, points, 1, corr, c_corr);
  if (tb) {
    a.table = static_cast<unsigned short*>(t_c1), a.table_ld = a.table_c = c_c1, a.leaky = 1;
  } else {
    a.out = static_cast<float*>(t_c1);
  }
  c1_f1.layer = gf_layer(a, planes, c_c1);
  c1_f1.x = flow, c1_f1.w = w_f1, c1_f1.bias = b_f1, c1_f1.out = t_f1;
  c1_f1.points = points, c1_f1.cin = c_flow, c1_f1.cout = c_f1, c1_f1.npad = npad_f1;
  DenseStep merge = {};
  a = input(points, points, 1, corr_feat, c_c1, flow_feat, c_f2);
  if (tb) {
    a.table = static_cast<unsigned short*>(t_m), a.table_ld = ld_m, a.table_c = c_m, a.leaky = 1;
  } else {
    a.out = static_cast<float*>(t_m), a.out_stride = ld_m;
  }
  merge.layer = gf_layer(a, planes + 3, c_m);

  // the tails read their f32 tables with the leaky ReLU (bf16 tables hold it)
  const int leaky = tb ? 0 : 1;
  Me3D u = {};
  Tail& c1 = u.tail[0];
  c1 = gather_of(points, n, idx, idx_stride, t_c1, c_c1, dw_c1, k_c1, c_c1);
  c1.leaky = leaky, c1.out = corr_feat, c1.out_ld = c_c1;
  Tail& f1 = u.tail[1];
  f1 = gather_of(points, n, idx, idx_stride, t_f1, c_f1, dw_f1, k_f1, c_f1);
  f1.leaky = leaky;
  f1.mlp_w = w_f2, f1.mlp_b = b_f2, f1.mlp_out = t_f2, f1.mlp_cout = c_f2, f1.mlp_npad = npad_f2;
  Tail& f2 = u.tail[2];
  f2 = gather_of(points, n, idx, idx_stride, t_f2, c_f2, dw_f2, k_f2, c_f2);
  f2.leaky = leaky, f2.out = flow_feat, f2.out_ld = c_f2;
  Tail& mg = u.tail[3];
  mg = gather_of(points, n, idx, idx_stride, t_m, ld_m, dw_m, k_m, c_m);
  mg.dw_ld = dw_kind == DW_INT8 ? round_up(c_m, 16) : ld_m;
  mg.leaky = leaky, mg.out = out, mg.out_ld = c_m + c_flow, mg.copy = flow, mg.copy_c = c_flow;

  const auto chain = dw_kind == DW_INT8   ? me_chain<DW_INT8>
                     : dw_kind == DW_BF16 ? me_chain<DW_BF16>
                                          : me_chain<DW_F32>;
  return chain(c1_f1, merge, u, stream);
}

// planes: (hi, lo, bias) of [z|r | q_xm] and q_h (tf32 planes [N_pad][K_pad]);
// w_1, b_1, w_2, b_2: conv1's and conv2's f32 weights [K_pad, npad] and
// biases; w_fc [>= c_2, fc_npad] (the int8 form: the weights rounded to
// bf16, the planes the one bf16 plane). The hoisted weights are f32, bf16
// or int8 as dw_kind (DwKind) says (bf16 and int8: bf16 tables). scratch
// holds per_point floats a point.
extern "C" int camli_gru_flowhead_3d(
    const float* h, const float* x3d, const float* motion, const int* idx,
    const void* dw_zr, const void* dw_q, const void* dw_1, const void* dw_2,
    const float* const* planes, const float* w_1, const float* b_1, const float* w_2,
    const float* b_2, const float* w_fc, const float* b_fc, float* scratch, float* h_out,
    float* delta, int dw_kind, int batch, int n, int idx_stride, int c_h, int c_x, int c_m,
    int c_1, int c_2, int c_out, int k_zr, int k_q, int k_1, int k_2, int npad_1, int npad_2,
    int fc_npad, int per_point, cudaStream_t stream) {
  // scratch, channels per point: f32 tables [[z|r | q_xm] table (3 c_h) | z
  // (c_h) | r*h (c_h) | q_h table (c_h) | conv1 table (c_1) | conv2 table
  // (c_2)]; bf16 tables [q_xm (c_h) | z (c_h) | r*h (c_h)] in f32, then [z|r
  // table (2 c_h) | q table (c_h) | conv1 table (c_1) | conv2 table (c_2)] in
  // bf16 (the bf16 and int8 forms); every part starts 16-byte aligned
  const bool tb = dw_kind != DW_F32;
  const int need = tb ? 3 * c_h + (3 * c_h + c_1 + c_2) / 2 : 6 * c_h + c_1 + c_2;
  if (per_point < need || (c_h | c_1 | c_2) % (tb ? 8 : 4) || dw_kind < DW_F32 ||
      dw_kind > DW_INT8) {
    return (int)cudaErrorInvalidValue;
  }
  const int points = batch * n;
  const size_t p = points;
  float *q_xm, *z, *rh;
  void *t_zr, *t_q, *t_1, *t_2;
  if (tb) {
    q_xm = scratch, z = q_xm + p * c_h, rh = z + p * c_h;
    unsigned short* t16 = reinterpret_cast<unsigned short*>(rh + p * c_h);
    t_zr = t16, t_q = t16 + p * 2 * c_h, t_1 = t16 + p * 3 * c_h, t_2 = t16 + p * (3 * c_h + c_1);
  } else {  // z|r's table and q_xm share [points, 3 c_h] rows
    t_zr = scratch, q_xm = scratch + 2 * c_h;
    z = scratch + p * 3 * c_h, rh = z + p * c_h;
    t_q = rh + p * c_h, t_1 = rh + p * 2 * c_h, t_2 = rh + p * (2 * c_h + c_1);
  }

  DenseStep zrq = {}, qh = {};
  Conv a = input(points, points, 1, h, c_h, x3d, c_x, motion, c_m);
  if (tb) {  // z|r to the bf16 table, q_xm to its own f32 rows
    a.table = static_cast<unsigned short*>(t_zr), a.table_ld = a.table_c = 2 * c_h;
    a.out = q_xm, a.out_stride = c_h;
  } else {
    a.out = static_cast<float*>(t_zr);
  }
  zrq.layer = gf_layer(a, planes, 3 * c_h);
  a = input(points, points, 1, rh, c_h);
  if (tb) {  // q's table: q_h + q_xm
    a.table = static_cast<unsigned short*>(t_q), a.table_ld = a.table_c = c_h;
    a.add = q_xm, a.add_ld = c_h;
  } else {
    a.out = static_cast<float*>(t_q);
  }
  qh.layer = gf_layer(a, planes + 3, c_h);

  const int leaky = tb ? 0 : 1;  // as #6's
  Gru3D u = {};
  Tail& zr = u.tail[0];
  zr = gather_of(points, n, idx, idx_stride, t_zr, tb ? 2 * c_h : 3 * c_h, dw_zr, k_zr, 2 * c_h);
  zr.out = z, zr.out2 = rh, zr.h = h, zr.half = c_h;
  Tail& q = u.tail[1];
  q = gather_of(points, n, idx, idx_stride, t_q, c_h, dw_q, k_q, c_h);
  if (!tb) q.table2 = q_xm, q.ld2 = 3 * c_h;
  q.out = h_out, q.h = h, q.z = z, q.half = c_h;
  q.mlp_w = w_1, q.mlp_b = b_1, q.mlp_out = t_1, q.mlp_cout = c_1, q.mlp_npad = npad_1;
  Tail& c1 = u.tail[2];
  c1 = gather_of(points, n, idx, idx_stride, t_1, c_1, dw_1, k_1, c_1);
  c1.leaky = leaky;
  c1.mlp_w = w_2, c1.mlp_b = b_2, c1.mlp_out = t_2, c1.mlp_cout = c_2, c1.mlp_npad = npad_2;
  Tail& c2 = u.tail[3];
  c2 = gather_of(points, n, idx, idx_stride, t_2, c_2, dw_2, k_2, c_2);
  c2.leaky = leaky;
  c2.out = delta, c2.fc_w = w_fc, c2.fc_b = b_fc, c2.fc_out = c_out, c2.fc_npad = fc_npad;

  const auto chain = dw_kind == DW_INT8   ? gf_chain<DW_INT8>
                     : dw_kind == DW_BF16 ? gf_chain<DW_BF16>
                                          : gf_chain<DW_F32>;
  return chain(zrq, qh, u, stream);
}

// One PointConvDW tail on its own: out[b, q, c] = max_j table[b, idx[b, q, j],
// c] * dw[b, q, j, c] for m queries against a table of n_table rows, any k
// >= 1 and c >= 1. It replaces camliflow_tpu/ops/pallas_ohg.py::dw_conv_ohg
// (whose one-hot selection is a TPU device; here the gather is a load), on
// the flagship's fuse_hidden path: GRU3D's z|r (c 256) and q (128),
// FlowHead3D's conv1 (128) and conv2 (64), with their MLPs outside, as
// dw_conv_ohg leaves them. The exact form (f32 dw): a warp a point; loads a
// lane follow c: up to 64 channels, 4-byte loads of channel lane + 32 v (1
// or 2 a lane); past that, 16-byte loads where c is a multiple of 4 and
// table, dw and out are 16-byte aligned (128: 1 float4 a lane; wider: 2, in
// rounds of 256 channels), else 4-byte loads in rounds of 64 channels. On an
// H100 (PERF.md) 4-byte loads on 32 lanes beat 16-byte loads on 4-16 lanes at
// 16-64 channels and k >= 16 (more points in flight), and lost to 16-byte
// loads at 125-128 channels. The fast form (bf16 != 0): dw bf16, the table
// f32 rounded to bf16 as it is read; on packed words (dw_max_words: 8
// channels a lane, the neighbours split over the warp where k >
// kWordRows) where c is a multiple of 8 and the three are 16-byte aligned,
// else in the exact form's shapes (see the note at the top).
extern "C" int camli_dw_max(const float* table, const void* dw, const int* idx, float* out,
                            int bf16, int batch, int n_table, int m, int idx_stride, int k,
                            int c, cudaStream_t stream) {
  if (k < 1 || c < 1) return (int)cudaErrorInvalidValue;
  Tail g = gather_of(batch * m, m, idx, idx_stride, table, c, dw, k, c);
  g.n_table = n_table, g.out = out, g.out_ld = c;
  const bool bf = bf16 != 0;
  if (bf && c % 8 == 0 && aligned(table) && aligned(dw) && aligned(out)) {
    return c <= 8     ? launch_dw_max_words<1>(g, stream)
           : c <= 16  ? launch_dw_max_words<2>(g, stream)
           : c <= 32  ? launch_dw_max_words<4>(g, stream)
           : c <= 64  ? launch_dw_max_words<8>(g, stream)
           : c <= 128 ? launch_dw_max_words<16>(g, stream)
                      : launch_dw_max_words<32>(g, stream);
  }
  if (c <= 32) return launch_dw_max<32, 1, 1>(g, bf, stream);
  if (c > 64 && c % 4 == 0 && aligned(table) && aligned(dw) && aligned(out)) {
    return c <= 128 ? launch_dw_max<32, 1, 4>(g, bf, stream)
                    : launch_dw_max<32, 2, 4>(g, bf, stream);
  }
  return launch_dw_max<32, 2, 1>(g, bf, stream);
}
