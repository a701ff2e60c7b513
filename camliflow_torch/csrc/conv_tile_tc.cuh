// The 3xTF32 tensor-core implicit-GEMM convolution tile: update2d.cu's
// motion encoder (kernel #9), its GRU and flow head (kernel #8), #8's two
// halves and the fused RAFT iteration (#10) on the exact path,
// update3d.cu's dense steps (#7) and clfm.cu's six dense layers (kernel
// #11) run on it.
//
// The convolution (`Conv`): NHWC inputs read as one virtual channel concat
// of up to three tensors, the reduction ordered (tap, input channel), zero
// padding at the borders as a load predicate (a horizontal tap at x = 0 or
// W-1 reads zero, never the neighbouring row), and epilogues that fuse the
// bias and the activation (ReLU, none, leaky ReLU), or the GRU's gates (the
// z|r conv writes z and r*h, the q conv writes h' = (1-z)*h + z*tanh(q)),
// nan_to_num and the 2-channel flow tail. A 1x1 convolution over [rows, C]
// (height = rows, width = 1) is a dense layer; `conv_tc_group_kernel` deals
// the tiles of up to four independent ones to one grid.
//
// A PointConvDW's table for update3d.cu's bf16 tails (EPI_TABLE): the f32
// value of the other epilogues, leaky ReLU where `leaky`, after adding
// `add` where given, rounded to bf16 (nearest, ties to even) and stored as
// bf16, two columns a 4-byte store; the columns past `table_c` are stored
// as f32 to `out`, unrounded (#7's first dense step: z|r's table, then q's
// x3d/motion part).
//
// Numerics: f32 in, f32 out, on the tensor cores by the 3xTF32 split. Every
// operand x becomes hi = tf32(x) (cvt.rna, 10 mantissa bits) and
// lo = tf32(x - hi); a product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b, the
// small terms first, accumulated in f32 (lo*lo, ~2^-22 relative, dropped).
// The weights arrive split once per request (ops/update2d.py::pack_convs,
// planes [N_pad][K_pad], K-major); the kernel splits the activations.
//
// The bf16 mode (template argument BF; the int8 form of update3d.cu's dense
// steps; the 2D chain's fast path runs on conv_tile_bf16.cuh's wgmma tile
// instead, and clfm.cu's bf16 form on a chain of its own on that file's
// primitives): the
// weights arrive rounded to bf16 once per request, in the hi plane (the lo
// plane is neither passed nor read); each activation is rounded to bf16
// (nearest, ties to even: cvt.rn.bf16x2) as it is taken from the stage; a
// chunk of 16 reduction values is one mma.sync m16n8k16 bf16 pass with f32
// accumulation, in place of 3xTF32's six m16n8k8 passes. The products are
// exact in f32, so only the sum's order differs from an f32 sum of the
// rounded operands. The GRU epilogues read the hidden state rounded to bf16
// and round h' to bf16 after nan_to_num, as the JAX package's bf16 kernels
// (camliflow_tpu/ops/pallas_update2d.py) do.
//
// Design, for an operation bound (the chain is ~10^3 operations per byte):
// mma.sync.aligned.m16n8k8 tf32 from registers, fed from shared memory.
// - Copies: cp.async 16-byte copies (4 channels; every input's channel
//   count is a multiple of 4 and its base 16-byte aligned, which the
//   wrappers check), zero-filled (source size 0) for taps outside the map,
//   pixels past the end and k past the reduction. A ring of kStages stages,
//   so chunks k+1 and k+2 are in flight while chunk k is multiplied; one
//   __syncthreads per chunk.
// - Layout: each stage holds, per warp-split slice, A as [BM][16] and the
//   two weight planes as [BN][16] (K-major both). A thread reads 4
//   consecutive floats of a row with one 128-bit load and uses them for two
//   k-steps: mma k-index t takes column 4t + 2s and t + 4 column 4t + 2s + 1
//   in step s. A and B use the same permutation of k, so the sum is the
//   convolution's; the 16-float rows make each quarter-warp's 128-bit loads
//   hit 8 distinct 16-byte bank groups (no conflicts).
// - Tiles: 4 warps a block. 64 pixels x 128 channels (warps of 32 x 64, 2
//   blocks an SM) for the 256-channel convs, 64 x 64 (warps of 32 x 32, 4
//   an SM) for the others, so that each conv of the chain at 68 x 120 px
//   runs 128-384 blocks in one wave; CLFM's dense layers take 64 x 64 too.
//   The flow head's last conv (256 -> 2, 3x3) is a narrow variant: 32
//   pixels x 8 channels a block, the reduction split over its 4 warps, whose
//   partial sums meet in shared memory in a fixed order (no float atomics:
//   two runs give the same bits).
// - wgmma (m64n64k8 tf32, A from registers, B through K-major descriptors
//   without swizzle) computed the same sums but took longer at every conv
//   of the chain on an H100, so the tile stays on mma.sync (PERF.md).
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int kNPad = 64;    // output channels: the packed planes' rows, padded
constexpr int kTcBk = 16;    // reduction floats per warp slice and stage
constexpr int kStages = 3;   // cp.async ring depth

enum Epilogue { EPI_RELU = 0, EPI_NONE = 1, EPI_ZR = 2, EPI_GATE = 3, EPI_LEAKY = 4,
                EPI_TABLE = 5 };

struct Conv {
  const float* in0;  // virtual concat of up to three NHWC inputs
  const float* in1;
  const float* in2;
  int c0, c1, c2;
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
  unsigned short* table;  // TABLE: bf16 [pixels, table_ld], columns < table_c
  int table_ld, table_c;
  int leaky;         // TABLE: leaky ReLU before the rounding
  const float* add;  // TABLE: added first, [pixels, add_ld] (or none)
  int add_ld;
};

__device__ __forceinline__ float nan_to_num(float v) {
  if (isnan(v)) return 0.f;
  return fminf(fmaxf(v, -FLT_MAX), FLT_MAX);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

int round_up(int v, int m) { return (v + m - 1) / m * m; }

// Fills the shape fields of a convolution.
Conv shaped(Conv a, int kh, int kw, int cout) {
  a.kh = kh;
  a.kw = kw;
  a.cout = cout;
  a.n_pad = round_up(cout, kNPad);
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


// --- PTX ------------------------------------------------------------------

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_address(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// round to bf16 (nearest, ties to even), as an f32 value; NaN stays NaN
__device__ __forceinline__ float round_bf16(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(v));
  return __uint_as_float((uint32_t)h << 16);
}

// an f32 value as bf16 bits (nearest, ties to even)
__device__ __forceinline__ unsigned short bf16_bits(float v) {
  unsigned short h;
  asm("cvt.rn.bf16.f32 %0, %1;\n" : "=h"(h) : "f"(v));
  return h;
}

// two f32 values as bf16x2 (nearest, ties to even): lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a * b, bf16 operands, f32 accumulation: a 16x16 (a0 rows g, k 2t
// and 2t+1; a1 rows g+8; a2 rows g, k 2t+8 and 2t+9; a3 rows g+8), b 16x8
// (b0 k 2t and 2t+1, b1 k 2t+8 and 2t+9; col g), d as in mma_tf32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// round to tf32 (nearest, ties away from zero), as an f32 bit pattern
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// d += a * b: a 16x8 (rows g, g+8; k t, t+4), b 8x8 (k t, t+4; col g),
// d 16x8 (rows g, g+8; cols 2t, 2t+1), g = lane / 4, t = lane % 4
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// --- the tile -------------------------------------------------------------

// Warps of (BM / WARPS_M) x (BN / WARPS_N), the reduction split over KSPLIT
// slices of warps.
template <int BM, int BN, int WARPS_M, int WARPS_N, int KSPLIT>
struct TcShape {
  static constexpr int kWarps = WARPS_M * WARPS_N * KSPLIT;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kMt = BM / WARPS_M / 16;  // m16 tiles per warp
  static constexpr int kNt = BN / WARPS_N / 8;   // n8 tiles per warp
  static constexpr int kKStep = KSPLIT * kTcBk;  // reduction per stage
  static constexpr int kAFloats = KSPLIT * BM * kTcBk;
  static constexpr int kStageFloats = kAFloats + 2 * KSPLIT * BN * kTcBk;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
  static constexpr int kRowsPerPass = kThreads / 4;  // A rows one pass of copies covers
  static_assert(BM % kRowsPerPass == 0, "A copies: whole passes of rows");
  static_assert(BM % (16 * WARPS_M) == 0 && BN % (8 * WARPS_N) == 0, "warp tiles");
  // blocks an SM the registers must allow: 4 of the 64 x 64 tile, 2 of the
  // 64 x 128 one (their shared memory allows as many)
  static constexpr int kMinBlocks = KSPLIT > 1 ? 1 : (BN == 64 ? 4 : 2);
};

// The epilogue of one output element (BF: the bf16 mode's roundings).
template <int EPI, bool BF = false>
__device__ __forceinline__ void store(const Conv& a, int p, int co, float acc) {
  if (p >= a.pixels || co >= a.cout) return;
  float v = acc + a.bias[co];
  if (EPI == EPI_RELU) {
    v = v < 0.f ? 0.f : v;
  } else if (EPI == EPI_LEAKY) {
    v = v > 0.f ? v : __fmul_rn(0.1f, v);
  } else if (EPI == EPI_ZR) {
    v = sigmoid(v);
    if (co < a.half) {
      a.out[(size_t)p * a.half + co] = v;
    } else {
      const size_t at = (size_t)p * a.half + (co - a.half);
      a.out2[at] = v * (BF ? round_bf16(a.h[at]) : a.h[at]);
    }
    return;
  } else if (EPI == EPI_GATE) {
    const size_t at = (size_t)p * a.cout + co;
    const float zv = a.z[at];
    v = (1.f - zv) * (BF ? round_bf16(a.h[at]) : a.h[at]) + zv * tanhf(v);
  }
  if (a.nan_fix) v = nan_to_num(v);
  if (BF && EPI == EPI_GATE) v = round_bf16(v);
  a.out[(size_t)p * a.out_stride + co] = v;
}

// EPI_TABLE: `add`'s value at one element (zero where there is none)
__device__ __forceinline__ float table_add(const Conv& a, int p, int co) {
  return a.add != nullptr && p < a.pixels && co < a.table_c && co < a.cout
             ? __ldg(a.add + (size_t)p * a.add_ld + co)
             : 0.f;
}

// EPI_TABLE: columns co and co + 1 (co even) of one pixel, and add's values
// there (table_add).
__device__ __forceinline__ void store_table(const Conv& a, int p, int co, float acc0,
                                            float acc1, float add0, float add1) {
  if (p >= a.pixels || co >= a.cout) return;
  const float acc[2] = {acc0, acc1}, add[2] = {add0, add1};
  float v[2];
  bool in_table[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    v[e] = acc[e] + a.bias[co + e];  // bias: [n_pad], n_pad even
    in_table[e] = co + e < a.table_c;
    if (in_table[e]) {
      if (a.add != nullptr) v[e] = __fadd_rn(v[e], add[e]);
      if (a.leaky) v[e] = v[e] > 0.f ? v[e] : __fmul_rn(0.1f, v[e]);
    }
  }
  unsigned short* row = a.table + (size_t)p * a.table_ld;
  if (in_table[1] && co + 1 < a.cout) {  // table_ld even: a 4-byte word
    *reinterpret_cast<uint32_t*>(row + co) = pack_bf16x2(v[0], v[1]);
    return;
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (co + e >= a.cout) break;
    if (in_table[e]) {
      row[co + e] = bf16_bits(v[e]);
    } else {
      a.out[(size_t)p * a.out_stride + co + e - a.table_c] = v[e];
    }
  }
}

// EPI_TABLE: a thread's sums of the tile, its pairs of columns a 4-byte
// store each; add's values loaded before any store, so that the loads
// overlap.
template <typename S, int BM, int BN, int WARPS_M, int WARPS_N>
__device__ __forceinline__ void store_tables(const Conv& a, const float (&acc)[S::kMt][S::kNt][4],
                                             int p0, int n0, int wm, int wn, int g, int t) {
  float add[S::kMt][S::kNt][4];
#pragma unroll
  for (int mi = 0; mi < S::kMt; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::kNt; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        add[mi][ni][c] = table_add(a, p0 + wm * (BM / WARPS_M) + mi * 16 + g + (c / 2) * 8,
                                   n0 + wn * (BN / WARPS_N) + ni * 8 + 2 * t + c % 2);
      }
#pragma unroll
  for (int mi = 0; mi < S::kMt; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::kNt; ++ni)
#pragma unroll
      for (int c = 0; c < 4; c += 2) {  // c and c + 1: one row, columns col and col + 1
        const int row = wm * (BM / WARPS_M) + mi * 16 + g + (c / 2) * 8;
        const int col = wn * (BN / WARPS_N) + ni * 8 + 2 * t;
        store_table(a, p0 + row, n0 + col, acc[mi][ni][c], acc[mi][ni][c + 1], add[mi][ni][c],
                    add[mi][ni][c + 1]);
      }
}

// The 3xTF32 split of one activation value.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// One block's tile: BM pixels x BN output channels at (p0, n0) of one
// convolution. `hi` and `lo` are the weight planes [>= n0 + BN][k_pad]
// (BF: `hi` the bf16-rounded weights, `lo` unread); a.k_total <= k_pad.
template <int BM, int BN, int WARPS_M, int WARPS_N, int KSPLIT, int EPI, bool BF = false>
__device__ __forceinline__ void conv_tc_tile(const Conv& a, const float* __restrict__ hi,
                                             const float* __restrict__ lo, int k_pad, int p0,
                                             int n0) {
  using S = TcShape<BM, BN, WARPS_M, WARPS_N, KSPLIT>;
  constexpr int kRows = BM / S::kRowsPerPass;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cin = a.c0 + a.c1 + a.c2;
  const int hw = a.height * a.width;
  const int n_chunks = (a.k_total + S::kKStep - 1) / S::kKStep;

  // copy roles: A rows tid/4 + pass * kRowsPerPass, 4 floats at 4 * (tid % 4)
  // of every slice; the (tap, channel) cursor of each slice advances by
  // kKStep per stage, without a division
  const int quad = tid % 4;
  int row_base[kRows], row_y[kRows], row_x[kRows];
#pragma unroll
  for (int q = 0; q < kRows; ++q) {
    const int p = p0 + tid / 4 + q * S::kRowsPerPass;
    const int b = p / hw;
    const int r = p - b * hw;
    row_y[q] = p < a.pixels ? r / a.width : -1000000;  // an invalid row
    row_x[q] = r - (r / a.width) * a.width;
    row_base[q] = b * hw;
  }
  int cur_k[KSPLIT], cur_ci[KSPLIT], cur_tx[KSPLIT], cur_ty[KSPLIT];
#pragma unroll
  for (int s = 0; s < KSPLIT; ++s) {
    cur_k[s] = s * kTcBk + 4 * quad;
    const int tap = cur_k[s] / cin;
    cur_ci[s] = cur_k[s] - tap * cin;
    cur_ty[s] = tap / a.kw;
    cur_tx[s] = tap - cur_ty[s] * a.kw;
  }
  int b_k0 = 0;  // the next stage's first reduction index, for the weights

  auto load_stage = [&](int slot) {
    float* stage = smem + slot * S::kStageFloats;
#pragma unroll
    for (int s = 0; s < KSPLIT; ++s) {
      const float* src = a.in0;
      int cs = a.c0, cc = cur_ci[s];
      if (cc >= a.c0 + a.c1) {
        src = a.in2, cs = a.c2, cc -= a.c0 + a.c1;
      } else if (cc >= a.c0) {
        src = a.in1, cs = a.c1, cc -= a.c0;
      }
      const bool k_ok = cur_k[s] < a.k_total;
      const int dy = cur_ty[s] - (a.kh - 1) / 2;
      const int dx = cur_tx[s] - (a.kw - 1) / 2;
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int iy = row_y[q] + dy;
        const int ix = row_x[q] + dx;
        const bool ok = k_ok && iy >= 0 && iy < a.height && ix >= 0 && ix < a.width;
        const float* from =
            ok ? src + ((size_t)row_base[q] + (size_t)iy * a.width + ix) * cs + cc : a.in0;
        const int row = tid / 4 + q * S::kRowsPerPass;
        cp_async16(stage + (s * BM + row) * kTcBk + 4 * quad, from, ok ? 16 : 0);
      }
      cur_k[s] += S::kKStep;
      cur_ci[s] += S::kKStep;
      while (cur_ci[s] >= cin) {
        cur_ci[s] -= cin;
        if (++cur_tx[s] == a.kw) cur_tx[s] = 0, ++cur_ty[s];
      }
    }
    // the weights: [plane][slice][BN][16] from the planes' rows n0 + n (BF:
    // the hi plane alone)
    constexpr int kBCopies = (BF ? 1 : 2) * KSPLIT * BN * 4;
#pragma unroll
    for (int i = 0; i < (kBCopies + S::kThreads - 1) / S::kThreads; ++i) {
      const int idx = i * S::kThreads + tid;
      if (kBCopies % S::kThreads == 0 || idx < kBCopies) {
        const int j = idx % 4;
        const int n = (idx / 4) % BN;
        const int s = (idx / (4 * BN)) % KSPLIT;
        const int plane = idx / (4 * BN * KSPLIT);
        const int k = b_k0 + s * kTcBk + 4 * j;
        const bool ok = k < k_pad;
        const float* from = (plane ? lo : hi) + (ok ? (size_t)(n0 + n) * k_pad + k : 0);
        cp_async16(stage + S::kAFloats + ((plane * KSPLIT + s) * BN + n) * kTcBk + 4 * j, from,
                   ok ? 16 : 0);
      }
    }
    b_k0 += S::kKStep;
  };

  // compute roles: warp (slice, wm, wn) multiplies its slice of every stage
  const int slice = warp / (WARPS_M * WARPS_N);
  const int wm = warp % (WARPS_M * WARPS_N) / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane / 4, t = lane % 4;
  float acc[S::kMt][S::kNt][4];
#pragma unroll
  for (int mi = 0; mi < S::kMt; ++mi)
#pragma unroll
    for (int ni = 0; ni < S::kNt; ++ni)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mi][ni][c] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) load_stage(s);
    cp_async_commit();
  }
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    cp_async_wait<kStages - 2>();  // this thread's copies of `chunk` landed
    __syncthreads();               // everyone's; and chunk - 1 is consumed
    if (chunk + kStages - 1 < n_chunks) load_stage((chunk + kStages - 1) % kStages);
    cp_async_commit();

    const float* stage = smem + (chunk % kStages) * S::kStageFloats;
    const float* As = stage + (slice * BM + wm * (BM / WARPS_M)) * kTcBk;
    const float* Bh = stage + S::kAFloats + (slice * BN + wn * (BN / WARPS_N)) * kTcBk;
    const float* Bl = Bh + KSPLIT * BN * kTcBk;
    float4 av[S::kMt][2], bh[S::kNt], bl[S::kNt];
#pragma unroll
    for (int mi = 0; mi < S::kMt; ++mi)
#pragma unroll
      for (int h8 = 0; h8 < 2; ++h8)
        av[mi][h8] =
            *reinterpret_cast<const float4*>(As + (mi * 16 + h8 * 8 + g) * kTcBk + 4 * t);
#pragma unroll
    for (int ni = 0; ni < S::kNt; ++ni) {
      bh[ni] = *reinterpret_cast<const float4*>(Bh + (ni * 8 + g) * kTcBk + 4 * t);
      if (!BF) bl[ni] = *reinterpret_cast<const float4*>(Bl + (ni * 8 + g) * kTcBk + 4 * t);
    }
    if constexpr (BF) {
      // one m16n8k16 pass: thread (g, t) holds columns 4t..4t+3 of its rows;
      // the pass takes columns 4t, 4t+1 as k 2t, 2t+1 and 4t+2, 4t+3 as
      // k 2t+8, 2t+9, for A and B alike, so the sum is the convolution's
      uint32_t a16[S::kMt][4];
#pragma unroll
      for (int mi = 0; mi < S::kMt; ++mi) {
        a16[mi][0] = pack_bf16x2(av[mi][0].x, av[mi][0].y);
        a16[mi][1] = pack_bf16x2(av[mi][1].x, av[mi][1].y);
        a16[mi][2] = pack_bf16x2(av[mi][0].z, av[mi][0].w);
        a16[mi][3] = pack_bf16x2(av[mi][1].z, av[mi][1].w);
      }
#pragma unroll
      for (int ni = 0; ni < S::kNt; ++ni) {
        const uint32_t b16[2] = {pack_bf16x2(bh[ni].x, bh[ni].y),
                                 pack_bf16x2(bh[ni].z, bh[ni].w)};
#pragma unroll
        for (int mi = 0; mi < S::kMt; ++mi) mma_bf16(acc[mi][ni], a16[mi], b16);
      }
    } else {
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        uint32_t a_hi[S::kMt][4], a_lo[S::kMt][4];
#pragma unroll
        for (int mi = 0; mi < S::kMt; ++mi) {
          // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
          const float x[4] = {step ? av[mi][0].z : av[mi][0].x, step ? av[mi][1].z : av[mi][1].x,
                              step ? av[mi][0].w : av[mi][0].y, step ? av[mi][1].w : av[mi][1].y};
#pragma unroll
          for (int r = 0; r < 4; ++r) split(x[r], a_hi[mi][r], a_lo[mi][r]);
        }
#pragma unroll
        for (int ni = 0; ni < S::kNt; ++ni) {
          const uint32_t b_hi[2] = {__float_as_uint(step ? bh[ni].z : bh[ni].x),
                                    __float_as_uint(step ? bh[ni].w : bh[ni].y)};
          const uint32_t b_lo[2] = {__float_as_uint(step ? bl[ni].z : bl[ni].x),
                                    __float_as_uint(step ? bl[ni].w : bl[ni].y)};
#pragma unroll
          for (int mi = 0; mi < S::kMt; ++mi) {
            mma_tf32(acc[mi][ni], a_lo[mi], b_hi);
            mma_tf32(acc[mi][ni], a_hi[mi], b_lo);
            mma_tf32(acc[mi][ni], a_hi[mi], b_hi);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  if (KSPLIT > 1) {
    // the slices' partial sums meet in slice 0, in slice order
    __syncthreads();  // every warp is done with the ring; reuse it
    constexpr int kPer = S::kMt * S::kNt * 4;
    float* red = smem;
    const int owner = warp % (WARPS_M * WARPS_N);
    if (slice > 0) {
#pragma unroll
      for (int mi = 0; mi < S::kMt; ++mi)
#pragma unroll
        for (int ni = 0; ni < S::kNt; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            red[(((slice - 1) * WARPS_M * WARPS_N + owner) * kPer + (mi * S::kNt + ni) * 4 + c) *
                    32 +
                lane] = acc[mi][ni][c];
    }
    __syncthreads();
    if (slice > 0) return;  // slice 0 alone stores
    for (int s = 1; s < KSPLIT; ++s)
#pragma unroll
      for (int mi = 0; mi < S::kMt; ++mi)
#pragma unroll
        for (int ni = 0; ni < S::kNt; ++ni)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[mi][ni][c] +=
                red[(((s - 1) * WARPS_M * WARPS_N + owner) * kPer + (mi * S::kNt + ni) * 4 + c) *
                        32 +
                    lane];
  }

  if constexpr (EPI == EPI_TABLE) {
    store_tables<S, BM, BN, WARPS_M, WARPS_N>(a, acc, p0, n0, wm, wn, g, t);
  } else {
#pragma unroll
    for (int mi = 0; mi < S::kMt; ++mi)
#pragma unroll
      for (int ni = 0; ni < S::kNt; ++ni)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int row = wm * (BM / WARPS_M) + mi * 16 + g + (c / 2) * 8;
          const int col = wn * (BN / WARPS_N) + ni * 8 + 2 * t + c % 2;
          store<EPI, BF>(a, p0 + row, n0 + col, acc[mi][ni][c]);
        }
  }
  if (a.tail_c > 0 && n0 == 0) {
    constexpr int kStorers = 32 * WARPS_M * WARPS_N;  // slice 0's threads
    for (int i = tid; i < BM * a.tail_c; i += kStorers) {
      const int p = p0 + i / a.tail_c;
      const int j = i % a.tail_c;
      if (p < a.pixels) {
        a.out[(size_t)p * a.out_stride + a.cout + j] = a.tail[(size_t)p * a.tail_c + j];
      }
    }
  }
}

// One convolution: block (x, y) computes the tile at (x * BM, y * BN).
template <int BM, int BN, int WARPS_M, int WARPS_N, int KSPLIT, int EPI, bool BF>
__global__ void __launch_bounds__(TcShape<BM, BN, WARPS_M, WARPS_N, KSPLIT>::kThreads,
                                  TcShape<BM, BN, WARPS_M, WARPS_N, KSPLIT>::kMinBlocks)
    conv_tc_kernel(const Conv a, const float* __restrict__ hi, const float* __restrict__ lo,
                   int k_pad) {
  conv_tc_tile<BM, BN, WARPS_M, WARPS_N, KSPLIT, EPI, BF>(a, hi, lo, k_pad, blockIdx.x * BM,
                                                          blockIdx.y * BN);
}

// A convolution with its weight planes, as one member of a grouped launch.
struct TcLayer {
  Conv a;
  const float* hi;
  const float* lo;
  int k_pad;
  int m_tiles, n_tiles;
};

// Up to four independent convolutions with one epilogue in one grid: block
// t takes tile t of the layers' tiles in order, the n tiles of one row of
// pixels consecutively (the blocks that read one A tile run together). The
// layers stay in the parameter space (__grid_constant__) and the block
// reads its own through a reference, so the tile's code is inlined once
// (four inlined copies spilled 160 bytes and ran slower on an H100).
struct TcGroup {
  TcLayer layer[4];  // a layer of 0 m_tiles is none
};

template <int BM, int BN, int WARPS_M, int WARPS_N, int EPI, bool BF = false>
__global__ void __launch_bounds__(TcShape<BM, BN, WARPS_M, WARPS_N, 1>::kThreads,
                                  TcShape<BM, BN, WARPS_M, WARPS_N, 1>::kMinBlocks)
    conv_tc_group_kernel(const __grid_constant__ TcGroup g) {
  int t = blockIdx.x, i = 0;
  while (i < 3 && t >= g.layer[i].m_tiles * g.layer[i].n_tiles) {
    t -= g.layer[i].m_tiles * g.layer[i].n_tiles;
    ++i;
  }
  const TcLayer& l = g.layer[i];
  conv_tc_tile<BM, BN, WARPS_M, WARPS_N, 1, EPI, BF>(l.a, l.hi, l.lo, l.k_pad,
                                                     (t / l.n_tiles) * BM, (t % l.n_tiles) * BN);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, int KSPLIT, int EPI, bool BF = false>
int launch_tc(const Conv& a, const float* hi, const float* lo, int k_pad, int n_tiles,
              cudaStream_t stream) {
  using S = TcShape<BM, BN, WARPS_M, WARPS_N, KSPLIT>;
  const auto kernel = conv_tc_kernel<BM, BN, WARPS_M, WARPS_N, KSPLIT, EPI, BF>;
  if (S::kSmemBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.pixels + BM - 1) / BM, n_tiles);
  kernel<<<grid, S::kThreads, S::kSmemBytes, stream>>>(a, hi, lo, k_pad);
  return (int)cudaGetLastError();
}

}  // namespace
