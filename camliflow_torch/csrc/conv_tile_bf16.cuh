// The bf16 tensor-core implicit-GEMM convolution tile for Hopper: the fast
// path's 2D update chain (update2d.cu with bf16 != 0: the motion encoder,
// kernel #9; the GRU and flow head, #8, and its halves; the RAFT iteration,
// #10) runs every conv on it. It replaces conv_tile_tc.cuh's bf16 mode for
// these kernels (that mode stays for #6/#7's int8 dense steps; #11's bf16
// form runs a chain of its own in clfm.cu on the primitives below), and
// like it takes the place of camliflow_tpu/ops/pallas_update2d.py's bf16 MXU
// dots.
//
// The convolution (`ConvB`) is conv_tile_tc.cuh's `Conv` with dtypes: NHWC
// inputs read as one virtual channel concat of up to three tensors, each f32
// or bf16 in memory; the reduction ordered (tap, input channel); zero padding
// at the borders as a load predicate; epilogues that fuse the bias and ReLU
// (or none), the GRU's gates (ZR writes z in f32 and r*h in bf16; GATE writes
// h' = (1 - z) * bf16(h) + z * tanh(q), nan_to_num, rounded to bf16, as f32),
// nan_to_num and the 2-channel flow tail; an output stored as f32 or bf16.
//
// Numerics: the weights arrive as a bf16 plane [N_pad][K_pad] (K-major,
// K_pad a multiple of 64, zero padding; ops/update2d.py::pack_convs with
// bf16=True). An activation stored in bf16 is taken as it is; one stored in
// f32 is rounded to bf16 (nearest, ties to even: cvt.rn.bf16x2) as it is
// staged. Products of bf16 values are exact in f32 and are summed in f32 by
// wgmma, so only the sum's order differs from an f32 sum of the rounded
// operands (and from conv_tile_tc.cuh's bf16 mode). Intermediates that every
// consumer rounds to bf16 (the ReLU outputs of conv_c1, conv_c2, conv_f2 and
// the flow head's first conv; r*h) are stored in bf16: the same values.
//
// Bound: bf16 operations on the tensor cores (989 TFLOP/s dense) against
// the bytes once (3.35 TB/s): at the flagship's 68 x 120 map the chain is
// ~10^3 operations a byte, so every conv but the flow head's last is bound
// by operations. What holds a tile back in practice is its feed: each block
// streams the whole weight plane through L2 (a 3x3 conv of 256 channels to
// 192 is 885 KB a block) and gathers its A tile tap by tap.
//
// Design:
// - A block computes 64 pixels x BN output channels, BN the conv's cout
//   rounded up to a wgmma width (8, 64, 128, 192 or 256), so each A tile is
//   gathered once; 64 pixels (one wgmma m64) keep 128 blocks at bs 1, where
//   the 68 x 120 map is 8,160 pixels, one wave on 132 SMs.
// - Warp specialisation, 384 threads, one block an SM: warpgroup 0
//   consumes; warpgroups 1 and 2 produce, each every other stage. A ring of
//   kStages stages, each 64 reduction values deep: A as [64 pixels][64]
//   bf16 and B as [BN][64] bf16, 128-byte rows in the 128-byte-swizzled
//   layout (16-byte chunk c of row r at chunk c ^ (r % 8) of its 1024-byte
//   group) that wgmma reads; a full and an empty mbarrier a stage. As many
//   stages as fit beside the gather's staging: 4 at BN 256, 5 at 192, 6 at
//   128, 8 below (~225 KB of shared memory at most).
// - B, the weights: one TMA load a stage (cp.async.bulk.tensor.2d, box
//   64 x BN, SWIZZLE_128B) by the producer's first thread, into the stage's
//   full barrier with its byte count.
// - A, the implicit-GEMM gather: each producer thread owns 4 reduction
//   values (a piece) of 8 rows of its stages, copied by cp.async through L1
//   (16 bytes: 4 f32 values; 8 bytes: 4 bf16) into the thread's own cells
//   of a staging ring (2 stages a warpgroup, 64 KB in all), zero-filled for
//   taps outside the map, pixels past the end and k past the reduction. A
//   stage's pieces are read back by the thread that copied them, rounded to
//   bf16 where they are f32, and stored into the swizzled tile; then a proxy
//   fence and an arrive on the full barrier.
// - The consumer warpgroup waits for a stage's full barrier, issues four
//   wgmma.mma_async m64nBNk16 bf16 (both operands by shared-memory
//   descriptors, f32 accumulators in registers: BN / 2 a thread), commits,
//   and once the stage before has retired (wgmma.wait_group 1) frees that
//   stage's slot with an arrive on its empty barrier.
// - The epilogue: the accumulators go through a [64][BN + 8] f32 tile in
//   the ring (8 floats of padding: conflict-free 8-byte writes); then all
//   384 threads finish 4 adjacent channels of a row each, a row's channels
//   on consecutive threads, so bias, h and z are read and the outputs
//   stored 16 (f32) or 8 (bf16) bytes a thread, coalesced, the global
//   inputs of 4 quads loaded before any is stored. No float atomics: two
//   runs give the same bits.
// - Grid: one block a 64-pixel tile, not persistent: at bs 1 one wave; at
//   bs 8 (65,280 pixels, 1,020 tiles) about 8 waves of one block an SM.
// - The flow head's last conv (256 -> 2) takes the same tile at BN = 8.
// - What bounds it (an H100; python -m camliflow_torch.csrc.bf16_tile_forms,
//   PERF.md): the producers' work a stage, not bytes, the tensor cores or
//   the barriers. At bs 1 the ten convs took 0.75x the time with no A or B
//   loads, 0.69x with no cp.async instruction (their issue: 1,024 a stage),
//   0.46x with no producer, 0.87x with no products and 0.82x with no
//   epilogue; one producer warpgroup took 1.24x. Register-staged loads, A
//   as one TMA box a stage, deeper rings, fences, warp-level arrivals, two
//   accumulator chains and ZR's and GATE's inputs prefetched by the
//   producers were slower or within a few percent.
// - A barrier wait that spins past ~2^24 polls traps (a launch error, not a
//   hung card).
#pragma once

#include <cuda.h>  // CUtensorMap, cuTensorMapEncodeTiled's types
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "conv_tile_tc.cuh"  // Epilogue, nan_to_num, sigmoid, round_bf16, pack_bf16x2

namespace {

constexpr int kB16Rows = 64;                            // pixels a tile (wgmma m64)
constexpr int kB16Depth = 64;                           // reduction values a stage
constexpr int kB16RowBytes = kB16Depth * 2;             // 128: one swizzle row
constexpr int kB16ATileBytes = kB16Rows * kB16RowBytes;  // 8 KB
constexpr int kB16Producers = 2;                        // producer warpgroups

struct ConvB {
  const void* in[3];  // virtual concat of up to three NHWC inputs
  int c[3];
  int in_bf16;        // bit i set: input i holds bf16 (else f32)
  const float* bias;  // [>= cout]
  int pixels, height, width, kh, kw;
  int cout, k_total;
  void* out;  // out[p * out_stride + co], bf16 if out_bf16, else f32
  int out_stride, out_bf16;
  const float* h;  // ZR, GATE: the hidden state, read rounded to bf16
  const float* z;  // GATE: the update gate
  void* out2;      // ZR: r * h, bf16
  int half;        // ZR: hidden channels (z in [0, half), r in [half, 2 half))
  const float* tail;  // copied to out[p, cout + j] for j < tail_c (f32 out)
  int tail_c;
  int nan_fix;  // nan_to_num on the stored value
};

// --- PTX ------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_address(bar)),
               "r"(count)
               : "memory");
}

// the barriers' initialisation made visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_address(bar))
               : "memory");
}

// an arrival that also expects `bytes` of asynchronous copies this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   shared_address(bar)),
               "r"(bytes)
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = shared_address(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls > (1u << 24)) __trap();
  }
}

// 8 or 16 bytes global -> shared through L1 (the gather's taps overlap);
// src_bytes 0 fills them with zeros
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(shared_address(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async16_ca(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(shared_address(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the consumer warpgroup's own barrier (named barrier 1, 128 threads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// all N threads of the block, producers past their last stage included
// (named barrier 2)
template <int N>
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a 2D tile of a tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(shared_address(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(shared_address(bar)), "r"(x), "r"(y)
      : "memory");
}

// a wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart (the leading offset is unused in this mode)
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = shared_address(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += a * b: wgmma.mma_async m64nNk16, bf16 operands from shared memory
// (descriptors), f32 accumulators: warp w of the warpgroup holds rows
// 16w + lane/4 (+8), columns 8j + 2 (lane % 4) (+1) of n8 group j, as
// d[4j + 2 (row + 8) + (col + 1)]
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3"
        "}, %4, %5, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<192> {
  __device__ static __forceinline__ void mma(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
          "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
          "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
          "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1));
  }
};

// --- the tile -------------------------------------------------------------

// A tile of BN output channels with NP producer warpgroups (each takes every
// NP-th stage). The ring holds kStages stages of A and B; each producer
// warpgroup's staging ring kGather stages of raw A pieces (16 bytes a row a
// thread: 4 f32 values, or 4 bf16 in the first 8 bytes).
template <int BN, int NP>
struct B16Shape {
  static_assert(BN % 8 == 0 && BN <= 256, "a wgmma width");
  // as many stages as fit beside the gather's staging (about 160 KB of ring
  // at BN >= 192)
  static constexpr int kStages = BN >= 192 ? 160 * 1024 / (kB16ATileBytes + BN * kB16RowBytes)
                                           : (BN >= 128 ? 6 : 8);
  static constexpr int kThreads = 128 * (1 + NP);
  static constexpr int kGather = 4 / NP;  // A stages in flight a producer thread
  static constexpr int kAcc = BN / 2;  // accumulators a consumer thread
  static constexpr int kBBytes = BN * kB16RowBytes;
  static constexpr int kStageBytes = kB16ATileBytes + kBBytes;  // a multiple of 1024
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kWgStaging = kGather * 8 * 128 * 16;  // [stage][row q][thread] 16 B
  static constexpr int kStagingBytes = NP * kWgStaging;
  static constexpr int kLd = BN + 8;  // the epilogue tile's row stride, floats
  static_assert(kB16Rows * kLd * 4 <= kRingBytes, "the epilogue tile fits in the ring");
  // the ring, the staging, the full and empty barriers, and room to align
  // the ring to the 1024 bytes of a swizzle pattern
  static constexpr int kSmemBytes = kRingBytes + kStagingBytes + 2 * kStages * 8 + 1024;
};

// 4 bf16 values as 2 words: an 8-byte piece as it is, or 4 f32 values rounded
__device__ __forceinline__ uint2 piece_bf16(uint4 v, bool bf) {
  if (bf) return make_uint2(v.x, v.y);
  return make_uint2(pack_bf16x2(__uint_as_float(v.x), __uint_as_float(v.y)),
                    pack_bf16x2(__uint_as_float(v.z), __uint_as_float(v.w)));
}

// The global inputs of an epilogue quad (channels co .. co + 3 of pixel p):
// ZR's r half h; GATE's z and h.
template <int EPI>
__device__ __forceinline__ void quad_inputs(const ConvB& a, int p, int co, float4& g1,
                                            float4& g2) {
  if (EPI == EPI_ZR && co >= a.half) {
    g1 = *reinterpret_cast<const float4*>(a.h + (size_t)p * a.half + (co - a.half));
  } else if (EPI == EPI_GATE) {
    g1 = *reinterpret_cast<const float4*>(a.z + (size_t)p * a.cout + co);
    g2 = *reinterpret_cast<const float4*>(a.h + (size_t)p * a.cout + co);
  }
}

// The epilogue of 4 adjacent output channels co .. co + 3 of pixel p (those
// below cout), from their sums v and quad_inputs' g1, g2.
template <int EPI>
__device__ __forceinline__ void store_quad(const ConvB& a, int p, int co, float4 v, float4 g1,
                                           float4 g2) {
  const float4 b = *reinterpret_cast<const float4*>(a.bias + co);  // padded to N_pad
  float x[4] = {v.x + b.x, v.y + b.y, v.z + b.z, v.w + b.w};
  if (EPI == EPI_ZR) {  // half is a multiple of 4: a quad is all z or all r
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = sigmoid(x[e]);
    if (co < a.half) {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + (size_t)p * a.half + co) =
          make_float4(x[0], x[1], x[2], x[3]);
    } else {
      const size_t at = (size_t)p * a.half + (co - a.half);
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(a.out2) + at) =
          make_uint2(pack_bf16x2(x[0] * round_bf16(g1.x), x[1] * round_bf16(g1.y)),
                     pack_bf16x2(x[2] * round_bf16(g1.z), x[3] * round_bf16(g1.w)));
    }
    return;
  }
  if (EPI == EPI_GATE) {  // cout (the hidden width) is a multiple of 4; g1 z, g2 h
    x[0] = (1.f - g1.x) * round_bf16(g2.x) + g1.x * tanhf(x[0]);
    x[1] = (1.f - g1.y) * round_bf16(g2.y) + g1.y * tanhf(x[1]);
    x[2] = (1.f - g1.z) * round_bf16(g2.z) + g1.z * tanhf(x[2]);
    x[3] = (1.f - g1.w) * round_bf16(g2.w) + g1.w * tanhf(x[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (EPI == EPI_RELU) x[e] = x[e] < 0.f ? 0.f : x[e];
    if (a.nan_fix) x[e] = nan_to_num(x[e]);
    if (EPI == EPI_GATE) x[e] = round_bf16(x[e]);
  }
  const size_t at = (size_t)p * a.out_stride + co;
  if (co + 4 <= a.cout) {
    if (a.out_bf16) {
      *reinterpret_cast<uint2*>(static_cast<uint16_t*>(a.out) + at) =
          make_uint2(pack_bf16x2(x[0], x[1]), pack_bf16x2(x[2], x[3]));
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + at) =
          make_float4(x[0], x[1], x[2], x[3]);
    }
    return;
  }
  for (int e = 0; co + e < a.cout; ++e) {  // the last, partial quad
    if (a.out_bf16) {
      static_cast<uint16_t*>(a.out)[at + e] = (uint16_t)(pack_bf16x2(x[e], 0.f) & 0xffff);
    } else {
      static_cast<float*>(a.out)[at + e] = x[e];
    }
  }
}

// A producer thread (pt of the NP warpgroups' threads): the A of stages
// c = wg, wg + NP, ... by cp.async into its staging ring, kGather of its
// stages ahead, then rounded into the swizzled tile; and their B by TMA
// from the warpgroup's first thread.
template <int BN, int NP>
__device__ __forceinline__ void produce(const ConvB& a, const CUtensorMap* weights,
                                        uint8_t* smem, uint64_t* full, uint64_t* empty, int p0,
                                        int n_chunks, int pt) {
  using S = B16Shape<BN, NP>;
  const int wg = pt / 128;
  const int lt = pt % 128;
  const int piece = lt % 16;  // reduction values 4 piece .. 4 piece + 3 of a stage
  const int r0 = lt / 16;     // rows r0 + 8 q of the tile
  const int hw = a.height * a.width;
  const int cin = a.c[0] + a.c[1] + a.c[2];
  int row_y[8], row_x[8];  // the rows' pixels p0 + r0 + 8q at (y, x) of their map
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int p = p0 + r0 + 8 * q;
    const int r = p % hw;
    const int y = r / a.width;
    row_y[q] = p < a.pixels ? y : -1000000;  // an invalid row: every tap outside
    row_x[q] = r - y * a.width;
  }
  // the next stage's place in the reduction: k, its tap (ty, tx), channel ci
  int k = 4 * piece + wg * kB16Depth;
  int tap = k / cin;
  int ci = k - tap * cin;
  int ty = tap / a.kw;
  int tx = tap - ty * a.kw;
  // this thread's 16-byte cells of the staging ring, and its 8-byte place in
  // the swizzled tile at row r0 (rows r0 + 8q lie 1024 bytes apart and
  // swizzle alike)
  uint8_t* staging = smem + S::kRingBytes + wg * S::kWgStaging + lt * 16;
  const int a_off = r0 * kB16RowBytes + (((piece >> 1) ^ r0) << 4) + ((piece & 1) << 3);
  uint32_t bf_bits = 0;  // bit s: staging stage s holds bf16 pieces

  // the copies of the next stage into staging stage s
  auto gather = [&](int s) {
    const int sel = ci >= a.c[0] + a.c[1] ? 2 : (ci >= a.c[0] ? 1 : 0);
    const char* src = static_cast<const char*>(sel == 2 ? a.in[2] : sel == 1 ? a.in[1] : a.in[0]);
    const int cs = sel == 2 ? a.c[2] : sel == 1 ? a.c[1] : a.c[0];
    const int cc = ci - (sel == 2 ? a.c[0] + a.c[1] : sel == 1 ? a.c[0] : 0);
    const bool bf = (a.in_bf16 >> sel) & 1;
    bf_bits = (bf_bits & ~(1u << s)) | ((bf ? 1u : 0u) << s);
    const bool k_ok = k < a.k_total;
    const int dy = ty - (a.kh - 1) / 2;
    const int dx = tx - (a.kw - 1) / 2;
    // the tap's pixel of row q is p0 + r0 + 8q + dy * width + dx; its piece
    // lies `pixel_bytes` a pixel apart, from this piece's channel on
    const int pixel_bytes = cs * (bf ? 2 : 4);
    const char* from = src + (long long)(p0 + r0 + dy * a.width + dx) * pixel_bytes +
                       cc * (bf ? 2 : 4);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const bool ok = k_ok && (unsigned)(row_y[q] + dy) < (unsigned)a.height &&
                      (unsigned)(row_x[q] + dx) < (unsigned)a.width;
      const char* at = ok ? from + (long long)(8 * q) * pixel_bytes : src;
      uint8_t* cell = staging + (s * 8 + q) * 128 * 16;
      if (bf) {
        cp_async8(cell, at, ok ? 8 : 0);
      } else {
        cp_async16_ca(cell, at, ok ? 16 : 0);
      }
    }
    k += NP * kB16Depth;
    ci += NP * kB16Depth;
    while (ci >= cin) {
      ci -= cin;
      if (++tx == a.kw) tx = 0, ++ty;
    }
  };

#pragma unroll
  for (int s = 0; s < S::kGather; ++s) {
    if (wg + s * NP < n_chunks) gather(s);
    cp_async_commit();
  }
  for (int c = wg, i = 0; c < n_chunks; c += NP, ++i) {
    const int s = i % S::kGather;
    cp_async_wait<S::kGather - 1>();  // this thread's copies of stage c have landed
    const bool bf = (bf_bits >> s) & 1;
    uint2 piece_v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      piece_v[q] = piece_bf16(*reinterpret_cast<const uint4*>(staging + (s * 8 + q) * 128 * 16),
                              bf);
    }
    const int slot = c % S::kStages;
    mbar_wait(&empty[slot], ((c / S::kStages) & 1) ^ 1);
    uint8_t* stage = smem + slot * S::kStageBytes;
    if (lt == 0) {
      mbar_arrive_tx(&full[slot], S::kBBytes);
      tma_load_2d(stage + kB16ATileBytes, weights, &full[slot], c * kB16Depth, 0);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      *reinterpret_cast<uint2*>(stage + a_off + q * 8 * kB16RowBytes) = piece_v[q];
    }
    fence_proxy_async();
    mbar_arrive(&full[slot]);
    // staging stage s is read (its values are in the tile): refill it
    if (c + S::kGather * NP < n_chunks) gather(s);
    cp_async_commit();
  }
}

// The consumer warpgroup: every stage's four m64nBNk16 products into the
// accumulators, which then go into a [64][BN + 8] f32 tile in the ring.
template <int BN, int NP, int EPI>
__device__ __forceinline__ void consume(const ConvB& a, uint8_t* smem, uint64_t* full,
                                        uint64_t* empty, int p0, int n_chunks, int tid) {
  using S = B16Shape<BN, NP>;
  float acc[S::kAcc];
#pragma unroll
  for (int i = 0; i < S::kAcc; ++i) acc[i] = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    const int slot = c % S::kStages;
    mbar_wait(&full[slot], (c / S::kStages) & 1);
    const uint8_t* stage = smem + slot * S::kStageBytes;
    const uint64_t da = smem_desc(stage);
    const uint64_t db = smem_desc(stage + kB16ATileBytes);
    __syncwarp();  // converged for the .aligned wgmma instructions
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kB16Depth / 16; ++ks) {  // 32 bytes of a row a step
      Wgmma<BN>::mma(acc, da + 2 * ks, db + 2 * ks);
    }
    wgmma_commit();
    fence_operands(acc);
    wgmma_wait<1>();  // the stage before has been multiplied: free its slot
    if (c > 0 && tid % 32 == 0) mbar_arrive(&empty[(c - 1) % S::kStages]);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  const int warp = tid / 32, lane = tid % 32;
  float* tile = reinterpret_cast<float*>(smem);
  consumer_sync();  // every warp's products have left the ring
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = 16 * warp + lane / 4 + 8 * hr;
      *reinterpret_cast<float2*>(tile + row * S::kLd + 8 * j + 2 * (lane % 4)) =
          make_float2(acc[4 * j + 2 * hr], acc[4 * j + 2 * hr + 1]);
    }
  }
}

// The epilogue, by all the block's threads once the consumer has put the
// sums into the [64][BN + 8] f32 tile: quad i of the tile is row i / kQuads,
// channels 4 (i % kQuads) ..; thread t takes quads t + kThreads e, their
// global inputs loaded a batch at a time.
template <int BN, int NP, int EPI>
__device__ __forceinline__ void finish(const ConvB& a, const float* tile, int p0, int t) {
  using S = B16Shape<BN, NP>;
  constexpr int kQuads = BN / 4;
  constexpr int kTotal = kB16Rows * kQuads;
  constexpr int kBatch = 4;
  for (int i0 = t; i0 < kTotal; i0 += kBatch * S::kThreads) {
    float4 g1[kBatch], g2[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = i0 + e * S::kThreads;
      const int p = p0 + i / kQuads, co = 4 * (i % kQuads);
      if (i < kTotal && p < a.pixels && co < a.cout) quad_inputs<EPI>(a, p, co, g1[e], g2[e]);
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int i = i0 + e * S::kThreads;
      const int row = i / kQuads, co = 4 * (i % kQuads);
      if (i < kTotal && p0 + row < a.pixels && co < a.cout) {
        store_quad<EPI>(a, p0 + row, co,
                        *reinterpret_cast<const float4*>(tile + row * S::kLd + co), g1[e], g2[e]);
      }
    }
  }
  if (a.tail_c > 0) {
    float* out = static_cast<float*>(a.out);
    for (int i = t; i < kB16Rows * a.tail_c; i += S::kThreads) {
      const int p = p0 + i / a.tail_c;
      const int j = i % a.tail_c;
      if (p < a.pixels) {
        out[(size_t)p * a.out_stride + a.cout + j] = a.tail[(size_t)p * a.tail_c + j];
      }
    }
  }
}

// One convolution: block x computes pixels [64 x, 64 x + 64) x all BN
// channels. n_chunks = K_pad / 64 stages.
template <int BN, int NP, int EPI>
__global__ void __launch_bounds__(B16Shape<BN, NP>::kThreads, 1)
    conv_bf16_kernel(const __grid_constant__ CUtensorMap weights, const ConvB a, int n_chunks) {
  using S = B16Shape<BN, NP>;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (shared_address(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kRingBytes + S::kStagingBytes);
  uint64_t* empty = full + S::kStages;
  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(&full[s], 128 + 1);  // the producer's threads + the TMA's byte count
      mbar_init(&empty[s], 4);       // the consumer's warps
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int p0 = blockIdx.x * kB16Rows;
  if (tid >= 128) {
    produce<BN, NP>(a, &weights, smem, full, empty, p0, n_chunks, tid - 128);
  } else {
    consume<BN, NP, EPI>(a, smem, full, empty, p0, n_chunks, tid);
  }
  block_sync<S::kThreads>();  // the consumer's sums are in the tile
  finish<BN, NP, EPI>(a, reinterpret_cast<const float*>(smem), p0, tid);
}

// --- host -----------------------------------------------------------------

using TensorMapEncoder = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                      const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                      const cuuint32_t*, CUtensorMapInterleave,
                                      CUtensorMapSwizzle, CUtensorMapL2promotion,
                                      CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, from the libcuda the runtime loaded
TensorMapEncoder tensor_map_encoder() {
  static const TensorMapEncoder fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<TensorMapEncoder>(dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 weight plane [n_rows][k_pad]: boxes of 64
// reduction values x box_n rows, 128-byte swizzled.
int weight_map(CUtensorMap* map, const void* plane, int k_pad, int n_rows, int box_n) {
  const TensorMapEncoder encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)k_pad, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k_pad * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kB16Depth, (cuuint32_t)box_n};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(plane),
                            dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int BN, int NP, int EPI>
int launch_bf16(const ConvB& a, const CUtensorMap& map, int n_chunks, cudaStream_t stream) {
  using S = B16Shape<BN, NP>;
  const auto kernel = conv_bf16_kernel<BN, NP, EPI>;
  static bool sized = false;  // the attribute once a kernel
  if (!sized) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    sized = true;
  }
  const int blocks = (a.pixels + kB16Rows - 1) / kB16Rows;
  kernel<<<blocks, S::kThreads, S::kSmemBytes, stream>>>(map, a, n_chunks);
  return (int)cudaGetLastError();
}

// (A source that takes only the primitives above, clfm.cu, defines
// CAMLI_BF16_PRIMITIVES_ONLY: it then builds none of the tile's kernels.)
#ifndef CAMLI_BF16_PRIMITIVES_ONLY
// One convolution of the chain on the bf16 tile: `plane` the bf16 weights
// [round_up(cout, 64)][round_up(kh * kw * cin, 64)], `bias` f32. The tile's
// width is cout rounded up to 8, 64, 128, 192 or 256 (the epilogues built:
// ReLU at 64-256, ZR at 128 and 256, GATE at 64 and 128, none at 8).
int run_conv_bf16(ConvB a, const void* plane, const float* bias, int epi, int kh, int kw,
                  int cout, cudaStream_t stream) {
  a.bias = bias;
  a.kh = kh;
  a.kw = kw;
  a.cout = cout;
  a.k_total = kh * kw * (a.c[0] + a.c[1] + a.c[2]);
  if (a.out_stride == 0) a.out_stride = cout;
  if (cout > 256) return (int)cudaErrorInvalidValue;
  const int k_pad = round_up(a.k_total, kB16Depth);
  const int bn = cout <= 8 ? 8 : cout <= 64 ? 64 : cout <= 128 ? 128 : cout <= 192 ? 192 : 256;
  CUtensorMap map;
  const int err = weight_map(&map, plane, k_pad, round_up(cout, kNPad), bn);
  if (err != 0) return err;
  const int n = k_pad / kB16Depth;
  switch (epi * 1000 + bn) {
    case EPI_RELU * 1000 + 64: return launch_bf16<64, kB16Producers, EPI_RELU>(a, map, n, stream);
    case EPI_RELU * 1000 + 128: return launch_bf16<128, kB16Producers, EPI_RELU>(a, map, n, stream);
    case EPI_RELU * 1000 + 192: return launch_bf16<192, kB16Producers, EPI_RELU>(a, map, n, stream);
    case EPI_RELU * 1000 + 256: return launch_bf16<256, kB16Producers, EPI_RELU>(a, map, n, stream);
    case EPI_ZR * 1000 + 128: return launch_bf16<128, kB16Producers, EPI_ZR>(a, map, n, stream);
    case EPI_ZR * 1000 + 256: return launch_bf16<256, kB16Producers, EPI_ZR>(a, map, n, stream);
    case EPI_GATE * 1000 + 64: return launch_bf16<64, kB16Producers, EPI_GATE>(a, map, n, stream);
    case EPI_GATE * 1000 + 128: return launch_bf16<128, kB16Producers, EPI_GATE>(a, map, n, stream);
    case EPI_NONE * 1000 + 8: return launch_bf16<8, kB16Producers, EPI_NONE>(a, map, n, stream);
    default: return (int)cudaErrorInvalidValue;  // a width this tile was not built for
  }
}
#endif  // CAMLI_BF16_PRIMITIVES_ONLY

}  // namespace
