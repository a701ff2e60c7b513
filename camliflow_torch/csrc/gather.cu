// Batched row gather into the k-major layout, staged a slab at a time.
//
// camli_gather_kmajor replaces
//   camliflow_tpu/ops/pallas_gather.py::gather_points_kmajor:
//   out[b, j, m, :] = data[b, idx[b, m, j], :], for data [B, N, C] of any
//   element type and idx [B, M, k] int32, so out is [B, k, M, C]. It also
//   covers tools/probe_gather_matrix.py::run, whose every case is such a row
//   gather. On the main paths it serves PointConv's two gathers in the point
//   encoders (xyz, C = 3, and [xyz, features], C = 99 and 131 at full width)
//   and the flagship's final 2048 -> 8192 upsample (xyz and the flow, k = 3).
//
// A gather moves bytes and computes nothing: the bound is reading each
// selected row and writing it once (the level-0 encoder gather at B = 2,
// [2, 8192, 99] x [2, 4096, 16], writes 52 MB; its 6.5 MB table stays in
// L2, so the writes set the pace).
//
// Design (gather_kmajor_slab): in the k-major output each tap's run
// out[b, j, mm0 : mm0 + T, :] is one contiguous T * row_bytes slab. A block
// takes one (b, j) and a tile of T consecutive query points (the plan,
// ops/gather.py::gather_plan). It stages the tile's T indices in shared
// memory, gathers the T source rows into a shared buffer laid out as the
// slab, and hands the slab's 16-byte-aligned body to the bulk copy engine
// (cp.async.bulk.global.shared::cta, TMA's 1-D form) in one instruction;
// an unaligned head and tail are copied by bytes. The gather walks the
// slab's (row, word) pairs flat over the block's threads, stepping without a
// division, in words of the widest size (16, 8, 4, 2 or 1 bytes) that
// divides the row and both base addresses (rows of 99 or 131 floats take
// 4-byte words), four loads in flight a thread. The buffer is shifted by the
// slab's address modulo 16, so its chunks line up with the output's. A row
// wider than the buffer is copied in pieces, a row a block. Measured on the
// H100 (csrc/gather_forms.py, PERF.md): the bulk copy beat 16-byte stores
// from registers by 7-8%, and one tap a block beat two or more taps
// double-buffered in one block: the overlap comes from the other resident
// blocks.
//
// Rows narrower than 16 bytes (xyz and the flow, 12 bytes) take
// gather_kmajor_words instead, chosen by the wrapper by shape: one thread an
// output word, no staging. There a slab is a few KB and a block's fixed
// cost (staging, two barriers, the copy's issue) outweighs its 16-byte
// stores: staged, the main path's 12-byte gathers ran 0.2-0.5 us slower.
//
// Both copies are exact in any element type: no value passes through a
// float register.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // loads in flight a thread
constexpr unsigned kGridMax = 65535;  // a grid's y and z extents at most

template <int W> struct WordOf;
template <> struct WordOf<16> { using type = uint4; };
template <> struct WordOf<8> { using type = uint2; };
template <> struct WordOf<4> { using type = uint32_t; };
template <> struct WordOf<2> { using type = uint16_t; };
template <> struct WordOf<1> { using type = uint8_t; };

struct Slab {
  const char* data;
  const int32_t* idx;
  char* out;
  int batch, n, m, k, row_bytes;
  int rows;    // T: query points a block
  int piece;   // bytes of each row a block copies (row_bytes unless rows == 1)
  int pieces;  // ceil(row_bytes / piece)
  int idx_bytes;  // shared memory before the buffer: the T indices, 16-byte rounded
};

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void bulk_store(char* dst, const char* src, unsigned bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// every bulk copy issued by this thread has read its shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// 8 blocks an SM (32 registers) ran the main path's slabs 7-15% faster
// than the compiler's own choice (64 registers, 4 blocks); 16-byte words
// spill at 32 and take 6 (40).
template <int W>
__global__ void __launch_bounds__(kThreads, W == 16 ? 6 : 8) gather_kmajor_slab(const Slab p) {
  using Word = typename WordOf<W>::type;
  extern __shared__ __align__(16) char smem[];
  int32_t* idx_s = reinterpret_cast<int32_t*>(smem);
  char* const buffer = smem + p.idx_bytes;

  const bool whole = p.pieces == 1;
  const int pc = whole ? 0 : (int)(blockIdx.x % (unsigned)p.pieces);
  const int mm0 = (whole ? (int)blockIdx.x : (int)(blockIdx.x / (unsigned)p.pieces)) * p.rows;
  const int rows = min(p.rows, p.m - mm0);
  const int c0 = pc * p.piece;
  const int bytes = min(p.piece, p.row_bytes - c0);  // of each row, a multiple of W
  const unsigned words = (unsigned)bytes / W;
  const unsigned total = (unsigned)rows * words;  // the slab's words
  const size_t len = (size_t)rows * bytes;        // the slab's bytes (rows == 1 if pieces > 1)
  // the flat walk over (row, word): thread t starts at word t, steps kThreads
  const unsigned step_rows = kThreads / words, step_words = kThreads - step_rows * words;
  const unsigned r0 = threadIdx.x / words, w0 = threadIdx.x - r0 * words;

  bool first = true;
  for (int b = blockIdx.z; b < p.batch; b += gridDim.z) {
    const int32_t* idx_b = p.idx + ((size_t)b * p.m + mm0) * p.k;
    const char* src_b = p.data + (size_t)b * p.n * p.row_bytes + c0;
    for (int j = blockIdx.y; j < p.k; j += gridDim.y) {
      if (!first) {  // a grid smaller than k or B: the last slab's copy has read the buffer
        if (threadIdx.x == 0) bulk_wait_read();
        __syncthreads();
      }
      first = false;
      for (int r = threadIdx.x; r < rows; r += kThreads) idx_s[r] = idx_b[(size_t)r * p.k + j];
      char* slab = p.out + (((size_t)b * p.k + j) * p.m + mm0) * p.row_bytes + c0;
      const unsigned shift = (unsigned)((uintptr_t)slab & 15);
      char* staged = buffer + shift;
      __syncthreads();

      unsigned r = r0, w = w0;
      for (unsigned f = threadIdx.x; f < total; f += kUnroll * kThreads) {
        Word v[kUnroll];
        unsigned at[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          at[u] = r * bytes + w * W;
          if (f + u * kThreads < total) {
            const char* row = src_b + (size_t)idx_s[r] * p.row_bytes;
            v[u] = reinterpret_cast<const Word*>(row)[w];
          }
          w += step_words;
          r += step_rows;
          if (w >= words) {
            w -= words;
            ++r;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (f + u * kThreads < total) *reinterpret_cast<Word*>(staged + at[u]) = v[u];
        }
      }
      fence_async_shared();  // the generic writes above, before the copy engine reads them
      __syncthreads();

      const size_t lead = (16 - shift) & 15;
      const size_t head = lead < len ? lead : len;
      const size_t tail = head + (len - head) / 16 * 16;
      if (threadIdx.x == 0 && tail > head) {
        bulk_store(slab + head, staged + head, (unsigned)(tail - head));
      }
      for (size_t i = threadIdx.x; i < head; i += kThreads) slab[i] = staged[i];
      for (size_t i = tail + threadIdx.x; i < len; i += kThreads) slab[i] = staged[i];
    }
  }
  if (threadIdx.x == 0) bulk_wait_read();  // the buffer lives until the copy has read it
}

// One thread an output word (e = ((b * k + j) * m + mm) * words + w), for
// rows narrower than 16 bytes.
template <int W>
__global__ void __launch_bounds__(kThreads) gather_kmajor_words(
    const typename WordOf<W>::type* __restrict__ data, const int32_t* __restrict__ idx,
    typename WordOf<W>::type* __restrict__ out, unsigned n, unsigned m, unsigned k,
    unsigned words, unsigned total) {
  const unsigned e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const unsigned row = e / words;  // the output row (b, j, mm), mm fastest
  const unsigned w = e - row * words;
  const unsigned mm = row % m;
  const unsigned bj = row / m;
  const unsigned j = bj % k;
  const unsigned b = bj / k;
  const unsigned src = (unsigned)idx[((size_t)b * m + mm) * k + j];
  out[e] = data[((size_t)b * n + src) * words + w];
}

template <int W>
int run_words(const void* data, const int32_t* idx, void* out, int batch, int n, int m, int k,
              int row_bytes, cudaStream_t stream) {
  using Word = typename WordOf<W>::type;
  const unsigned words = (unsigned)row_bytes / W;
  const unsigned total = (unsigned)batch * k * m * words;
  gather_kmajor_words<W><<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const Word*>(data), idx, static_cast<Word*>(out), n, m, k, words, total);
  return (int)cudaGetLastError();
}

template <int W>
int run_slab(const Slab& p, cudaStream_t stream) {
  const unsigned tiles = (unsigned)(p.m + p.rows - 1) / p.rows;
  const dim3 grid(tiles * p.pieces, p.k < (int)kGridMax ? p.k : kGridMax,
                  p.batch < (int)kGridMax ? p.batch : kGridMax);
  const size_t smem = (size_t)p.idx_bytes + ((size_t)p.rows * p.piece + 16 + 15) / 16 * 16;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {  // above 48 KB only after this; refused above the card's limit
    err = cudaFuncSetAttribute(gather_kmajor_slab<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();  // the refusal is reported here, not left for the next launch
    return (int)err;
  }
  gather_kmajor_slab<W><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// rows (T) and piece come from ops/gather.py::gather_plan: T query points a
// block, each row copied in pieces of `piece` bytes (a multiple of 16,
// row_bytes unless T == 1); rows == 0 takes gather_kmajor_words. The word
// divides the row and both addresses: a view may start at any element of its
// storage. The wrapper keeps batch * k * m * row_bytes below 2^31.
extern "C" int camli_gather_kmajor(const void* data, const int32_t* idx, void* out,
                                   int batch, int n, int m, int k, int row_bytes, int rows,
                                   int piece, cudaStream_t stream) {
  if (batch == 0 || m == 0 || k == 0 || row_bytes == 0) return 0;
  const uintptr_t align = (uintptr_t)row_bytes | (uintptr_t)data | (uintptr_t)out;
  if (rows == 0) {
    if (align % 8 == 0) return run_words<8>(data, idx, out, batch, n, m, k, row_bytes, stream);
    if (align % 4 == 0) return run_words<4>(data, idx, out, batch, n, m, k, row_bytes, stream);
    if (align % 2 == 0) return run_words<2>(data, idx, out, batch, n, m, k, row_bytes, stream);
    return run_words<1>(data, idx, out, batch, n, m, k, row_bytes, stream);
  }
  if (piece >= row_bytes) piece = row_bytes;
  // a slab is contiguous only for whole rows or one row; pieces keep 16-byte steps
  if (rows < 0 || (piece < row_bytes && (rows != 1 || piece % 16 != 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Slab p{static_cast<const char*>(data), idx, static_cast<char*>(out), batch, n, m, k,
         row_bytes, rows, piece, (row_bytes + piece - 1) / piece, (rows * 4 + 15) / 16 * 16};
  if (align % 16 == 0) return run_slab<16>(p, stream);
  if (align % 8 == 0) return run_slab<8>(p, stream);
  if (align % 4 == 0) return run_slab<4>(p, stream);
  if (align % 2 == 0) return run_slab<2>(p, stream);
  return run_slab<1>(p, stream);
}
