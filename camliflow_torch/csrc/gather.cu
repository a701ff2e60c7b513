// Batched row gather into the k-major layout.
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
// [2, 8192, 99] x [2, 4096, 16], writes 52 MB). Design: a row is copied as
// words of the widest size (4, 2 or 1 bytes) that divides its byte length
// and both base addresses, one thread per output word, so neighbouring threads write neighbouring
// words and read neighbouring words of the same source row. Rows of 99 or
// 131 floats are not 16-byte aligned, so no vector loads. The copy is exact
// in any element type: no value passes through a float register.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <typename Word>
__global__ void __launch_bounds__(kThreads) gather_kmajor_kernel(
    const Word* __restrict__ data, const int32_t* __restrict__ idx, Word* __restrict__ out,
    unsigned n, unsigned m, unsigned k, unsigned words, unsigned total) {
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

template <typename Word>
int run(const void* data, const int32_t* idx, void* out, int batch, int n, int m, int k,
        int row_bytes, cudaStream_t stream) {
  const unsigned words = (unsigned)row_bytes / sizeof(Word);
  const unsigned total = (unsigned)batch * k * m * words;
  if (total == 0) return 0;
  gather_kmajor_kernel<Word><<<(total + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      static_cast<const Word*>(data), idx, static_cast<Word*>(out), n, m, k, words, total);
  return (int)cudaGetLastError();
}

}  // namespace

// The wrapper keeps batch * k * m * row_bytes below 2^31. The word must also
// divide both addresses: a view may start at any element of its storage.
extern "C" int camli_gather_kmajor(const void* data, const int32_t* idx, void* out,
                                   int batch, int n, int m, int k, int row_bytes,
                                   cudaStream_t stream) {
  const uintptr_t align = (uintptr_t)row_bytes | (uintptr_t)data | (uintptr_t)out;
  if (align % 4 == 0) return run<uint32_t>(data, idx, out, batch, n, m, k, row_bytes, stream);
  if (align % 2 == 0) return run<uint16_t>(data, idx, out, batch, n, m, k, row_bytes, stream);
  return run<uint8_t>(data, idx, out, batch, n, m, k, row_bytes, stream);
}
