// The 2D update chain.
//
// camli_motion_encoder_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::motion_encoder_2d_pallas:
//   conv_c1 1x1 (324->256), conv_c2 3x3 (256->192), conv_f2 3x3 (128->64),
//   merge 3x3 over [cf, ff] (256->126), all ReLU, nan_to_num, then the flow
//   appended as the last 2 channels. conv_f1 (7x7, 2->128) runs outside, in
//   the wrapper, as the JAX wrapper leaves it to XLA. 4 launches.
// camli_gru_flowhead_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::gru_flowhead_2d_pallas: its two
//   halves in sequence. camli_gru_2d is the separable ConvGRU (1x5 then
//   5x1; z and r from one conv whose output stacks both weights, then q)
//   over hx = [h, x2d, motion], nan_to_num of the new hidden state after
//   both directions (as models/raft.py::GRU2D), 4 launches;
//   camli_flow_head_2d the flow head 3x3 (128->256) ReLU, 3x3 (256->2),
//   nan_to_num, 2 launches. With fuse_hidden, CLFM sits between them and
//   the model calls each half on its own.
// These run on conv_tile_tc.cuh's 3xTF32 tensor-core tile (see its note for
// the design and the numerics), on weights packed and split once per
// request.
// camli_update_2d replaces
//   camliflow_tpu/ops/pallas_update2d.py::update_2d_pallas: the whole RAFT
//   iteration (the motion encoder, then the GRU and the flow head) from one
//   entry point, as 10 launches of the tile on one scratch buffer: the two
//   entry points above in sequence, so h' and delta are theirs bit for bit.
//   At 68x120 the whole scratch (33 MB) stays in the 50 MB L2 between
//   launches. One cooperative launch of the nine stages with grid barriers
//   between them, on the same tile variants and bit for bit the same, took
//   1.54 ms of device time against the chain's 1.02 on an H100 (PERF.md):
//   the barriers cost 0.027 ms, but every stage ran 33-73% slower inside it
//   than as its own launch, so it was deleted.
//
// All three compute the port's exact path on the 3xTF32 tile, and with
// bf16 != 0 the fast path's (fast_inference=on) on conv_tile_bf16.cuh's
// wgmma tile (see its note for the design), on weight planes stored in bf16
// once per request, with the TPU kernels' rounding points
// (camliflow_tpu/ops/pallas_update2d.py): every conv's input rounded to
// bf16, r*h and the flow head's mid taken from bf16, and the GRU's new
// hidden state nan_to_num-ed and rounded to bf16 after each direction, h'
// written as the f32 of that bf16 value. There the ReLU outputs of conv_c1,
// conv_c2, conv_f2 and the flow head's first conv, and r*h, are stored in
// bf16 (cf1, cf, ff, mid, rh); motion, z, h' and delta stay f32. The flow
// head's last conv (256 -> 2) takes the same tile at a width of 8.
//
// Bound on the card, at the flagship shape (1 x 68 x 120 = 8160 pixels):
// the motion encoder is 14.5 GFLOP per call (c1 1.35, c2 7.22, f2 1.20,
// merge 4.74) and moves ~18 MB (corr 10.6 MB, weights 3.6 MB, output
// 4.2 MB); the GRU + flow head is 29.0 GFLOP (zr 2 x 8.02, q 2 x 4.01,
// head 4.81 + 0.08) over ~24 MB. At 67 TFLOP/s of f32 outside the tensor
// cores that is 0.22 ms and 0.43 ms, and at 495 TFLOP/s of TF32 with three
// products per f32 product 0.088 ms and 0.176 ms, against ~7 us of memory
// traffic at 3.35 TB/s: all are bound by operations, and so is the whole
// iteration (43.5 GFLOP, 0.65 ms in f32; 0.264 ms as 3xTF32).
#include "conv_tile_bf16.cuh"

namespace {

// One convolution of the exact path as its own launch. The weight planes are
// [N_pad][K_pad] with N_pad = round_up(cout, 64) and K_pad =
// round_up(kh*kw*cin, 16), zero past (cout, kh*kw*cin). A conv of at most 8
// output channels and no epilogue (the flow head's last) takes the narrow
// split-reduction variant; one of 256 channels or more the 64 x 128 tile.
int run_conv_exact(const Conv& a, const float* hi, const float* lo, int epi, int k_pad,
                   cudaStream_t stream) {
  if (a.cout <= 8 && epi == EPI_NONE) {
    return launch_tc<32, 8, 1, 1, 4, EPI_NONE>(a, hi, lo, k_pad, 1, stream);
  }
  if (a.cout >= 256 && a.n_pad % 128 == 0) {
    const int n_tiles = a.n_pad / 128;
    switch (epi) {
      case EPI_RELU:
        return launch_tc<64, 128, 2, 2, 1, EPI_RELU>(a, hi, lo, k_pad, n_tiles, stream);
      case EPI_ZR:
        return launch_tc<64, 128, 2, 2, 1, EPI_ZR>(a, hi, lo, k_pad, n_tiles, stream);
      default:
        break;  // the other epilogues take the 64 x 64 tile
    }
  }
  const int n_tiles = a.n_pad / 64;
  switch (epi) {
    case EPI_RELU:
      return launch_tc<64, 64, 2, 2, 1, EPI_RELU>(a, hi, lo, k_pad, n_tiles, stream);
    case EPI_NONE:
      return launch_tc<64, 64, 2, 2, 1, EPI_NONE>(a, hi, lo, k_pad, n_tiles, stream);
    case EPI_ZR:
      return launch_tc<64, 64, 2, 2, 1, EPI_ZR>(a, hi, lo, k_pad, n_tiles, stream);
    default:
      return launch_tc<64, 64, 2, 2, 1, EPI_GATE>(a, hi, lo, k_pad, n_tiles, stream);
  }
}

// The inputs of a convolution: a virtual concat of up to three NHWC maps,
// each bf16 where its flag is set (the fast path's intermediates), else f32.
ConvB maps(int pixels, int height, int width, const void* in0, int c0, bool bf0,
           const void* in1 = nullptr, int c1 = 0, bool bf1 = false, const void* in2 = nullptr,
           int c2 = 0, bool bf2 = false) {
  ConvB a = {};
  a.pixels = pixels;
  a.height = height;
  a.width = width;
  a.in[0] = in0, a.in[1] = in1, a.in[2] = in2;
  a.c[0] = c0, a.c[1] = c1, a.c[2] = c2;
  a.in_bf16 = (bf0 ? 1 : 0) | (bf1 ? 2 : 0) | (bf2 ? 4 : 0);
  return a;
}

// One convolution of the chain: w = (hi, lo, bias) of its packing. bf16: the
// bf16 tile on the bf16 plane hi; else the 3xTF32 tile on f32 inputs and
// outputs (no flag set).
int run_conv(const ConvB& a, const void* const* w, int epi, int kh, int kw, int cout, int bf16,
             cudaStream_t stream) {
  const float* bias = static_cast<const float*>(w[2]);
  if (bf16) return run_conv_bf16(a, w[0], bias, epi, kh, kw, cout, stream);
  Conv c = input(a.pixels, a.height, a.width, static_cast<const float*>(a.in[0]), a.c[0],
                 static_cast<const float*>(a.in[1]), a.c[1],
                 static_cast<const float*>(a.in[2]), a.c[2]);
  c.bias = bias;
  c.out = static_cast<float*>(a.out);
  c.out_stride = a.out_stride;
  c.h = a.h;
  c.z = a.z;
  c.out2 = static_cast<float*>(a.out2);
  c.half = a.half;
  c.tail = a.tail;
  c.tail_c = a.tail_c;
  c.nan_fix = a.nan_fix;
  c = shaped(c, kh, kw, cout);
  return run_conv_exact(c, static_cast<const float*>(w[0]), static_cast<const float*>(w[1]),
                        epi, round_up(c.k_total, kTcBk), stream);
}

// bytes of a [pixels, channels] scratch map of `bytes`-byte values, rounded
// up to 16 so that the next map stays 16-byte aligned
size_t map_bytes(size_t pixels, int channels, int bytes) {
  return (pixels * channels * bytes + 15) / 16 * 16;
}

}  // namespace

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

// convs: (hi, lo, bias) of conv_c1, conv_c2, conv_f2, the merge conv (bf16:
// hi the bf16 plane, lo unread); cf1, cf, ff: [pixels, c_c1 | c_c2 | c_f2]
// scratch, bf16 with bf16 != 0, else f32
extern "C" int camli_motion_encoder_2d(const float* flow, const float* ff1, const float* corr,
                                       const void* const* convs, void* cf1, void* cf, void* ff,
                                       float* out, int bf16, int batch, int height, int width,
                                       int c_corr, int c_c1, int c_c2, int c_f1, int c_f2,
                                       int c_m, cudaStream_t stream) {
  const int pixels = batch * height * width;
  const bool b = bf16 != 0;  // the intermediates' storage
  ConvB a = maps(pixels, height, width, corr, c_corr, false);
  a.out = cf1, a.out_bf16 = b;
  CAMLI_TRY(run_conv(a, convs, EPI_RELU, 1, 1, c_c1, bf16, stream));
  a = maps(pixels, height, width, cf1, c_c1, b);
  a.out = cf, a.out_bf16 = b;
  CAMLI_TRY(run_conv(a, convs + 3, EPI_RELU, 3, 3, c_c2, bf16, stream));
  a = maps(pixels, height, width, ff1, c_f1, false);
  a.out = ff, a.out_bf16 = b;
  CAMLI_TRY(run_conv(a, convs + 6, EPI_RELU, 3, 3, c_f2, bf16, stream));
  a = maps(pixels, height, width, cf, c_c2, b, ff, c_f2, b);
  a.out = out, a.out_stride = c_m + 2;
  a.tail = flow, a.tail_c = 2, a.nan_fix = 1;
  return run_conv(a, convs + 9, EPI_RELU, 3, 3, c_m, bf16, stream);
}

// convs: (hi, lo, bias) of zr1, q1, zr2, q2; z, rh: [pixels, c_h] scratch
// (rh bf16 with bf16 != 0, z f32)
extern "C" int camli_gru_2d(const float* h, const float* x2d, const float* motion,
                            const void* const* convs, float* z, void* rh, float* h1,
                            float* h_out, int bf16, int batch, int height, int width, int c_h,
                            int c_x, int c_m, cudaStream_t stream) {
  const int pixels = batch * height * width;
  const float* state = h;
  float* next[2] = {h1, h_out};
  for (int d = 0; d < 2; ++d) {
    const int kh = d == 0 ? 1 : 5;
    const int kw = d == 0 ? 5 : 1;
    const void* const* zr = convs + 6 * d;
    const void* const* q = zr + 3;
    ConvB a = maps(pixels, height, width, state, c_h, false, x2d, c_x, false, motion, c_m, false);
    a.out = z, a.out2 = rh, a.h = state;
    a.half = c_h;
    CAMLI_TRY(run_conv(a, zr, EPI_ZR, kh, kw, 2 * c_h, bf16, stream));
    a = maps(pixels, height, width, rh, c_h, bf16 != 0, x2d, c_x, false, motion, c_m, false);
    a.out = next[d], a.h = state, a.z = z;
    // nan_to_num once, after both directions (bf16: after each, where h'
    // is rounded to bf16)
    a.nan_fix = bf16 || d == 1;
    CAMLI_TRY(run_conv(a, q, EPI_GATE, kh, kw, c_h, bf16, stream));
    state = next[d];
  }
  return 0;
}

// convs: (hi, lo, bias) of head1, head2; mid: [pixels, c_mid] scratch (bf16
// with bf16 != 0)
extern "C" int camli_flow_head_2d(const float* h, const void* const* convs, void* mid,
                                  float* delta, int bf16, int batch, int height, int width,
                                  int c_h, int c_mid, cudaStream_t stream) {
  const int pixels = batch * height * width;
  ConvB a = maps(pixels, height, width, h, c_h, false);
  a.out = mid, a.out_bf16 = bf16 != 0;
  CAMLI_TRY(run_conv(a, convs, EPI_RELU, 3, 3, c_mid, bf16, stream));
  a = maps(pixels, height, width, mid, c_mid, bf16 != 0);
  a.out = delta, a.nan_fix = 1;
  return run_conv(a, convs + 3, EPI_NONE, 3, 3, 2, bf16, stream);
}

// convs: (hi, lo, bias) of zr1, q1, zr2, q2, head1, head2
extern "C" int camli_gru_flowhead_2d(const float* h, const float* x2d, const float* motion,
                                     const void* const* convs, float* z, void* rh, float* h1,
                                     void* mid, float* h_out, float* delta, int bf16, int batch,
                                     int height, int width, int c_h, int c_x, int c_m,
                                     int c_mid, cudaStream_t stream) {
  CAMLI_TRY(camli_gru_2d(h, x2d, motion, convs, z, rh, h1, h_out, bf16, batch, height, width,
                         c_h, c_x, c_m, stream));
  return camli_flow_head_2d(h_out, convs + 12, mid, delta, bf16, batch, height, width, c_h,
                            c_mid, stream);
}

// The bytes of camli_update_2d's scratch: per pixel [max(c_c1, c_mid) | c_c2
// | c_f2] (bf16 with bf16 != 0, else f32), [c_m + 2 | c_h] f32, [c_h] (as
// the first three), [c_h] f32, each map rounded up to 16 bytes.
extern "C" size_t camli_update_2d_scratch(int bf16, int pixels, int c_c1, int c_c2, int c_f2,
                                          int c_m, int c_h, int c_mid) {
  const int e = bf16 ? 2 : 4;
  return map_bytes(pixels, c_c1 > c_mid ? c_c1 : c_mid, e) + map_bytes(pixels, c_c2, e) +
         map_bytes(pixels, c_f2, e) + map_bytes(pixels, c_m + 2, 4) + map_bytes(pixels, c_h, 4) +
         map_bytes(pixels, c_h, e) + map_bytes(pixels, c_h, 4);
}

// convs: (hi, lo, bias) of conv_c1, conv_c2, conv_f2, the merge conv, zr1,
// q1, zr2, q2, head1, head2; scratch: camli_update_2d_scratch bytes
extern "C" int camli_update_2d(const float* h, const float* x2d, const float* flow,
                               const float* ff1, const float* corr, const void* const* convs,
                               void* scratch, float* h_out, float* delta, int bf16, int batch,
                               int height, int width, int c_corr, int c_c1, int c_c2, int c_f1,
                               int c_f2, int c_m, int c_h, int c_x, int c_mid,
                               cudaStream_t stream) {
  // the first map holds cf1, then the flow head's mid
  const size_t p = (size_t)batch * height * width;
  const int e = bf16 ? 2 : 4;
  char* wide = static_cast<char*>(scratch);
  char* cf = wide + map_bytes(p, c_c1 > c_mid ? c_c1 : c_mid, e);
  char* ff = cf + map_bytes(p, c_c2, e);
  float* motion = reinterpret_cast<float*>(ff + map_bytes(p, c_f2, e));
  float* z = reinterpret_cast<float*>(reinterpret_cast<char*>(motion) + map_bytes(p, c_m + 2, 4));
  char* rh = reinterpret_cast<char*>(z) + map_bytes(p, c_h, 4);
  float* h1 = reinterpret_cast<float*>(rh + map_bytes(p, c_h, e));
  CAMLI_TRY(camli_motion_encoder_2d(flow, ff1, corr, convs, wide, cf, ff, motion, bf16, batch,
                                    height, width, c_corr, c_c1, c_c2, c_f1, c_f2, c_m, stream));
  return camli_gru_flowhead_2d(h, x2d, motion, convs + 12, z, rh, h1, wide, h_out, delta, bf16,
                               batch, height, width, c_h, c_x, c_m + 2, c_mid, stream);
}
