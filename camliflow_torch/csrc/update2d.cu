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
// bf16 != 0 the fast path's (fast_inference=on): the tile's bf16 mode
// (conv_tile_tc.cuh), one m16n8k16 bf16 pass a chunk with f32 accumulation,
// on weights rounded to bf16 once per request, with the TPU kernels'
// rounding points (camliflow_tpu/ops/pallas_update2d.py): every conv's
// input rounded to bf16, r*h and the flow head's mid taken from bf16, and
// the GRU's new hidden state nan_to_num-ed and rounded to bf16 after each
// direction, h' written as the f32 of that bf16 value.
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
#include "conv_tile_tc.cuh"

namespace {

// One convolution as its own launch. The weight planes are [N_pad][K_pad]
// with N_pad = round_up(cout, 64) and K_pad = round_up(kh*kw*cin, 16), zero
// past (cout, kh*kw*cin). A conv of at most 8 output channels and no
// epilogue (the flow head's last) takes the narrow split-reduction variant;
// one of 256 channels or more the 64 x 128 tile. BF: the tile's bf16 mode.
template <bool BF>
int run_conv_mode(const Conv& a, const float* hi, const float* lo, int epi, int k_pad,
                  cudaStream_t stream) {
  if (a.cout <= 8 && epi == EPI_NONE) {
    return launch_tc<32, 8, 1, 1, 4, EPI_NONE, BF>(a, hi, lo, k_pad, 1, stream);
  }
  if (a.cout >= 256 && a.n_pad % 128 == 0) {
    const int n_tiles = a.n_pad / 128;
    switch (epi) {
      case EPI_RELU:
        return launch_tc<64, 128, 2, 2, 1, EPI_RELU, BF>(a, hi, lo, k_pad, n_tiles, stream);
      case EPI_ZR:
        return launch_tc<64, 128, 2, 2, 1, EPI_ZR, BF>(a, hi, lo, k_pad, n_tiles, stream);
      default:
        break;  // the other epilogues take the 64 x 64 tile
    }
  }
  const int n_tiles = a.n_pad / 64;
  switch (epi) {
    case EPI_RELU:
      return launch_tc<64, 64, 2, 2, 1, EPI_RELU, BF>(a, hi, lo, k_pad, n_tiles, stream);
    case EPI_NONE:
      return launch_tc<64, 64, 2, 2, 1, EPI_NONE, BF>(a, hi, lo, k_pad, n_tiles, stream);
    case EPI_ZR:
      return launch_tc<64, 64, 2, 2, 1, EPI_ZR, BF>(a, hi, lo, k_pad, n_tiles, stream);
    default:
      return launch_tc<64, 64, 2, 2, 1, EPI_GATE, BF>(a, hi, lo, k_pad, n_tiles, stream);
  }
}

int run_conv_tc(Conv a, const float* hi, const float* lo, int epi, int kh, int kw, int cout,
                int bf16, cudaStream_t stream) {
  a = shaped(a, kh, kw, cout);
  const int k_pad = round_up(a.k_total, kTcBk);
  return bf16 ? run_conv_mode<true>(a, hi, lo, epi, k_pad, stream)
              : run_conv_mode<false>(a, hi, lo, epi, k_pad, stream);
}

}  // namespace

#define CAMLI_TRY(call)         \
  do {                          \
    const int err_ = (call);    \
    if (err_ != 0) return err_; \
  } while (0)

// convs: (hi, lo, bias) of conv_c1, conv_c2, conv_f2, the merge conv (bf16:
// hi the bf16-rounded weights, lo unread); cf1, cf, ff: [pixels, c_c1 |
// c_c2 | c_f2] scratch
extern "C" int camli_motion_encoder_2d(const float* flow, const float* ff1, const float* corr,
                                       const float* const* convs, float* cf1, float* cf,
                                       float* ff, float* out, int bf16, int batch, int height,
                                       int width,
                                       int c_corr, int c_c1, int c_c2, int c_f1, int c_f2,
                                       int c_m, cudaStream_t stream) {
  const int pixels = batch * height * width;
  Conv a = input(pixels, height, width, corr, c_corr);
  a.bias = convs[2], a.out = cf1;
  CAMLI_TRY(run_conv_tc(a, convs[0], convs[1], EPI_RELU, 1, 1, c_c1, bf16, stream));
  a = input(pixels, height, width, cf1, c_c1);
  a.bias = convs[5], a.out = cf;
  CAMLI_TRY(run_conv_tc(a, convs[3], convs[4], EPI_RELU, 3, 3, c_c2, bf16, stream));
  a = input(pixels, height, width, ff1, c_f1);
  a.bias = convs[8], a.out = ff;
  CAMLI_TRY(run_conv_tc(a, convs[6], convs[7], EPI_RELU, 3, 3, c_f2, bf16, stream));
  a = input(pixels, height, width, cf, c_c2, ff, c_f2);
  a.bias = convs[11], a.out = out, a.out_stride = c_m + 2;
  a.tail = flow, a.tail_c = 2, a.nan_fix = 1;
  return run_conv_tc(a, convs[9], convs[10], EPI_RELU, 3, 3, c_m, bf16, stream);
}

// convs: (hi, lo, bias) of zr1, q1, zr2, q2; z, rh: [pixels, c_h] scratch
extern "C" int camli_gru_2d(const float* h, const float* x2d, const float* motion,
                            const float* const* convs, float* z, float* rh, float* h1,
                            float* h_out, int bf16, int batch, int height, int width, int c_h,
                            int c_x, int c_m, cudaStream_t stream) {
  const int pixels = batch * height * width;
  const float* state = h;
  float* next[2] = {h1, h_out};
  for (int d = 0; d < 2; ++d) {
    const int kh = d == 0 ? 1 : 5;
    const int kw = d == 0 ? 5 : 1;
    const float* const* zr = convs + 6 * d;
    const float* const* q = zr + 3;
    Conv a = input(pixels, height, width, state, c_h, x2d, c_x, motion, c_m);
    a.bias = zr[2], a.out = z, a.out2 = rh, a.h = state;
    a.half = c_h;
    CAMLI_TRY(run_conv_tc(a, zr[0], zr[1], EPI_ZR, kh, kw, 2 * c_h, bf16, stream));
    a = input(pixels, height, width, rh, c_h, x2d, c_x, motion, c_m);
    a.bias = q[2], a.out = next[d], a.h = state, a.z = z;
    // nan_to_num once, after both directions (bf16: after each, where h'
    // is rounded to bf16)
    a.nan_fix = bf16 || d == 1;
    CAMLI_TRY(run_conv_tc(a, q[0], q[1], EPI_GATE, kh, kw, c_h, bf16, stream));
    state = next[d];
  }
  return 0;
}

// convs: (hi, lo, bias) of head1, head2; mid: [pixels, c_mid] scratch
extern "C" int camli_flow_head_2d(const float* h, const float* const* convs, float* mid,
                                  float* delta, int bf16, int batch, int height, int width,
                                  int c_h, int c_mid, cudaStream_t stream) {
  const int pixels = batch * height * width;
  Conv a = input(pixels, height, width, h, c_h);
  a.bias = convs[2], a.out = mid;
  CAMLI_TRY(run_conv_tc(a, convs[0], convs[1], EPI_RELU, 3, 3, c_mid, bf16, stream));
  a = input(pixels, height, width, mid, c_mid);
  a.bias = convs[5], a.out = delta, a.nan_fix = 1;
  return run_conv_tc(a, convs[3], convs[4], EPI_NONE, 3, 3, 2, bf16, stream);
}

// convs: (hi, lo, bias) of zr1, q1, zr2, q2, head1, head2
extern "C" int camli_gru_flowhead_2d(const float* h, const float* x2d, const float* motion,
                                     const float* const* convs, float* z, float* rh, float* h1,
                                     float* mid, float* h_out, float* delta, int bf16,
                                     int batch, int height, int width, int c_h, int c_x,
                                     int c_m, int c_mid, cudaStream_t stream) {
  CAMLI_TRY(camli_gru_2d(h, x2d, motion, convs, z, rh, h1, h_out, bf16, batch, height, width,
                         c_h, c_x, c_m, stream));
  return camli_flow_head_2d(h_out, convs + 12, mid, delta, bf16, batch, height, width, c_h,
                            c_mid, stream);
}

// convs: (hi, lo, bias) of conv_c1, conv_c2, conv_f2, the merge conv, zr1,
// q1, zr2, q2, head1, head2
extern "C" int camli_update_2d(const float* h, const float* x2d, const float* flow,
                               const float* ff1, const float* corr, const float* const* convs,
                               float* scratch, float* h_out, float* delta, int bf16, int batch,
                               int height, int width, int c_corr, int c_c1, int c_c2, int c_f1,
                               int c_f2, int c_m, int c_h, int c_x, int c_mid,
                               cudaStream_t stream) {
  // scratch, channels per pixel: [max(c_c1, c_mid) | c_c2 | c_f2 | c_m + 2 |
  // 3 x c_h]; the first region holds cf1, then the flow head's mid
  const size_t p = (size_t)batch * height * width;
  float* wide = scratch;
  float* cf = wide + p * (c_c1 > c_mid ? c_c1 : c_mid);
  float* ff = cf + p * c_c2;
  float* motion = ff + p * c_f2;
  float* z = motion + p * (c_m + 2);
  float* rh = z + p * c_h;
  float* h1 = rh + p * c_h;
  CAMLI_TRY(camli_motion_encoder_2d(flow, ff1, corr, convs, wide, cf, ff, motion, bf16, batch,
                                    height, width, c_corr, c_c1, c_c2, c_f1, c_f2, c_m, stream));
  return camli_gru_flowhead_2d(h, x2d, motion, convs + 12, z, rh, h1, wide, h_out, delta, bf16,
                               batch, height, width, c_h, c_x, c_m + 2, c_mid, stream);
}
