"""Measure where the 3D chain's word tails spend their time on the card
(update3d.cu's forms on bf16 tables, #6 and #7 on bf16 and int8 weights,
and #13's bf16 form on packed words).

    python -m camliflow_torch.csrc.update3d_forms [--calls dw_max ...]

Builds `update3d.cu` as shipped and with forms made from its text, each into
its own library under build/camliflow_torch/forms3d/:
  shipped       as built by build.py
  no_table      the word tails load no table row (zero words)
  no_weights    the word tails load no hoisted weights (zero words)
  no_loads      neither
  no_products   no products: the words' an xor, not mul.rn.bf16x2 (int8
                weights still widened)
  int8_f32      the int8 form's products in f32 (each bf16 table value times
                its int8 weight, exact), the max rounded to bf16 once: the
                same bits as the shipped bf16 words
  rows16        kGfRows 16: twice the bytes of neighbour rows a lane keeps
                in flight
  wide          every launch in a wide shape (SH_WIDE, SH_I8_WIDE), the
                shape shipped takes past one wave of blocks
  lanes         every launch in a narrow shape (SH_LANES, SH_I8_LANES), the
                shape shipped takes within one wave
  occupancy8    the bf16 tails under __launch_bounds__(128, 8)
  dw_f32_table  #13's bf16 form on its f32-table shapes (a warp a point,
                4- or 16-byte table loads, the weights widened to f32 and
                repacked), not on packed words
  word_no_split #13's word form with no split of the neighbours: C / 8
                lanes a point take all k (shipped: the whole warp a point
                where k > kWordRows)
  word_split    #13's word form with every point's neighbours split over
                the warp, whatever k
  word_rows8    #13's word form with 8 rows in flight a lane, not 4
  word_ldcg     #13's word form reading the table from L2 alone (ld.global.cg),
                not through L1
Only `shipped` computes the chain; the forms that drop loads or products
time a part of it, and every other form is held bit for bit to `shipped`
(SAME_BITS) before it is timed. Runs #6 and #7 on bf16 and on int8 hoisted weights
(`prepare_int8`) and #13 on bf16 weights at the fuse_hidden path's four
shapes, at the loop's 2048 points (bs 1) and at 16,384 (bs 8), and prints
each launch's device time (torch.profiler, the mean over 10 calls), the
forms in turns, and the f32 form's beside them (`--calls`: only the
wrappers named, of motion_encoder_3d, gru_flowhead_3d and dw_max). Needs a
CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build
from .bf16_tile_forms import using

SOURCE = "update3d.cu"
TABLE_LOAD = """                  t = load_words<W, LD_CG>(static_cast<const unsigned short*>(g.table) + tb +
                                           (size_t)row * g.ld + c);"""
WEIGHT_LOAD = """                  w = load_dw_words<W, DW>(g.dw, wp + (size_t)j * g.dw_ld + c);"""
PRODUCTS_HEAD = """  uint32_t w2[E / 2];
  if constexpr (DW == DW_INT8) {"""
F32_PRODUCTS = """  if constexpr (DW == DW_INT8) {  // f32 products, the max rounded once by the tail
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const uint32_t biased = ww[i] ^ 0x80808080u;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t t = tw[2 * i + e / 2];
        x[4 * i + e] = __fmul_rn(__uint_as_float(e % 2 ? t & 0xffff0000u : t << 16),
                                 int8_f32(biased, e));
      }
    }
    return;
  }
  uint32_t w2[E / 2];
  if constexpr (false) {"""
ROUND_MAX = """      if constexpr (DW == DW_INT8) {
#pragma unroll
        for (int e = 0; e < kE; ++e) m[e] = round_bf16(m[e]);
      }
      // the post op of the chunk"""
WORD_TABLE_LOAD = "const float4 t0 = __ldg(t), t1 = __ldg(t + 1);"
WORD_WEIGHT_LOAD = (
    "const uint4 w = __ldcs(reinterpret_cast<const uint4*>(dw + (size_t)j * g.dw_ld + c));")
FORMS = {
    "shipped": [],
    "no_table": [(TABLE_LOAD, ""), (WORD_TABLE_LOAD, "const float4 t0 = {}, t1 = {};")],
    "no_weights": [(WEIGHT_LOAD, ""), (WORD_WEIGHT_LOAD, "const uint4 w = {};")],
    "no_products": [("const uint32_t prod = mul_bf16x2(tw[e], w2[e]);",
                     "const uint32_t prod = tw[e] ^ w2[e];")],
    "int8_f32": [(PRODUCTS_HEAD, F32_PRODUCTS), ("      // the post op of the chunk", ROUND_MAX)],
    "rows16": [("constexpr int kGfRows = 8;", "constexpr int kGfRows = 16;")],
    "wide": [("  return sms * per_sm;", "  return 0;")],
    "lanes": [("  return sms * per_sm;", "  return 1 << 30;")],
    "occupancy8": [("__global__ void __launch_bounds__(kGfThreads, 4)\n"
                    "    gru_flowhead_3d_tail(",
                    "__global__ void __launch_bounds__(kGfThreads, kTb8)\n"
                    "    gru_flowhead_3d_tail("),
                   ("__global__ void __launch_bounds__(kGfThreads, 4)\n"
                    "    motion_encoder_3d_tail(",
                    "__global__ void __launch_bounds__(kGfThreads, kTb8)\n"
                    "    motion_encoder_3d_tail("),
                   ("enum GfPost {", "#define kTb8 (DW == DW_BF16 ? 8 : 4)\nenum GfPost {")],
    "dw_f32_table": [("  if (bf && c % 8 == 0 && aligned(table)",
                      "  if (false && bf && c % 8 == 0 && aligned(table)")],
    "word_no_split": [("  return g.k > kWordRows ? launch_dw_max_words<CL, 32 / CL>(g, stream)",
                       "  return false ? launch_dw_max_words<CL, 32 / CL>(g, stream)")],
    "word_split": [("  return g.k > kWordRows ? launch_dw_max_words<CL, 32 / CL>(g, stream)",
                    "  return true ? launch_dw_max_words<CL, 32 / CL>(g, stream)")],
    "word_rows8": [("constexpr int kWordRows = 4;", "constexpr int kWordRows = 8;")],
    "word_ldcg": [(WORD_TABLE_LOAD, "const float4 t0 = __ldcg(t), t1 = __ldcg(t + 1);")],
}
FORMS["no_loads"] = FORMS["no_table"] + FORMS["no_weights"]
# the forms that keep the arithmetic: held bit for bit to `shipped`
SAME_BITS = ("int8_f32", "rows16", "wide", "lanes", "occupancy8", "dw_f32_table",
             "word_no_split", "word_split", "word_rows8", "word_ldcg")


def build_form(name: str, patches):
    """update3d.cu with the form's patches and knn.cu (for
    camli_error_string), as one library."""
    import ctypes

    out = build.BUILD_DIR / "forms3d" / name
    out.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / SOURCE).read_text()
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"form {name}: {SOURCE} no longer holds {old[:50]!r}")
        text = text.replace(old, new)
    (out / SOURCE).write_text(text)
    lib = out / "lib.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", f"-I{build.CSRC}", "-o", str(lib),
         str(out / SOURCE), str(build.CSRC / "knn.cu")],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for form {name}:\n{proc.stdout}{proc.stderr}")
    spills = [line.strip() for line in proc.stdout.splitlines() + proc.stderr.splitlines()
              if "spill" in line and " 0 bytes spill stores" not in line]
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in build.SIGNATURES.items():
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
    handle.camli_error_string.argtypes = [ctypes.c_int]
    handle.camli_error_string.restype = ctypes.c_char_p
    return handle, spills


def launch_ms(fn, reps: int = 10) -> list[float]:
    """Each kernel launch of fn() in order (update3d.cu's: #6's, #7's and
    dw_max's), its mean device time (ms) over reps calls, from
    torch.profiler's kernel events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and ("3d_" in e.name or "dw_max" in e.name)),
                     key=lambda e: e.time_range.start)
    per = len(kernels) // reps
    return [sum(e.time_range.elapsed_us() for e in kernels[i::per]) / reps / 1e3
            for i in range(per)]


STEPS = {"motion_encoder_3d": "dense c1|f1, tail f1, tails c1|f2, dense merge, tail merge",
         "gru_flowhead_3d": "dense zr|q_xm, tail zr, dense q_h, tail q, tail conv1, tail conv2",
         "dw_max": "z|r k=4 C=256, q k=4 C=128, conv1 k=32 C=128, conv2 k=32 C=64"}


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", nargs="+", choices=list(STEPS), default=list(STEPS),
                        help="the wrappers to time (default: all three)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("update3d_forms: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from torch import nn

    from ..models.camliraft_l import FlowHead3D, GRU3D, MotionEncoder3D
    from ..ops import knn, update3d
    from ..runtime.checkpoint import random_weights

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(FORMS)) as pool:  # one nvcc a form, all at once
        built = dict(zip(FORMS, pool.map(lambda item: build_form(*item), FORMS.items())))
    for name, (_, spills) in built.items():
        if spills:
            print(f"  {name}: ptxas {'; '.join(spills)}", flush=True)
    device = torch.device("cuda", 0)
    blocks = nn.ModuleList([MotionEncoder3D(), GRU3D(), FlowHead3D()])
    random_weights(blocks, 8)
    encoder, gru, head = blocks.to(device).requires_grad_(False)
    me = update3d.prepare_motion_encoder_3d_params(encoder)
    gf = update3d.prepare_gru_flowhead_3d_params(gru, head)
    with torch.inference_mode():
        for batch in (1, 8):
            gen = torch.Generator(device=device).manual_seed(1)
            xyz = torch.randn(batch, 2048, 3, generator=gen, device=device)
            idx = knn.k_nearest_neighbor(xyz, xyz, 32)
            dw_me = encoder.precompute_weights(xyz, idx)
            dw_gf = {**gru.precompute_weights(xyz, idx), **head.precompute_weights(xyz, idx)}

            def rand(channels, scale=1.0):
                return scale * torch.randn(batch, 2048, channels, generator=gen, device=device)

            flow, corr, h, x3d = rand(3, 0.05), rand(128), torch.tanh(rand(128)), rand(128)
            motion = update3d.motion_encoder_3d(flow, corr, idx, dw_me, me)
            d8, me8, gf8 = update3d.prepare_int8(update3d.to_bf16({
                "motion_encoder": dw_me, "gru": {k: dw_gf[k] for k in ("conv_zr", "conv_q")},
                "flow_head": {k: dw_gf[k] for k in ("conv1", "conv2")}}), encoder, gru, head)
            d8_gf = {**d8["gru"], **d8["flow_head"]}
            tables = {key: rand(channels) for key, channels in
                      (("conv_zr", 256), ("conv_q", 128), ("conv1", 128), ("conv2", 64))}
            calls = {}
            for form in ("f32", "bf16", "int8"):
                if form == "int8":
                    d_me, d_gf, p_me, p_gf = d8["motion_encoder"], d8_gf, me8, gf8
                else:
                    d_me, d_gf = (update3d.to_bf16(d) if form == "bf16" else d
                                  for d in (dw_me, dw_gf))
                    p_me, p_gf = me, gf
                calls[("motion_encoder_3d", form)] = (
                    lambda d=d_me, p=p_me: update3d.motion_encoder_3d(flow, corr, idx, d, p))
                calls[("gru_flowhead_3d", form)] = (
                    lambda d=d_gf, p=p_gf: update3d.gru_flowhead_3d(h, x3d, motion, idx, d, p))
                if form != "int8":
                    calls[("dw_max", form)] = (
                        lambda d=d_gf: [update3d.dw_max(t, idx, d[key])
                                        for key, t in tables.items()])
            names = list(FORMS)
            for fn, form in calls:
                if form == "f32" or fn not in args.calls:
                    continue
                outputs = {}
                for name in ("shipped",) + SAME_BITS:
                    with using(built[name][0]):
                        out = calls[(fn, form)]()
                    out = out if isinstance(out, (tuple, list)) else (out,)
                    outputs[name] = torch.cat([o.flatten() for o in out]).view(torch.int32)
                differ = [name for name in SAME_BITS
                          if not torch.equal(outputs[name], outputs["shipped"])]
                if differ:
                    raise AssertionError(f"{fn} ({form}) bs {batch}: forms {differ} are not "
                                         "the shipped form's bits")
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    with using(built[name][0]):
                        times[name].append(launch_ms(calls[(fn, form)]))
                with using(built["shipped"][0]):
                    exact = launch_ms(calls[(fn, "f32")])
                print(f"{fn} ({form}) bs {batch} ({STEPS[fn]}): each launch's device time, ms",
                      flush=True)
                print(f"  {'f32 form':13s} {sum(exact):.4f}: " +
                      ", ".join(f"{ms:.4f}" for ms in exact), flush=True)
                for name in names:
                    first, second = times[name]
                    print(f"  {name:13s} {sum(first):.4f}, {sum(second):.4f}: " +
                          ", ".join(f"{a:.4f}/{b:.4f}" for a, b in zip(first, second)),
                          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
