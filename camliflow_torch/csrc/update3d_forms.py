"""Measure where the 3D chain's bf16 tails spend their time on the card
(update3d.cu's bf16 form, #6·bf16 and #7·bf16).

    python -m camliflow_torch.csrc.update3d_forms

Builds `update3d.cu` as shipped and with forms made from its text, each into
its own library under build/camliflow_torch/forms3d/:
  shipped       as built by build.py
  no_table      the tails on bf16 tables load no table row (zero words)
  no_weights    the tails on bf16 tables load no hoisted weights (zero words)
  no_loads      neither
  no_products   the words' products are an xor, not mul.rn.bf16x2
  rows16        kGfRows 16: twice the bytes of neighbour rows a lane keeps
                in flight
  wide          every launch in shape SH_WIDE (16-byte loads), the shape
                shipped takes past one wave of blocks
  lanes         every launch in shape SH_LANES (8-byte loads on the 64- and
                128-channel tails, twice the lanes a point), the shape
                shipped takes within one wave
  occupancy8    the bf16 tails under __launch_bounds__(128, 8)
Only `shipped` computes the chain; the forms that drop loads or products
time a part of it. Runs #6 and #7 on bf16 hoisted weights at the loop's
2048 points (bs 1) and at 16,384 (bs 8), and prints each launch's device
time (torch.profiler, the mean over 10 calls), the forms in turns, and the
f32 form's beside them. Needs a CUDA card; prints the card's name and power
limit.
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
FORMS = {
    "shipped": [],
    "no_table": [(TABLE_LOAD, "")],
    "no_weights": [(WEIGHT_LOAD, "")],
    "no_products": [("const uint32_t prod = mul_bf16x2(tw[jj][e], ww[jj][e]);",
                     "const uint32_t prod = tw[jj][e] ^ ww[jj][e];")],
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
}
FORMS["no_loads"] = FORMS["no_table"] + FORMS["no_weights"]


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
    """Each kernel launch of fn() in order, its mean device time (ms) over
    reps calls, from torch.profiler's kernel events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "3d_" in e.name), key=lambda e: e.time_range.start)
    per = len(kernels) // reps
    return [sum(e.time_range.elapsed_us() for e in kernels[i::per]) / reps / 1e3
            for i in range(per)]


def main() -> int:
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
    steps = {"motion_encoder_3d": "dense c1|f1, tail f1, tails c1|f2, dense merge, tail merge",
             "gru_flowhead_3d": "dense zr|q_xm, tail zr, dense q_h, tail q, tail conv1, "
                                "tail conv2"}
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
            calls = {}
            for dtype in (torch.float32, torch.bfloat16):
                d_me, d_gf = (update3d.to_bf16(d) if dtype == torch.bfloat16 else d
                              for d in (dw_me, dw_gf))
                calls[("motion_encoder_3d", dtype)] = (
                    lambda d=d_me: update3d.motion_encoder_3d(flow, corr, idx, d, me))
                calls[("gru_flowhead_3d", dtype)] = (
                    lambda d=d_gf: update3d.gru_flowhead_3d(h, x3d, motion, idx, d, gf))
            names = list(FORMS)
            for fn in steps:
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    with using(built[name][0]):
                        times[name].append(launch_ms(calls[(fn, torch.bfloat16)]))
                with using(built["shipped"][0]):
                    exact = launch_ms(calls[(fn, torch.float32)])
                print(f"{fn} bs {batch} ({steps[fn]}): each launch's device time, ms", flush=True)
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
