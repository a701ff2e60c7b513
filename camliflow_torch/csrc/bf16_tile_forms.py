"""Measure where the 2D chain's bf16 tile spends its time on the card
(conv_tile_bf16.cuh's design choices).

    python -m camliflow_torch.csrc.bf16_tile_forms

Builds `update2d.cu` with the tile as shipped and with forms made from its
text, each into its own library under build/camliflow_torch/forms/:
  shipped       as built by build.py
  no_a_loads    the gather's cp.async copy nothing (zero-filled pieces)
  no_b          no TMA of the weights (the stages' B is stale)
  no_loads      neither
  no_cp_async   no cp.async instructions at all (the staging is stale)
  no_products   the consumer issues no wgmma
  no_producer   the producers do nothing; the consumer waits for no stage
  no_epilogue   the sums are never stored
  one_stage     every conv runs its first 64-deep stage only
  one_producer  one producer warpgroup (kB16Producers = 1)
Only `shipped` computes the convolution; the others time a part of it. Runs
#10·bf16 (`update_2d` on a bf16 packing) at the flagship's 1/8 map, 68x120,
bs 1 and 8, and prints each conv's device time (torch.profiler, the mean
over 10 calls) and their sum, the forms in turns. Needs a CUDA card; prints
the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build

TILE = "conv_tile_bf16.cuh"
FORMS = {
    "shipped": [],
    "no_a_loads": [("cp_async8(cell, at, ok ? 8 : 0);", "cp_async8(cell, src, 0);"),
                   ("cp_async16_ca(cell, at, ok ? 16 : 0);", "cp_async16_ca(cell, src, 0);")],
    "no_b": [("""      mbar_arrive_tx(&full[slot], S::kBBytes);
      tma_load_2d(stage + kB16ATileBytes, weights, &full[slot], c * kB16Depth, 0);""",
              "      mbar_arrive(&full[slot]);")],
    "no_cp_async": [("        cp_async8(cell, at, ok ? 8 : 0);", ""),
                    ("        cp_async16_ca(cell, at, ok ? 16 : 0);", "")],
    "no_products": [("      Wgmma<BN>::mma(acc, da + 2 * ks, db + 2 * ks);", "")],
    "no_producer": [("    produce<BN, NP>(a, &weights, smem, full, empty, p0, n_chunks, tid - 128);",
                     ""),
                    ("    mbar_wait(&full[slot], (c / S::kStages) & 1);", "")],
    "no_epilogue": [("  finish<BN, NP, EPI>(a, reinterpret_cast<const float*>(smem), p0, tid);", "")],
    "one_stage": [("  kernel<<<blocks, S::kThreads, S::kSmemBytes, stream>>>(map, a, n_chunks);",
                   "  kernel<<<blocks, S::kThreads, S::kSmemBytes, stream>>>(map, a, 1);")],
    "one_producer": [("constexpr int kB16Producers = 2;", "constexpr int kB16Producers = 1;")],
}
FORMS["no_loads"] = FORMS["no_a_loads"] + FORMS["no_b"]


def build_form(name: str, patches) -> ctypes.CDLL:
    """update2d.cu and knn.cu (for camli_error_string) with the form's tile,
    as one library."""
    out = build.BUILD_DIR / "forms" / name
    out.mkdir(parents=True, exist_ok=True)
    tile = (build.CSRC / TILE).read_text()
    for old, new in patches:
        if old not in tile:
            raise RuntimeError(f"form {name}: {TILE} no longer holds {old[:50]!r}")
        tile = tile.replace(old, new)
    (out / TILE).write_text(tile)
    # a copy of update2d.cu beside the form's tile, whose quoted include it
    # takes first; conv_tile_tc.cuh comes from the sources
    (out / "update2d.cu").write_text((build.CSRC / "update2d.cu").read_text())
    lib = out / "lib.so"
    proc = subprocess.run(
        [build._nvcc(), *build.NVCC_FLAGS, "-shared", f"-I{build.CSRC}", "-o", str(lib),
         str(out / "update2d.cu"), str(build.CSRC / "knn.cu")],
        capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for form {name}:\n{proc.stdout}{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in build.SIGNATURES.items():
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
    for fn, argtypes in build.SIZES.items():
        getattr(handle, fn).argtypes = argtypes
        getattr(handle, fn).restype = ctypes.c_size_t
    handle.camli_error_string.argtypes = [ctypes.c_int]
    handle.camli_error_string.restype = ctypes.c_char_p
    return handle


@contextlib.contextmanager
def using(handle: ctypes.CDLL):
    """The wrappers launch through `handle` (they look `launch` and
    `library` up in build at each call)."""
    saved = build.library, build.launch

    def launch(name, *args):
        code = getattr(handle, name)(*args, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"{name}: CUDA error {code}: {handle.camli_error_string(code)}")

    build.library, build.launch = (lambda: handle), launch
    try:
        yield
    finally:
        build.library, build.launch = saved


def conv_ms(fn, reps: int = 10) -> list[tuple[str, float]]:
    """Each conv_bf16_kernel launch of fn() in order with its mean device
    time (ms) over reps calls, from torch.profiler's kernel events."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and "conv_bf16_kernel" in e.name), key=lambda e: e.time_range.start)
    per = len(kernels) // reps
    return [(re.sub(r".*conv_bf16_kernel(<[^>]*>).*", r"\1", kernels[i].name),
             sum(e.time_range.elapsed_us() for e in kernels[i::per]) / reps / 1e3)
            for i in range(per)]


def main() -> int:
    if not torch.cuda.is_available():
        print("bf16_tile_forms: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from torch import nn

    from ..models.raft import FlowHead2D, GRU2D, MotionEncoder2D
    from ..ops import update2d
    from ..runtime.checkpoint import random_weights

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(smi, flush=True)
    with ThreadPoolExecutor(len(FORMS)) as pool:  # one nvcc a form, all at once
        libs = dict(zip(FORMS, pool.map(lambda item: build_form(*item), FORMS.items())))
    device = torch.device("cuda", 0)
    blocks = nn.ModuleList([MotionEncoder2D(), GRU2D(), FlowHead2D()])
    random_weights(blocks, 7)
    encoder, gru, head = blocks.to(device)
    with torch.inference_mode():
        me, gf = update2d.prepare_update_2d_params(encoder, gru, head, bf16=True)
        for batch in (1, 8):
            gen = torch.Generator(device=device).manual_seed(1)

            def rand(channels, scale=1.0):
                return scale * torch.randn(batch, 68, 120, channels, generator=gen,
                                           device=device)

            flow, corr = rand(2, 2.0), rand(324)
            h, x2d = torch.tanh(rand(128)), torch.relu(rand(128))
            names = list(FORMS)
            times = {name: [] for name in names}
            for name in names + names[::-1]:
                with using(libs[name]):
                    times[name].append(conv_ms(
                        lambda: update2d.update_2d(h, x2d, flow, corr, me, gf)))
            print(f"bs {batch}: each conv's device time, ms (two readings, in turns)",
                  flush=True)
            for name in names:
                first, second = times[name]
                print(f"  {name:13s} {sum(ms for _, ms in first):.4f}, "
                      f"{sum(ms for _, ms in second):.4f}: " +
                      ", ".join(f"{k} {a:.4f}" for (k, a), (_, b) in zip(first, second)),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
