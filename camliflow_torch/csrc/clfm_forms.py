"""Measure where #11's bf16 form (csrc/clfm.cu's chain, CAMLIFLOW_CLFM=1)
spends its time on the card.

    python -m camliflow_torch.csrc.clfm_forms

Builds `clfm.cu` as shipped and with forms made from its text, each into its
own library under build/camliflow_torch/formsclfm/:
  shipped       as built by build.py
  no_products   the consumer issues no wgmma
  no_weights    no TMA of the weight tiles (the ring's tiles are stale)
  no_gather     the gatherers load nothing (zero A operands)
  no_stores     the chain stores no a or b (the blend reads stale ones)
  only2d        the chain's 2D blocks alone
  only3d        the chain's 3D blocks alone
  stages4       a ring of 4 weight tiles, not 6
  fill4, fill8  a gathering thread loads 4 (8) quads before it stores any, not 6
  one_consumer  one warpgroup multiplies (weight tiles of 64 outputs), two only
                gather
Only `shipped` computes the whole fusion; the others time a part of it or
another shape of it. Runs the flagship's corr (C2 324, C3 128) and motion
(128, 128) calls at the 1/8 map (68 x 120) against 2048 points, bs 1 and 8,
and prints each launch's device time (torch.profiler, the mean over 10
calls), the forms in turns. Needs a CUDA card; prints the card's name and
power limit. About 2 minutes of command with its 10 builds.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from . import build
from .bf16_tile_forms import using

SOURCE = "clfm.cu"
FORMS = {
    "shipped": [],
    "no_products": [("    for (int ks = 0; ks < 4; ++ks) Wgmma<64>::mma(acc, da + 2 * ks, "
                     "db + 2 * ks);", "")],
    "no_weights": [("    mbar_arrive_tx(&full[slot], kTileBytes);\n"
                    "    tma_load_2d(ring + slot * kTileBytes, maps + map, &full[slot], x, y);",
                    "    mbar_arrive(&full[slot]);")],
    "no_gather": [("      if (i < kChainRows * quads && r < valid && c < width) v[u] = quad(r, c);",
                   "")],
    "no_stores": [("        *reinterpret_cast<float2*>(s.a + at) = make_float2(va0, va1);\n"
                   "        *reinterpret_cast<float2*>(s.b + at) = make_float2(vb0, vb1);", "")],
    "only2d": [("  const int blocks = g.blocks2 + batch * g.side[1].tiles;",
                "  const int blocks = g.blocks2;")],
    "only3d": [("  g.blocks2 = batch * two.tiles;", "  g.blocks2 = 0;")],
    "stages4": [("constexpr int kChainStages = 6;", "constexpr int kChainStages = 4;")],
    "fill4": [("constexpr int kFillBatch = 6;", "constexpr int kFillBatch = 4;")],
    "fill8": [("constexpr int kFillBatch = 6;", "constexpr int kFillBatch = 8;")],
    "one_consumer": [("constexpr int kChainConsumers = 2;", "constexpr int kChainConsumers = 1;"),
                     ("constexpr int kChainGather = 128;", "constexpr int kChainGather = 256;")],
}


def build_form(name: str, patches):
    """clfm.cu with the form's patches and knn.cu (for camli_error_string),
    as one library; its ptxas lines that report spills, by kernel."""
    out = build.BUILD_DIR / "formsclfm" / name
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
    spills, function = [], ""
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        if "Function properties for " in line:
            function = line.split("Function properties for ")[1].strip()
        elif "spill" in line and " 0 bytes spill stores" not in line:
            spills.append(f"{function[-48:]}: {line.strip()}")
    handle = ctypes.CDLL(str(lib))
    for fn, argtypes in build.SIGNATURES.items():
        if hasattr(handle, fn):
            getattr(handle, fn).argtypes = argtypes
            getattr(handle, fn).restype = ctypes.c_int
    handle.camli_error_string.argtypes = [ctypes.c_int]
    handle.camli_error_string.restype = ctypes.c_char_p
    return handle, spills


def launch_ms(fn, reps: int = 10) -> list[tuple[str, float]]:
    """Each kernel launch of fn() in order, its mean device time (ms) over
    reps calls, from torch.profiler's kernel events."""
    import re

    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
    per = len(kernels) // reps
    return [(re.sub(r".*::(\w+(?:<[^<>]*>)?)\(.*", r"\1", kernels[i].name),
             sum(e.time_range.elapsed_us() for e in kernels[i::per]) / reps / 1e3)
            for i in range(per)]


def main() -> int:
    if not torch.cuda.is_available():
        print("clfm_forms: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from ..nn.clfm import CLFM, fusion_interp_cache
    from ..ops import clfm
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
    height, width, n = 68, 120, 2048
    with torch.inference_mode():
        for c2, c3 in ((324, 128), (128, 128)):
            block = CLFM(c2, c3).eval()
            random_weights(block, 10)
            block = block.to(device)
            params = clfm.prepare_clfm_params(block, bf16=True)
            for batch in (1, 8):
                gen = torch.Generator(device=device).manual_seed(1)
                span = torch.tensor([width, height], device=device, dtype=torch.float32)
                uv = torch.rand(batch, n, 2, generator=gen, device=device) * span
                cache = fusion_interp_cache(uv, height, width)
                inputs = (torch.randn(batch, height, width, c2, generator=gen, device=device),
                          torch.randn(batch, n, c3, generator=gen, device=device),
                          clfm.hoist_interp_score(block.interp, cache[1], True), cache[0],
                          *clfm.grid_sample_cache(uv, height, width))
                call = lambda: clfm.clfm_fused(*inputs, params)  # noqa: E731
                names = list(FORMS)
                times = {name: [] for name in names}
                for name in names + names[::-1]:
                    with using(built[name][0]):
                        times[name].append(launch_ms(call))
                print(f"C2 {c2}, C3 {c3}, bs {batch}: each launch's device time, ms (two "
                      "readings, in turns)", flush=True)
                for name in names:
                    first, second = times[name]
                    print(f"  {name:12s} {sum(ms for _, ms in first):.4f}, "
                          f"{sum(ms for _, ms in second):.4f}: " +
                          ", ".join(f"{k} {a:.4f}/{b:.4f}"
                                    for (k, a), (_, b) in zip(first, second)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
