"""Measure kernel #12's forms on the card (gather.cu's design choices).

    python -m camliflow_torch.csrc.gather_forms

Builds `gather.cu` as shipped and two variants made from its text, each
into its own library under build/camliflow_torch/forms/:
  shipped     the slab leaves by one bulk copy; 8 blocks an SM (6 for
              16-byte words)
  registers   the slab's body leaves by 16-byte stores from registers
  bounds      __launch_bounds__ without a minimum of blocks (the compiler
              picks the registers)
and times each, by profiler device time in turns (forward, then backward),
on the main path's gathers: the encoder's level 0 ([2, 8192, 99] x
[2, 4096, 16]) and level 1 ([2, 4096, 131] x [2, 2048, 16]) at several T,
and the 12-byte rows (xyz at both levels and the upsample's
[1, 2048, 3] x [1, 8192, 3]) staged at several T against the word-a-thread
kernel that gather_plan picks for them. Every run is held bit for bit to
the plain version. The indices are KNN neighbours of random clouds, as the
encoders' are. Needs a CUDA card; prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from . import build

FORMS = {
    "shipped": [],
    "registers": [(
        """      if (threadIdx.x == 0 && tail > head) {
        bulk_store(slab + head, staged + head, (unsigned)(tail - head));
      }""",
        """      for (size_t i = threadIdx.x; i < (tail - head) / 16; i += kThreads) {
        reinterpret_cast<uint4*>(slab + head)[i] = reinterpret_cast<const uint4*>(staged + head)[i];
      }""")],
    "bounds": [("__launch_bounds__(kThreads, W == 16 ? 6 : 8)", "__launch_bounds__(kThreads)")],
}


def build_form(name: str, patches) -> ctypes.CDLL:
    source = (build.CSRC / "gather.cu").read_text()
    for old, new in patches:
        if old not in source:
            raise RuntimeError(f"form {name}: gather.cu no longer holds {old[:40]!r}")
        source = source.replace(old, new)
    out = build.BUILD_DIR / "forms"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{name}.cu").write_text(source)
    lib = out / f"{name}.so"
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                           str(out / f"{name}.cu")], capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for form {name}:\n{proc.stdout}{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    handle.camli_gather_kmajor.argtypes = build.SIGNATURES["camli_gather_kmajor"]
    handle.camli_gather_kmajor.restype = ctypes.c_int
    return handle


def device_ms(fn, reps: int = 30) -> float:
    """fn()'s device time per call: its gather kernels' self device time
    from torch.profiler, after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and "gather_kmajor" in e.key) / 1e3 / reps


def main_path_cases(device):
    """(label, data, idx, plans) for the main path's gathers."""
    from ..ops.knn import k_nearest_neighbor

    gen = torch.Generator(device=device).manual_seed(0)
    both = torch.randn(2, 8192, 3, generator=gen, device=device)
    both[..., 2] = both[..., 2].abs() * 15 + 5
    lv0, lv1 = both[:, :4096].contiguous(), both[:, :2048].contiguous()
    idx0 = k_nearest_neighbor(both, lv0, 16)
    idx1 = k_nearest_neighbor(lv0, lv1, 16)
    up = k_nearest_neighbor(lv1[:1], both[:1], 3)
    feats = [torch.randn(2, 8192, 99, generator=gen, device=device),
             torch.randn(2, 4096, 131, generator=gen, device=device)]
    narrow = [(0, 0), (128, 12), (256, 12), (512, 12)]
    return [
        ("level 0 [2,8192,99] x [2,4096,16]", feats[0], idx0,
         [(48, 396), (32, 396), (64, 396), (16, 396)]),
        ("level 1 [2,4096,131] x [2,2048,16]", feats[1], idx1,
         [(32, 524), (16, 524), (48, 524)]),
        ("level 0 xyz [2,8192,3] x [2,4096,16]", both, idx0, narrow),
        ("level 1 xyz [2,4096,3] x [2,2048,16]", lv0, idx1, narrow),
        ("upsample [1,2048,3] x [1,8192,3]", lv1[:1].contiguous(), up, narrow),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("gather_forms: no CUDA device; this runs only on a GPU", file=sys.stderr)
        return 1
    from ..ops.gather import gather_points_kmajor_plain

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(smi, flush=True)
    libs = {name: build_form(name, patches) for name, patches in FORMS.items()}
    device = torch.device("cuda", 0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, data, idx, plans in main_path_cases(device):
        ref = gather_points_kmajor_plain(data, idx)
        batch, n, channels = data.shape
        m, k = idx.shape[1:]
        calls = {}
        for plan in plans:
            for name, lib in libs.items():
                if plan[0] == 0 and name != "shipped":
                    continue  # the word-a-thread kernel is the same in every form
                out = torch.empty_like(ref.contiguous())

                def call(lib=lib, out=out, plan=plan):
                    code = lib.camli_gather_kmajor(data.data_ptr(), idx.data_ptr(),
                                                   out.data_ptr(), batch, n, m, k, 4 * channels,
                                                   *plan, stream)
                    if code:
                        raise RuntimeError(f"{label} {plan}: CUDA error {code}")

                call()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{label}, {name}, plan {plan}: not bit for bit")
                calls[(name, plan)] = call
        times = {key: [] for key in calls}
        for key in list(calls) + list(calls)[::-1]:
            times[key].append(device_ms(calls[key]))
        print(label, flush=True)
        for (name, plan), (first, second) in times.items():
            form = "words" if plan[0] == 0 else f"{name}, T = {plan[0]}"
            print(f"  {form}: {first:.4f}, {second:.4f} ms device", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
