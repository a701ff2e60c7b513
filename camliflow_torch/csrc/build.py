"""Build and load the port's CUDA kernels.

The kernels (`*.cu` beside this file) have a plain C interface. At first use
each source is compiled by its own `nvcc` for Hopper (`sm_90a`), all of them
at once, and the objects are linked into one shared library under
`build/camliflow_torch/` at the repository root, loaded with `ctypes`. The
library's name carries a hash of the sources and flags, so an edited source
is rebuilt and an unchanged one is reused.

    python -m camliflow_torch.csrc.build     # build now, print ptxas info
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent
BUILD_DIR = CSRC.parents[1] / "build" / "camliflow_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    # no multiply-add contraction: distances must round exactly as the
    # plain PyTorch versions do (the conv kernels write theirs explicitly)
    "-fmad=false",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argtypes (every one returns a cudaError_t as int)
SIGNATURES = {
    "camli_knn": [_P, _P, _P] + [_I] * 7 + [_P],
    "camli_fps": [_P, _P, _I, _I, _I, _P],
    "camli_interp": [_P] * 4 + [_I] * 8 + [_P],
    "camli_corr3d": [_P] * 5 + [_I] * 6 + [_P, _I, _P, _I, _I, _P],
    "camli_motion_encoder_2d": [_P] * 8 + [_I] * 10 + [_P],
    "camli_gru_2d": [_P] * 8 + [_I] * 7 + [_P],
    "camli_flow_head_2d": [_P] * 4 + [_I] * 6 + [_P],
    "camli_gru_flowhead_2d": [_P] * 10 + [_I] * 8 + [_P],
    "camli_update_2d": [_P] * 9 + [_I] * 13 + [_P],
    "camli_motion_encoder_3d": [_P] * 14 + [_I] * 17 + [_P],
    "camli_gru_flowhead_3d": [_P] * 18 + [_I] * 18 + [_P],
    "camli_dw_max": [_P] * 4 + [_I] * 7 + [_P],
    "camli_gather_kmajor": [_P] * 3 + [_I] * 7 + [_P],
    "camli_corr3d_tail": [_P] * 12 + [_I] * 7 + [_P],
    "camli_clfm": [_P] * 14 + [_I] * 8 + [_P],
}
# host functions that return a byte count: name -> argtypes
SIZES = {
    "camli_update_2d_scratch": [_I] * 8,
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(found).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return found


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in sources() + sorted(CSRC.glob("*.cuh")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libcamliflow_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, float, str]:
    """Compile the library if it is missing. Returns (path, seconds, log)."""
    lib = library_path()
    if lib.exists():
        return lib, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    start = time.perf_counter()
    objects, procs = [], []
    for src in sources():  # one nvcc per source, all started together
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    try:
        log = "".join(proc.communicate()[0] for proc in procs)
        if any(proc.returncode != 0 for proc in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        link = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                               *map(str, objects)], capture_output=True, text=True,
                              check=False)
    finally:
        for obj in objects:
            obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    tmp.replace(lib)  # atomic: a concurrent loader sees all or nothing
    return lib, time.perf_counter() - start, log


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every entry point's argtypes set."""
    lib = ctypes.CDLL(str(build()[0]))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name, argtypes in SIZES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_size_t
    lib.camli_error_string.argtypes = [ctypes.c_int]
    lib.camli_error_string.restype = ctypes.c_char_p
    return lib


def launch(name: str, *args) -> None:
    """Call a kernel's C entry point on PyTorch's current stream; raise if
    the launch was refused."""
    import torch

    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    code = getattr(lib, name)(*args, stream)
    if code != 0:
        message = lib.camli_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {message}")


if __name__ == "__main__":
    path, secs, output = build()
    print(output)
    print(f"built {path} in {secs:.1f} s")
