"""Argument checks shared by the kernel wrappers.

A wrapper hands raw pointers to a kernel, so it first checks what the kernel
assumes and raises on anything else: every tensor on the same CUDA device,
which is the current one (kernels launch on the current device's stream),
of the expected dtype and shape, contiguous.
"""

from __future__ import annotations

import functools

import torch


def forward_only(name: str, *tensors) -> None:
    """Raise when grad mode is on and an input requires grad: the fused
    kernels (#5-#13) and the interpolation (#3) have no backward, so on
    either device their wrappers refuse to drop a gradient without a word.
    Training runs the modules' own differentiable forwards instead."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            f"{name} is forward-only (no backward) but an input requires grad; run it "
            "under torch.no_grad() / torch.inference_mode(), or train through the "
            "modules' own forwards (the model in train mode)")


def forward_only_modules(name: str, *modules: torch.nn.Module) -> None:
    """Raise when grad mode is on and a module whose weights a fused kernel's
    packer copies requires grad: the packed copies carry no gradient back."""
    if torch.is_grad_enabled() and any(
        p.requires_grad for m in modules for p in m.parameters()
    ):
        raise RuntimeError(
            f"{name} packs weights that require grad into a forward-only kernel's "
            "layout; pack under torch.no_grad() / torch.inference_mode() (eval), or "
            "train through the modules' own forwards (the model in train mode)")


COUNTERS = ("launches", "fast_launches", "int8_launches")


def count(wrapper, form: int) -> None:
    """One launch of `wrapper`'s kernel, on the counter of its form: 0
    (False) the exact form's `launches`, 1 (True) the fast path's
    `fast_launches` (int8, scaled or bf16 operands), 2 the int8 3D chain's
    `int8_launches` (ops/update3d.py's DwKind)."""
    name = COUNTERS[int(form)]
    setattr(wrapper, name, getattr(wrapper, name) + 1)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the plain version applies)."""
    return all(t.device.type == "cpu" for t in tensors)


@functools.cache
def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on the H100 SXM)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(name: str, dtype: torch.dtype, **tensors: torch.Tensor) -> None:
    """Raise unless each tensor is a contiguous `dtype` tensor on one CUDA
    device, the current one."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(f"{name}: all inputs must lie on one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    current = torch.cuda.current_device()
    if next(iter(devices)).index not in (None, current):
        raise ValueError(f"{name}: the inputs lie on {next(iter(devices))}, but the kernels "
                         f"launch on the current device, cuda:{current}; select it first")
    for key, t in tensors.items():
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")


def check_shape(name: str, key: str, t: torch.Tensor, shape: tuple) -> None:
    """Raise unless `t` has `shape` (None matches any extent)."""
    ok = t.dim() == len(shape) and all(
        s is None or s == d for s, d in zip(shape, t.shape)
    )
    if not ok:
        raise ValueError(f"{name}: {key} must have shape {shape}, got "
                         f"{tuple(t.shape)}")
