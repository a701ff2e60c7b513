"""Device setup for the port's entry points (counterpart of
camliflow_tpu/utils/jax_setup.py)."""

from __future__ import annotations

import torch


def setup_torch() -> None:
    """Full-f32 numerics: no TF32 in matrix products or cuDNN convolutions,
    so the card computes what the JAX exact path computes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def autotuned_convolutions():
    """A context in which cuDNN picks each convolution's algorithm by timing
    the candidates at its first call with a shape (benchmark mode), TF32
    still off. The PWC family's forwards run in it: cuDNN's heuristics alone
    gave, on the H100, one of CamLiPWC's 3x3 convolutions (307 -> 128
    channels at 144 x 240) an algorithm of 33,000 launches, the request
    peaking at 20 GB, and PWC's at bs 8 FFTs, peaking at 44 GB (PERF.md
    §6). The choice is cached per shape for the process (also for calls
    outside the context)."""
    return torch.backends.cudnn.flags(enabled=True, benchmark=True,
                                      deterministic=torch.backends.cudnn.deterministic,
                                      allow_tf32=torch.backends.cudnn.allow_tf32)
