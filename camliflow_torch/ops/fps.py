"""Furthest-point sampling: CUDA kernel, plain version, wrapper.

Replaces camliflow_tpu/ops/pallas_fps.py::furthest_point_sampling_pallas
with `csrc/fps.cu`: one thread-block cluster of 4 blocks per cloud walks
the serial steps, each block with its slice of the points and running
distances in registers; a step's argmax is two warp redux instructions, and
the winners travel with their coordinates through distributed shared
memory, pushed by one-way st.async stores that complete an mbarrier each
block waits on. The kernel is bound by the latency of one step, not by
arithmetic or bandwidth; see the source for the design note.
"""

from __future__ import annotations

import torch

from . import _cuda

CLUSTER = 4  # csrc/fps.cu: blocks a cloud
MAX_POINTS = 8192  # csrc/fps.cu: 4 blocks x 128 threads x 16 points in registers


def furthest_point_sampling_plain(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """The serial loop in tensor ops: start at 0, running min distance from
    1e10, first index of the maximum. The distance is written per coordinate
    (`dx*dx + dy*dy + dz*dz`) so it rounds exactly as the kernel's does."""
    batch, n_points, _ = xyz.shape
    xyz = xyz.float()
    rows = torch.arange(batch, device=xyz.device)
    distances = torch.full((batch, n_points), 1e10, device=xyz.device)
    farthest = torch.zeros(batch, dtype=torch.long, device=xyz.device)
    indices = torch.zeros(batch, n_samples, dtype=torch.int32, device=xyz.device)
    for i in range(n_samples):
        indices[:, i] = farthest
        cur = xyz[rows, farthest]  # [B, 3]
        dx = xyz[..., 0] - cur[:, None, 0]
        dy = xyz[..., 1] - cur[:, None, 1]
        dz = xyz[..., 2] - cur[:, None, 2]
        distances = torch.minimum(distances, dx * dx + dy * dy + dz * dz)
        # argmax returns the first maximal index
        farthest = torch.argmax(distances, dim=-1)
    return indices


def furthest_point_sampling(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """[B, N, 3] -> [B, n_samples] int32. CPU tensors take the plain version;
    CUDA tensors the kernel."""
    if _cuda.on_cpu(xyz):
        return furthest_point_sampling_plain(xyz, n_samples)
    name = "furthest_point_sampling"
    _cuda.check(name, torch.float32, xyz=xyz)
    _cuda.check_shape(name, "xyz", xyz, (None, None, 3))
    batch, n_points, _ = xyz.shape
    if n_points > MAX_POINTS or not 1 <= n_samples <= n_points:
        raise ValueError(f"{name}: need N <= {MAX_POINTS} and "
                         f"1 <= n_samples <= N, got N={n_points}, "
                         f"n_samples={n_samples}")
    out = torch.empty(batch, n_samples, dtype=torch.int32, device=xyz.device)
    from ..csrc.build import launch

    launch("camli_fps", xyz.data_ptr(), out.data_ptr(), batch, n_points, n_samples)
    furthest_point_sampling.launches += 1
    return out


furthest_point_sampling.launches = 0
