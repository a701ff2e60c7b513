"""k-nearest-neighbour selection: CUDA kernel, plain version, wrapper.

Replaces camliflow_tpu/ops/pallas_knn.py::k_nearest_neighbor_pallas with
`csrc/knn.cu`: one thread per query scans the support set through shared
memory, keeping a sorted register list (strictly-smaller insertion, so equal
distances keep the lowest index first). The kernel is arithmetic-bound on
query-candidate pairs; see the source for the design note.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _cuda
from .geometry import knn_from_dists, squared_distance

MAX_K = 32


def k_nearest_neighbor_plain(
    input_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int
) -> torch.Tensor:
    """Dense distances + stable sort: [B, N, k] int32, ascending distance."""
    return knn_from_dists(squared_distance(query_xyz, input_xyz), k)


def k_nearest_neighbor(
    input_xyz: torch.Tensor, query_xyz: torch.Tensor, k: int
) -> torch.Tensor:
    """[B, M, D] points, [B, N, D] queries, D = 3 or 2 -> [B, N, k] int32
    indices.

    CPU tensors take the plain version; CUDA tensors the kernel. 2-D points
    (CLFM's projected uv) reach the kernel with a zero third coordinate,
    which adds an exact 0*0 to every distance and changes no rounding."""
    if _cuda.on_cpu(input_xyz, query_xyz):
        return k_nearest_neighbor_plain(input_xyz, query_xyz, k)
    name = "k_nearest_neighbor"
    _cuda.check(name, torch.float32, input_xyz=input_xyz, query_xyz=query_xyz)
    batch, m, dim = input_xyz.shape
    if dim == 2:
        input_xyz = F.pad(input_xyz, (0, 1))
        query_xyz = F.pad(query_xyz, (0, 1))
    _cuda.check_shape(name, "input_xyz", input_xyz, (batch, m, 3))
    _cuda.check_shape(name, "query_xyz", query_xyz, (batch, None, 3))
    if not 1 <= k <= min(MAX_K, m):
        raise ValueError(f"{name}: need 1 <= k <= min({MAX_K}, M={m}), got {k}")
    n = query_xyz.shape[1]
    out = torch.empty(batch, n, k, dtype=torch.int32, device=input_xyz.device)
    from ..csrc.build import launch

    launch("camli_knn", input_xyz.data_ptr(), query_xyz.data_ptr(),
           out.data_ptr(), batch, m, n, k)
    k_nearest_neighbor.launches += 1
    return out


k_nearest_neighbor.launches = 0
