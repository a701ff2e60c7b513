"""k-NN inverse-distance interpolation: CUDA kernel, plain version, wrapper.

Replaces camliflow_tpu/ops/pallas_interp.py::knn_interpolation_pallas with
`csrc/interp.cu`: the KNN kernel's split scan and warp merge select each
query's k nearest supports (planned by `knn.select_plan`), then the merging
warp forms the weights and the weighted feature sum, a lane a channel.
Arithmetic-bound on query-support pairs; see the source for the design
note. The kernel has no backward: the wrapper raises under grad mode on an
input that requires grad, on either device, and the train paths
interpolate through `geometry.knn_interpolation_train` instead.
"""

from __future__ import annotations

import torch

from . import _cuda
from .geometry import gather_points
from .knn import MAX_K, k_nearest_neighbor_plain, select_plan


def knn_interpolation_plain(
    input_xyz: torch.Tensor,
    input_features: torch.Tensor,
    query_xyz: torch.Tensor,
    k: int = 3,
) -> torch.Tensor:
    """Plain KNN + gathers: weights 1 / max(|support - query|, 1e-8),
    normalised, then the weighted sum of the features."""
    idx = k_nearest_neighbor_plain(input_xyz, query_xyz, k)  # [B, N, k]
    diff = (gather_points(input_xyz, idx) - query_xyz[:, :, None, :]).float()
    dist = torch.sqrt(
        diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
        + diff[..., 2] * diff[..., 2]
    ).clamp_min(1e-8)
    weights = 1.0 / dist
    weights = weights / weights.sum(dim=-1, keepdim=True)
    feats = gather_points(input_features, idx)  # [B, N, k, C]
    return (feats * weights[..., None].to(feats.dtype)).sum(dim=2)


def knn_interpolation(
    input_xyz: torch.Tensor,
    input_features: torch.Tensor,
    query_xyz: torch.Tensor,
    k: int = 3,
) -> torch.Tensor:
    """[B, M, 3] supports, [B, M, C] features, [B, N, 3] queries -> [B, N, C].
    CPU tensors take the plain version; CUDA tensors the kernel. Forward
    only: under grad mode an input that requires grad raises."""
    _cuda.forward_only("knn_interpolation", input_xyz, input_features, query_xyz)
    if _cuda.on_cpu(input_xyz, input_features, query_xyz):
        return knn_interpolation_plain(input_xyz, input_features, query_xyz, k)
    name = "knn_interpolation"
    _cuda.check(name, torch.float32, input_xyz=input_xyz,
                input_features=input_features, query_xyz=query_xyz)
    batch, m = input_xyz.shape[:2]
    _cuda.check_shape(name, "input_xyz", input_xyz, (batch, m, 3))
    _cuda.check_shape(name, "input_features", input_features, (batch, m, None))
    _cuda.check_shape(name, "query_xyz", query_xyz, (batch, None, 3))
    if not 1 <= k <= min(MAX_K, m):
        raise ValueError(f"{name}: need 1 <= k <= min({MAX_K}, M={m}), got {k}")
    n, channels = query_xyz.shape[1], input_features.shape[2]
    out = torch.empty(batch, n, channels, dtype=torch.float32,
                      device=input_xyz.device)
    from ..csrc.build import launch

    launch("camli_interp", input_xyz.data_ptr(), input_features.data_ptr(),
           query_xyz.data_ptr(), out.data_ptr(), batch, m, n, channels, k,
           *select_plan(batch, n, m, k, _cuda.sm_count(input_xyz.device)))
    knn_interpolation.launches += 1
    return out


knn_interpolation.launches = 0
