"""Continuous point convolutions on channel-last data.

PyTorch counterpart of camliflow_tpu/nn/point_conv.py (exact path).

PointConv: KNN gather -> relative-xyz weight net MLP(3->[8,16]) ->
weights^T @ neighbour features -> linear -> norm -> act. Both gathers are
k-major ([B, k, M, C]): in eval through kernel #12 on a card
(ops/gather.py), as the JAX fast path gathers; in train mode through the
plain, differentiable gather, as the JAX training path gathers. The
contraction over k is the same sum either way.
PointConvDW: depthwise variant, feature MLP * weight_net(dxyz), max over k,
as differentiable torch ops (the eval loops run the tail as kernel #13 or
inside #6/#7 on weights packed once per request, ops/update3d.py); its
geometric weights depend only on the points, so `compute_weights` lets a
caller hoist them out of a refinement loop.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import update3d
from ..ops.gather import gather_points_kmajor, gather_points_kmajor_plain
from ..ops.geometry import gather_points, k_nearest_neighbor
from .layers import MLP, Norm, apply_act


def _resolve_knn(xyz, sampled_xyz, knn_indices, k: int) -> torch.Tensor:
    if knn_indices is None:
        return k_nearest_neighbor(xyz, sampled_xyz, k)
    if knn_indices.shape[:2] != sampled_xyz.shape[:2] or knn_indices.shape[2] < k:
        raise ValueError(f"knn_indices {tuple(knn_indices.shape)} do not cover "
                         f"{tuple(sampled_xyz.shape[:2])} x k={k}")
    return knn_indices[:, :, :k]


class PointConv(nn.Module):
    """Continuous conv as a (16 x (C+3)) contraction per point."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: str | None = None, act: str | None = "leaky_relu",
                 k: int = 16):
        super().__init__()
        self.k = k
        self.act = act
        self.weight_net = MLP(3, [8, 16], act=act)
        self.linear = nn.Linear(16 * (in_channels + 3), out_channels)
        self.norm_fn = Norm(norm, out_channels)

    def forward(self, xyz, features, sampled_xyz=None, knn_indices=None):
        """xyz [B, N, 3], features [B, N, C] -> [B, M, out_channels] at
        sampled_xyz [B, M, 3] (default xyz)."""
        if sampled_xyz is None:
            sampled_xyz = xyz
        batch, n_samples = sampled_xyz.shape[:2]
        features = torch.cat([xyz.to(features.dtype), features], dim=-1)
        knn_indices = _resolve_knn(xyz, sampled_xyz, knn_indices, self.k).contiguous()
        gather = gather_points_kmajor_plain if self.training else gather_points_kmajor
        rel_xyz = gather(xyz, knn_indices) - sampled_xyz[:, None, :, :]
        weights = self.weight_net(rel_xyz)  # [B, k, M, 16]
        knn_feats = gather(features, knn_indices)  # [B, k, M, C+3]
        # flattened weights-major ([16, C+3] row-major) so checkpoints line up
        out = torch.einsum("bkmw,bkmc->bmwc", weights, knn_feats)
        out = self.linear(out.reshape(batch, n_samples, -1))
        return apply_act(self.norm_fn(out), self.act)


class PointConvDW(nn.Module):
    """Depthwise point conv: feature MLP * weight_net(dxyz), max over k."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: str | None = None, act: str | None = "leaky_relu",
                 k: int = 16):
        super().__init__()
        self.k = k
        self.mlp = MLP(in_channels, [out_channels], norm=norm, act=act)
        self.weight_net = MLP(3, [8, 32, out_channels], act="relu")

    def compute_weights(self, xyz, sampled_xyz=None, knn_indices=None):
        """Loop-invariant geometric weights [B, M, k, out_channels]."""
        if sampled_xyz is None:
            sampled_xyz = xyz
        knn_indices = _resolve_knn(xyz, sampled_xyz, knn_indices, self.k)
        rel_xyz = gather_points(xyz, knn_indices) - sampled_xyz[:, :, None, :]
        return self.weight_net(rel_xyz)

    def forward(self, xyz, features, sampled_xyz=None, knn_indices=None,
                weights=None):
        if sampled_xyz is None:
            sampled_xyz = xyz
        knn_indices = _resolve_knn(xyz, sampled_xyz, knn_indices, self.k).contiguous()
        if weights is None:
            weights = self.compute_weights(xyz, sampled_xyz, knn_indices)
        return update3d.dw_max_plain(self.mlp(features), knn_indices, weights)

