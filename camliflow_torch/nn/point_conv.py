"""Continuous point convolutions on channel-last data.

PyTorch counterpart of camliflow_tpu/nn/point_conv.py.

PointConv: KNN gather -> relative-xyz weight net MLP(3->[8,16]) ->
weights^T @ neighbour features -> linear -> norm -> act. Both gathers are
k-major ([B, k, M, C]): in eval through kernel #12 on a card
(ops/gather.py), as the JAX fast path gathers; in train mode through the
plain, differentiable gather, as the JAX training path gathers. The
contraction over k is the same sum either way.
PointNet2: MLP over [dxyz, neighbour features], max over k (no model uses
it).
PointConvDW: depthwise variant, feature MLP * weight_net(dxyz), max over k,
as differentiable torch ops (the eval loops run the tail as kernel #13 or
inside #6/#7 on weights packed once per request, ops/update3d.py); its
geometric weights depend only on the points, so `compute_weights` lets a
caller hoist them out of a refinement loop. With `fast` (inference) it is
the JAX package's fast form: the MLP output and the weights in bf16, their
products rounded to bf16, the max over k returned as f32. `paired_dw_conv`
runs two PointConvDWs over the same input and neighbours with one gather.
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


class PointNet2(nn.Module):
    """PointNet++ set abstraction: an MLP over [dxyz, neighbour features]
    for each of k neighbours, then the max over k. No model uses it (nor
    the reference's); it completes the building blocks. The neighbours are
    selected by `k_nearest_neighbor` (kernel #1 on a card) unless given;
    the gathers are the plain, differentiable ones."""

    def __init__(self, in_channels: int, mlp_channels, norm: str | None = None,
                 act: str | None = "leaky_relu", k: int = 16):
        super().__init__()
        self.k = k
        self.mlp = MLP(3 + in_channels, list(mlp_channels), norm=norm, act=act)

    def forward(self, xyz, features, sampled_xyz=None, knn_indices=None):
        """xyz [B, N, 3], features [B, N, C] -> [B, M, mlp_channels[-1]] at
        sampled_xyz [B, M, 3] (default xyz)."""
        if sampled_xyz is None:
            sampled_xyz = xyz
        knn_indices = _resolve_knn(xyz, sampled_xyz, knn_indices, self.k)
        rel_xyz = (gather_points(xyz, knn_indices) - sampled_xyz[:, :, None, :]).to(features.dtype)
        knn_feats = gather_points(features, knn_indices)
        return self.mlp(torch.cat([rel_xyz, knn_feats], dim=-1)).amax(dim=2)


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
                weights=None, fast: bool = False):
        if sampled_xyz is None:
            sampled_xyz = xyz
        knn_indices = _resolve_knn(xyz, sampled_xyz, knn_indices, self.k).contiguous()
        if weights is None:
            weights = self.compute_weights(xyz, sampled_xyz, knn_indices)
        if fast:
            weights = weights.to(torch.bfloat16)
        return update3d.dw_max_plain(self.mlp(features), knn_indices, weights)


def paired_dw_conv(conv_a: PointConvDW, conv_b: PointConvDW, xyz, features, knn_indices=None,
                   weights=None, fast: bool = False):
    """Two PointConvDWs over the same input and neighbours (a point GRU's z
    and r) with one gather: the channel concat of both MLP outputs is
    gathered once and multiplied by `weights`, the two convs' weights
    concatenated on the last axis, then the max over k is split. Each
    half equals its conv's own output bit for bit (the products and the
    max are per channel). `fast` as PointConvDW takes it."""
    if conv_a.k != conv_b.k:
        raise ValueError(f"paired_dw_conv: the convs take {conv_a.k} and {conv_b.k} neighbours")
    idx = _resolve_knn(xyz, xyz, knn_indices, conv_a.k).contiguous()
    if weights is None:
        weights = torch.cat([conv.compute_weights(xyz, knn_indices=idx)
                             for conv in (conv_a, conv_b)], dim=-1)
    if fast:
        weights = weights.to(torch.bfloat16)
    fa, fb = conv_a.mlp(features), conv_b.mlp(features)
    out = update3d.dw_max_plain(torch.cat([fa, fb], dim=-1), idx, weights)
    return out[..., : fa.shape[-1]], out[..., fa.shape[-1]:]

