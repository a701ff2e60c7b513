"""CLFM: bidirectional camera-LiDAR fusion.

PyTorch counterpart of camliflow_tpu/nn/clfm.py:
- 3D->2D, `FusionAwareInterp`: every pixel takes its k nearest projected
  points (a 2-D KNN, cached once per frame by `fusion_interp_cache`, or
  built here when no cache is passed); a score MLP over the offset
  [du, dv, |d|] gates those points' features, summed over k;
- 2D->3D: the image features bilinearly sampled at uv, then a 1x1 MLP;
- a fusion head on each side: `SKFusion` (selective kernel, reduction 2,
  the one the models use), `AddFusion`, `ConcatFusion` or `GatedFusion`.
`FusionAwareInterpCVPR` is the CVPR paper's 3D->2D interpolation, which no
model uses. feat_2d is NHWC, feat_3d [B, N, C], uv [B, N, 2] pixel
coordinates.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.geometry import gather_points, k_nearest_neighbor
from ..ops.gridsample import grid_sample_points
from ..ops.image import mesh_grid
from .layers import DenseNormAct, apply_act


def _pixel_grid(batch: int, image_h: int, image_w: int, device) -> torch.Tensor:
    """The pixel centres (x, y) as [B, HW, 2] f32."""
    return mesh_grid(batch, image_h, image_w, device=device).reshape(batch, image_h * image_w, 2)


def fusion_interp_cache(uv: torch.Tensor, image_h: int, image_w: int, k: int = 1):
    """The pixel grid's nearest projected points: (indices [B, HW, k] int32,
    offsets point - pixel [B, HW, k, 2]). It depends only on uv, so a caller
    computes it once per frame and reuses it in every iteration."""
    grid = _pixel_grid(uv.shape[0], image_h, image_w, uv.device)
    knn_indices = k_nearest_neighbor(uv.contiguous(), grid.contiguous(), k)
    knn_offset = gather_points(uv, knn_indices) - grid[:, :, None, :]
    return knn_indices, knn_offset


class FusionAwareInterp(nn.Module):
    """Scatter 3D features onto the image grid through the k nearest points."""

    def __init__(self, n_channels_3d: int, k: int = 1, norm: str | None = None):
        super().__init__()
        self.n_channels_3d = n_channels_3d
        self.k = k
        self.score_net = nn.Sequential(
            DenseNormAct(3, 16),
            DenseNormAct(16, n_channels_3d, act="sigmoid"),
        )
        self.out_conv = DenseNormAct(n_channels_3d, n_channels_3d, norm=norm)

    def forward(self, uv, feat_2d, feat_3d, interp_cache=None):
        """interp_cache: `fusion_interp_cache(uv, H, W, k)`, built here when
        None."""
        batch, image_h, image_w, _ = feat_2d.shape
        if interp_cache is None:
            interp_cache = fusion_interp_cache(uv, image_h, image_w, self.k)
        knn_indices, knn_offset = interp_cache
        knn_feat3d = gather_points(feat_3d, knn_indices)  # [B, HW, k, C3]
        offset_norm = torch.linalg.vector_norm(knn_offset, dim=-1, keepdim=True)
        score = self.score_net(torch.cat([knn_offset, offset_norm], dim=-1))
        final = torch.sum(score * knn_feat3d, dim=2)
        final = final.reshape(batch, image_h, image_w, self.n_channels_3d)
        return self.out_conv(final)


class FusionAwareInterpCVPR(nn.Module):
    """The CVPR paper's 3D->2D interpolation: for every pixel its nearest
    projected point (kernel #1 on a card), whose offset, features and the
    correlation of its sampled image features with the pixel's go through a
    3-layer MLP. Every input of the MLP is detached, as the JAX package
    stops their gradients: the gradient reaches the MLP's weights only."""

    def __init__(self, n_channels_2d: int, n_channels_3d: int, norm: str | None = None):
        super().__init__()
        widths = [n_channels_3d + 3, n_channels_3d, n_channels_3d, n_channels_3d]
        self.mlps = nn.Sequential(*(DenseNormAct(i, o, norm=norm)
                                    for i, o in zip(widths[:-1], widths[1:])))

    def forward(self, uv, feat_2d, feat_3d):
        batch, h, w, c2 = feat_2d.shape
        grid = _pixel_grid(batch, h, w, uv.device)
        nn_indices = k_nearest_neighbor(uv.contiguous(), grid.contiguous(), 1)[..., 0]
        with torch.no_grad():
            sampled = grid_sample_points(feat_2d, uv)  # [B, N, C2]
            nn_feat2d = gather_points(sampled, nn_indices)  # [B, HW, C2]
            nn_feat3d = gather_points(feat_3d, nn_indices)
            nn_offset = gather_points(uv, nn_indices) - grid
            nn_corr = torch.mean(nn_feat2d * feat_2d.reshape(batch, h * w, c2), dim=-1,
                                 keepdim=True)
        feat = torch.cat([nn_offset, nn_corr, nn_feat3d], dim=-1).reshape(batch, h, w, -1)
        return self.mlps(feat)


class AddFusion(nn.Module):
    """leaky_relu(align1(a) + align2(b))."""

    def __init__(self, in_a: int, in_b: int, out_channels: int, norm: str | None = None):
        super().__init__()
        self.align1 = DenseNormAct(in_a, out_channels, norm=norm)
        self.align2 = DenseNormAct(in_b, out_channels, norm=norm)

    def forward(self, feat_a, feat_b):
        return apply_act(self.align1(feat_a) + self.align2(feat_b), "leaky_relu")


class ConcatFusion(nn.Module):
    """One 1x1 layer over the channel concat of a and b."""

    def __init__(self, in_a: int, in_b: int, out_channels: int, norm: str | None = None):
        super().__init__()
        self.mlp = DenseNormAct(in_a + in_b, out_channels, norm=norm)

    def forward(self, feat_a, feat_b):
        return self.mlp(torch.cat([feat_a, feat_b], dim=-1))


class GatedFusion(nn.Module):
    """The aligned a and b blended by per-position weights: a softmax over
    the sum of two sigmoid gates, one from each side."""

    def __init__(self, in_a: int, in_b: int, out_channels: int, norm: str | None = None):
        super().__init__()
        self.align1 = DenseNormAct(in_a, out_channels, norm=norm)
        self.align2 = DenseNormAct(in_b, out_channels, norm=norm)
        self.mlp1 = DenseNormAct(out_channels, 2, act="sigmoid")
        self.mlp2 = DenseNormAct(out_channels, 2, act="sigmoid")

    def forward(self, feat_a, feat_b):
        a, b = self.align1(feat_a), self.align2(feat_b)
        weight = torch.softmax(self.mlp1(a) + self.mlp2(b), dim=-1)
        return a * weight[..., 0:1] + b * weight[..., 1:2]


class SKFusion(nn.Module):
    """Selective-kernel fusion of two aligned feature sets."""

    def __init__(self, in_a: int, in_b: int, out_channels: int,
                 norm: str | None = None, reduction: int = 2):
        super().__init__()
        self.align1 = DenseNormAct(in_a, out_channels, norm=norm)
        self.align2 = DenseNormAct(in_b, out_channels, norm=norm)
        mid = out_channels // reduction
        self.fc_mid = nn.Sequential(nn.Linear(out_channels, mid, bias=False), nn.ReLU())
        self.fc_out = nn.Sequential(nn.Linear(mid, out_channels * 2, bias=False),
                                    nn.Sigmoid())

    def forward(self, feat_a, feat_b):
        a, b = self.align1(feat_a), self.align2(feat_b)
        batch, channels = a.shape[0], a.shape[-1]
        spatial = tuple(range(1, a.dim() - 1))
        weight = self.fc_out(self.fc_mid(torch.mean(a + b, dim=spatial)))
        weight = torch.softmax(weight.reshape(batch, channels, 2), dim=-1)
        shape = (batch,) + (1,) * len(spatial) + (channels,)
        return a * weight[..., 0].reshape(shape) + b * weight[..., 1].reshape(shape)


FUSIONS = {"add": AddFusion, "concat": ConcatFusion, "gated": GatedFusion, "sk": SKFusion}


class CLFM(nn.Module):
    """Bidirectional fusion of an image feature map and a point feature set;
    `fusion_fn` names each side's head (SK with reduction 2)."""

    def __init__(self, in_channels_2d: int, in_channels_3d: int, fusion_fn: str = "sk",
                 norm: str | None = None):
        super().__init__()
        if fusion_fn not in FUSIONS:
            raise ValueError(f"unknown fusion_fn {fusion_fn!r}: one of {sorted(FUSIONS)}")
        c2, c3 = in_channels_2d, in_channels_3d
        fusion = FUSIONS[fusion_fn]
        self.fusion_fn = fusion_fn
        self.interp = FusionAwareInterp(c3, norm=norm)
        self.fuse2d = fusion(c2, c3, c2, norm=norm)
        self.mlps3d = DenseNormAct(c2, c2, norm=norm)
        self.fuse3d = fusion(c2, c3, c3, norm=norm)

    def forward(self, uv, feat_2d, feat_3d, interp_cache=None):
        """-> (out_2d [B, H, W, C2], out_3d [B, N, C3]); interp_cache as
        FusionAwareInterp takes it. Each side reaches the other's features
        detached, as in the reference: the gradient of a fused output flows
        into its own side's input only (and into the fusion's weights)."""
        feat_2d, feat_3d = feat_2d.float(), feat_3d.float()
        interp = self.interp(uv, feat_2d.detach(), feat_3d.detach(), interp_cache)
        out_2d = self.fuse2d(feat_2d, interp)
        sampled = self.mlps3d(grid_sample_points(feat_2d.detach(), uv))
        return out_2d, self.fuse3d(sampled, feat_3d)
