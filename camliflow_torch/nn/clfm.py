"""CLFM: bidirectional camera-LiDAR fusion.

PyTorch counterpart of camliflow_tpu/nn/clfm.py with the selective-kernel
fusion head the models use ('sk', reduction 2):
- 3D->2D, `FusionAwareInterp`: every pixel takes its nearest projected point
  (a 2-D k=1 KNN, cached once per frame by `fusion_interp_cache`); a score
  MLP over the offset [du, dv, |d|] gates that point's features;
- 2D->3D: the image features bilinearly sampled at uv, then a 1x1 MLP;
- `SKFusion` on each side.
feat_2d is NHWC, feat_3d [B, N, C], uv [B, N, 2] pixel coordinates.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.geometry import gather_points, k_nearest_neighbor
from ..ops.gridsample import grid_sample_points
from ..ops.image import mesh_grid
from .layers import DenseNormAct


def fusion_interp_cache(uv: torch.Tensor, image_h: int, image_w: int, k: int = 1):
    """The pixel grid's nearest projected points: (indices [B, HW, k] int32,
    offsets point - pixel [B, HW, k, 2]). It depends only on uv, so a caller
    computes it once per frame and reuses it in every iteration."""
    batch = uv.shape[0]
    grid = mesh_grid(batch, image_h, image_w, device=uv.device)
    grid = grid.reshape(batch, image_h * image_w, 2)
    knn_indices = k_nearest_neighbor(uv.contiguous(), grid.contiguous(), k)
    knn_offset = gather_points(uv, knn_indices) - grid[:, :, None, :]
    return knn_indices, knn_offset


class FusionAwareInterp(nn.Module):
    """Scatter 3D features onto the image grid through the nearest point."""

    def __init__(self, n_channels_3d: int, norm: str | None = None):
        super().__init__()
        self.n_channels_3d = n_channels_3d
        self.score_net = nn.Sequential(
            DenseNormAct(3, 16),
            DenseNormAct(16, n_channels_3d, act="sigmoid"),
        )
        self.out_conv = DenseNormAct(n_channels_3d, n_channels_3d, norm=norm)

    def forward(self, feat_2d, feat_3d, interp_cache):
        batch, image_h, image_w, _ = feat_2d.shape
        knn_indices, knn_offset = interp_cache
        knn_feat3d = gather_points(feat_3d, knn_indices)  # [B, HW, k, C3]
        offset_norm = torch.linalg.vector_norm(knn_offset, dim=-1, keepdim=True)
        score = self.score_net(torch.cat([knn_offset, offset_norm], dim=-1))
        final = torch.sum(score * knn_feat3d, dim=2)
        final = final.reshape(batch, image_h, image_w, self.n_channels_3d)
        return self.out_conv(final)


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


class CLFM(nn.Module):
    """Bidirectional fusion of an image feature map and a point feature set."""

    def __init__(self, in_channels_2d: int, in_channels_3d: int, norm: str | None = None):
        super().__init__()
        c2, c3 = in_channels_2d, in_channels_3d
        self.interp = FusionAwareInterp(c3, norm=norm)
        self.fuse2d = SKFusion(c2, c3, c2, norm=norm)
        self.mlps3d = DenseNormAct(c2, c2, norm=norm)
        self.fuse3d = SKFusion(c2, c3, c3, norm=norm)

    def forward(self, uv, feat_2d, feat_3d, interp_cache):
        """-> (out_2d [B, H, W, C2], out_3d [B, N, C3]). Each side reaches the
        other's features detached, as in the reference: the gradient of a
        fused output flows into its own side's input only (and into the
        fusion's weights)."""
        feat_2d, feat_3d = feat_2d.float(), feat_3d.float()
        interp = self.interp(feat_2d.detach(), feat_3d.detach(), interp_cache)
        out_2d = self.fuse2d(feat_2d, interp)
        sampled = self.mlps3d(grid_sample_points(feat_2d.detach(), uv))
        return out_2d, self.fuse3d(sampled, feat_3d)
