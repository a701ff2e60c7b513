"""CamLiPWC-L: LiDAR-only coarse-to-fine scene flow (a point-space PWC), eval
and training.

PyTorch counterpart of camliflow_tpu/models/camlipwc_l.py. Module and
parameter names follow the reference PyTorch state_dict
(`core.feature_pyramid.pyramid_convs.<i>`, `core.correlations.<i>`,
`core.pyramid_feat_aligners.<i>`, `core.flow_estimator`), so the weight bridge
names every key with runtime/names.py (a per-level list is a `level_list`:
levels 1-5 at their own index).

On a card the selections run as kernels: FPS once a request (#2), KNN (#1)
in each PointConv of the pyramid and twice a decoder level, the
interpolation (#3) in the level upsample, the backwarp and the final
upsample, and every PointConv's two gathers as the k-major gather (#12).
Correlation3DPWC gathers with `torch.gather`, as the JAX package does. Eval
returns the final flow only.

Train mode (and eval with `with_pyramid`, as the trainer validates) also
returns every level's flow, each interpolated to the next finer level and
taken back through IDS (`flows_3d`, finest first), and the FPS indices
(`sample_indices1`) at which the pyramid loss reads the target. In train
mode the pyramid's BatchNorms take batch statistics, per frame, and every
interpolation the flow goes through (the level upsample, the backwarp, the
final upsamples) is `knn_interpolation_train`, differentiable, its
selection #1 (#3 has no backward); the PointConvs gather with the plain,
differentiable gather (#12 has none either). `loss_fn` and `is_better` are
the JAX ones.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.layers import MLP, DenseNormAct, compute_precision, level_list
from ..nn.point_conv import PointConv
from ..ops.geometry import (
    backwarp_3d,
    build_pc_pyramid,
    gather_points,
    k_nearest_neighbor,
    knn_interpolation,
    knn_interpolation_train,
)
from ..ops.ids import make_parallel_camera_info, paral2persp, persp2paral
from .camliraft_l import DEFAULT_N_SAMPLES
from .losses import calc_pyramid_loss_3d
from .metrics import compute_3d_metrics, merge_metrics, scalar_metric

PYRAMID_CHANNELS = (16, 32, 64, 96, 128, 192)
# the sensor CamLiPWC-L's IDS assumes, whatever the input (camlipwc_l.py)
SENSOR_H, SENSOR_W = 540, 960


class FeaturePyramid3D(nn.Module):
    """6-level point feature pyramid: an MLP at the full cloud, then per
    level an MLP and a PointConv down to the next FPS level."""

    def __init__(self, n_channels=PYRAMID_CHANNELS, norm: str | None = "batch_norm",
                 k: int = 16):
        super().__init__()
        c = n_channels
        self.level0_mlp = MLP(3, [c[0], c[0]])
        self.pyramid_mlps = nn.ModuleList(MLP(c[i], [c[i], c[i + 1]]) for i in range(len(c) - 1))
        self.pyramid_convs = nn.ModuleList(
            PointConv(c[i + 1], c[i + 1], norm=norm, k=k) for i in range(len(c) - 1)
        )

    def forward(self, xyzs):
        feats = [self.level0_mlp(xyzs[0])]
        for i, (mlp, conv) in enumerate(zip(self.pyramid_mlps, self.pyramid_convs)):
            feats.append(conv(xyzs[i], mlp(feats[-1]), xyzs[i + 1]))
        return feats


class Correlation3DPWC(nn.Module):
    """Patch-to-patch cost volume: a cost MLP over each point's k nearest in
    frame 2, summed with learned weights, then re-aggregated over its k
    nearest in frame 1."""

    def __init__(self, in_channels: int, out_channels: int,
                 align_channels: int | None = None, k: int = 16):
        super().__init__()
        self.k = k
        self.cost_mlp = MLP(2 * in_channels + 3, [out_channels, out_channels])
        self.weight_net1 = MLP(3, [8, 8, out_channels], act="relu")
        self.weight_net2 = MLP(3, [8, 8, out_channels], act="relu")
        self.feat_aligner = (None if align_channels is None
                             else DenseNormAct(out_channels, align_channels))

    def forward(self, xyz1, feat1, xyz2, feat2, knn_indices_1in1=None):
        """xyz1/feat1 [B, N, 3|C], xyz2/feat2 [B, M, 3|C] -> [B, N, out]."""
        batch, n_points, channels = feat1.shape
        knn_1in2 = k_nearest_neighbor(xyz2, xyz1, self.k)  # [B, N, k]
        knn_xyz2_norm = gather_points(xyz2, knn_1in2) - xyz1[:, :, None, :]
        feat1_expand = feat1[:, :, None, :].expand(batch, n_points, self.k, channels)
        p2p_cost = self.cost_mlp(torch.cat(
            [feat1_expand, gather_points(feat2, knn_1in2), knn_xyz2_norm], dim=-1))
        p2n_cost = torch.sum(self.weight_net2(knn_xyz2_norm) * p2p_cost, dim=2)

        if knn_indices_1in1 is None:
            knn_1in1 = k_nearest_neighbor(xyz1, xyz1, self.k)
        else:
            knn_1in1 = knn_indices_1in1[:, :, : self.k]
        knn_xyz1_norm = gather_points(xyz1, knn_1in1) - xyz1[:, :, None, :]
        n2n_cost = torch.sum(self.weight_net1(knn_xyz1_norm) * gather_points(p2n_cost, knn_1in1),
                             dim=2)
        return n2n_cost if self.feat_aligner is None else self.feat_aligner(n2n_cost)


class FlowEstimator3D(nn.Module):
    """Two PointConvs and an MLP; with conv_last also the flow delta."""

    def __init__(self, n_channels, norm: str | None = None, conv_last: bool = True,
                 k: int = 16):
        super().__init__()
        c = self.n_channels = tuple(n_channels)  # (in, c1, c2, c3)
        self.point_conv1 = PointConv(c[0], c[1], norm=norm, k=k)
        self.point_conv2 = PointConv(c[1], c[2], norm=norm, k=k)
        self.mlp = MLP(c[2], [c[2], c[3]])
        self.conv_last = nn.Linear(c[3], 3) if conv_last else None

    def forward(self, xyz, feat, knn_indices):
        feat = self.point_conv1(xyz, feat, knn_indices=knn_indices)
        feat = self.mlp(self.point_conv2(xyz, feat, knn_indices=knn_indices))
        if self.conv_last is None:
            return feat
        return feat, self.conv_last(feat)


class CamLiPWCLCore(nn.Module):
    """Coarse-to-fine 3D decoder: levels 5 (256 points) to 1 (4096)."""

    def __init__(self, norm_feature_pyramid: str | None = "batch_norm",
                 norm_flow_estimator: str | None = None):
        super().__init__()
        channels = PYRAMID_CHANNELS[1:]
        self.feature_pyramid = FeaturePyramid3D(norm=norm_feature_pyramid)
        self.correlations = level_list(Correlation3DPWC(c, c, align_channels=64)
                                       for c in channels)
        self.pyramid_feat_aligners = level_list(DenseNormAct(c, 64) for c in channels)
        self.flow_estimator = FlowEstimator3D((64 + 64 + 3, 128, 128, 64),
                                              norm=norm_flow_estimator)

    def decode(self, xyzs1, xyzs2, feats1, feats2, pyramid: bool = False):
        """-> [the flow at level 1's points, upsampled to the full cloud];
        with `pyramid`, every level's flow upsampled to the next finer
        level's points, finest first."""
        interp = knn_interpolation_train if self.training else knn_interpolation
        flows = []
        for level in range(len(xyzs1) - 1, 0, -1):
            xyz1, feat1 = xyzs1[level], feats1[level]
            xyz2, feat2 = xyzs2[level], feats2[level]
            knn1 = k_nearest_neighbor(xyz1, xyz1, 16)
            if not flows:
                last_flow = torch.zeros_like(xyz1)
                xyz2_warp = xyz2
            else:
                last_flow = interp(xyzs1[level + 1], flows[-1], xyz1)
                xyz2_warp = backwarp_3d(xyz1, xyz2, last_flow, train=self.training)
            x = torch.cat([self.pyramid_feat_aligners[level](feat1),
                           self.correlations[level](xyz1, feat1, xyz2_warp, feat2, knn1),
                           last_flow.to(feat1.dtype)], dim=-1)
            flows.append(last_flow + self.flow_estimator(xyz1, x, knn1)[1].float())
        levels = len(flows) if pyramid else 1
        return [interp(xyzs1[i + 1], flow, xyzs1[i]) for i, flow in enumerate(flows[::-1][:levels])]

    def forward(self, xyzs1, xyzs2, pyramid: bool = False):
        return self.decode(xyzs1, xyzs2, self.feature_pyramid(xyzs1),
                           self.feature_pyramid(xyzs2), pyramid)


class CamLiPWCL(nn.Module):
    """Model wrapper: IDS (on a fixed 540x960 sensor), the FPS pyramids, the
    core, IDS back. In train mode (and with `with_pyramid`) it also returns
    `flows_3d` and `sample_indices1`; train mode computes under
    `compute_dtype` (bf16 autocast or f32), eval stays f32."""

    def __init__(self, cfgs: dict):
        super().__init__()
        self.with_pyramid = False
        self.compute_dtype = cfgs.get("compute_dtype")
        compute_precision(self.compute_dtype, "cpu")  # raises on a dtype it does not know
        self.ids_enabled = bool(cfgs["ids"]["enabled"])
        self.n_samples_list = tuple(cfgs.get("n_samples_list", DEFAULT_N_SAMPLES))
        self.core = CamLiPWCLCore(norm_feature_pyramid=cfgs["norm"]["feature_pyramid"],
                                  norm_flow_estimator=cfgs["norm"]["flow_estimator"])

    def forward(self, inputs: dict) -> dict:
        pcs = inputs["pcs"].float()
        pc1, pc2 = pcs[..., :3].contiguous(), pcs[..., 3:].contiguous()
        intrinsics = inputs["intrinsics"].float()
        persp_cam = {"projection_mode": "perspective", "sensor_h": SENSOR_H,
                     "sensor_w": SENSOR_W, "f": intrinsics[:, 0], "cx": intrinsics[:, 1],
                     "cy": intrinsics[:, 2]}
        if self.ids_enabled:
            paral_cam = make_parallel_camera_info(SENSOR_H, SENSOR_W)
            pc1 = persp2paral(pc1, persp_cam, paral_cam)
            pc2 = persp2paral(pc2, persp_cam, paral_cam)
        xyzs1, xyzs2, sample_indices1, _ = build_pc_pyramid(pc1, pc2,
                                                            list(self.n_samples_list))
        pyramid = self.training or self.with_pyramid
        dtype = self.compute_dtype if self.training else None
        with compute_precision(dtype, pc1.device.type):
            flows = self.core(xyzs1, xyzs2, pyramid)
        if self.ids_enabled:
            flows = [paral2persp(xyz + flow, persp_cam, paral_cam)
                     - paral2persp(xyz, persp_cam, paral_cam) for xyz, flow in zip(xyzs1, flows)]
        if not pyramid:
            return {"flow_3d": flows[0]}
        return {"flow_3d": flows[0], "flows_3d": flows, "sample_indices1": sample_indices1}


def loss_fn(outputs: dict, inputs: dict, cfgs) -> tuple[torch.Tensor, dict]:
    """Pyramid loss at the FPS levels and metrics (the JAX `loss_fn`)."""
    target_3d = inputs["flow_3d"]
    loss = calc_pyramid_loss_3d(outputs["flows_3d"], target_3d,
                                level_weights=list(cfgs["loss"]["level_weights"]),
                                order=cfgs["loss"]["order"], indices=outputs["sample_indices1"])
    return loss, merge_metrics({"loss3d": scalar_metric(loss)},
                               compute_3d_metrics(outputs["flow_3d"], target_3d[..., :3]))


def is_better(curr: dict, best: dict | None) -> bool:
    return best is None or curr["epe3d"] < best["epe3d"]
