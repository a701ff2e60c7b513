"""CamLiPWC: joint 2D + 3D coarse-to-fine flow with CLFM fusion, eval and
training.

PyTorch counterpart of camliflow_tpu/models/camlipwc.py: the PWC branch
(models/pwc.py) and the CamLiPWC-L branch (models/camlipwc_l.py) decode
level by level side by side, fused by CLFMs (nn/clfm.py) at up to three
points a level, as the `fusion` config switches them: the pyramid features,
the correlations, the estimators' flow features. Module and parameter names
follow the reference state_dict (`core.branch_2d_fnet`, `core.pyramid_clfms.
<i>`, ...) for the weight bridge (runtime/names.py).

Each level's CLFMs share one pixel-to-point cache per frame
(`fusion_interp_cache`, a 2-D KNN, #1 on a card): frame 1's serves the
pyramid, correlation and estimator CLFMs, frame 2's the pyramid CLFM. The
JAX package recomputes the same indices in each CLFM call. The 3D side's
kernels are CamLiPWC-L's; the level upsample interpolates the flow and the
64 flow-feature channels together (#3 at 67 channels); the convolutions'
algorithms are autotuned, as PWC's. Eval returns the final flows only.

Train mode (and eval with `with_pyramid`, as the trainer validates) also
returns every level's flows, `flows_2d` as PWC's and `flows_3d` as
CamLiPWC-L's (through IDS), and `sample_indices1`. In train mode every
interpolation of the 3D flow is `knn_interpolation_train` (#3 has no
backward) and the PointConvs gather with the plain gather (#12 has none
either); `freeze_bn` keeps every BatchNorm on its running statistics.
`loss_fn` and `is_better` are the JAX ones.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.clfm import CLFM, fusion_interp_cache
from ..nn.layers import BatchNorm, Conv2dNormAct, DenseNormAct, compute_precision, level_list
from ..ops.correlation import correlation2d
from ..ops.geometry import (
    backwarp_3d,
    build_pc_pyramid,
    k_nearest_neighbor,
    knn_interpolation,
    knn_interpolation_train,
)
from ..ops.ids import make_parallel_camera_info, paral2persp, persp2paral, project_pc2image
from ..ops.image import backwarp_2d, convex_upsample, resize_flow2d, resize_to_multiple
from ..utils.torch_setup import autotuned_convolutions
from .camlipwc_l import DEFAULT_N_SAMPLES, Correlation3DPWC, FeaturePyramid3D, FlowEstimator3D
from .losses import calc_pyramid_loss_2d, calc_pyramid_loss_3d
from .metrics import compute_2d_metrics, compute_3d_metrics, merge_metrics, scalar_metric
from .pwc import (
    PYRAMID_CHANNELS,
    ContextNetwork2D,
    FeaturePyramid2D,
    FlowEstimatorDense2D,
    FlowEstimatorLite2D,
    UpMaskHead,
    nchw,
    nhwc,
    upsample2x,
    upsample2x_flow,
    upsample_flow,
)


class CamLiPWCCore(nn.Module):
    """The two branches and their fusions; levels 5 to 1, then the 2D flow
    convex-upsampled x4 and the 3D flow interpolated to the full cloud."""

    def __init__(self, cfgs2d: dict, cfgs3d: dict, fusion: dict):
        super().__init__()
        self.max_displacement = int(cfgs2d["max_displacement"])
        self.k = int(cfgs3d["k"])
        self.fuse_pyramid = bool(fusion["fuse_pyramid"])
        self.fuse_correlation = bool(fusion["fuse_correlation"])
        self.fuse_estimator = bool(fusion["fuse_estimator"])
        corr_channels = (2 * self.max_displacement + 1) ** 2
        channels = PYRAMID_CHANNELS[1:]
        norm2d, norm3d = cfgs2d["norm"], cfgs3d["norm"]

        self.branch_2d_fnet = FeaturePyramid2D(PYRAMID_CHANNELS, norm=norm2d["feature_pyramid"])
        self.branch_2d_fnet_aligners = level_list(Conv2dNormAct(c, 64, 1) for c in channels)
        estimator = FlowEstimatorLite2D if cfgs2d["lite_estimator"] else FlowEstimatorDense2D
        self.branch_2d_flow_estimator = estimator(
            (64 + corr_channels + 2 + 32, 128, 128, 96, 64, 32),
            norm=norm2d["flow_estimator"], conv_last=not self.fuse_estimator)
        flow_feat_2d = self.branch_2d_flow_estimator.flow_feat_dim
        self.branch_2d_context_network = ContextNetwork2D(
            (flow_feat_2d + 2, 128, 128, 128, 96, 64, 32), norm=norm2d["context_network"])
        self.branch_2d_up_mask_head = UpMaskHead()

        self.branch_3d_fnet = FeaturePyramid3D(PYRAMID_CHANNELS, norm=norm3d["feature_pyramid"],
                                               k=self.k)
        self.branch_3d_fnet_aligners = level_list(DenseNormAct(c, 64) for c in channels)
        self.branch_3d_correlations = level_list(Correlation3DPWC(c, c, k=self.k)
                                                 for c in channels)
        self.branch_3d_correlation_aligners = level_list(DenseNormAct(c, 64) for c in channels)
        self.branch_3d_flow_estimator = FlowEstimator3D(
            (64 + 64 + 3 + 64, 128, 128, 64), norm=norm3d["flow_estimator"],
            conv_last=not self.fuse_estimator, k=self.k)

        if self.fuse_pyramid:
            self.pyramid_clfms = level_list(CLFM(c, c, norm=norm2d["feature_pyramid"])
                                            for c in channels)
        if self.fuse_correlation:
            self.corr_clfms = level_list(CLFM(corr_channels, c) for c in channels)
        if self.fuse_estimator:
            self.estimator_clfm = CLFM(flow_feat_2d, 64)
            self.branch_2d_conv_last = nn.Conv2d(flow_feat_2d, 2, 3, padding=1)
            self.branch_3d_conv_last = nn.Linear(64, 3)

    def decode(self, xyzs1, xyzs2, feats1_2d, feats2_2d, feats1_3d, feats2_3d, camera_info,
               pyramid: bool = False):
        """-> ([flow_2d [B, H, W, 2] at the resized images' size], [flow_3d
        [B, N, 3] at the full cloud]), in the parallel camera's space; with
        `pyramid`, every level's flows, finest first, the 2D ones at 4x
        their size, the 3D ones at the next finer level's points."""
        fused = self.fuse_pyramid or self.fuse_correlation or self.fuse_estimator
        interp3d = knn_interpolation_train if self.training else knn_interpolation
        flows_2d, flows_3d = [], []
        flow_2d = flow_3d = flow_feat_2d = flow_feat_3d = None
        for level in range(len(xyzs1) - 1, 0, -1):
            xyz1, feat1_2d, feat1_3d = xyzs1[level], feats1_2d[level], feats1_3d[level]
            xyz2, feat2_2d, feat2_3d = xyzs2[level], feats2_2d[level], feats2_3d[level]
            batch, image_h, image_w, _ = feat1_2d.shape

            # the points in this level's pixels (the sensor scaled to the
            # map), the scale filled on the device (a copy from the host
            # would make the host wait for the card)
            scale = torch.full((2,), (image_w - 1) / (camera_info["sensor_w"] - 1),
                               dtype=torch.float32, device=xyz1.device)
            scale[1] = (image_h - 1) / (camera_info["sensor_h"] - 1)
            uv1 = project_pc2image(xyz1, camera_info) * scale
            uv2 = project_pc2image(xyz2, camera_info) * scale
            knn_xyz1 = k_nearest_neighbor(xyz1, xyz1, self.k)
            cache1 = fusion_interp_cache(uv1, image_h, image_w) if fused else None

            if self.fuse_pyramid:
                clfm = self.pyramid_clfms[level]
                feat1_2d, feat1_3d = clfm(uv1, feat1_2d, feat1_3d, cache1)
                feat2_2d, feat2_3d = clfm(uv2, feat2_2d, feat2_3d,
                                          fusion_interp_cache(uv2, image_h, image_w))

            if flow_2d is None:
                last_flow_2d = feat1_2d.new_zeros(batch, image_h, image_w, 2)
                last_feat_2d = feat1_2d.new_zeros(batch, image_h, image_w, 32)
                last_flow_3d = torch.zeros_like(xyz1)
                last_feat_3d = feat1_3d.new_zeros(*xyz1.shape[:2], 64)
                xyz2_warp, feat2_2d_warp = xyz2, feat2_2d
            else:
                last_flow_2d = upsample2x_flow(flow_2d)
                last_feat_2d = upsample2x(flow_feat_2d)
                interp = interp3d(xyzs1[level + 1],
                                  torch.cat([flow_3d, flow_feat_3d.to(flow_3d.dtype)], dim=-1),
                                  xyz1)
                last_flow_3d, last_feat_3d = interp[..., :3], interp[..., 3:]
                feat2_2d_warp = backwarp_2d(feat2_2d, last_flow_2d, "border")
                xyz2_warp = backwarp_3d(xyz1, xyz2, last_flow_3d, train=self.training)

            feat_corr_3d = self.branch_3d_correlations[level](
                xyz1, feat1_3d, xyz2_warp, feat2_3d, knn_xyz1)
            feat_corr_2d = F.leaky_relu(
                correlation2d(feat1_2d, feat2_2d_warp, self.max_displacement),
                negative_slope=0.1)
            if self.fuse_correlation:
                feat_corr_2d, feat_corr_3d = self.corr_clfms[level](
                    uv1, feat_corr_2d, feat_corr_3d, cache1)

            feat1_2d = nhwc(self.branch_2d_fnet_aligners[level](nchw(feat1_2d)))
            feat1_3d = self.branch_3d_fnet_aligners[level](feat1_3d)
            feat_corr_3d = self.branch_3d_correlation_aligners[level](feat_corr_3d)
            x_2d = torch.cat([feat_corr_2d, feat1_2d, last_flow_2d.to(feat1_2d.dtype),
                              last_feat_2d.to(feat1_2d.dtype)], dim=-1)
            x_3d = torch.cat([feat_corr_3d, feat1_3d, last_flow_3d.to(feat1_3d.dtype),
                              last_feat_3d.to(feat1_3d.dtype)], dim=-1)

            if self.fuse_estimator:
                flow_feat_2d, flow_feat_3d = self.estimator_clfm(
                    uv1, self.branch_2d_flow_estimator(x_2d),
                    self.branch_3d_flow_estimator(xyz1, x_3d, knn_xyz1), cache1)
                flow_delta_2d = nhwc(self.branch_2d_conv_last(nchw(flow_feat_2d)))
                flow_delta_3d = self.branch_3d_conv_last(flow_feat_3d)
            else:
                flow_feat_2d, flow_delta_2d = self.branch_2d_flow_estimator(x_2d)
                flow_feat_3d, flow_delta_3d = self.branch_3d_flow_estimator(
                    xyz1, x_3d, knn_xyz1)
            flow_2d = last_flow_2d + flow_delta_2d.float()
            flow_3d = last_flow_3d + flow_delta_3d.float()

            # the context network refines the 2D flow only
            flow_feat_2d, flow_delta_2d = self.branch_2d_context_network(
                torch.cat([flow_feat_2d, flow_2d.to(flow_feat_2d.dtype)], dim=-1))
            flow_2d = torch.clamp(flow_delta_2d.float() + flow_2d, -1000.0, 1000.0)
            flow_3d = torch.clamp(flow_3d, -100.0, 100.0)
            flows_2d.append(flow_2d)
            flows_3d.append(flow_3d)

        flow_2d = convex_upsample(flow_2d, self.branch_2d_up_mask_head(flow_feat_2d),
                                  scale_factor=4)
        levels = len(flows_3d) if pyramid else 1
        return ([flow_2d] + [upsample_flow(f, 4) for f in flows_2d[-2::-1] if pyramid],
                [interp3d(xyzs1[i + 1], f, xyzs1[i])
                 for i, f in enumerate(flows_3d[::-1][:levels])])

    def forward(self, image1, image2, xyzs1, xyzs2, camera_info, pyramid: bool = False):
        return self.decode(xyzs1, xyzs2, self.branch_2d_fnet(image1),
                           self.branch_2d_fnet(image2), self.branch_3d_fnet(xyzs1),
                           self.branch_3d_fnet(xyzs2), camera_info, pyramid)


class CamLiPWC(nn.Module):
    """Model wrapper: images to [0, 1], resized up to multiples of 64; IDS
    onto a parallel camera of the resized size; the FPS pyramids; the core;
    the 2D flow resized back and the 3D flow back through IDS. In train mode
    (and with `with_pyramid`) it also returns `flows_2d`, `flows_3d` and
    `sample_indices1`; train mode computes under `compute_dtype` (bf16
    autocast or f32), eval stays f32. `freeze_bn` keeps every BatchNorm on
    its running statistics in train mode."""

    CONV_BENCHMARK = True  # train_step runs the backward under autotuning too

    def __init__(self, cfgs: dict):
        super().__init__()
        self.with_pyramid = False
        self.freeze_bn = bool(cfgs.get("freeze_bn", False))
        self.compute_dtype = cfgs.get("compute_dtype")
        compute_precision(self.compute_dtype, "cpu")  # raises on a dtype it does not know
        self.n_samples_list = tuple(cfgs.get("n_samples_list", DEFAULT_N_SAMPLES))
        self.core = CamLiPWCCore(cfgs["pwc2d"], cfgs["pwc3d"], cfgs["fusion"])

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.freeze_bn:
            for module in self.modules():
                if isinstance(module, BatchNorm):
                    module.eval()
        return self

    def forward(self, inputs: dict) -> dict:
        images = inputs["images"].float() / 255.0
        pcs = inputs["pcs"].float()
        pc1, pc2 = pcs[..., :3], pcs[..., 3:]
        intrinsics = inputs["intrinsics"].float()

        origin_h, origin_w = images.shape[1:3]
        images, _ = resize_to_multiple(images, None, x=64)
        image1, image2 = images[..., :3].contiguous(), images[..., 3:].contiguous()
        persp_cam = {"projection_mode": "perspective", "sensor_h": origin_h,
                     "sensor_w": origin_w, "f": intrinsics[:, 0], "cx": intrinsics[:, 1],
                     "cy": intrinsics[:, 2]}
        paral_cam = make_parallel_camera_info(image1.shape[1], image1.shape[2])
        pc1 = persp2paral(pc1, persp_cam, paral_cam)
        pc2 = persp2paral(pc2, persp_cam, paral_cam)
        xyzs1, xyzs2, sample_indices1, _ = build_pc_pyramid(pc1, pc2,
                                                            list(self.n_samples_list))

        pyramid = self.training or self.with_pyramid
        dtype = self.compute_dtype if self.training else None
        with autotuned_convolutions(), compute_precision(dtype, image1.device.type):
            flows_2d, flows_3d = self.core(image1, image2, xyzs1, xyzs2, paral_cam, pyramid)
        flows_3d = [paral2persp(xyz + flow, persp_cam, paral_cam)
                    - paral2persp(xyz, persp_cam, paral_cam) for xyz, flow in zip(xyzs1, flows_3d)]
        out = {"flow_2d": resize_flow2d(flows_2d[0], origin_h, origin_w), "flow_3d": flows_3d[0]}
        if not pyramid:
            return out
        return {**out, "flows_2d": flows_2d, "flows_3d": flows_3d,
                "sample_indices1": sample_indices1}


def loss_fn(outputs: dict, inputs: dict, cfgs) -> tuple[torch.Tensor, dict]:
    """The 2D and 3D pyramid losses and metrics (the JAX `loss_fn`)."""
    target_2d, target_3d = inputs["flow_2d"], inputs["flow_3d"]
    loss_2d = calc_pyramid_loss_2d(outputs["flows_2d"], target_2d,
                                   level_weights=list(cfgs["loss2d"]["level_weights"]),
                                   order=cfgs["loss2d"]["order"])
    loss_3d = calc_pyramid_loss_3d(outputs["flows_3d"], target_3d,
                                   level_weights=list(cfgs["loss3d"]["level_weights"]),
                                   order=cfgs["loss3d"]["order"],
                                   indices=outputs["sample_indices1"])
    loss = loss_2d + loss_3d
    metrics = merge_metrics(
        {"loss": scalar_metric(loss), "loss2d": scalar_metric(loss_2d),
         "loss3d": scalar_metric(loss_3d)},
        compute_2d_metrics(outputs["flow_2d"], target_2d),
        compute_3d_metrics(outputs["flow_3d"], target_3d),
    )
    if "occ_mask_3d" in inputs:
        metrics = merge_metrics(metrics, compute_3d_metrics(
            outputs["flow_3d"], target_3d, occ_mask=inputs["occ_mask_3d"]))
    return loss, metrics


def is_better(curr: dict, best: dict | None) -> bool:
    return best is None or curr["epe2d"] < best["epe2d"]
