"""PWC-Net: 2D optical flow, coarse to fine with local cost volumes, eval
and training.

PyTorch counterpart of camliflow_tpu/models/pwc.py. Module and parameter
names follow the reference PyTorch state_dict (`core.feature_pyramid.
pyramid_convs.<i>`, `core.pyramid_feature_aligners.<i>`, ...), so the weight
bridge names every key with runtime/names.py (a per-level list is a
`level_list`: levels 1-5 at their own index). Modules take and return NHWC;
inside, a module's chain of convolutions runs on one contiguous NCHW copy.
Eval returns the final flow only; train mode (and eval with
`with_pyramid`, as the trainer validates) also every level's flow at 4x its
size, `flows_2d`, finest first, which the pyramid loss reads. In train mode
the feature pyramid's BatchNorms take batch statistics, each frame's call
updating the running ones in turn, as Flax's mutable `batch_stats` does.
No kernel of the port is on this path, in eval or training: the cost volume
and the warps are plain PyTorch, as the JAX package computes them in XLA,
and the convolutions are cuDNN's, their algorithms autotuned
(`utils/torch_setup.py`), in training for the backward too
(`CONV_BENCHMARK`, read by `runtime/train_state.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.layers import Conv2dNormAct, compute_precision, level_list
from ..ops.correlation import correlation2d
from ..ops.gridsample import resize_bilinear_align_corners
from ..ops.image import backwarp_2d, convex_upsample, resize_flow2d, resize_to_multiple
from ..utils.torch_setup import autotuned_convolutions
from .losses import calc_pyramid_loss_2d
from .metrics import compute_2d_metrics, merge_metrics, scalar_metric

PYRAMID_CHANNELS = (16, 32, 64, 96, 128, 192)
CONTEXT_DILATIONS = (1, 2, 4, 8, 16, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    """NHWC -> contiguous NCHW (cuDNN's f32 convolutions are NCHW kernels)."""
    return x.permute(0, 3, 1, 2).contiguous()


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW -> an NHWC view (its consumer copies it where it must)."""
    return x.permute(0, 2, 3, 1)


def upsample2x(feat: torch.Tensor) -> torch.Tensor:
    """[B, h, w, C] -> [B, 2h, 2w, C], bilinear with align_corners=True."""
    h, w = feat.shape[1:3]
    return resize_bilinear_align_corners(feat, 2 * h, 2 * w)


def upsample2x_flow(flow: torch.Tensor) -> torch.Tensor:
    """A coarser level's flow at this level: twice the size, twice the
    magnitude."""
    return upsample2x(flow * 2.0)


def upsample_flow(flow: torch.Tensor, scale: int) -> torch.Tensor:
    """A level's flow `scale` times the size and magnitude, bilinear with
    align_corners=True (the pyramid loss's coarser levels)."""
    h, w = flow.shape[1:3]
    return resize_bilinear_align_corners(flow * float(scale), h * scale, w * scale)


def flow_conv(in_channels: int) -> nn.Conv2d:
    """The 3x3 flow head of the estimators and the context network."""
    return nn.Conv2d(in_channels, 2, 3, padding=1)


class ResidualBlock(nn.Module):
    """Stride-2 residual block: 1x1 shortcut, 3x3 + 3x3 (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int, norm: str | None = None):
        super().__init__()
        self.down0 = Conv2dNormAct(in_channels, out_channels, 1, stride=2, norm=norm, act=None)
        self.conv0 = Conv2dNormAct(in_channels, out_channels, 3, stride=2, norm=norm)
        self.conv1 = Conv2dNormAct(out_channels, out_channels, 3, norm=norm, act=None)

    def forward(self, x):
        return F.leaky_relu(self.conv1(self.conv0(x)) + self.down0(x), negative_slope=0.1)


class FeaturePyramid2D(nn.Module):
    """6 residual blocks: image [B, H, W, 3] -> features at 1/2 .. 1/64."""

    def __init__(self, n_channels=PYRAMID_CHANNELS, norm: str | None = None):
        super().__init__()
        widths = (3, *n_channels)
        self.pyramid_convs = nn.ModuleList(
            ResidualBlock(i, o, norm=norm) for i, o in zip(widths[:-1], widths[1:])
        )

    def forward(self, image):
        x, outputs = nchw(image), []
        for block in self.pyramid_convs:
            x = block(x)
            outputs.append(nhwc(x))
        return outputs


class FlowEstimatorLite2D(nn.Module):
    """Five 3x3 convs, each of the two before it; flow features [x4, x5]."""

    def __init__(self, n_channels, norm: str | None = None, conv_last: bool = True):
        super().__init__()
        c = n_channels
        self.flow_feat_dim = c[4] + c[5]
        self.conv1 = Conv2dNormAct(c[0], c[1], 3, norm=norm)
        self.conv2 = Conv2dNormAct(c[1], c[2], 3, norm=norm)
        self.conv3 = Conv2dNormAct(c[1] + c[2], c[3], 3, norm=norm)
        self.conv4 = Conv2dNormAct(c[2] + c[3], c[4], 3, norm=norm)
        self.conv5 = Conv2dNormAct(c[3] + c[4], c[5], 3, norm=norm)
        self.conv_last = flow_conv(self.flow_feat_dim) if conv_last else None

    def forward(self, x):
        """x [B, H, W, C] -> flow features (and the flow delta [B, H, W, 2]
        with conv_last), NHWC."""
        x1 = self.conv1(nchw(x))
        x2 = self.conv2(x1)
        x3 = self.conv3(torch.cat([x1, x2], dim=1))
        x4 = self.conv4(torch.cat([x2, x3], dim=1))
        x5 = self.conv5(torch.cat([x3, x4], dim=1))
        flow_feat = torch.cat([x4, x5], dim=1)
        if self.conv_last is None:
            return nhwc(flow_feat)
        return nhwc(flow_feat), nhwc(self.conv_last(flow_feat))


class FlowEstimatorDense2D(nn.Module):
    """DenseNet-style: five 3x3 convs, each output stacked in front of its
    input; the flow features are the whole stack."""

    def __init__(self, n_channels, norm: str | None = None, conv_last: bool = True):
        super().__init__()
        c = n_channels
        self.flow_feat_dim = sum(c)
        for i in range(1, 6):
            self.add_module(f"conv{i}", Conv2dNormAct(sum(c[:i]), c[i], 3, norm=norm))
        self.conv_last = flow_conv(self.flow_feat_dim) if conv_last else None

    def forward(self, x):
        x = nchw(x)
        for i in range(1, 6):
            x = torch.cat([getattr(self, f"conv{i}")(x), x], dim=1)
        if self.conv_last is None:
            return nhwc(x)
        return nhwc(x), nhwc(self.conv_last(x))


class ContextNetwork2D(nn.Module):
    """Dilated 3x3 convs, then the flow head: (features, flow delta), NHWC."""

    def __init__(self, n_channels, dilations=CONTEXT_DILATIONS, norm: str | None = None):
        super().__init__()
        self.convs = nn.ModuleList(
            Conv2dNormAct(i, o, 3, dilation=d, norm=norm)
            for i, o, d in zip(n_channels[:-1], n_channels[1:], dilations)
        )
        self.conv_last = flow_conv(n_channels[-1])

    def forward(self, x):
        x = nchw(x)
        for conv in self.convs:
            x = conv(x)
        return nhwc(x), nhwc(self.conv_last(x))


class UpMaskHead(nn.Sequential):
    """The mask logits of the x4 convex upsampling, NHWC in and out."""

    def __init__(self, in_channels: int = 32):
        super().__init__(nn.Conv2d(in_channels, 64, 3, padding=1), nn.ReLU(),
                         nn.Conv2d(64, 4 * 4 * 9, 1))

    def forward(self, x):
        return nhwc(super().forward(nchw(x)))


class PWCCore(nn.Module):
    """2D coarse-to-fine core: levels 5 (1/64) to 1 (1/4), then the x4 convex
    upsampling of level 1's flow."""

    def __init__(self, max_displacement: int = 4, lite_estimator: bool = False,
                 norm_feature_pyramid: str | None = "batch_norm",
                 norm_flow_estimator: str | None = None,
                 norm_context_network: str | None = None):
        super().__init__()
        self.max_displacement = max_displacement
        corr_channels = (2 * max_displacement + 1) ** 2
        self.feature_pyramid = FeaturePyramid2D(PYRAMID_CHANNELS, norm=norm_feature_pyramid)
        self.pyramid_feature_aligners = level_list(
            Conv2dNormAct(c, 64, 1) for c in PYRAMID_CHANNELS[1:])
        estimator = FlowEstimatorLite2D if lite_estimator else FlowEstimatorDense2D
        self.flow_estimator = estimator((64 + corr_channels + 2, 128, 128, 96, 64, 32),
                                        norm=norm_flow_estimator)
        self.context_network = ContextNetwork2D(
            (self.flow_estimator.flow_feat_dim + 2, 128, 128, 128, 96, 64, 32),
            norm=norm_context_network)
        self.up_mask_head = UpMaskHead()

    def decode(self, feats1, feats2, pyramid: bool = False):
        """-> [the final flow [B, H, W, 2]]; with `pyramid`, every level's
        flow, finest first: level 1's convex-upsampled x4 (the final flow),
        each coarser one resized x4."""
        flow = flow_feat = None
        flows = []
        for level in range(len(feats1) - 1, 0, -1):
            feat1, feat2 = feats1[level], feats2[level]
            if flow is None:
                last_flow = feat1.new_zeros(*feat1.shape[:3], 2, dtype=torch.float32)
                feat2_warp = feat2
            else:
                last_flow = upsample2x_flow(flow)
                feat2_warp = backwarp_2d(feat2, last_flow, "border")
            corr = F.leaky_relu(correlation2d(feat1, feat2_warp, self.max_displacement),
                                negative_slope=0.1)
            aligned = nhwc(self.pyramid_feature_aligners[level](nchw(feat1)))
            flow_feat, flow_delta = self.flow_estimator(
                torch.cat([corr, aligned, last_flow], dim=-1))
            flow = flow_delta + last_flow
            flow_feat, flow_delta = self.context_network(torch.cat([flow_feat, flow], dim=-1))
            flow = flow_delta + flow
            flows.append(flow)
        final = convex_upsample(flow, self.up_mask_head(flow_feat), scale_factor=4)
        return [final] + [upsample_flow(f.float(), 4) for f in flows[-2::-1] if pyramid]

    def forward(self, image1, image2, pyramid: bool = False):
        """Images [B, H, W, 3] in [0, 1], H and W multiples of 64 -> the
        flows of `decode`."""
        return self.decode(self.feature_pyramid(image1), self.feature_pyramid(image2), pyramid)


class PWC(nn.Module):
    """Model wrapper: images to [0, 1], resized up to multiples of 64, the
    core, the flow resized back. In train mode (and with `with_pyramid`) it
    also returns `flows_2d`; train mode computes under `compute_dtype`
    (bf16 autocast or f32), eval stays f32."""

    CONV_BENCHMARK = True  # train_step runs the backward under autotuning too

    def __init__(self, cfgs: dict):
        super().__init__()
        self.with_pyramid = False
        self.compute_dtype = cfgs.get("compute_dtype")
        compute_precision(self.compute_dtype, "cpu")  # raises on a dtype it does not know
        norm = cfgs["norm"]
        self.core = PWCCore(
            max_displacement=int(cfgs["max_displacement"]),
            lite_estimator=bool(cfgs["lite_estimator"]),
            norm_feature_pyramid=norm["feature_pyramid"],
            norm_flow_estimator=norm["flow_estimator"],
            norm_context_network=norm["context_network"],
        )

    def forward(self, inputs: dict) -> dict:
        images = inputs["images"].float() / 255.0
        origin_h, origin_w = images.shape[1:3]
        images, _ = resize_to_multiple(images, None, x=64)
        image1, image2 = images[..., :3].contiguous(), images[..., 3:].contiguous()
        pyramid = self.training or self.with_pyramid
        dtype = self.compute_dtype if self.training else None
        with autotuned_convolutions(), compute_precision(dtype, image1.device.type):
            flows = self.core(image1, image2, pyramid)
        out = {"flow_2d": resize_flow2d(flows[0], origin_h, origin_w)}
        return {**out, "flows_2d": flows} if pyramid else out


def loss_fn(outputs: dict, inputs: dict, cfgs) -> tuple[torch.Tensor, dict]:
    """Pyramid loss and metrics (the JAX `loss_fn`)."""
    target_2d = inputs["flow_2d"]
    loss = calc_pyramid_loss_2d(outputs["flows_2d"], target_2d,
                                level_weights=list(cfgs["loss"]["level_weights"]),
                                order=cfgs["loss"]["order"])
    return loss, merge_metrics({"loss2d": scalar_metric(loss)},
                               compute_2d_metrics(outputs["flow_2d"], target_2d))


def is_better(curr: dict, best: dict | None) -> bool:
    return best is None or curr["epe2d"] < best["epe2d"]
