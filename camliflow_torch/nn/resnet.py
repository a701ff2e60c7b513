"""ResNet encoder cut at stage 2 (stride-8 output), NHWC in and out.

PyTorch counterpart of camliflow_tpu/nn/resnet.py: the mmdet ResNet
configuration of the reference (depth 50, two stages, strides (1, 2), stride
on the 3x3, norm_eval) followed by a 1x1 align conv to 128 channels with
bias and leaky ReLU. The backbone's BatchNorms always normalise with their
running statistics (eps 1e-5). Inside, data is NCHW for `F.conv2d`; module
names are the torchvision ones (`layer1.0.conv1`, `layer1.0.downsample.0`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2dNormAct

# (planes per stage, blocks per stage, block type) for the torchvision depths
_STAGE_SPECS = {
    18: ((64, 128), (2, 2), "basic"),
    34: ((64, 128), (3, 4), "basic"),
    50: ((64, 128), (3, 4), "bottleneck"),
    101: ((64, 128), (3, 4), "bottleneck"),
}


class BatchNorm2d(BatchNorm):
    """BatchNorm over NCHW data, always with the running statistics."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight,
                            self.bias, False, 0.0, self.eps)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 1), BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3, stride), BatchNorm2d(planes)
        self.conv3, self.bn3 = _conv(planes, planes * 4, 1), BatchNorm2d(planes * 4)
        self.downsample = (
            nn.Sequential(_conv(cin, planes * 4, 1, stride), BatchNorm2d(planes * 4))
            if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, planes, 3, stride), BatchNorm2d(planes)
        self.conv2, self.bn2 = _conv(planes, planes, 3), BatchNorm2d(planes)
        self.downsample = (
            nn.Sequential(_conv(cin, planes, 1, stride), BatchNorm2d(planes))
            if downsample else None
        )

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class ResNetEncoder2D(nn.Module):
    """Stem + 2 stages (stride-8 output) + 1x1 align conv to `out_channels`."""

    def __init__(self, depth: int = 50, out_channels: int = 128):
        super().__init__()
        planes_list, blocks_list, block_type = _STAGE_SPECS[depth]
        block_cls = BottleneckBlock if block_type == "bottleneck" else BasicBlock
        # stem: 7x7/2 pad 3 + BN + relu, then a 3x3/2 max-pool
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        for stage, (planes, n_blocks) in enumerate(zip(planes_list, blocks_list)):
            stride = 1 if stage == 0 else 2
            blocks = []
            for block in range(n_blocks):
                s = stride if block == 0 else 1
                needs_ds = block == 0 and (s != 1 or cin != planes * block_cls.expansion)
                blocks.append(block_cls(cin, planes, s, needs_ds))
                cin = planes * block_cls.expansion
            self.add_module(f"layer{stage + 1}", nn.Sequential(*blocks))
        self.align = Conv2dNormAct(cin, out_channels, kernel_size=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, H/8, W/8, out_channels]."""
        x = F.relu(self.bn1(self.conv1(x.permute(0, 3, 1, 2))))
        # the -inf padding of the reference pool is max_pool2d's own
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        x = self.layer2(self.layer1(x))
        return self.align(x).permute(0, 2, 3, 1).contiguous()
