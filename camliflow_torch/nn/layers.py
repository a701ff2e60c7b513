"""Dense/norm/act building blocks on channel-last data.

PyTorch counterpart of camliflow_tpu/nn/layers.py. A 1x1 conv on channel-last
data is a Linear over the last axis. Module and parameter names follow the
reference PyTorch state_dict (`convs.<i>.conv_fn`, `convs.<i>.norm_fn`), so
`runtime/names.py::our_path_to_torch` names every key.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn


def apply_act(x: torch.Tensor, act: str | None) -> torch.Tensor:
    if act is None:
        return x
    if act == "relu":
        return F.relu(x)
    if act == "leaky_relu":
        return F.leaky_relu(x, negative_slope=0.1)
    if act == "sigmoid":
        return torch.sigmoid(x)
    if act == "tanh":
        return torch.tanh(x)
    raise NotImplementedError(f"Unknown activation function: {act}")


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis of data of any rank. Eval
    normalises with the running statistics, eps 1e-5."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = F.batch_norm(
            x.reshape(-1, x.shape[-1]), self.running_mean, self.running_var,
            self.weight, self.bias, self.training, self.momentum, self.eps,
        )
        return flat.reshape(x.shape)


def Norm(norm: str | None, channels: int) -> nn.Module:
    """The reference's norm-name strings; only those CamLiRAFT-L uses."""
    if norm is None:
        return nn.Identity()
    if norm == "batch_norm":
        return BatchNorm(channels)
    raise NotImplementedError(f"Unknown normalization function: {norm}")


class DenseNormAct(nn.Module):
    """1x1 conv + norm + act; the conv has a bias iff there is no norm."""

    def __init__(self, in_channels: int, out_channels: int,
                 norm: str | None = None, act: str | None = "leaky_relu"):
        super().__init__()
        self.conv_fn = nn.Linear(in_channels, out_channels, bias=norm is None)
        self.norm_fn = Norm(norm, out_channels)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(self.norm_fn(self.conv_fn(x)), self.act)


class MLP(nn.Module):
    """Stack of DenseNormAct."""

    def __init__(self, in_channels: int, mlp_channels: Sequence[int],
                 norm: str | None = None, act: str | None = "leaky_relu"):
        super().__init__()
        widths = [in_channels, *mlp_channels]
        self.convs = nn.ModuleList(
            DenseNormAct(i, o, norm=norm, act=act)
            for i, o in zip(widths[:-1], widths[1:])
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv in self.convs:
            x = conv(x)
        return x


class Conv2dNormAct(nn.Module):
    """KxK conv (symmetric padding, bias) + act on NCHW data. Only the form
    without a norm is ported (the ResNet align conv)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 act: str | None = "leaky_relu"):
        super().__init__()
        self.conv_fn = nn.Conv2d(in_channels, out_channels, kernel_size,
                                 padding=(kernel_size - 1) // 2)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(self.conv_fn(x), self.act)
