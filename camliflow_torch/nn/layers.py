"""Dense/norm/act building blocks on channel-last data.

PyTorch counterpart of camliflow_tpu/nn/layers.py. A 1x1 conv on channel-last
data is a Linear over the last axis. Module and parameter names follow the
reference PyTorch state_dict (`convs.<i>.conv_fn`, `convs.<i>.norm_fn`), so
`runtime/names.py::our_path_to_torch` names every key.
"""

from __future__ import annotations

import contextlib
from collections.abc import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel import dist


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


def compute_precision(dtype: str | None, device_type: str = "cuda"):
    """The `compute_dtype` config key as a context: `"bfloat16"` runs the
    forward under a bf16 `torch.autocast` (matrix products and convolutions
    in bf16; parameters, the cost volumes and the selections stay f32),
    None or `"float32"` leaves everything f32. Any other string raises
    (the JAX package turns an unknown one, `"bf16"` say, into f32 silently)."""
    if dtype in (None, "float32"):
        return contextlib.nullcontext()
    if dtype == "bfloat16":
        return torch.autocast(device_type, dtype=torch.bfloat16)
    raise ValueError(f"compute_dtype must be bfloat16 or float32, got {dtype!r}")


def full_precision(device_type: str):
    """An f32 island inside `compute_precision`: autocast off."""
    return torch.autocast(device_type, enabled=False)


class BatchNorm(nn.Module):
    """BatchNorm over the channel axis, the last (`channel_dim=-1`, data of
    any rank) or dim 1 (`channel_dim=1`, NCHW). Eval normalises with the
    running statistics, eps 1e-5. Train normalises with the batch
    statistics and updates the running ones as Flax does: with the biased
    batch variance (torch's own update takes the unbiased one), momentum
    0.1 (Flax's 0.9). With a group of more than one rank
    (`parallel/dist.py`), train mode takes the statistics of the global
    batch, as BatchNorm does over the JAX package's mesh, in two passes
    as one process takes them: the mean from the ranks' counts and sums
    (f32), then the biased variance from their sums of squared deviations
    from it, each all-reduced by a differentiable sum, so the backward sums
    the statistics' gradients over the ranks. (One pass, E[x^2] - E[x]^2
    as Flax computes it, lost ~3e-6 of the variance where the 3D encoder's
    features sit about five standard deviations from 0.) Every rank updates
    the running statistics alike. Eval mode issues no collective."""

    def __init__(self, channels: int, eps: float = 1e-5, momentum: float = 0.1,
                 channel_dim: int = -1):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # F.batch_norm takes dim 1 as the channels: [N, C] or [N, C, H, W]
        flat = x if self.channel_dim == 1 else x.reshape(-1, x.shape[-1])
        if not self.training:
            out = F.batch_norm(flat, self.running_mean, self.running_var, self.weight,
                               self.bias, False, 0.0, self.eps)
            return out.reshape(x.shape)
        if dist.spread():
            return self._global_batch_norm(flat).reshape(x.shape)
        with torch.no_grad():
            stats = flat.to(self.running_mean.dtype)
            dims = [d for d in range(stats.dim()) if d != 1]
            mean = stats.mean(dim=dims)
            shape = [-1 if d == 1 else 1 for d in range(stats.dim())]
            var = (stats - mean.reshape(shape)).square().mean(dim=dims)
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(var, self.momentum)
        out = F.batch_norm(flat, None, None, self.weight, self.bias, True, 0.0, self.eps)
        return out.reshape(x.shape)

    def _global_batch_norm(self, flat: torch.Tensor) -> torch.Tensor:
        """Train mode over every rank's batch; `flat` has its channels at dim 1."""
        x = flat.float()
        dims = [d for d in range(x.dim()) if d != 1]
        channels = x.shape[1]
        shape = [-1 if d == 1 else 1 for d in range(x.dim())]
        count = x.new_full((1,), x.numel() // channels)
        sums = dist.sum_over_ranks(torch.cat([x.sum(dims), count]))
        mean = sums[:channels] / sums[-1]
        centered = x - mean.reshape(shape)
        var = dist.sum_over_ranks(centered.square().sum(dims)) / sums[-1]
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach(), self.momentum)
            self.running_var.lerp_(var.detach(), self.momentum)
        out = centered * torch.rsqrt(var + self.eps).reshape(shape)
        out = out * self.weight.float().reshape(shape) + self.bias.float().reshape(shape)
        return out.to(flat.dtype)


def _channel_shape(x: torch.Tensor, channel_dim: int) -> list[int]:
    """A per-channel vector's shape broadcast against x."""
    shape = [1] * x.dim()
    shape[channel_dim] = -1
    return shape


class InstanceNorm(nn.Module):
    """Per-sample normalisation over the spatial axes (every axis but the
    batch's and the channels'), with the biased variance, eps 1e-5; with
    `affine` a per-channel weight (1) and bias (0), without it none (torch's
    InstanceNorm default, as the reference takes it). Channels last
    (`channel_dim=-1`) or at dim 1 (NCHW)."""

    def __init__(self, channels: int, affine: bool = False, eps: float = 1e-5,
                 channel_dim: int = -1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        channel_dim = self.channel_dim % x.dim()
        axes = [d for d in range(1, x.dim()) if d != channel_dim]
        var, mean = torch.var_mean(x, dim=axes, correction=0, keepdim=True)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            shape = _channel_shape(x, channel_dim)
            y = y * self.weight.reshape(shape) + self.bias.reshape(shape)
        return y


class LayerNorm(nn.Module):
    """Normalisation over the channel axis alone, eps 1e-6, a per-channel
    weight and bias (the reference's LayerNormCF). The variance is the
    two-pass mean of squared deviations (`F.layer_norm`); Flax's LayerNorm,
    which the JAX package uses, takes E[x^2] - E[x]^2, which differs from
    it by about 2^-24 (mean^2 + var) / var relative."""

    def __init__(self, channels: int, eps: float = 1e-6, channel_dim: int = -1):
        super().__init__()
        self.eps = eps
        self.channel_dim = channel_dim
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.movedim(self.channel_dim, -1)
        y = F.layer_norm(y, self.weight.shape, self.weight, self.bias, self.eps)
        return y.movedim(-1, self.channel_dim)


def Norm(norm: str | None, channels: int, channel_dim: int = -1) -> nn.Module:
    """The reference's norm-name strings."""
    if norm is None:
        return nn.Identity()
    if norm == "batch_norm":
        return BatchNorm(channels, channel_dim=channel_dim)
    if norm in ("instance_norm", "instance_norm_affine"):
        return InstanceNorm(channels, affine=norm == "instance_norm_affine",
                            channel_dim=channel_dim)
    if norm == "layer_norm":
        return LayerNorm(channels, channel_dim=channel_dim)
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
    """KxK conv + norm + act on NCHW data. Symmetric padding
    dilation*(k-1)//2 on both sides, also under a stride, as the reference
    pads; the conv has a bias iff there is no norm. (cuDNN's f32
    convolutions are NCHW kernels: a channels-last input costs a transpose
    in and out of each.)"""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 1,
                 stride: int = 1, dilation: int = 1, norm: str | None = None,
                 act: str | None = "leaky_relu"):
        super().__init__()
        self.conv_fn = nn.Conv2d(in_channels, out_channels, kernel_size, stride=stride,
                                 padding=dilation * (kernel_size - 1) // 2,
                                 dilation=dilation, bias=norm is None)
        self.norm_fn = Norm(norm, out_channels, channel_dim=1)
        self.act = act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_act(self.norm_fn(self.conv_fn(x)), self.act)


def level_list(modules) -> nn.ModuleList:
    """A coarse-to-fine model's modules of pyramid levels 1, 2, ... at their
    level's index: index 0 holds an `nn.Identity` (the reference's None),
    so the state_dict numbers them as the reference does."""
    return nn.ModuleList([nn.Identity(), *modules])
