"""The RAFT 2D update modules (eval): MotionEncoder2D, GRU2D, FlowHead2D and
ConvexUpsampler2D.

PyTorch counterpart of camliflow_tpu/models/raft.py:44-105. Each conv is a
`Conv2d` with bias and symmetric padding, named as in the reference
state_dict. A module's `forward` is the plain chain of ops/update2d.py on
its own weights, NHWC in and out; the refinement loop instead hoists the
packed weights once per request and calls the kernel wrappers there.
"""

from __future__ import annotations

from torch import nn

from ..ops import update2d
from ..ops.image import convex_upsample


def _conv(cin: int, cout: int, kernel: tuple[int, int]) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, padding=tuple((k - 1) // 2 for k in kernel))


class MotionEncoder2D(nn.Module):
    """corr + flow -> motion features [.., 126 conv channels + 2 flow]."""

    def __init__(self, corr_channels: int = 324):
        super().__init__()
        self.conv_c1 = _conv(corr_channels, 256, (1, 1))
        self.conv_c2 = _conv(256, 192, (3, 3))
        self.conv_f1 = _conv(2, 128, (7, 7))
        self.conv_f2 = _conv(128, 64, (3, 3))
        self.conv = _conv(192 + 64, 128 - 2, (3, 3))

    def forward(self, flow, corr):
        params = update2d.prepare_motion_encoder_params(self)
        return update2d.motion_encoder_2d_plain(flow, corr, params)


class GRU2D(nn.Module):
    """Separable 1x5 + 5x1 ConvGRU."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, kernel in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}{suffix}", _conv(cin, hidden_dim, kernel))

    def forward(self, h, x):
        return update2d.gru_2d_plain(h, x, update2d.prepare_gru_params(self))


class FlowHead2D(nn.Module):
    """Hidden state -> delta flow."""

    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = _conv(input_dim, hidden_dim, (3, 3))
        self.conv2 = _conv(hidden_dim, 2, (3, 3))

    def forward(self, h):
        return update2d.flow_head_2d_plain(h, update2d.prepare_flow_head_params(self))


class ConvexUpsampler2D(nn.Module):
    """Learned convex upsampling mask, 0.25-scaled."""

    def __init__(self, input_dim: int = 128, scale_factor: int = 8):
        super().__init__()
        self.scale_factor = scale_factor
        self.mask = nn.Sequential(
            _conv(input_dim, 256, (3, 3)), nn.ReLU(),
            _conv(256, scale_factor * scale_factor * 9, (1, 1)),
        )

    def forward(self, h, flow):
        mask = self.mask(h.float().permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return convex_upsample(flow, 0.25 * mask, self.scale_factor)
