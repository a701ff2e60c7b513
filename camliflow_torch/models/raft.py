"""RAFT: 2D optical flow with all-pairs correlation and a ConvGRU (eval),
and its 2D update modules, which the flagship's 2D branch shares.

PyTorch counterpart of camliflow_tpu/models/raft.py on its exact path: the
all-pairs volume stays f32, the refinement `nn.scan` is a Python loop and
eval is final-only (one convex upsample of the last flow). Each conv is a
`Conv2d` with bias and symmetric padding, named as in the reference
state_dict (`core.fnet`, `core.correlation.fnet_aligner`, `core.gru`, ...).
A module's `forward` is the plain chain of ops/update2d.py on its own
weights, NHWC in and out; the refinement loop instead hoists the packed
weights once per request and runs the whole iteration (motion encoder, GRU,
flow head) as kernel #10 from one entry point (`update2d.update_2d`): ten
launches of the 3xTF32 tensor-core conv tile.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.resnet import ResNetEncoder2D
from ..ops import update2d
from ..ops.correlation import (
    all_pairs_correlation_pyramid,
    corr_lookup_2d,
    resolve_lookup_storage,
)
from ..ops.image import InputPadder, convex_upsample, mesh_grid
from .camliraft_l import resolve_fast_inference

CORR_RADIUS = 4
CORR_LEVELS = 4


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


class Correlation2D(nn.Module):
    """Holds the fnet aligner under the reference's name."""

    def __init__(self):
        super().__init__()
        self.fnet_aligner = nn.Linear(128, 256)


class UpdateBlock2D(nn.Module):
    """One RAFT iteration: the windowed lookup, then kernel #10. `pack`
    repacks the three modules' weights for it, once per request."""

    def __init__(self, corr_radius: int = CORR_RADIUS, corr_levels: int = CORR_LEVELS):
        super().__init__()
        self.corr_radius = corr_radius
        self.motion_encoder = MotionEncoder2D(corr_channels=corr_levels * (2 * corr_radius + 1) ** 2)
        self.gru = GRU2D(hidden_dim=128, input_dim=256)
        self.flow_head = FlowHead2D()
        self.convex_upsampler = ConvexUpsampler2D()

    def pack(self):
        return update2d.prepare_update_2d_params(self.motion_encoder, self.gru, self.flow_head)

    def forward(self, h, flow, consts):
        corr = corr_lookup_2d(consts["pyramid"], consts["grid"] + flow, radius=self.corr_radius)
        h, delta = update2d.update_2d(h, consts["x"], flow, corr, *consts["packed"])
        return h, flow + delta


class RAFTCore(nn.Module):
    """Standalone 2D RAFT loop, eval (final-only)."""

    def __init__(self, n_iters: int = 12, backbone_depth: int = 50):
        super().__init__()
        self.n_iters = n_iters
        self.fnet = ResNetEncoder2D(depth=backbone_depth)
        self.cnet = ResNetEncoder2D(depth=backbone_depth)
        self.cnet_aligner = nn.Linear(128, 256)
        self.correlation = Correlation2D()
        update = UpdateBlock2D()
        # the update's submodules are registered on the core under the
        # reference state_dict names (core.motion_encoder, ...); the block
        # itself stays outside the module tree, so that its parameters are
        # not registered a second time under core.update
        self.motion_encoder = update.motion_encoder
        self.gru = update.gru
        self.flow_head = update.flow_head
        self.convex_upsampler = update.convex_upsampler
        self.__dict__["update"] = update

    def forward(self, image1, image2):
        """Padded, normalised images [B, H, W, 3] -> final flow [B, H, W, 2]."""
        batch = image1.shape[0]
        # both frames share one fnet call (its BatchNorms use running stats)
        fmaps = self.fnet(torch.cat([image1, image2], dim=0))
        aligner = self.correlation.fnet_aligner
        pyramid = all_pairs_correlation_pyramid(aligner(fmaps[:batch]), aligner(fmaps[batch:]),
                                                CORR_LEVELS)
        h, x = torch.chunk(self.cnet_aligner(self.cnet(image1)), 2, dim=-1)
        feat_h, feat_w = fmaps.shape[1:3]
        consts = {"pyramid": pyramid, "x": torch.relu(x),
                  "grid": mesh_grid(batch, feat_h, feat_w, device=image1.device),
                  "packed": self.update.pack()}
        h = torch.tanh(h)
        flow = image1.new_zeros(batch, feat_h, feat_w, 2)
        for _ in range(self.n_iters):
            h, flow = self.update(h, flow, consts)
        return self.convex_upsampler(h, flow)


class RAFT(nn.Module):
    """Model wrapper: [-1, 1] normalisation, padding to a multiple of 8, the
    core, unpadding."""

    def __init__(self, cfgs: dict):
        super().__init__()
        resolve_fast_inference(str(cfgs.get("fast_inference", "auto")))
        resolve_lookup_storage(str(cfgs.get("lookup_storage", "auto")))
        if "backbone" in cfgs:
            depth = cfgs["backbone"]["depth"]
        elif cfgs.get("pretrain", {}).get("enabled", False):
            depth = cfgs["pretrain"]["depth"]
        else:
            depth = 50
        self.core = RAFTCore(n_iters=int(cfgs["n_iters_eval"]), backbone_depth=int(depth))

    def forward(self, inputs: dict) -> dict:
        images = 2.0 * (inputs["images"].float() / 255.0) - 1.0
        padder = InputPadder(images.shape, x=8)
        image1, image2 = padder.pad(images[..., :3], images[..., 3:])
        flow = padder.unpad(self.core(image1.contiguous(), image2.contiguous()))
        return {"flow_2d": flow, "flow_2d_seq": flow[None]}
