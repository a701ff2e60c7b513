"""2D image-space ops: mesh grid, backward warping, input padding and
resizing, convex upsampling, flow resizing (NHWC).

PyTorch counterpart of camliflow_tpu/ops/image.py (`mesh_grid`,
`backwarp_2d`, `InputPadder`, `resize_to_multiple`, `convex_upsample`,
`resize_flow2d`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .gridsample import grid_sample_pixel, resize_bilinear_align_corners


def mesh_grid(batch: int, height: int, width: int, device=None) -> torch.Tensor:
    """Pixel-coordinate grid [B, H, W, 2] as (x, y), f32."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return torch.stack([xs, ys], dim=-1)[None].expand(batch, height, width, 2)


def backwarp_2d(x: torch.Tensor, flow12: torch.Tensor, padding_mode: str) -> torch.Tensor:
    """Frame-2 features x [B, H, W, C] sampled at p + flow12 [B, H, W, 2]
    for every pixel p of frame 1; `padding_mode` "zeros" or "border"."""
    batch, height, width, _ = x.shape
    grid = mesh_grid(batch, height, width, device=x.device) + flow12.float()
    return grid_sample_pixel(x, grid, padding_mode=padding_mode)


def convex_upsample(flow: torch.Tensor, mask: torch.Tensor, scale_factor: int = 8):
    """RAFT convex-combination upsampling.

    flow [B, h, w, 2]; mask [B, h, w, 9*s*s] logits with channel
    c = k*s*s + iy*s + ix, k the 3x3 neighbour (row-major) and (iy, ix) the
    sub-pixel offset. Returns [B, h*s, w*s, 2], rescaled by s.
    """
    batch, h, w, _ = flow.shape
    s = scale_factor
    mask = torch.softmax(mask.reshape(batch, h, w, 9, s, s).float(), dim=3)
    padded = F.pad(flow.float() * s, (0, 0, 1, 1, 1, 1))
    neighbors = torch.stack(
        [padded[:, dy : dy + h, dx : dx + w, :] for dy in range(3) for dx in range(3)],
        dim=3,
    )  # [B, h, w, 9, 2]
    up = torch.einsum("bhwkyx,bhwkc->bhwyxc", mask, neighbors)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(batch, h * s, w * s, 2)


def resize_flow2d(flow: torch.Tensor, target_h: int, target_w: int) -> torch.Tensor:
    """Bilinear-resize a flow field [B, h, w, 2] (align_corners=True) to
    [B, target_h, target_w, 2] and rescale its magnitudes."""
    origin_h, origin_w = flow.shape[1:3]
    if (target_h, target_w) == (origin_h, origin_w):
        return flow
    flow = F.interpolate(flow.permute(0, 3, 1, 2), size=(target_h, target_w),
                         mode="bilinear", align_corners=True).permute(0, 2, 3, 1)
    scale = torch.tensor([target_w / origin_w, target_h / origin_h], dtype=flow.dtype)
    return flow * scale.to(flow.device, non_blocking=True)


def resize_to_multiple(inputs: torch.Tensor, target: torch.Tensor | None, x: int = 64):
    """Bilinear-resize (align_corners=True) images [B, H, W, C] up to the
    next multiples of x, and a flow target [B, H, W, 2] with them, its
    magnitudes rescaled. Returns (inputs, target)."""
    _, h, w, _ = inputs.shape
    if h % x == 0 and w % x == 0:
        return inputs, target
    resized_h, resized_w = -(-h // x) * x, -(-w // x) * x
    inputs = resize_bilinear_align_corners(inputs, resized_h, resized_w)
    if target is not None:
        target = resize_bilinear_align_corners(target, resized_h, resized_w)
        scale = torch.tensor([resized_w / w, resized_h / h], dtype=target.dtype)
        target = target * scale.to(target.device, non_blocking=True)
    return inputs, target


class InputPadder:
    """Replicate-pad NHWC images so H and W are multiples of `x`: (left,
    right) split pad_wd, (top, bottom) = (0, pad_ht), as the reference."""

    def __init__(self, dims, x: int = 8):
        self.ht, self.wd = dims[1:3]
        pad_ht = (((self.ht // x) + 1) * x - self.ht) % x
        pad_wd = (((self.wd // x) + 1) * x - self.wd) % x
        self._pad = (pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht)  # l, r, t, b

    def pad(self, *inputs):
        return [
            F.pad(x.permute(0, 3, 1, 2), self._pad, mode="replicate").permute(0, 2, 3, 1)
            for x in inputs
        ]

    def unpad(self, x):
        left, right, top, bottom = self._pad
        ht, wd = x.shape[1:3]
        return x[:, top : ht - bottom, left : wd - right, :]
