"""Bilinear sampling at pixel coordinates (grid_sample, align_corners=True,
zeros padding). PyTorch counterpart of camliflow_tpu/ops/gridsample.py.

Images are NHWC; coordinates are pixel coordinates (x, y). A corner tap
outside the image contributes zero.
"""

from __future__ import annotations

import torch


def bilinear_taps(x: torch.Tensor, y: torch.Tensor, height: int, width: int):
    """The 4 corner taps of a zeros-padded bilinear sample: flat indices into
    the [H*W] plane and lerp weights with out-of-bounds validity folded in,
    so `sample = sum_t flat_image[idx[..., t]] * w[..., t]`. Tap order:
    (x0,y0), (x1,y0), (x0,y1), (x1,y1). Returns (idx [..., 4] int64,
    weights [..., 4] f32)."""
    x0, y0 = torch.floor(x), torch.floor(y)
    idxs, ws = [], []
    for xi, yi, wx, wy in (
        (x0, y0, 1.0 - (x - x0), 1.0 - (y - y0)),
        (x0 + 1.0, y0, x - x0, 1.0 - (y - y0)),
        (x0, y0 + 1.0, 1.0 - (x - x0), y - y0),
        (x0 + 1.0, y0 + 1.0, x - x0, y - y0),
    ):
        valid = (xi >= 0) & (xi <= width - 1) & (yi >= 0) & (yi <= height - 1)
        xc = torch.clamp(xi, 0, width - 1).long()
        yc = torch.clamp(yi, 0, height - 1).long()
        idxs.append(yc * width + xc)
        ws.append(wx * wy * valid)
    return torch.stack(idxs, dim=-1), torch.stack(ws, dim=-1)


def grid_sample_pixel(image: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sample `image` [B, H, W, C] at pixel coordinates
    [B, ..., 2] (x, y), zeros padding -> [B, ..., C]."""
    batch, height, width, channels = image.shape
    out_shape = (*coords.shape[:-1], channels)
    coords = coords.reshape(batch, -1, 2).float()
    flat_idx, weights = bilinear_taps(coords[..., 0], coords[..., 1], height, width)
    flat = image.reshape(batch, height * width, channels)
    out = None
    for t in range(4):
        index = flat_idx[..., t : t + 1].expand(-1, -1, channels)
        vals = torch.gather(flat, 1, index) * weights[..., t : t + 1].to(image.dtype)
        out = vals if out is None else out + vals
    return out.reshape(out_shape)


def grid_sample_points(feat_2d: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Image features [B, H, W, C] at projected points uv [B, N, 2] ->
    [B, N, C], in f32 (CLFM's 2D->3D path)."""
    return grid_sample_pixel(feat_2d.float(), uv)
