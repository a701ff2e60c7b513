"""Bilinear sampling at pixel coordinates (grid_sample, align_corners=True)
and the align-corners resize. PyTorch counterpart of
camliflow_tpu/ops/gridsample.py.

Images are NHWC; coordinates are pixel coordinates (x, y). With zeros
padding a corner tap outside the image contributes zero; with border
padding the coordinate is first clamped into the image.
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


def grid_sample_pixel(image: torch.Tensor, coords: torch.Tensor,
                      padding_mode: str = "zeros") -> torch.Tensor:
    """Bilinear sample `image` [B, H, W, C] at pixel coordinates
    [B, ..., 2] (x, y) -> [B, ..., C]. `padding_mode`: "zeros" (a tap
    outside contributes 0) or "border" (x, y clamped to [0, W-1] x [0, H-1]
    before the taps are taken)."""
    batch, height, width, channels = image.shape
    out_shape = (*coords.shape[:-1], channels)
    coords = coords.reshape(batch, -1, 2).float()
    x, y = coords[..., 0], coords[..., 1]
    if padding_mode == "border":
        x, y = x.clamp(0.0, width - 1), y.clamp(0.0, height - 1)
    elif padding_mode != "zeros":
        raise ValueError(f"unknown padding_mode: {padding_mode}")
    flat_idx, weights = bilinear_taps(x, y, height, width)
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


def align_corners_coords(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """The n_out sample positions, f32, of an align_corners resize along an
    axis of n_in pixels: i * s with s = (n_in - 1) * (1 / (n_out - 1)), two
    f32 roundings, the last position exactly n_in - 1. This is the JAX
    package's jnp.linspace(0, n_in - 1, n_out) as XLA compiles it on the CPU
    (F.interpolate's s = (n_in - 1) / (n_out - 1) puts 540 -> 576 rows up to
    6e-5 px elsewhere, which moves a resize of random data by 3e-4)."""
    if n_out == 1:
        return torch.zeros(1, device=device)
    scale = torch.full((), n_in - 1.0, device=device) * torch.full((), 1.0 / (n_out - 1),
                                                                      device=device)
    coords = torch.arange(n_out, dtype=torch.float32, device=device) * scale
    coords[-1] = n_in - 1.0
    return coords


def resize_bilinear_align_corners(image: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of [B, H, W, C] to [B, out_h, out_w, C] with
    align_corners=True: a border-padded sample at `align_corners_coords`
    in each axis."""
    batch, in_h, in_w, _ = image.shape
    if (in_h, in_w) == (out_h, out_w):
        return image
    ys = align_corners_coords(in_h, out_h, image.device)
    xs = align_corners_coords(in_w, out_w, image.device)
    grid_y, grid_x = torch.meshgrid(ys, xs, indexing="ij")
    coords = torch.stack([grid_x, grid_y], dim=-1)[None].expand(batch, out_h, out_w, 2)
    return grid_sample_pixel(image, coords, padding_mode="border")
