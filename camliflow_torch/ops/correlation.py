"""2D cost volumes: PWC's local correlation, and RAFT's all-pairs
correlation pyramid with its windowed bilinear lookup.

PyTorch counterpart of camliflow_tpu/ops/correlation.py (`correlation2d`,
`all_pairs_correlation_pyramid`, `padded_pyramid_from_features`,
`corr_lookup_2d`). The exact path keeps the volume f32 (the TPU's bf16
hi/lo split storage, which rebuilds f32 to ~2^-18, is a workaround of its
matrix unit and is not ported: `split` names the f32 volume here). The fast
path's storages are ported: `bf16` (each value rounded to bf16) and `int8`
(each level row quantised with its own scale, `quantize_rows_int8`); the
lookup dequantises after the bilinear blend. Plain PyTorch; the JAX
functions are not Pallas kernels either. NHWC.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import quantize_rows_int8

STORAGES = ("split", "bf16", "int8")
ROW_CHUNK = 2048  # frame-1 pixels a stored level is built for at a time


def correlation2d(input1: torch.Tensor, input2: torch.Tensor,
                  max_displacement: int) -> torch.Tensor:
    """PWC's local cost volume: input1, input2 [B, H, W, C] -> [B, H, W,
    (2d+1)^2] f32, channel i*(2d+1) + j the mean over channels of
    input1(y, x) * input2(y + i - d, x + j - d): the vertical shift is the
    major index. Frame 2 is zero-padded, so a shift past the border gives 0.

    One vertical shift at a time: its 2d+1 horizontal shifts are a window
    view of the padded rows, multiplied by input1 and summed over channels
    (2 launches a vertical shift rather than 2 a shift)."""
    d = max_displacement
    span = 2 * d + 1
    batch, height, width, channels = input1.shape
    input1 = input1.float()[:, :, :, None, :]  # [B, H, W, 1, C]
    padded = F.pad(input2.float(), (0, 0, d, d, d, d))  # [B, H+2d, W+2d, C]
    costs = []
    for i in range(span):
        # [B, H, span, C, W] -> [B, H, W, span, C]: the j-th horizontal shift
        window = padded[:, i : i + height].unfold(2, width, 1).permute(0, 1, 4, 2, 3)
        costs.append((input1 * window).sum(dim=-1))
    return torch.cat(costs, dim=-1) / channels


def resolve_lookup_storage(mode: str, fast: bool = False) -> str:
    """The `lookup_storage` config key: `auto` stores the volume int8 on the
    fast path and f32 (`split`) otherwise; `split`, `bf16` and `int8` name
    a storage whatever the path."""
    if mode not in ("auto", *STORAGES):
        raise ValueError(f"lookup_storage must be auto|split|bf16|int8, got {mode!r}")
    if mode != "auto":
        return mode
    return "int8" if fast else "split"


def all_pairs_correlation_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor,
                                  num_levels: int = 4) -> list[torch.Tensor]:
    """fmap1, fmap2 [B, H, W, C] -> levels [B*H*W, H/2^i, W/2^i, 1] (f32):
    an f32 matmul scaled by 1/sqrt(C), then 2x2 average pools that drop an
    odd trailing row or column."""
    batch, height, width, dim = fmap1.shape
    f1 = fmap1.reshape(batch, height * width, dim).float()
    f2 = fmap2.reshape(batch, height * width, dim).float()
    corr = torch.matmul(f1, f2.transpose(1, 2))
    # sqrt(C) filled on the card (a copy from the host would make it wait)
    corr = corr / torch.sqrt(torch.full((), dim, dtype=torch.float32, device=corr.device))
    corr = corr.reshape(batch * height * width, height, width, 1)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        rows, h, w, _ = corr.shape
        h2, w2 = h // 2, w // 2
        corr = corr[:, : h2 * 2, : w2 * 2, 0].reshape(rows, h2, 2, w2, 2)
        corr = corr.mean(dim=(2, 4))[..., None]
        pyramid.append(corr)
    return pyramid


def correlation_pyramid(fmap1: torch.Tensor, fmap2: torch.Tensor, num_levels: int = 4,
                        storage: str = "split") -> list:
    """The lookup pyramid in a storage (`resolve_lookup_storage`).

    `split`: `all_pairs_correlation_pyramid`, f32. `bf16` and `int8` (the
    JAX package's `padded_pyramid_from_features`): each level is one matmul
    of frame 1's features against frame 2's, 2x2 average-pooled per level
    (pooling the volume over frame-2 pixels is pooling frame 2's features,
    the product being bilinear; the two differ by rounding), times
    1/sqrt(C), then stored: a bf16 level [B*H*W, h, w, 1], or an int8 level
    with its per-row scale, ([B*H*W, h, w, 1] int8, [B*H*W] f32). ROW_CHUNK
    frame-1 pixels at a time, so that their f32 rows of one level are the
    largest temporary, not the f32 volume the storage saves."""
    if storage == "split":
        return all_pairs_correlation_pyramid(fmap1, fmap2, num_levels)
    if storage not in STORAGES:
        raise ValueError(f"unknown lookup storage {storage!r}")
    batch, height, width, dim = fmap1.shape
    f1 = fmap1.reshape(batch, height * width, dim).float()
    f2 = fmap2.float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(dim)))  # f32, as the JAX einsum's
    out = []
    for i in range(num_levels):
        if i:  # floor semantics: an odd trailing row or column is dropped
            b2, lh, lw, c = f2.shape
            f2 = f2[:, : lh // 2 * 2, : lw // 2 * 2].reshape(b2, lh // 2, 2, lw // 2, 2, c)
            f2 = f2.mean(dim=(2, 4))
        lh, lw = f2.shape[1:3]
        table = f2.reshape(batch, lh * lw, dim)
        items = []
        for b in range(batch):
            for r0 in range(0, height * width, ROW_CHUNK):
                vol = torch.matmul(f1[b, r0:r0 + ROW_CHUNK], table[b].t()).mul_(scale)
                items.append(vol.to(torch.bfloat16) if storage == "bf16"
                             else quantize_rows_int8(vol))
        shape = (batch * height * width, lh, lw, 1)
        if storage == "bf16":
            out.append(torch.cat(items).reshape(shape))
        else:
            out.append((torch.cat([q for q, _ in items]).reshape(shape),
                        torch.cat([s for _, s in items])[:, 0]))
    return out


def corr_lookup_2d(pyramid: list[torch.Tensor], coords: torch.Tensor,
                   radius: int = 4) -> torch.Tensor:
    """Bilinear (2r+1)^2 window lookup into every level, in any storage of
    `correlation_pyramid`: the taps are read in the level's type and
    blended in f32, and an int8 level's blend is then multiplied by its
    row's scale (dequantised after the blend, as the JAX lookup does).

    coords [B, H, W, 2] are frame-2 pixel coordinates (grid + flow), halved
    per level. Window tap (i, j) samples (x - r + i, y - r + j) and lands in
    channel i*(2r+1) + j: the x offset is the major index (the reference's
    channel order). Taps outside [0, dim) contribute zero, and coordinates
    are clamped to [-(r+1), dim+r], beyond which every tap is outside.
    Returns [B, H, W, levels*(2r+1)^2].
    """
    batch, height, width, _ = coords.shape
    r = radius
    span, patch = 2 * r + 1, 2 * r + 2
    rows = batch * height * width
    flat_coords = coords.reshape(rows, 2).float()
    offsets = torch.arange(patch, device=coords.device)
    out = []
    for i, level in enumerate(pyramid):
        scale = None
        if isinstance(level, tuple):  # int8 and its rows' scales
            level, scale = level
        level_h, level_w = level.shape[1:3]
        c = flat_coords / (2.0**i)
        cx = torch.clamp(c[:, 0], -(r + 1.0), level_w + r)
        cy = torch.clamp(c[:, 1], -(r + 1.0), level_h + r)
        x0, y0 = torch.floor(cx), torch.floor(cy)
        fx = (cx - x0)[:, None, None]
        fy = (cy - y0)[:, None, None]
        xs = (x0 - r).long()[:, None] + offsets  # [rows, P]
        ys = (y0 - r).long()[:, None] + offsets
        valid = ((xs >= 0) & (xs < level_w))[:, :, None] & ((ys >= 0) & (ys < level_h))[:, None, :]
        index = ys.clamp(0, level_h - 1)[:, None, :] * level_w + xs.clamp(0, level_w - 1)[:, :, None]
        patches = torch.gather(level.reshape(rows, level_h * level_w), 1,
                               index.reshape(rows, patch * patch))
        patches = patches.float().reshape(rows, patch, patch) * valid  # [rows, x, y]
        blended = (
            (1.0 - fx) * (1.0 - fy) * patches[:, :-1, :-1]
            + (1.0 - fx) * fy * patches[:, :-1, 1:]
            + fx * (1.0 - fy) * patches[:, 1:, :-1]
            + fx * fy * patches[:, 1:, 1:]
        )
        if scale is not None:
            blended = blended * scale[:, None, None]
        out.append(blended.reshape(batch, height, width, span * span))
    return torch.cat(out, dim=-1)
