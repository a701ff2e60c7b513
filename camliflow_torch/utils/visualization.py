"""Flow visualisation: the port's copy of camliflow_tpu/utils/visualization.py
on numpy alone (no OpenCV)."""

from __future__ import annotations

import numpy as np

# OpenCV's sector table for HSV -> RGB (color_hsv.simd.hpp): the entries of
# (v, v(1 - s), v(1 - s h), v(1 - s(1 - h))) that b, g, r take in each sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv2rgb_8bit(hsv: np.ndarray) -> np.ndarray:
    """OpenCV's 8-bit COLOR_HSV2RGB: [..., 3] uint8 (h in 0-180 a turn, s and
    v in 0-255) -> RGB uint8, in its float32 arithmetic. A hue past 180
    wraps: h * 6 / 180 is taken mod 6."""
    h = hsv[..., 0].astype(np.float32)
    s = hsv[..., 1].astype(np.float32) * np.float32(1.0 / 255.0)
    v = hsv[..., 2].astype(np.float32) * np.float32(1.0 / 255.0)
    h = np.fmod(h * np.float32(6.0 / 180.0), np.float32(6.0))
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    tab = np.stack([v, v * (np.float32(1.0) - s), v * (np.float32(1.0) - s * h),
                    v * (np.float32(1.0) - s * (np.float32(1.0) - h))], axis=-1)
    tab[s == 0] = v[s == 0][:, None]  # grey: b = g = r = v
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    rgb = bgr[..., ::-1] * np.float32(255.0)
    return np.clip(np.rint(rgb), 0, 255).astype(np.uint8)


def viz_optical_flow(flow: np.ndarray, max_flow: float = 512) -> np.ndarray:
    """HSV colour-wheel visualisation of a [H, W, 2] flow field -> RGB uint8.
    As in the reference, the hue goes in scaled to 0-255 where the 8-bit
    conversion takes 0-180 a turn, so hues past 180 wrap into the next
    sectors: the picture depends on it."""
    n = 8
    u, v = flow[:, :, 0], flow[:, :, 1]
    mag = np.sqrt(np.square(u) + np.square(v))
    angle = np.arctan2(v, u)
    image_h = np.mod(angle / (2 * np.pi) + 1, 1)
    image_s = np.clip(mag * n / max_flow, a_min=0, a_max=1)
    image_v = np.ones_like(image_s)
    image_hsv = np.stack([image_h, image_s, image_v], axis=2)
    image_hsv = (image_hsv * 255).astype(np.uint8)
    return hsv2rgb_8bit(image_hsv)
