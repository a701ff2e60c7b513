"""File codecs (the port's copy of what the FlyingThings3D reader needs from
camliflow_tpu/data/io.py)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def load_flow_png(path: str | Path, scale: float = 64.0):
    """Load a KITTI 16-bit flow PNG.

    Stored channel layout (as read by cv2, BGR): ch0 = validity, ch1 = v,
    ch2 = u; flow = (value - 32768) / scale. Returns (flow [H, W, 2] f32 as
    (u, v), valid_mask [H, W] bool).
    """
    import cv2

    flow_img = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
    flow = flow_img[:, :, 2:0:-1].astype(np.float32)  # (u, v)
    mask = flow_img[:, :, 0] > 0
    return (flow - 32768.0) / scale, mask


def load_image_rgb(path: str | Path) -> np.ndarray:
    """An 8-bit image as [H, W, 3] RGB."""
    import cv2

    return cv2.imread(str(path))[..., ::-1]
