"""File codecs and geometry lifting for the eval readers: the port's copy of
what they need from camliflow_tpu/data/io.py (the reference's utils.py
semantics): PFM, Middlebury .flo, KITTI 16-bit flow and disparity PNGs,
KITTI calibration files, zero padding, disparity -> point cloud lifting and
numpy camera projection. OpenCV is imported only where a PNG is decoded."""

from __future__ import annotations

import re
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


def load_pfm(path: str | Path) -> np.ndarray:
    """Load a PFM image. Returns [H, W] or [H, W, 3] f32, top row first."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            color = True
        elif header == b"Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")
        dim_match = re.match(rb"^(\d+)\s(\d+)\s$", f.readline())
        if not dim_match:
            raise ValueError("Malformed PFM header.")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(data.reshape(shape)).copy()  # PFM stores bottom-to-top


def load_flow(path: str | Path) -> np.ndarray:
    """Load a Middlebury .flo file. Returns [H, W, 2] f32."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if len(magic) == 0 or magic[0] != 202021.25:
            raise ValueError(f"Invalid .flo file: {path}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def load_disp_png(path: str | Path):
    """Load a KITTI 16-bit disparity PNG. Returns (disp [H, W] f32,
    valid_mask [H, W]): disp = value / 256, and -1 where the value is 0
    (invalid)."""
    import cv2

    array = cv2.imread(str(path), cv2.IMREAD_UNCHANGED).astype(np.float32)
    valid_mask = array > 0
    disp = array / 256.0
    disp[~valid_mask] = -1.0
    return disp, valid_mask


def load_calib(path: str | Path) -> np.ndarray:
    """The P_rect_02 3x4 matrix of a KITTI calibration file."""
    with open(path) as f:
        for line in f.readlines():
            if line.startswith("P_rect_02") or line.startswith("P2:"):
                values = line.split()[1:]
                return np.array(values, dtype=np.float32).reshape(3, 4)
    raise ValueError(f"No P_rect_02 / P2 entry in {path}")


def zero_padding(array: np.ndarray, target_h: int, target_w: int) -> np.ndarray:
    """Zero-pad bottom and right to [target_h, target_w, ...]: the content
    stays at the top left."""
    h, w = array.shape[:2]
    if h > target_h or w > target_w:
        raise ValueError(f"cannot pad {array.shape[:2]} to {(target_h, target_w)}")
    out = np.zeros((target_h, target_w) + array.shape[2:], dtype=array.dtype)
    out[:h, :w] = array
    return out


def disp2pc(disp: np.ndarray, baseline: float, f: float, cx: float, cy: float,
            flow: np.ndarray | None = None) -> np.ndarray:
    """Lift a [H, W] disparity map to [H, W, 3] points (invalid, non-positive
    disparities give z <= 0). `flow` [H, W, 2], when given, moves the pixel
    grid before the lift (frame 2's points from frame 1's disparity)."""
    height, width = disp.shape
    depth = baseline * f / (disp + 1e-5)
    xs = np.tile(np.arange(width, dtype=np.float32)[None, :], (height, 1))
    ys = np.tile(np.arange(height, dtype=np.float32)[:, None], (1, width))
    if flow is not None:
        xs = xs + flow[:, :, 0]
        ys = ys + flow[:, :, 1]
    pc_x = (xs - cx) * depth / f
    pc_y = (ys - cy) * depth / f
    return np.stack([pc_x, pc_y, depth], axis=-1)


def project_pc2image_np(pc: np.ndarray, image_h, image_w, f, cx=None, cy=None, clip=True):
    """Project [N, 3] points to [N, 2] pixel coordinates, clipped to the
    image unless `clip` is False."""
    if pc.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {pc.shape}")
    cx = (image_w - 1) / 2 if cx is None else cx
    cy = (image_h - 1) / 2 if cy is None else cy
    pc_x, pc_y, depth = pc[:, 0], pc[:, 1], pc[:, 2]
    image_x = cx + (f / depth) * pc_x
    image_y = cy + (f / depth) * pc_y
    if clip:
        image_x = np.clip(image_x, a_min=0, a_max=image_w - 1)
        image_y = np.clip(image_y, a_min=0, a_max=image_h - 1)
    return np.stack([image_x, image_y], axis=-1)
