"""File codecs and geometry lifting for the eval readers: the port's copy of
what they need from camliflow_tpu/data/io.py (the reference's utils.py
semantics): PFM, Middlebury .flo, KITTI 16-bit flow and disparity PNGs,
KITTI calibration files, zero padding, disparity -> point cloud lifting and
numpy camera projection, the KITTI PNG writers, and PFM and .flo writers
(for synthetic raw FlyingThings3D data). PNGs go through the
port's own codec (`png.py`), which returns a file's channels in their stored
RGB order; each function here keeps what OpenCV's BGR reads gave the JAX
package."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from .png import read_png, write_png


def load_flow_png(path: str | Path, scale: float = 64.0):
    """Load a KITTI 16-bit flow PNG.

    Stored channels (RGB): R = u, G = v, B = validity; flow = (value -
    32768) / scale. Returns (flow [H, W, 2] f32 as (u, v), valid_mask
    [H, W] bool).
    """
    flow_img = read_png(path)
    flow = flow_img[:, :, 0:2].astype(np.float32)  # (u, v)
    mask = flow_img[:, :, 2] > 0
    return (flow - 32768.0) / scale, mask


def save_flow_png(path: str | Path, flow: np.ndarray, mask=None, scale: float = 64.0) -> None:
    """Save a KITTI 16-bit flow PNG: value = flow * scale + 32768, truncated
    to uint16; validity 1, or (mask > 0) where a mask is given. |flow| must
    stay under 32767 / scale."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    if not np.abs(flow).max() < 32767.0 / scale:
        raise ValueError(f"|flow| reaches {np.abs(flow).max()}, the PNG holds under "
                         f"{32767.0 / scale}")
    flow = flow * scale + 32768.0
    if mask is None:
        mask = np.ones_like(flow)[..., 0]
    else:
        mask = np.float32(mask > 0)
    flow_img = np.concatenate([flow[..., 0:1], flow[..., 1:2], mask[..., None]],
                              axis=-1).astype(np.uint16)
    write_png(path, flow_img)


def load_image_rgb(path: str | Path) -> np.ndarray:
    """An image as [H, W, 3] RGB uint8, as OpenCV's colour read gives it:
    grey repeated into three channels, alpha dropped, 16-bit samples cut to
    their high byte."""
    image = read_png(path)
    if image.dtype == np.uint16:
        image = (image >> 8).astype(np.uint8)
    if image.ndim == 2:
        image = image[..., None]
    if image.shape[2] in (2, 4):  # drop alpha
        image = image[..., :-1]
    if image.shape[2] == 1:
        image = np.repeat(image, 3, axis=2)
    return image


def load_grey_png(path: str | Path) -> np.ndarray:
    """An 8-bit greyscale PNG (a class map, a mask) as [H, W] uint8."""
    image = read_png(path)
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"{path}: expected an 8-bit greyscale PNG, got {image.dtype} "
                         f"{image.shape}")
    return image


def save_grey_png(path: str | Path, image: np.ndarray) -> None:
    """Save an [H, W] uint8 array as an 8-bit greyscale PNG."""
    if image.ndim != 2 or image.dtype != np.uint8:
        raise ValueError(f"expected [H, W] uint8, got {image.dtype} {image.shape}")
    write_png(path, image)


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


def save_pfm(path: str | Path, image: np.ndarray, scale: float = 1.0) -> None:
    """Save an [H, W] or [H, W, 3] array as a little-endian f32 PFM (rows
    stored bottom to top, as `load_pfm` reads them)."""
    image = np.flipud(np.asarray(image, dtype="<f4"))
    color = image.ndim == 3 and image.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(b"%d %d\n" % (image.shape[1], image.shape[0]))
        f.write(b"%f\n" % -scale)  # negative: little-endian
        image.tofile(f)


def save_flow(path: str | Path, flow: np.ndarray) -> None:
    """Save [H, W, 2] as a Middlebury .flo file."""
    if flow.ndim != 3 or flow.shape[2] != 2:
        raise ValueError(f"flow must be [H, W, 2], got {flow.shape}")
    with open(path, "wb") as f:
        np.float32(202021.25).tofile(f)
        np.array(flow.shape[1::-1], np.int32).tofile(f)  # width, height
        flow.astype(np.float32).tofile(f)


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
    array = read_png(path).astype(np.float32)
    valid_mask = array > 0
    disp = array / 256.0
    disp[~valid_mask] = -1.0
    return disp, valid_mask


def save_disp_png(path: str | Path, disp: np.ndarray, mask=None) -> None:
    """Save a KITTI 16-bit disparity PNG: value = disp * 256, clipped to
    uint16 and truncated; 0 (invalid) where mask, by default disp > 0, is
    false."""
    if mask is None:
        mask = disp > 0
    disp = np.clip(disp * 256.0, 0, 65535).astype(np.uint16)
    disp[~mask] = 0
    write_png(path, disp)


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
