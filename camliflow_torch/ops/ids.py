"""Inverse depth scaling (IDS): perspective <-> parallel projection.

PyTorch counterpart of camliflow_tpu/ops/ids.py. Point clouds are
`[B, N, 3]`; camera infos are plain dicts with f/cx/cy either Python scalars
or `[B]` tensors.
"""

from __future__ import annotations

import torch


def _expand(v, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or [B] camera parameter against [B, N] data. A
    Python number becomes a 0-dim tensor filled on like's device (a copy
    from the host would make the host wait for the card)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    v = v.to(dtype=like.dtype, device=like.device)
    return v[:, None] if v.dim() == 1 else v


def make_parallel_camera_info(image_h: int, image_w: int) -> dict:
    """Virtual parallel camera of size (H/32, W/32)."""
    sensor_h, sensor_w = round(image_h / 32), round(image_w / 32)
    return {
        "projection_mode": "parallel",
        "sensor_h": sensor_h,
        "sensor_w": sensor_w,
        "cx": (sensor_w - 1) / 2,
        "cy": (sensor_h - 1) / 2,
    }


def persp2paral(xyz: torch.Tensor, persp: dict, paral: dict) -> torch.Tensor:
    """Perspective -> parallel projection."""
    src_x, src_y, src_z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    f = _expand(persp["f"], src_x)
    cx = _expand(persp["cx"], src_x)
    cy = _expand(persp["cy"], src_x)

    dst_x = cx + (f / src_z) * src_x
    dst_y = cy + (f / src_z) * src_y
    dst_z = f * torch.log(src_z) + 1.0

    scale_w = (paral["sensor_w"] - 1) / (persp["sensor_w"] - 1)
    scale_h = (paral["sensor_h"] - 1) / (persp["sensor_h"] - 1)
    return torch.stack(
        [
            dst_x * scale_w - (paral["sensor_w"] - 1) / 2,
            dst_y * scale_h - (paral["sensor_h"] - 1) / 2,
            dst_z * min(scale_w, scale_h),
        ],
        dim=-1,
    )


def paral2persp(xyz: torch.Tensor, persp: dict, paral: dict) -> torch.Tensor:
    """Parallel -> perspective projection (exact inverse)."""
    src_x, src_y, src_z = xyz[..., 0], xyz[..., 1], xyz[..., 2]

    scale_w = (paral["sensor_w"] - 1) / (persp["sensor_w"] - 1)
    scale_h = (paral["sensor_h"] - 1) / (persp["sensor_h"] - 1)
    src_x = (src_x + (paral["sensor_w"] - 1) / 2) / scale_w
    src_y = (src_y + (paral["sensor_h"] - 1) / 2) / scale_h
    src_z = src_z / min(scale_w, scale_h)

    f = _expand(persp["f"], src_x)
    cx = _expand(persp["cx"], src_x)
    cy = _expand(persp["cy"], src_x)

    dst_z = torch.exp((src_z - 1.0) / f)
    dst_x = (src_x - cx) * dst_z / f
    dst_y = (src_y - cy) * dst_z / f
    return torch.stack([dst_x, dst_y, dst_z], dim=-1)


def project_pc2image(pc: torch.Tensor, camera_info: dict) -> torch.Tensor:
    """Project [B, N, 3] points to [B, N, 2] image coordinates (x, y)."""
    pc_x, pc_y, pc_z = pc[..., 0], pc[..., 1], pc[..., 2]
    cx = _expand(camera_info["cx"], pc_x)
    cy = _expand(camera_info["cy"], pc_x)
    if camera_info["projection_mode"] == "perspective":
        f = _expand(camera_info["f"], pc_x)
        image_x = cx + (f / pc_z) * pc_x
        image_y = cy + (f / pc_z) * pc_y
    elif camera_info["projection_mode"] == "parallel":
        image_x = pc_x + cx
        image_y = pc_y + cy
    else:
        raise NotImplementedError(camera_info["projection_mode"])
    return torch.stack([image_x, image_y], dim=-1)
