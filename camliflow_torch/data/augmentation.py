"""Joint 2D/3D augmentation pipeline (host-side NumPy): the port's copy of
camliflow_tpu/data/augmentation.py.

The color jitter reproduces torchvision ColorJitter's sampling scheme
(uniform factors, random op order) in NumPy; the geometric ops reproject
point clouds through the camera as the reference does (flips mirror image
coordinates, crops shift cx/cy, scale rescales x/y and intrinsics). Every
random draw comes from an explicit `numpy.random.RandomState`, in the JAX
file's order, so a RandomState seeded as the JAX package's global
`np.random` gives the same result bit for bit. OpenCV (the hue shift
through HSV, the scale's resize) is imported inside the functions that use
it.

All functions take/return NumPy arrays; images are [H, W, 3] uint8, point
clouds [N, 3], flow_2d [H, W, 2 or 3], flow_3d [N, 3 or 4].
"""

from __future__ import annotations

import numpy as np


def _blend(img1, img2, ratio):
    return np.clip(ratio * img1 + (1.0 - ratio) * img2, 0.0, 255.0)


def _grayscale(img):
    return (
        0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    )[..., None]


def _adjust_brightness(img, factor):
    return _blend(img, np.zeros_like(img), factor)


def _adjust_contrast(img, factor):
    mean = _grayscale(img).mean()
    return _blend(img, np.full_like(img, mean), factor)


def _adjust_saturation(img, factor):
    return _blend(img, _grayscale(img), factor)


def _adjust_hue(img, factor):
    import cv2

    hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV)
    # OpenCV uses H in [0, 180)
    shift = np.uint8(factor * 180.0) if factor >= 0 else np.uint8(180 + factor * 180.0)
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + shift) % 180
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32)


def color_jitter(
    image1, image2, brightness, contrast, saturation, hue, rng: np.random.RandomState
):
    """torchvision-style joint color jitter (augmentation.py:7-17 semantics:
    the same sampled transform is applied to both frames)."""
    images = np.concatenate([image1, image2], axis=0).astype(np.float32)

    ops = []
    if brightness:
        f = rng.uniform(max(0.0, 1.0 - brightness), 1.0 + brightness)
        ops.append(lambda im, f=f: _adjust_brightness(im, f))
    if contrast:
        f = rng.uniform(max(0.0, 1.0 - contrast), 1.0 + contrast)
        ops.append(lambda im, f=f: _adjust_contrast(im, f))
    if saturation:
        f = rng.uniform(max(0.0, 1.0 - saturation), 1.0 + saturation)
        ops.append(lambda im, f=f: _adjust_saturation(im, f))
    if hue:
        f = rng.uniform(-hue, hue)
        ops.append(lambda im, f=f: _adjust_hue(im, f))

    for idx in rng.permutation(len(ops)):
        images = ops[idx](images)

    images = images.astype(np.uint8)
    h = image1.shape[0]
    return images[:h], images[h:]


def flip_point_cloud(pc, image_h, image_w, f, cx, cy, flip_mode):
    """Reproject a cloud through a mirrored camera (augmentation.py:20-36)."""
    assert flip_mode in ("lr", "ud")
    pc_x, pc_y, depth = pc[..., 0], pc[..., 1], pc[..., 2]
    image_x = cx + (f / depth) * pc_x
    image_y = cy + (f / depth) * pc_y
    if flip_mode == "lr":
        image_x = image_w - 1 - image_x
    else:
        image_y = image_h - 1 - image_y
    pc_x = (image_x - cx) * depth / f
    pc_y = (image_y - cy) * depth / f
    return np.stack([pc_x, pc_y, depth], axis=-1)


def flip_scene_flow(pc1, flow_3d, image_h, image_w, f, cx, cy, flip_mode):
    """Warp-endpoint difference transform (augmentation.py:39-42)."""
    new_pc1 = flip_point_cloud(pc1, image_h, image_w, f, cx, cy, flip_mode)
    new_pc1_warp = flip_point_cloud(
        pc1 + flow_3d[:, :3], image_h, image_w, f, cx, cy, flip_mode
    )
    return np.concatenate([new_pc1_warp - new_pc1, flow_3d[:, 3:]], axis=-1)


def flip_image(image, flip_mode):
    return np.fliplr(image).copy() if flip_mode == "lr" else np.flipud(image).copy()


def flip_optical_flow(flow, flip_mode):
    if flip_mode == "lr":
        flow = np.fliplr(flow).copy()
        flow[:, :, 0] *= -1
    else:
        flow = np.flipud(flow).copy()
        flow[:, :, 1] *= -1
    return flow


def random_flip(
    image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, flip_mode, rng
):
    """50% joint flip of all modalities (augmentation.py:63-83)."""
    image_h, image_w = image1.shape[:2]
    if rng.rand() < 0.5:
        return image1, image2, pc1, pc2, flow_2d, flow_3d
    return (
        flip_image(image1, flip_mode),
        flip_image(image2, flip_mode),
        flip_point_cloud(pc1, image_h, image_w, f, cx, cy, flip_mode),
        flip_point_cloud(pc2, image_h, image_w, f, cx, cy, flip_mode),
        flip_optical_flow(flow_2d, flip_mode),
        flip_scene_flow(pc1, flow_3d, image_h, image_w, f, cx, cy, flip_mode),
    )


def crop_image_with_pc(
    image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, crop_window, drop_pc=False
):
    """Crop images; optionally drop points outside (augmentation.py:86-128)."""
    x1, y1, x2, y2 = crop_window
    image_h, image_w = image1.shape[:2]
    cx = (image_w - 1) / 2 if cx is None else cx
    cy = (image_h - 1) / 2 if cy is None else cy

    xy1_x = cx + (f / pc1[..., 2]) * pc1[..., 0]
    xy1_y = cy + (f / pc1[..., 2]) * pc1[..., 1]
    xy2_x = cx + (f / pc2[..., 2]) * pc2[..., 0]
    xy2_y = cy + (f / pc2[..., 2]) * pc2[..., 1]

    image1 = image1[y1:y2, x1:x2].copy()
    image2 = image2[y1:y2, x1:x2].copy()
    flow_2d = flow_2d[y1:y2, x1:x2].copy()

    if drop_pc:
        mask1 = (xy1_x > x1) & (xy1_x < x2) & (xy1_y > y1) & (xy1_y < y2)
        mask2 = (xy2_x > x1) & (xy2_x < x2) & (xy2_y > y1) & (xy2_y < y2)
        pc1, pc2, flow_3d = pc1[mask1], pc2[mask2], flow_3d[mask1]
        if pc1.shape[0] == 0 or pc2.shape[0] == 0:
            raise AssertionError("empty crop")  # retried by the dataset

    return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx - x1, cy - y1


def random_crop(
    image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, crop_size, drop_pc, rng
):
    crop_w, crop_h = crop_size
    image_h, image_w = image1.shape[:2]
    assert crop_w <= image_w and crop_h <= image_h
    x1 = rng.randint(low=0, high=image_w - crop_w + 1)
    y1 = rng.randint(low=0, high=image_h - crop_h + 1)
    return crop_image_with_pc(
        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
        [x1, y1, x1 + crop_w, y1 + crop_h], drop_pc,
    )


def resize_sparse_flow_map(flow, target_w, target_h):
    """Rescatter a sparse flow map at a new resolution (augmentation.py:147-171)."""
    curr_h, curr_w = flow.shape[:2]
    coords = np.stack(
        np.meshgrid(np.arange(curr_w), np.arange(curr_h)), axis=-1
    ).astype(np.float32)

    mask = flow[..., -1] > 0
    coords0, flow0 = coords[mask], flow[mask][:, :2]

    scale_w = (target_w - 1) / (curr_w - 1)
    scale_h = (target_h - 1) / (curr_h - 1)
    coords1 = coords0 * [scale_w, scale_h]
    flow1 = flow0 * [scale_w, scale_h]

    xx = np.round(coords1[:, 0]).astype(np.int32)
    yy = np.round(coords1[:, 1]).astype(np.int32)
    valid = (xx >= 0) & (xx < target_w) & (yy >= 0) & (yy < target_h)
    xx, yy, flow1 = xx[valid], yy[valid], flow1[valid]

    out = np.zeros([target_h, target_w, 3], dtype=np.float32)
    out[yy, xx, :2] = flow1
    out[yy, xx, 2:] = 1.0
    return out


def random_scale(
    image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, scale_range, rng
):
    """Crop-then-resize zoom augmentation (augmentation.py:174-213)."""
    assert 1 <= scale_range[0] < scale_range[1]
    if rng.rand() < 0.5:
        return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy

    scale_ratio = rng.uniform(scale_range[0], scale_range[1])
    image_h, image_w = image1.shape[:2]
    crop_h, crop_w = int(image_h / scale_ratio), int(image_w / scale_ratio)
    x1 = rng.randint(low=0, high=image_w - crop_w + 1)
    y1 = rng.randint(low=0, high=image_h - crop_h + 1)

    image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy = crop_image_with_pc(
        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
        [x1, y1, x1 + crop_w, y1 + crop_h],
    )

    import cv2

    image1 = cv2.resize(image1, (image_w, image_h), interpolation=cv2.INTER_LINEAR)
    image2 = cv2.resize(image2, (image_w, image_h), interpolation=cv2.INTER_LINEAR)
    flow_2d = resize_sparse_flow_map(flow_2d, image_w, image_h)

    scale_w = (image_w - 1) / (crop_w - 1)
    scale_h = (image_h - 1) / (crop_h - 1)
    pc1 = pc1 * [scale_w, scale_h, 1.0]
    pc2 = pc2 * [scale_w, scale_h, 1.0]
    flow_3d = flow_3d * ([scale_w, scale_h, 1.0] + [1.0] * (flow_3d.shape[1] - 3))
    return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx * scale_w, cy * scale_h


def joint_augmentation(
    image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, cfgs, rng: np.random.RandomState
):
    """Full pipeline gated by config (augmentation.py:216-252)."""
    if not cfgs.enabled:
        return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy

    if cfgs.color_jitter.enabled:
        image1, image2 = color_jitter(
            image1, image2,
            brightness=cfgs.color_jitter.brightness,
            contrast=cfgs.color_jitter.contrast,
            saturation=cfgs.color_jitter.saturation,
            hue=cfgs.color_jitter.hue,
            rng=rng,
        )
    if cfgs.random_horizontal_flip.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d = random_flip(
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, "lr", rng
        )
    if cfgs.random_vertical_flip.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d = random_flip(
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, "ud", rng
        )
    if cfgs.random_crop.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy = random_crop(
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
            crop_size=cfgs.random_crop.crop_size,
            drop_pc=cfgs.random_crop.drop_pc,
            rng=rng,
        )
    if cfgs.random_scale.enabled:
        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy = random_scale(
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy,
            scale_range=cfgs.random_scale.scale_range,
            rng=rng,
        )
    return image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy
