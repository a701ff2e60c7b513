"""Rigid-background refinement for the KITTI leaderboard (NumPy and OpenCV on
the host): the port's copy of camliflow_tpu/postprocess/refine.py, with the
same arithmetic, seeds and OpenCV calls, so its outputs are the JAX
package's bit for bit. OpenCV (`cv2`) is imported inside the functions that
call its solvers, so the rest of the port never needs it.

Post-processing that replaces the predicted flow / disparity-change on static
background pixels with the reprojection of a rigid scene under an estimated
camera motion. Behaviour matches the reference pipeline (refine_utils.py:46-340,
which the reference adapted from gengshan-y/rigidmask), and the KITTI-tuned
constants are kept verbatim because leaderboard numbers depend on them — but
the implementation here is restructured from the geometry up:

- camera pose is a small `Pose` value type instead of loose (R, T) tuples;
- two-view midpoint triangulation is solved directly from its normal
  equations  X = (sum_i (I - b_i b_i^T))^-1 sum_i (I - b_i b_i^T) a_i
  (ray origins a_i, unit directions b_i). The reference's m1/m2/Cinv
  formulation is algebraically identical (substitute B = n*I - C); the
  direct form needs no pseudo-inverses and is sign-invariant in b.
- the scale RANSAC and the agreement selection are expressed as standalone
  helpers with explicit names.

The reference optionally refines pose with NG-RANSAC; like its own fallback
path we rely on cv2.findEssentialMat (refine_utils.py:183-187).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# KITTI-tuned constants (values load-bearing for leaderboard parity)
MAX_SAMPLED_CORRESPONDENCES = 3000  # pose / scale estimation subsample size
SCALE_RANSAC_ITERS = 100
SCALE_LOG_INLIER_THRESHOLD = 0.01
AGREEMENT_LOG_RATIO = 1.2  # triangulated-vs-measured inverse-depth agreement
MAX_PNP_POINTS = 50000  # keep only the best-agreeing points for PnP
DEPTH_MEDIAN_WINDOW = 5.0  # accept inverse depths within [med/5, med*5]
STATIC_PARALLAX_PX = 8.0  # mean residual parallax below this => camera static


@dataclass
class Pose:
    """Rigid camera motion: x_world = R @ x_cam + t (camera-1 center at t)."""

    rotation: np.ndarray  # [3, 3]
    translation: np.ndarray  # [3]

    def projection(self, intrinsics: np.ndarray) -> np.ndarray:
        """3x4 projection matrix of the moved camera."""
        rt = self.rotation.T
        return intrinsics @ np.concatenate(
            [rt, -rt @ self.translation[:, None]], axis=1
        )


def pixel_grid_homogeneous(height: int, width: int) -> np.ndarray:
    """[3, H*W] homogeneous pixel coordinates (x, y, 1)."""
    xs, ys = np.meshgrid(
        np.arange(width, dtype=np.float32), np.arange(height, dtype=np.float32)
    )
    return np.stack([xs, ys, np.ones_like(xs)], 0).reshape(3, -1)


def lift_disparity(
    disp: np.ndarray, hp: np.ndarray, intrinsics: np.ndarray, baseline: float
) -> np.ndarray:
    """Disparity map -> camera-frame 3D points [3, H*W]; invalid disp -> 0."""
    fl = intrinsics[0, 0]
    depth = baseline * fl / disp.reshape(-1)
    rays = np.linalg.inv(intrinsics) @ hp
    points = rays * depth
    points[:, (disp <= 0).reshape(-1)] = 0.0
    return points


def triangulate_two_view(
    hp0: np.ndarray, hp1: np.ndarray, pose: Pose,
    intrinsics0: np.ndarray, intrinsics1: np.ndarray,
) -> np.ndarray:
    """Midpoint triangulation of correspondences under `pose`.

    Solves, per correspondence, the normal equations of
    min_X sum_i || (I - b_i b_i^T)(X - a_i) ||^2 with ray origins
    a_0 = 0, a_1 = pose.translation and unit directions b_i along the
    backprojected pixels. Returns [3, N] world points.
    """
    n_points = hp0.shape[1]
    eye = np.eye(3, dtype=np.float64)

    def unit_rays(matrix3, hp):
        rays = np.linalg.inv(matrix3) @ hp
        return rays / np.linalg.norm(rays, axis=0, keepdims=True)

    b0 = unit_rays(intrinsics0, hp0)  # camera 0 at the origin
    b1 = unit_rays(intrinsics1 @ pose.rotation.T, hp1)

    # per-point 3x3 systems, batched over N
    def outer(b):  # [3, N] -> [N, 3, 3]
        return b.T[:, :, None] * b.T[:, None, :]

    normal = 2.0 * eye[None] - outer(b0) - outer(b1)  # sum_i (I - b_i b_i^T)
    a1 = pose.translation.astype(np.float64)
    rhs = (eye[None] - outer(b1)) @ a1  # a_0 = 0 contributes nothing
    return np.linalg.solve(normal, rhs[:, :, None])[:, :, 0].T


def ransac_log_scale(
    pred: np.ndarray,
    measured: np.ndarray,
    inlier_threshold: float = SCALE_LOG_INLIER_THRESHOLD,
    n_iters: int = SCALE_RANSAC_ITERS,
) -> tuple[float, float]:
    """RANSAC a multiplicative scale between two positive signals.

    Candidates are the per-sample ratios at random indices; the winner
    maximises the count of |log(measured * s) - log(pred)| < threshold.
    Returns (scale, inlier_ratio). Seeded for deterministic submissions.
    """
    count = len(pred)
    np.random.seed(0)
    keep = np.random.choice(range(count), min(MAX_SAMPLED_CORRESPONDENCES, count))
    pred = pred[keep]
    measured = measured[keep]

    draw = np.random.choice(range(len(pred)), n_iters)
    candidates = (pred / measured)[draw]
    log_err = np.abs(
        np.log(measured[:, None] * candidates[None]) - np.log(pred[:, None])
    )
    votes = (log_err < inlier_threshold).sum(0)
    scale = candidates[np.argmax(votes)]
    inliers = (
        np.abs(np.log(measured * scale) - np.log(pred)) < inlier_threshold
    ).mean()
    return float(scale), float(inliers)


def _depth_positive_fraction_ok(
    intrinsics0, intrinsics1, rotation, translation, hp0, hp1
) -> bool:
    """Cheirality: most triangulated depths positive in both cameras."""
    import cv2

    probe = cv2.triangulatePoints(
        intrinsics0 @ np.concatenate([np.eye(3), np.zeros((3, 1))], -1),
        intrinsics1 @ np.concatenate([rotation, translation], -1),
        hp0[:2],
        hp1[:2],
    )
    depth0 = probe[2] / probe[-1]
    depth1 = (rotation @ (depth0 * (np.linalg.inv(intrinsics0) @ hp0)) + translation)[-1]
    return (depth0 > 0).sum() > (depth0 <= 0).sum() and (
        depth1 > 0
    ).sum() > (depth1 <= 0).sum()


def estimate_ego_pose(
    hp0: np.ndarray, hp1: np.ndarray,
    intrinsics0: np.ndarray, intrinsics1: np.ndarray,
) -> Pose:
    """Camera pose up to scale from an essential-matrix RANSAC.

    Tries all four (R, t) decompositions and keeps the one passing the
    cheirality check; identity/forward if estimation fails.
    """
    import cv2

    norm0 = (np.linalg.inv(intrinsics0) @ hp0)[:2].T
    norm1 = (np.linalg.inv(intrinsics1) @ hp1)[:2].T
    essential, _ = cv2.findEssentialMat(
        norm0, norm1, np.eye(3), cv2.FM_RANSAC, threshold=0.0001
    )
    pose = Pose(np.eye(3), np.asarray([0.0, 0.0, 1.0]))
    if essential is None or essential.shape != (3, 3):
        return pose
    rot_a, rot_b, trans = cv2.decomposeEssentialMat(essential)
    for rotation, translation in (
        (rot_a, trans), (rot_b, trans), (rot_a, -trans), (rot_b, -trans)
    ):
        if _depth_positive_fraction_ok(
            intrinsics0, intrinsics1, rotation, translation, hp0, hp1
        ):
            # convert cam0->cam1 extrinsics to a world-frame camera motion
            pose = Pose(rotation.T, -rotation.T @ translation[:, 0])
    return pose


def _subsample_pairs(
    hp0: np.ndarray, hp1: np.ndarray, mask: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """One shared random draw keeps the correspondences paired."""
    kept0, kept1 = hp0[:, mask], hp1[:, mask]
    draw = np.random.choice(
        range(kept0.shape[1]), min(MAX_SAMPLED_CORRESPONDENCES, kept0.shape[1])
    )
    return kept0[:, draw], kept1[:, draw]


def select_rigid_agreement(
    pose: Pose, hp0, hp1, disp, baseline, intrinsics0, intrinsics1, valid_mask
):
    """Triangulate valid correspondences, register the translation scale
    against the measured disparity, and rank points by how well their
    triangulated inverse depth agrees with it.

    Returns (agreement_mask over valid points, scaled translation,
    agreement ranking) or (None, None, None) when too few points survive.
    """
    hp0 = hp0[:, valid_mask]
    hp1 = hp1[:, valid_mask]
    disp = disp.reshape(-1)[valid_mask]

    points = triangulate_two_view(hp0, hp1, pose, intrinsics0, intrinsics1)
    inv_depth = np.clip(intrinsics0[0, 0] * baseline / points[2], 1e-6, np.inf)

    # keep the nearer half, then a [med/5, med*5] window around its median
    finite = np.logical_and(inv_depth > 1e-12, ~np.isinf(inv_depth))
    kept = finite[finite].copy()
    n_finite = finite.sum()
    ascending = np.argsort(inv_depth[finite])
    kept[ascending[: n_finite - n_finite // 2]] = False
    finite[finite] = kept
    median = np.median(inv_depth[finite])
    finite &= (inv_depth > median / DEPTH_MEDIAN_WINDOW) & (
        inv_depth < median * DEPTH_MEDIAN_WINDOW
    )
    if finite.sum() < 10:
        return None, None, None

    scale, _ = ransac_log_scale(inv_depth[finite], disp[finite])
    log_ratio = np.abs(np.log(inv_depth / scale) - np.log(disp))
    agreement = log_ratio < np.log(AGREEMENT_LOG_RATIO)
    ranking = np.argsort(log_ratio)
    return agreement, pose.translation * scale, ranking


def refine_rigid_background(
    bg_mask: np.ndarray,
    disp: np.ndarray,
    disp_change: np.ndarray,
    flow: np.ndarray,
    intrinsics0: np.ndarray,
    intrinsics1: np.ndarray,
    baseline: float,
    occ_mask: np.ndarray,
    parallax_threshold: float = STATIC_PARALLAX_PX,
):
    """Overwrite background flow / disparity-change with a rigid reprojection.

    Pipeline: essential-matrix pose -> residual-parallax static check ->
    triangulation-agreement point selection -> two-stage PnP polish ->
    reproject the disparity-lifted scene under the polished pose.

    Args mirror the submission files: `disp`/`disp_change` maps, `flow`
    [H, W, 2], boolean background and non-occlusion masks, 3x3 intrinsics.
    Returns (refined_flow, refined_disp_change).
    """
    import cv2

    flow = flow.copy()
    height, width = flow.shape[:2]
    hp0 = pixel_grid_homogeneous(height, width)
    hp1 = np.concatenate(
        [hp0[:2] + flow.reshape(-1, 2).T, hp0[2:]], axis=0
    ).astype(hp0.dtype)

    valid_mask = ((disp > 0) & bg_mask & occ_mask).reshape(-1)

    sampled0, sampled1 = _subsample_pairs(hp0, hp1, valid_mask)
    pose = estimate_ego_pose(sampled0, sampled1, intrinsics0, intrinsics1)

    # residual parallax after removing rotation (plane-at-infinity homography)
    infinity_h = intrinsics0 @ pose.rotation @ np.linalg.inv(intrinsics1)
    rotated_hp1 = infinity_h @ hp1
    rotated_hp1 /= rotated_hp1[-1:]
    parallax = np.linalg.norm(
        (rotated_hp1[:2] - hp0[:2]).T.reshape(height, width, 2), axis=-1
    )
    if parallax[bg_mask].mean() < parallax_threshold:
        # static camera: rigid replacement would be degenerate; keep inputs
        return flow, disp_change

    agreement, _, ranking = select_rigid_agreement(
        pose, hp0, hp1, disp, baseline, intrinsics0, intrinsics1, valid_mask
    )
    if agreement is None:
        return flow, disp_change
    agreement[ranking[MAX_PNP_POINTS:]] = False
    pnp_mask = valid_mask.copy()
    pnp_mask[pnp_mask] = agreement

    scene = lift_disparity(disp, hp0, intrinsics0, baseline)

    # PnP polish: EPnP bootstrap, then iterative refinement from that guess.
    # (The reference used SOLVEPNP_DLS, which modern OpenCV maps to EPnP.)
    object_points = scene.T[pnp_mask, None]
    image_points = hp1[:2].T[pnp_mask, None]
    _, rodrigues, trans = cv2.solvePnP(
        object_points, image_points, intrinsics0, np.zeros(4),
        flags=getattr(cv2, "SOLVEPNP_DLS", cv2.SOLVEPNP_EPNP),
    )
    _, rodrigues, trans = cv2.solvePnP(
        object_points, image_points, intrinsics0, np.zeros(4),
        rodrigues, trans, useExtrinsicGuess=True, flags=cv2.SOLVEPNP_ITERATIVE,
    )
    rotation = cv2.Rodrigues(rodrigues)[0].T
    translation = (-rotation @ trans)[:, 0]
    if np.isinf(np.linalg.norm(translation)):
        return flow, disp_change

    # reproject the lifted scene under the polished pose
    moved = rotation.T @ scene - (rotation.T @ translation)[:, None]
    projected = intrinsics0 @ moved
    projected /= projected[-1:]
    flow[bg_mask] = (projected - hp0).T.reshape(height, width, 3)[bg_mask][:, :2]
    disp_change[bg_mask] = (
        baseline * intrinsics0[0, 0] / moved[-1].reshape(height, width)[bg_mask]
    )
    return flow, disp_change


# public API name used by refine_background.py and the reference CLI
def mod_flow(bg_mask, disp, disp_change, flow, K0, K1, bl, occ_mask,
             parallax_th: float = STATIC_PARALLAX_PX):
    """Reference-named wrapper of `refine_rigid_background`."""
    return refine_rigid_background(
        bg_mask, disp, disp_change, flow, K0, K1, bl, occ_mask,
        parallax_threshold=parallax_th,
    )
