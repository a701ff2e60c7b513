"""The published scene-flow protocols' test sets: the port's copy of
camliflow_tpu/data/protocol_datasets.py (the reference's eval_*_sf.py
readers), with the same channel-last samples ([N, 6] pcs, [N, 3] flow) and
the same draws from numpy's global random state: the FlyingThings3D readers
draw unseeded, as the reference does, and the KITTI readers seed it with 1
before each sample.

- FlyingThings3DSubsetHPL       non-occluded, HPLFlowNet's protocol
- FlyingThings3DSubsetFlowNet3D occluded, FlowNet3D's (TEST*.npz)
- KITTIFlowNet3D                occluded KITTI, FlowNet3D's (kitti_rm_ground)
- KITTIPointPWC                 non-occluded KITTI, PointPWC's
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .io import load_calib

HPL_VAL_SAMPLES = 3824  # the HPLFlowNet preprocessing's val directories

# domain-alignment statistics for Things -> KITTI transfer, which
# CamLiRAFT-L's renormalisation reads from the samples
KITTI_FLOWNET3D_STATS = {
    "src_mean": np.array([3.8450, -3.6596, 86.1627], dtype=np.float32),
    "src_std": np.array([10.1774, 1.2327, 13.5970], dtype=np.float32),
    "dst_mean": np.array([0.079332, 1.8988, 91.909], dtype=np.float32),
    "dst_std": np.array([8.0472, 4.1851, 13.6923], dtype=np.float32),
}
KITTI_POINTPWC_STATS = {
    "src_mean": np.array([1.9823, -4.0814, 87.4855], dtype=np.float32),
    "src_std": np.array([11.1490, 1.3005, 10.9335], dtype=np.float32),
    "dst_mean": np.array([0.079332, 1.8988, 91.909], dtype=np.float32),
    "dst_std": np.array([8.0472, 4.1851, 13.6923], dtype=np.float32),
}
THINGS_INTRINSICS = np.float32([1050, 479.5, 269.5])


def kitti_intrinsics(calib_root: str, index: int) -> np.ndarray:
    proj_mat = load_calib(os.path.join(calib_root, "%06d.txt" % index))
    return np.float32([proj_mat[0, 0], proj_mat[0, 2], proj_mat[1, 2]])


class FlyingThings3DSubsetHPL:
    """Non-occluded evaluation following HPLFlowNet."""

    def __init__(self, cfgs):
        self.root_dir = cfgs.root_dir
        self.n_points = cfgs.n_points
        split_dir = os.path.join(self.root_dir, "val")
        useful = sorted(item[0] for item in os.walk(split_dir) if len(item[1]) == 0)
        if len(useful) != HPL_VAL_SAMPLES:
            raise ValueError(f"expected {HPL_VAL_SAMPLES} val dirs, got {len(useful)}")
        self.samples = useful

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        pc1 = np.load(os.path.join(self.samples[index], "pc1.npy"))
        pc2 = np.load(os.path.join(self.samples[index], "pc2.npy"))
        # the subset's axes: x and z flipped
        pc1[..., -1] *= -1
        pc2[..., -1] *= -1
        pc1[..., 0] *= -1
        pc2[..., 0] *= -1
        sf = pc2[:, :3] - pc1[:, :3]

        idx1 = np.random.choice(pc1.shape[0], size=self.n_points, replace=False)
        idx2 = np.random.choice(pc2.shape[0], size=self.n_points, replace=False)
        pc1, pc2, sf = pc1[idx1], pc2[idx2], sf[idx1]
        return {
            "index": index,
            "pcs": np.concatenate([pc1, pc2], axis=1).astype(np.float32),
            "flow_3d": sf.astype(np.float32),
            "intrinsics": THINGS_INTRINSICS.copy(),
        }


class FlyingThings3DSubsetFlowNet3D:
    """Occluded evaluation following FlowNet3D (TEST*.npz with valid_mask1)."""

    def __init__(self, cfgs):
        self.root_dir = cfgs.root_dir
        self.n_points = cfgs.n_points
        self.datapath = glob.glob(os.path.join(self.root_dir, "TEST*.npz"))

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        with open(self.datapath[index], "rb") as fp:
            data = np.load(fp)
            pc1 = data["points1"].astype(np.float32)
            pc2 = data["points2"].astype(np.float32)
            sf = data["flow"].astype(np.float32)
            noc_mask = data["valid_mask1"].astype(bool)

        idx1 = np.random.choice(pc1.shape[0], size=self.n_points, replace=False)
        idx2 = np.random.choice(pc2.shape[0], size=self.n_points, replace=False)
        pc1, pc2, sf, noc_mask = pc1[idx1], pc2[idx2], sf[idx1], noc_mask[idx1]
        return {
            "index": index,
            "pcs": np.concatenate([pc1, pc2], axis=1).astype(np.float32),
            "flow_3d": sf.astype(np.float32),
            "intrinsics": THINGS_INTRINSICS.copy(),
            "noc_mask_3d": noc_mask.astype(np.float32),
        }


class KITTIFlowNet3D:
    """Occluded KITTI evaluation following FlowNet3D (kitti_rm_ground npz)."""

    def __init__(self, root="datasets/kitti_scene_flow/training/kitti_rm_ground",
                 n_points=8192,
                 calib_root="datasets/kitti_scene_flow/training/calib_cam_to_cam"):
        self.n_points = n_points
        self.root = root
        self.calib_root = calib_root
        self.datapath = glob.glob(os.path.join(self.root, "*.npz"))

    def __len__(self):
        return len(self.datapath)

    def __getitem__(self, index):
        np.random.seed(1)
        with open(self.datapath[index], "rb") as fp:
            data = np.load(fp)
            pos1, pos2, flow = data["pos1"], data["pos2"], data["gt"]

        def sample(n):  # every point once, then repeats, when there are too few
            if n >= self.n_points:
                return np.random.choice(n, self.n_points, replace=False)
            return np.concatenate(
                [np.arange(n), np.random.choice(n, self.n_points - n, replace=True)]
            )

        idx1, idx2 = sample(pos1.shape[0]), sample(pos2.shape[0])
        pos1, pos2, flow = pos1[idx1], pos2[idx2], flow[idx1]
        order = [1, 2, 0]  # the npz's axes to the camera's
        pos1, pos2, flow = pos1[:, order], pos2[:, order], flow[:, order]
        return {
            "index": index,
            "pcs": np.concatenate([pos1, pos2], axis=1).astype(np.float32),
            "flow_3d": flow.astype(np.float32),
            "intrinsics": kitti_intrinsics(self.calib_root, index),
            **KITTI_FLOWNET3D_STATS,
        }


class KITTIPointPWC:
    """Non-occluded KITTI evaluation following PointPWC."""

    def __init__(self, root="datasets/kitti_scene_flow/training/pointcloud",
                 n_points=8192, max_depth=35.0, remove_ground=True,
                 calib_root="datasets/kitti_scene_flow/training/calib_cam_to_cam"):
        self.root = root
        self.calib_root = calib_root
        self.n_points = n_points
        self.max_depth = max_depth
        self.remove_ground = remove_ground
        self.samples = self._make_dataset()

    def _make_dataset(self):
        root = os.path.realpath(os.path.expanduser(self.root))
        useful = [item[0] for item in sorted(os.walk(root)) if len(item[1]) == 0]
        mapping_path = os.path.join(self.root, "KITTI_mapping.txt")
        if os.path.exists(mapping_path):
            with open(mapping_path) as fd:
                lines = [line.strip() for line in fd.readlines()]
            useful = [p for p in useful if lines[int(os.path.split(p)[-1])] != ""]
        return useful

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        pc1 = np.load(os.path.join(self.samples[index], "pc1.npy"))
        pc2 = np.load(os.path.join(self.samples[index], "pc2.npy"))
        if self.remove_ground:
            not_ground = ~np.logical_and(pc1[:, 1] < -1.4, pc2[:, 1] < -1.4)
            pc1, pc2 = pc1[not_ground], pc2[not_ground]

        np.random.seed(1)
        sf = pc2[:, :3] - pc1[:, :3]
        near = np.logical_and(pc1[:, 2] < self.max_depth, pc2[:, 2] < self.max_depth)
        indices = np.where(near)[0]
        if len(indices) == 0:
            raise ValueError(f"no point nearer than {self.max_depth} m in "
                             f"{self.samples[index]}")
        try:
            idx1 = np.random.choice(indices, size=self.n_points, replace=False)
            idx2 = np.random.choice(indices, size=self.n_points, replace=False)
        except ValueError:  # fewer near points than n_points
            idx1 = np.random.choice(indices, size=self.n_points, replace=True)
            idx2 = np.random.choice(indices, size=self.n_points, replace=True)

        pc1, sf, pc2 = pc1[idx1], sf[idx1], pc2[idx2]
        return {
            "index": index,
            "pcs": np.concatenate([pc1, pc2], axis=1).astype(np.float32),
            "flow_3d": sf.astype(np.float32),
            "intrinsics": kitti_intrinsics(self.calib_root, index),
            **KITTI_POINTPWC_STATS,
        }
