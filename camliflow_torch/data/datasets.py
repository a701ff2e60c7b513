"""FlyingThings3D for evaluation, and a sequential batch loader.

The port's copy of the eval half of camliflow_tpu/data/datasets.py
(`FlyingThings3D`) and camliflow_tpu/data/loader.py (`collate`), with the
same channel-last sample format:
  images  [H, W, 6]   (frame1 | frame2, RGB uint8-as-float)
  flow_2d [H, W, 3]   (u, v, validity)
  pcs     [N, 6]      (pc1 | pc2)
  flow_3d [N, 3]
  occ_mask_3d [N]
  intrinsics [3] = (f, cx, cy)
Augmentation (training) is not ported. The loader reads samples one after
another in the calling thread: the config's `n_workers` is not used.
"""

from __future__ import annotations

import os

import numpy as np

from . import io


class FlyingThings3D:
    """Preprocessed FlyingThings3D subset, eval split."""

    def __init__(self, cfgs):
        if cfgs.augmentation.enabled:
            raise NotImplementedError(
                "FlyingThings3D augmentation (training) is not ported; see "
                "ROADMAP.md Queue 1 item 9 (training)"
            )
        assert os.path.isdir(cfgs.root_dir), cfgs.root_dir
        self.split_dir = os.path.join(str(cfgs.root_dir), str(cfgs.split))
        self.cfgs = cfgs
        self.indices = sorted(
            int(fn.split(".")[0])
            for fn in os.listdir(os.path.join(self.split_dir, "flow_2d"))
        )

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        rng = np.random.RandomState(0)  # deterministic point sampling
        idx1 = self.indices[i]
        data = {"index": idx1}
        f, cx, cy = 1050.0, 479.5, 269.5
        path = lambda sub, name: os.path.join(self.split_dir, sub, name)  # noqa: E731

        images = f"image_{self.cfgs.pass_name}"
        image1 = io.load_image_rgb(path(images, "%07d.png" % idx1))
        image2 = io.load_image_rgb(path(images, "%07d.png" % (idx1 + 1)))
        flow_2d, flow_mask_2d = io.load_flow_png(path("flow_2d", "%07d.png" % idx1))

        pc_dict = np.load(path("pc", "%07d.npz" % idx1))
        flow_3d = np.load(path("flow_3d", "%07d.npy" % idx1))
        pc1, pc2 = pc_dict["pc1"], pc_dict["pc2"]

        if os.path.exists(os.path.join(self.split_dir, "occ_mask_3d")):
            occ_mask_3d = np.load(path("occ_mask_3d", "%07d.npy" % idx1))
            occ_mask_3d = np.unpackbits(occ_mask_3d, count=len(pc1))
        else:
            occ_mask_3d = np.zeros(len(pc1), dtype=bool)

        # ignore fast-moving objects
        flow_mask_2d = np.logical_and(
            flow_mask_2d, np.linalg.norm(flow_2d, axis=-1) < 250.0
        )
        flow_2d = np.concatenate(
            [flow_2d, flow_mask_2d[..., None].astype(np.float32)], axis=2
        )

        n_points = self.cfgs.n_points
        if pc1.shape[0] != n_points:
            idxs1 = rng.choice(pc1.shape[0], size=n_points, replace=pc1.shape[0] < n_points)
            idxs2 = rng.choice(pc2.shape[0], size=n_points, replace=pc2.shape[0] < n_points)
            pc1, pc2 = pc1[idxs1], pc2[idxs2]
            flow_3d, occ_mask_3d = flow_3d[idxs1], occ_mask_3d[idxs1]

        if self.cfgs.with_pc:
            data["pcs"] = np.concatenate([pc1, pc2], axis=1).astype(np.float32)
            data["flow_3d"] = flow_3d.astype(np.float32)
            data["intrinsics"] = np.float32([f, cx, cy])
            data["occ_mask_3d"] = occ_mask_3d.astype(np.float32)
        if self.cfgs.with_image:
            data["images"] = np.concatenate([image1, image2], axis=-1).astype(np.float32)
            data["flow_2d"] = flow_2d.astype(np.float32)
        return data


def dataset_factory(cfgs):
    """The eval datasets ported so far, by `cfgs.name`."""
    if cfgs["name"] == "flyingthings3d":
        return FlyingThings3D(cfgs)
    raise NotImplementedError(
        f"dataset {cfgs['name']} is not ported; see ROADMAP.md Queue 1 item 8"
    )


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into batched arrays."""
    out = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float, np.integer, np.floating)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def batches(dataset, batch_size: int):
    """Consecutive batches in dataset order, the last one possibly short."""
    for start in range(0, len(dataset), batch_size):
        stop = min(start + batch_size, len(dataset))
        yield collate([dataset[i] for i in range(start, stop)])
