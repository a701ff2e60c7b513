"""The datasets (FlyingThings3D and KITTI for training and eval, KITTI's test
split and Sintel for eval) and a sequential batch loader.

The port's copy of camliflow_tpu/data/datasets.py and of
camliflow_tpu/data/loader.py's `collate`, with the same channel-last sample
format:
  images  [H, W, 6]   (frame1 | frame2, RGB uint8-as-float)
  flow_2d [H, W, 3]   (u, v, validity)
  pcs     [N, 6]      (pc1 | pc2)
  flow_3d [N, 3]      (KITTI: [N, 4], a validity channel of ones)
  occ_mask_3d [N]
  intrinsics [3] = (f, cx, cy)
Without augmentation, points are sampled with the reference's fixed seeds,
so a sample equals the JAX reader's bit for bit. With augmentation
(training), FlyingThings3D and KITTI draw every random choice (the pass,
the augmentation, the points) from one explicit `numpy.random.RandomState`
per sample, in the JAX reader's order: seeded as the JAX package's global
`np.random`, it gives the JAX sample bit for bit (`sample`); in a run it is
seeded by (seed, epoch, index), so a sample does not depend on which worker
thread reads it. `batches` reads samples one after another in the calling
thread; data/loader.py's `DataLoader` reads them on worker threads.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from . import io
from .augmentation import joint_augmentation


def sample_points(rng, n: int, n_points: int):
    """`n_points` indices into n points, without repeats when there are
    enough (the reference's sampling, in its order of draws)."""
    return rng.choice(n, size=n_points, replace=n < n_points)


class FlyingThings3D:
    """Preprocessed FlyingThings3D subset: the eval split, or with
    augmentation the training split."""

    def __init__(self, cfgs, seed: int = 0):
        assert os.path.isdir(cfgs.root_dir), cfgs.root_dir
        self.split_dir = os.path.join(str(cfgs.root_dir), str(cfgs.split))
        self.cfgs = cfgs
        self.seed = seed
        self.epoch = 0
        self.indices = sorted(
            int(fn.split(".")[0])
            for fn in os.listdir(os.path.join(self.split_dir, "flow_2d"))
        )

    def __len__(self):
        return len(self.indices)

    def set_epoch(self, epoch: int) -> None:
        """The epoch that seeds each sample's draws with augmentation."""
        self.epoch = epoch

    def __getitem__(self, i):
        if self.cfgs.augmentation.enabled:
            rng = np.random.RandomState([self.seed, self.epoch, i])
        else:
            rng = np.random.RandomState(0)  # deterministic point sampling
        return self.sample(i, rng)

    def sample(self, i, rng: np.random.RandomState) -> dict:
        """Sample i, every random draw from `rng`."""
        augment = self.cfgs.augmentation.enabled
        idx1 = self.indices[i]
        data = {"index": idx1}
        f, cx, cy = 1050.0, 479.5, 269.5
        path = lambda sub, name: os.path.join(self.split_dir, sub, name)  # noqa: E731

        pass_name = self.cfgs.pass_name
        if pass_name == "cleanfinal" and augment:
            pass_name = "clean" if rng.randint(2) == 0 else "final"
        images = f"image_{pass_name}"
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

        # augmentation, drawn again after an empty crop
        while augment:
            try:
                results = joint_augmentation(image1, image2, pc1, pc2, flow_2d, flow_3d, f,
                                             cx, cy, self.cfgs.augmentation, rng)
            except AssertionError:
                continue
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy = results
            break

        n_points = self.cfgs.n_points
        if augment or pc1.shape[0] != n_points:
            idxs1 = sample_points(rng, pc1.shape[0], n_points)
            idxs2 = sample_points(rng, pc2.shape[0], n_points)
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


class KITTI:
    """KITTI scene-flow training splits: training160 with augmentation for
    fine-tuning, the others for evaluation (JAX data/datasets.py:126, the
    reference's kitti.py)."""

    SPLITS = ("training200", "training160", "training40", "testing200")

    def __init__(self, cfgs, seed: int = 0):
        assert os.path.isdir(cfgs.root_dir), cfgs.root_dir
        if cfgs.split not in self.SPLITS:
            raise ValueError(f"KITTI split must be one of {self.SPLITS}, got {cfgs.split!r}")
        sub = "training" if "training" in cfgs.split else "testing"
        self.root_dir = os.path.join(cfgs.root_dir, sub)
        self.cfgs = cfgs
        self.seed = seed
        self.epoch = 0
        if cfgs.split in ("training200", "testing200"):
            self.indices = list(range(200))
        elif cfgs.split == "training160":
            self.indices = [i for i in range(200) if i % 5 != 0]
        else:
            self.indices = [i for i in range(200) if i % 5 == 0]

    def __len__(self):
        return len(self.indices)

    def set_epoch(self, epoch: int) -> None:
        """The epoch that seeds each sample's draws with augmentation."""
        self.epoch = epoch

    def __getitem__(self, i):
        if self.cfgs.augmentation.enabled:
            rng = np.random.RandomState([self.seed, self.epoch, i])
        else:
            rng = np.random.RandomState(23333)  # deterministic point sampling
        return self.sample(i, rng)

    def sample(self, i, rng: np.random.RandomState) -> dict:
        """Sample i, every random draw from `rng`: the augmentation (after
        the zero padding to 376 x 1242, so a flip moves the padding to the
        left), then pc1's points, then pc2's."""
        index = self.indices[i]
        data = {"index": index}
        path = lambda sub, name: os.path.join(self.root_dir, sub, name % index)  # noqa: E731

        proj_mat = io.load_calib(path("calib_cam_to_cam", "%06d.txt"))
        f, cx, cy = proj_mat[0, 0], proj_mat[0, 2], proj_mat[1, 2]
        image1 = io.load_image_rgb(path("image_2", "%06d_10.png"))
        image2 = io.load_image_rgb(path("image_2", "%06d_11.png"))
        data["input_h"], data["input_w"] = image1.shape[:2]

        flow_2d, flow_2d_mask = io.load_flow_png(path("flow_occ", "%06d_10.png"))
        disp1, mask1 = io.load_disp_png(path("disp_occ_0", "%06d_10.png"))
        disp2, mask2 = io.load_disp_png(path("disp_occ_1", "%06d_10.png"))
        mask = np.logical_and(np.logical_and(mask1, mask2), flow_2d_mask)

        pc1 = io.disp2pc(disp1, baseline=0.54, f=f, cx=cx, cy=cy)[mask]
        pc2 = io.disp2pc(disp2, baseline=0.54, f=f, cx=cx, cy=cy, flow=flow_2d)[mask]
        flow_3d = pc2 - pc1
        flow_3d_mask = np.ones(flow_3d.shape[0], dtype=np.float32)

        # frame 2's points that leave the image are dropped: realistic occlusion
        image_h, image_w = disp2.shape[:2]
        xy2 = io.project_pc2image_np(pc2, image_h, image_w, f, cx, cy, clip=False)
        inside = ((xy2[..., 0] >= 0) & (xy2[..., 0] < image_w)
                  & (xy2[..., 1] >= 0) & (xy2[..., 1] < image_h))
        pc2 = pc2[inside]

        flow_2d = np.concatenate([flow_2d, flow_2d_mask[..., None].astype(np.float32)], axis=-1)
        flow_3d = np.concatenate([flow_3d, flow_3d_mask[..., None]], axis=-1)
        image1 = io.zero_padding(image1, 376, 1242)
        image2 = io.zero_padding(image2, 376, 1242)
        flow_2d = io.zero_padding(flow_2d, 376, 1242)

        image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy = joint_augmentation(
            image1, image2, pc1, pc2, flow_2d, flow_3d, f, cx, cy, self.cfgs.augmentation, rng)

        n_points = self.cfgs.n_points
        idxs1 = sample_points(rng, pc1.shape[0], n_points)
        idxs2 = sample_points(rng, pc2.shape[0], n_points)
        pc1, pc2, flow_3d = pc1[idxs1], pc2[idxs2], flow_3d[idxs1]

        data["images"] = np.concatenate([image1, image2], axis=-1).astype(np.float32)
        data["flow_2d"] = flow_2d.astype(np.float32)
        data["pcs"] = np.concatenate([pc1, pc2], axis=1).astype(np.float32)
        data["flow_3d"] = flow_3d.astype(np.float32)
        data["intrinsics"] = np.float32([f, cx, cy])
        return data


class KITTITest:
    """KITTI's test split with disparities from a stereo method (JAX
    data/datasets.py:222, the reference's kitti.py)."""

    def __init__(self, cfgs):
        assert os.path.isdir(cfgs.root_dir), cfgs.root_dir
        if cfgs.split != "testing200":
            raise ValueError(f"KITTITest split must be testing200, got {cfgs.split!r}")
        self.root_dir = os.path.join(cfgs.root_dir, "testing")
        self.cfgs = cfgs

    def __len__(self):
        return 200

    def __getitem__(self, index):
        rng = np.random.RandomState(23333)
        data = {"index": index}
        path = lambda sub, name: os.path.join(self.root_dir, sub, name % index)  # noqa: E731

        proj_mat = io.load_calib(path("calib_cam_to_cam", "%06d.txt"))
        f, cx, cy = proj_mat[0, 0], proj_mat[0, 2], proj_mat[1, 2]
        image1 = io.load_image_rgb(path("image_2", "%06d_10.png"))
        image2 = io.load_image_rgb(path("image_2", "%06d_11.png"))
        data["input_h"], data["input_w"] = image1.shape[:2]

        provider = self.cfgs.disp_provider
        disp1, mask1 = io.load_disp_png(path(f"disp_{provider}", "%06d_10.png"))
        disp2, mask2 = io.load_disp_png(path(f"disp_{provider}", "%06d_11.png"))
        mask1[:110] = 0  # the top 110 rows: sky
        mask2[:110] = 0

        pc1 = io.disp2pc(disp1, baseline=0.54, f=f, cx=cx, cy=cy)[mask1]
        pc2 = io.disp2pc(disp2, baseline=0.54, f=f, cx=cx, cy=cy)[mask2]
        pc1 = pc1[pc1[..., 1] > -2.0]
        pc2 = pc2[pc2[..., 1] > -2.0]
        pc1 = pc1[pc1[..., -1] < self.cfgs.max_depth]
        pc2 = pc2[pc2[..., -1] < self.cfgs.max_depth]

        pad = self.cfgs.get("zero_padding", {})  # the reference fixes 376x1242
        pad_h, pad_w = int(pad.get("target_h", 376)), int(pad.get("target_w", 1242))
        image1 = io.zero_padding(image1, pad_h, pad_w)
        image2 = io.zero_padding(image2, pad_h, pad_w)

        n_points = self.cfgs.n_points
        idxs1 = sample_points(rng, pc1.shape[0], n_points)
        idxs2 = sample_points(rng, pc2.shape[0], n_points)
        pc1, pc2 = pc1[idxs1], pc2[idxs2]

        data["images"] = np.concatenate([image1, image2], axis=-1).astype(np.float32)
        data["pcs"] = np.concatenate([pc1, pc2], axis=1).astype(np.float32)
        data["intrinsics"] = np.float32([f, cx, cy])
        return data


# the reference's unofficial Sintel train/val scene split
SINTEL_TRAIN_SCENES = [
    "alley_1", "ambush_4", "ambush_6", "ambush_7", "bamboo_2", "bandage_2",
    "cave_2", "market_2", "market_5", "shaman_2", "sleeping_2", "temple_3",
]
SINTEL_VALIDATE_SCENES = [
    "alley_2", "ambush_2", "ambush_5", "bamboo_1", "bandage_1", "cave_4",
    "market_6", "mountain_1", "shaman_3", "sleeping_1", "temple_2",
]


def depth_read_dpt(filename):
    """Read a Sintel .dpt depth map, [H, W] f32."""
    with open(filename, "rb") as f:
        check = np.fromfile(f, dtype=np.float32, count=1)[0]
        if check != 202021.25:
            raise ValueError(f"wrong tag in {filename}")
        width = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        height = int(np.fromfile(f, dtype=np.int32, count=1)[0])
        return np.fromfile(f, dtype=np.float32, count=-1).reshape((height, width))


def depth2pc(depth, f, cx, cy):
    """Lift a dense [H, W] depth map to [H, W, 3] points."""
    h, w = depth.shape
    xx = np.tile(np.arange(w, dtype=np.float32)[None, :], (h, 1))
    yy = np.tile(np.arange(h, dtype=np.float32)[:, None], (1, w))
    return np.stack([(xx - cx) * depth / f, (yy - cy) * depth / f, depth], axis=-1)


class Sintel:
    """MPI Sintel with clouds lifted from its depth maps, for 2D evaluation
    (JAX data/datasets.py:317, the reference's sintel.py)."""

    def __init__(self, cfgs):
        assert os.path.isdir(cfgs.root_dir), cfgs.root_dir
        if cfgs.pass_name not in ("clean", "final", "clean_final"):
            raise ValueError(f"Sintel pass must be clean|final|clean_final, got "
                             f"{cfgs.pass_name!r}")
        self.cfgs = cfgs
        scenes = {"train": SINTEL_TRAIN_SCENES, "val": SINTEL_VALIDATE_SCENES,
                  "trainval": SINTEL_TRAIN_SCENES + SINTEL_VALIDATE_SCENES}
        if cfgs.split not in scenes:
            raise ValueError(cfgs.split)
        self.samples = []
        for pass_name in ("clean", "final"):
            if pass_name not in cfgs.pass_name:
                continue
            for scene in scenes[cfgs.split]:
                image_dir = os.path.join(cfgs.root_dir, "flow", "training", pass_name, scene)
                depth_dir = os.path.join(cfgs.root_dir, "depth", "training", "depth", scene)
                flow_dir = os.path.join(cfgs.root_dir, "flow", "training", "flow", scene)
                if not os.path.isdir(image_dir):
                    continue  # a partial download (the reference asserts)
                image_paths = sorted(glob.glob(os.path.join(image_dir, "*.png")))
                depth_paths = sorted(glob.glob(os.path.join(depth_dir, "*.dpt")))
                flow_paths = sorted(glob.glob(os.path.join(flow_dir, "*.flo")))
                if not len(image_paths) == len(depth_paths) == len(flow_paths) + 1:
                    raise ValueError(f"Sintel scene {scene}: {len(image_paths)} images, "
                                     f"{len(depth_paths)} depths, {len(flow_paths)} flows")
                for i, flow_path in enumerate(flow_paths):
                    self.samples.append({
                        "image1_path": image_paths[i],
                        "image2_path": image_paths[i + 1],
                        "depth1_path": depth_paths[i],
                        "depth2_path": depth_paths[i + 1],
                        "flow_path": flow_path,
                        "scene_name": scene,
                        "sample_name": os.path.basename(image_paths[i]).split(".")[0],
                    })

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index):
        rng = np.random.RandomState(0)
        sample = self.samples[index]
        data = {"index": index, "scene_name": sample["scene_name"],
                "sample_name": sample["sample_name"]}

        image1 = io.load_image_rgb(sample["image1_path"])
        image2 = io.load_image_rgb(sample["image2_path"])
        depth1 = depth_read_dpt(sample["depth1_path"])
        depth2 = depth_read_dpt(sample["depth2_path"])
        flow_2d = io.load_flow(sample["flow_path"])

        # rescale depth until n_points lie within max_depth, then put the
        # nearest at 5 m
        max_depth = self.cfgs.max_depth
        while min(np.count_nonzero(depth1 < max_depth),
                  np.count_nonzero(depth2 < max_depth)) < self.cfgs.n_points:
            depth1 *= 0.1
            depth2 *= 0.1
        min_depth = min(np.min(depth1), np.min(depth2))
        depth1 += 5 - min_depth
        depth2 += 5 - min_depth

        f, cx, cy = 1500.0, 511.5, 217.5
        pc1 = depth2pc(depth1, f, cx, cy)
        pc2 = depth2pc(depth2, f, cx, cy)
        flow_3d = np.zeros_like(pc1)

        mask1 = pc1[..., -1] < max(np.min(pc1[..., -1]) + 1, max_depth)
        mask2 = pc2[..., -1] < max(np.min(pc2[..., -1]) + 1, max_depth)
        pc1, pc2, flow_3d = pc1[mask1], pc2[mask2], flow_3d[mask1]

        n_points = self.cfgs.n_points
        idxs1 = sample_points(rng, pc1.shape[0], n_points)
        idxs2 = sample_points(rng, pc2.shape[0], n_points)
        pc1, pc2, flow_3d = pc1[idxs1], pc2[idxs2], flow_3d[idxs1]

        data["pcs"] = np.concatenate([pc1, pc2], axis=1).astype(np.float32)
        data["flow_3d"] = flow_3d.astype(np.float32)
        data["intrinsics"] = np.float32([f, cx, cy])
        data["images"] = np.concatenate([image1, image2], axis=-1).astype(np.float32)
        data["flow_2d"] = flow_2d.astype(np.float32)
        return data


def dataset_factory(cfgs, seed: int = 0):
    """The dataset named by `cfgs.name`; `seed` seeds the augmentation of
    the readers that train (FlyingThings3D, KITTI)."""
    readers = {"flyingthings3d": FlyingThings3D, "kitti": KITTI, "kitti_test": KITTITest,
               "sintel": Sintel}
    if cfgs["name"] not in readers:
        raise NotImplementedError(f"Unknown dataset: {cfgs['name']}")
    if cfgs["name"] in ("flyingthings3d", "kitti"):
        return readers[cfgs["name"]](cfgs, seed)
    return readers[cfgs["name"]](cfgs)


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
