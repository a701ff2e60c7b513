"""PyTorch port, the training data path against the JAX package on the CPU:
data/augmentation.py (each transform and the whole pipeline), the
FlyingThings3D reader's training half (cleanfinal, augmentation, point
sampling) and data/loader.py.

The JAX augmentation draws from numpy's global random state; the port's
from an explicit `numpy.random.RandomState`. Each comparison seeds the
global state and a RandomState with the same number, so both draw the
same stream, and the port's output must equal the JAX one bit for bit
(every array, every scalar). The FlyingThings3D tree is
tools/make_synthetic_dataset.py's output (with its clean images copied to
a final pass, so cleanfinal has two passes to pick from).
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from camliflow_tpu.data import augmentation as ja
from camliflow_tpu.data import datasets as jd
from camliflow_tpu.data import loader as jl
from camliflow_tpu.utils.config import Config
from camliflow_torch.data import augmentation as ta
from camliflow_torch.data import datasets as td
from camliflow_torch.data import loader as tl

REPO = Path(__file__).resolve().parents[1]


def sample(seed, h=40, w=56, n=300):
    rng = np.random.RandomState(seed)
    image1 = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    image2 = rng.randint(0, 255, (h, w, 3)).astype(np.uint8)
    pc1 = rng.randn(n, 3).astype(np.float32)
    pc1[:, 2] = np.abs(pc1[:, 2]) * 10 + 5
    pc2 = pc1 + 0.05 * rng.randn(n, 3).astype(np.float32)
    flow_2d = np.concatenate([3 * rng.randn(h, w, 2), rng.rand(h, w, 1) > 0.2], -1)
    flow_3d = (pc2 - pc1).astype(np.float32)
    return [image1, image2, pc1, pc2, flow_2d.astype(np.float32), flow_3d, 60.0,
            (w - 1) / 2, (h - 1) / 2]


def augmentation_cfgs(**enabled):
    on = lambda key: {"enabled": enabled.get(key, True)}  # noqa: E731
    return Config({
        "enabled": True,
        "color_jitter": {**on("color_jitter"), "brightness": 0.3, "contrast": 0.3,
                         "saturation": 0.3, "hue": 0.159},
        "random_horizontal_flip": on("flip"), "random_vertical_flip": on("flip"),
        "random_crop": {**on("crop"), "crop_size": [48, 32], "drop_pc": True},
        "random_scale": {**on("scale"), "scale_range": [1.0, 1.5]},
    })


def same(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        if isinstance(r, np.ndarray):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        else:
            assert g == r


CASES = {
    "color_jitter": (lambda m, s, rng: m.color_jitter(s[0], s[1], 0.3, 0.3, 0.3, 0.159, rng)),
    "flip_lr": (lambda m, s, rng: m.random_flip(*s[:6], *s[6:9], "lr", rng)),
    "flip_ud": (lambda m, s, rng: m.random_flip(*s[:6], *s[6:9], "ud", rng)),
    "crop": (lambda m, s, rng: m.random_crop(*s, [48, 32], True, rng)),
    "scale": (lambda m, s, rng: m.random_scale(*s, [1.0, 1.5], rng)),
    "pipeline": (lambda m, s, rng: m.joint_augmentation(*s, augmentation_cfgs(), rng)),
    "pipeline_no_crop": (lambda m, s, rng: m.joint_augmentation(
        *s, augmentation_cfgs(crop=False), rng)),
}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_augmentation_matches_jax_bit_for_bit(case, seed):
    fn = CASES[case]
    np.random.seed(seed)
    ref = fn(ja, sample(10 + seed), np.random)
    got = fn(ta, sample(10 + seed), np.random.RandomState(seed))
    same(got, ref)


def test_augmentation_disabled_is_the_identity():
    cfgs = augmentation_cfgs()
    cfgs.enabled = False
    s = sample(5)
    same(ta.joint_augmentation(*s, cfgs, np.random.RandomState(0)), s)


@pytest.fixture(scope="module")
def ft3d(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft3d")
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_dataset.py"),
                    "--out", str(root), "--n", "3", "--height", "40", "--width", "56",
                    "--n_points", "600"], check=True, capture_output=True, timeout=120)
    for split in ("train", "val"):
        shutil.copytree(root / split / "image_clean", root / split / "image_final")
    return root


def reader_cfgs(root, pass_name="cleanfinal", augment=True, n_points=512, crop=True):
    aug = augmentation_cfgs(crop=crop, scale=True)
    aug.enabled = augment
    return Config({"name": "flyingthings3d", "root_dir": str(root), "split": "train",
                   "n_points": n_points, "max_depth": 35.0, "pass_name": pass_name,
                   "with_pc": True, "with_image": True, "augmentation": aug.to_dict()})


def same_sample(got, ref):
    assert set(got) == set(ref)
    for key in ref:
        if isinstance(ref[key], np.ndarray):
            assert got[key].dtype == ref[key].dtype, key
            np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
        else:
            assert got[key] == ref[key], key


@pytest.mark.parametrize("pass_name", ["cleanfinal", "clean"])
@pytest.mark.parametrize("seed", [0, 7])
def test_flyingthings3d_training_sample_matches_jax(ft3d, pass_name, seed):
    """The training half: the pass drawn for cleanfinal, the augmentation
    (the shipped one, without the crop: the reader's fixed 960x540
    intrinsics put the synthetic points outside these small images, where
    every crop would come out empty), the point sampling; every array bit
    for bit."""
    cfgs = reader_cfgs(ft3d, pass_name, crop=False)
    jax_set, port_set = jd.FlyingThings3D(cfgs), td.FlyingThings3D(cfgs)
    for i in range(len(jax_set)):
        np.random.seed(seed + i)
        ref = jax_set[i]
        same_sample(port_set.sample(i, np.random.RandomState(seed + i)), ref)


def test_flyingthings3d_without_augmentation_is_the_eval_reader(ft3d):
    cfgs = reader_cfgs(ft3d, "clean", augment=False, n_points=512)
    jax_set, port_set = jd.FlyingThings3D(cfgs), td.FlyingThings3D(cfgs)
    for i in range(len(jax_set)):
        same_sample(port_set[i], jax_set[i])


def test_flyingthings3d_training_draws_by_seed_epoch_and_index(ft3d):
    """In a run each sample draws from RandomState((seed, epoch, index)):
    the same sample whichever thread reads it, another one next epoch."""
    port_set = td.FlyingThings3D(reader_cfgs(ft3d, crop=False), seed=3)
    first = port_set[1]
    same_sample(port_set[1], first)
    same_sample(port_set.sample(1, np.random.RandomState([3, 0, 1])), first)
    port_set.set_epoch(1)
    assert not np.array_equal(port_set[1]["pcs"], first["pcs"])


class Numbers:
    """A dataset of n samples, each its index."""

    def __init__(self, n):
        self.n = n
        self.epochs = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"index": i, "x": np.full((2,), i, np.float32)}

    def set_epoch(self, epoch):
        self.epochs.append(epoch)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_batches_match_jax(workers, drop_last):
    """Epoch-seeded shuffling and drop_last as the JAX loader (one shard),
    on worker threads or in the calling thread."""
    data = Numbers(11)
    for epoch in (0, 1, 5):
        ref = jl.DataLoader(data, 4, shuffle=True, num_workers=0, drop_last=drop_last, seed=2)
        ref.set_epoch(epoch)
        got = tl.DataLoader(data, 4, shuffle=True, num_workers=workers, drop_last=drop_last,
                            seed=2)
        got.set_epoch(epoch)
        assert len(got) == len(ref) == (2 if drop_last else 3)
        ref_batches, got_batches = list(ref), list(got)
        assert len(got_batches) == len(ref_batches)
        for g, r in zip(got_batches, ref_batches):
            np.testing.assert_array_equal(g["index"], r["index"])
            np.testing.assert_array_equal(g["x"], r["x"])
    assert data.epochs[-1] == 5  # the loader passes its epoch on to the dataset


def test_loader_raises_a_worker_error_and_stops():
    class Broken(Numbers):
        def __getitem__(self, i):
            if i == 5:
                raise ValueError("bad sample")
            return super().__getitem__(i)

    loader = tl.DataLoader(Broken(12), 2, shuffle=False, num_workers=2)
    with pytest.raises(ValueError, match="bad sample"):
        list(loader)
    partial = iter(tl.DataLoader(Numbers(40), 2, num_workers=2))
    next(partial)
    partial.close()  # an abandoned epoch stops its producer
