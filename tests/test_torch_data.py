"""PyTorch port: the eval readers (data/io.py, data/datasets.py,
data/protocol_datasets.py) against the JAX package's, on the CPU.

Each reader's files are written under a temporary directory with the JAX
package's own writers (`camliflow_tpu.data.io.save_*`, cv2 for images,
numpy for arrays), as tests/test_sintel.py and tools/make_synthetic_kitti.py
write theirs. The port's sample must equal the JAX reader's key for key,
with every array bit for bit; the readers that draw from numpy's global
random state draw after the same seed on both sides. The writers here also
serve tests/test_torch_protocols.py.
"""

import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from camliflow_tpu.data import datasets as jd
from camliflow_tpu.data import io as jio
from camliflow_tpu.data import protocol_datasets as jpd
from camliflow_tpu.utils.config import Config
from camliflow_torch.data import datasets as td
from camliflow_torch.data import io as tio
from camliflow_torch.data import protocol_datasets as tpd

REPO = Path(__file__).resolve().parents[1]
KITTI_TRAINING = Path("datasets") / "kitti_scene_flow" / "training"


def write_calib(path, f, cx, cy):
    proj = np.zeros((3, 4), np.float32)
    proj[0, 0] = proj[1, 1] = f
    proj[0, 2], proj[1, 2], proj[2, 2] = cx, cy, 1.0
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("P_rect_02: " + " ".join(str(v) for v in proj.reshape(-1)) + "\n")


def write_kitti_training(root, indices, h=120, w=184, seed=0):
    """KITTI's training layout: calibration, both images, the occluded flow
    and both disparities, for `indices`."""
    rng = np.random.RandomState(seed)
    base = Path(root) / "training"
    for sub in ("image_2", "flow_occ", "disp_occ_0", "disp_occ_1"):
        (base / sub).mkdir(parents=True, exist_ok=True)
    yy = np.tile(np.arange(h, dtype=np.float32)[:, None], (1, w))
    for i in indices:
        write_calib(base / "calib_cam_to_cam" / ("%06d.txt" % i), 100.0, (w - 1) / 2, (h - 1) / 2)
        for suffix in ("10", "11"):
            cv2.imwrite(str(base / "image_2" / ("%06d_%s.png" % (i, suffix))),
                        rng.randint(0, 255, (h, w, 3), np.uint8))
        flow = (4 * rng.randn(h, w, 2)).astype(np.float32)
        jio.save_flow_png(base / "flow_occ" / ("%06d_10.png" % i), flow,
                          (rng.rand(h, w) > 0.2).astype(np.float32))
        for sub in ("disp_occ_0", "disp_occ_1"):
            disp = 8.0 + 6.0 * yy / h + rng.rand(h, w).astype(np.float32)
            disp[rng.rand(h, w) < 0.1] = 0  # invalid pixels
            jio.save_disp_png(base / sub / ("%06d_10.png" % i), disp)


def write_kitti_testing(root, n=2):
    subprocess.run([sys.executable, str(REPO / "tools" / "make_synthetic_kitti.py"),
                    "--out", str(root), "--n", str(n)], check=True, capture_output=True,
                   timeout=120)


def write_dpt(path, depth):
    with open(path, "wb") as f:
        np.float32(202021.25).tofile(f)
        np.int32(depth.shape[1]).tofile(f)
        np.int32(depth.shape[0]).tofile(f)
        depth.astype(np.float32).tofile(f)


def write_sintel(root, scenes=("alley_1", "alley_2"), frames=3, h=64, w=96, seed=0):
    """Sintel's layout: final-pass images, .dpt depths and .flo flows."""
    rng = np.random.RandomState(seed)
    root = Path(root)
    for scene in scenes:
        dirs = [root / "flow" / "training" / "final" / scene,
                root / "depth" / "training" / "depth" / scene,
                root / "flow" / "training" / "flow" / scene]
        for d in dirs:
            d.mkdir(parents=True, exist_ok=True)
        for i in range(frames):
            cv2.imwrite(str(dirs[0] / f"frame_{i:04d}.png"),
                        rng.randint(0, 255, (h, w, 3), np.uint8))
            write_dpt(dirs[1] / f"frame_{i:04d}.dpt", rng.rand(h, w).astype(np.float32) * 20 + 2)
            if i < frames - 1:
                jio.save_flow(dirs[2] / f"frame_{i:04d}.flo", rng.randn(h, w, 2).astype(np.float32))


def cloud(rng, n, depth=10.0):
    pc = rng.randn(n, 3).astype(np.float32)
    pc[:, 2] = np.abs(pc[:, 2]) * depth + 5
    return pc


def write_hpl(root, n_dirs, n=600, seed=0):
    """HPLFlowNet's FlyingThings3D val layout: a directory a sample, x and z
    negated (the readers flip them back)."""
    rng = np.random.RandomState(seed)
    for i in range(n_dirs):
        d = Path(root) / "val" / f"{i:07d}"
        d.mkdir(parents=True, exist_ok=True)
        pc1 = cloud(rng, n) * np.float32([-1, 1, -1])
        np.save(d / "pc1.npy", pc1)
        np.save(d / "pc2.npy", pc1 + 0.05 * rng.randn(n, 3).astype(np.float32))


def write_flownet3d_things(root, n_files=3, n=600, seed=0):
    rng = np.random.RandomState(seed)
    Path(root).mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        pc1 = cloud(rng, n)
        flow = 0.05 * rng.randn(n, 3)
        np.savez(Path(root) / f"TEST_A_{i:04d}.npz", points1=pc1.astype(np.float64),
                 points2=(pc1 + flow + 0.01 * rng.randn(n, 3)).astype(np.float64),
                 flow=flow, valid_mask1=rng.rand(n) > 0.3)


def write_kitti_rm_ground(base, n_files=3, sizes=(700, 400, 600), seed=0):
    """FlowNet3D's kitti_rm_ground layout (and the calibrations it reads),
    under `base`, the directory the KITTI protocols run from; one cloud has
    fewer points than 512, so the sampler repeats."""
    rng = np.random.RandomState(seed)
    root = Path(base) / KITTI_TRAINING
    (root / "kitti_rm_ground").mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        pos1 = cloud(rng, sizes[i % len(sizes)])[:, [2, 0, 1]]  # the npz's axis order
        gt = 0.05 * rng.randn(*pos1.shape)
        np.savez(root / "kitti_rm_ground" / f"{i:06d}.npz", pos1=pos1,
                 pos2=pos1 + gt + 0.01 * rng.randn(*pos1.shape), gt=gt)
        write_calib(root / "calib_cam_to_cam" / ("%06d.txt" % i), 721.5, 609.6, 172.9)


def write_kitti_pointpwc(base, n_dirs=3, n=800, seed=0):
    """PointPWC's KITTI layout: a directory a sample, a mapping file (one
    sample unmapped), and the calibrations."""
    rng = np.random.RandomState(seed)
    root = Path(base) / KITTI_TRAINING
    for i in range(n_dirs):
        d = root / "pointcloud" / f"{i:06d}"
        d.mkdir(parents=True, exist_ok=True)
        pc1 = cloud(rng, n, depth=15.0)
        pc1[: n // 10, 1] = -1.5  # ground
        np.save(d / "pc1.npy", pc1)
        np.save(d / "pc2.npy", pc1 + 0.05 * rng.randn(n, 3).astype(np.float32))
        write_calib(root / "calib_cam_to_cam" / ("%06d.txt" % i), 721.5, 609.6, 172.9)
    mapping = ["x"] * n_dirs
    mapping[1] = ""
    (root / "pointcloud" / "KITTI_mapping.txt").write_text("\n".join(mapping) + "\n")


def assert_same_sample(got, want):
    assert list(got) == list(want)
    for key, value in want.items():
        if isinstance(value, np.ndarray):
            assert isinstance(got[key], np.ndarray), key
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
            assert got[key].tobytes() == value.tobytes(), key
        else:
            assert type(got[key]) is type(value) and got[key] == value, key


def kitti_cfgs(root, split, **extra):
    return Config({"name": "kitti", "root_dir": str(root), "split": split, "n_points": 256,
                   "max_depth": 90, "disp_provider": "ganet", "n_workers": 0,
                   "augmentation": {"enabled": False}, **extra})


# --- io -------------------------------------------------------------------

def test_io_codecs_match_jax(tmp_path):
    rng = np.random.RandomState(1)
    image = rng.rand(7, 9, 3).astype(np.float32)
    jio.save_pfm(tmp_path / "a.pfm", image)
    jio.save_pfm(tmp_path / "b.pfm", image[..., 0])
    for name in ("a.pfm", "b.pfm"):
        assert tio.load_pfm(tmp_path / name).tobytes() == jio.load_pfm(tmp_path / name).tobytes()
    jio.save_flow(tmp_path / "f.flo", rng.randn(5, 6, 2).astype(np.float32))
    assert tio.load_flow(tmp_path / "f.flo").tobytes() == jio.load_flow(tmp_path / "f.flo").tobytes()
    disp = 20 * rng.rand(5, 6).astype(np.float32)
    disp[0, :3] = 0
    jio.save_disp_png(tmp_path / "d.png", disp)
    for got, want in zip(tio.load_disp_png(tmp_path / "d.png"),
                         jio.load_disp_png(tmp_path / "d.png")):
        assert got.tobytes() == want.tobytes()
    write_calib(tmp_path / "c.txt", 721.5, 609.6, 172.9)
    assert tio.load_calib(tmp_path / "c.txt").tobytes() == jio.load_calib(tmp_path / "c.txt").tobytes()
    assert (tio.zero_padding(image, 10, 12).tobytes() == jio.zero_padding(image, 10, 12).tobytes())
    with pytest.raises(ValueError):
        tio.zero_padding(image, 6, 12)


def test_io_geometry_matches_jax():
    rng = np.random.RandomState(2)
    disp = 5 + 10 * rng.rand(6, 8).astype(np.float32)
    flow = rng.randn(6, 8, 2).astype(np.float32)
    for extra in ({}, {"flow": flow}):
        got = tio.disp2pc(disp, 0.54, 100.0, 3.5, 2.5, **extra)
        assert got.tobytes() == jio.disp2pc(disp, 0.54, 100.0, 3.5, 2.5, **extra).tobytes()
    pc = cloud(rng, 50)
    for clip in (True, False):
        got = tio.project_pc2image_np(pc, 60, 80, 100.0, 39.5, 29.5, clip=clip)
        want = jio.project_pc2image_np(pc, 60, 80, 100.0, 39.5, 29.5, clip=clip)
        assert got.tobytes() == want.tobytes()
    assert (tio.project_pc2image_np(pc, 60, 80, 100.0).tobytes()
            == jio.project_pc2image_np(pc, 60, 80, 100.0).tobytes())


# --- the datasets ---------------------------------------------------------

@pytest.mark.parametrize("split", ["training40", "training160"])
def test_kitti_matches_jax(tmp_path, split):
    write_kitti_training(tmp_path, indices=range(7))
    port, ref = td.KITTI(kitti_cfgs(tmp_path, split)), jd.KITTI(kitti_cfgs(tmp_path, split))
    assert len(port) == len(ref)
    for i in (0, 1):
        assert_same_sample(port[i], ref[i])


def test_kitti_rejects_augmentation_and_unknown_splits(tmp_path):
    """An unknown split is rejected, with augmentation or without; the
    training half (augmentation) is ported (tests/test_torch_train_kitti.py)
    and builds on a known split."""
    for augmentation in ({"enabled": False}, {"enabled": True}):
        with pytest.raises(ValueError, match="split"):
            td.KITTI(kitti_cfgs(tmp_path, "training7", augmentation=augmentation))
    assert len(td.KITTI(kitti_cfgs(tmp_path, "training160",
                                   augmentation={"enabled": True}))) == 160


@pytest.mark.parametrize("padding", [None, {"target_h": 128, "target_w": 192}])
def test_kitti_test_matches_jax(tmp_path, padding):
    write_kitti_testing(tmp_path)
    extra = {} if padding is None else {"zero_padding": padding}
    cfgs = kitti_cfgs(tmp_path, "testing200", name="kitti_test", **extra)
    port, ref = td.KITTITest(cfgs), jd.KITTITest(cfgs)
    assert len(port) == len(ref) == 200
    for i in (0, 1):
        assert_same_sample(port[i], ref[i])


@pytest.mark.parametrize("split,pass_name", [("trainval", "final"), ("val", "final"),
                                             ("train", "clean_final")])
def test_sintel_matches_jax(tmp_path, split, pass_name):
    write_sintel(tmp_path)
    cfgs = Config({"name": "sintel", "root_dir": str(tmp_path), "split": split,
                   "pass_name": pass_name, "n_points": 128, "max_depth": 30.0,
                   "n_workers": 0, "augmentation": {"enabled": False}})
    port, ref = td.Sintel(cfgs), jd.Sintel(cfgs)
    assert port.samples == ref.samples and len(port) > 0
    for i in range(len(port)):
        assert_same_sample(port[i], ref[i])
    depth = np.random.RandomState(3).rand(4, 5).astype(np.float32)
    write_dpt(tmp_path / "d.dpt", depth)
    assert td.depth_read_dpt(tmp_path / "d.dpt").tobytes() == jd.depth_read_dpt(
        tmp_path / "d.dpt").tobytes()
    assert (td.depth2pc(depth, 100.0, 2.0, 1.5).tobytes()
            == jd.depth2pc(depth, 100.0, 2.0, 1.5).tobytes())


def test_dataset_factory_routes_as_jax(tmp_path):
    write_kitti_training(tmp_path, indices=[0])
    write_kitti_testing(tmp_path, n=1)
    write_sintel(tmp_path / "sintel")
    for cfgs in (kitti_cfgs(tmp_path, "training40"),
                 kitti_cfgs(tmp_path, "testing200", name="kitti_test"),
                 Config({"name": "sintel", "root_dir": str(tmp_path / "sintel"),
                         "split": "train", "pass_name": "final", "n_points": 64,
                         "max_depth": 30.0, "augmentation": {"enabled": False}})):
        port, ref = td.dataset_factory(cfgs), jd.dataset_factory(cfgs)
        assert type(port).__name__ == type(ref).__name__
    with pytest.raises(NotImplementedError):
        td.dataset_factory(Config({"name": "middlebury"}))


# --- the protocols' readers -------------------------------------------------

@pytest.fixture(scope="module")
def hpl_root(tmp_path_factory):
    """HPLFlowNet's val layout at its full count of directories (the JAX
    reader requires it), small clouds."""
    root = tmp_path_factory.mktemp("hpl")
    write_hpl(root, tpd.HPL_VAL_SAMPLES, n=40)
    return root


def test_hpl_matches_jax(hpl_root):
    cfgs = Config({"root_dir": str(hpl_root), "n_points": 32})
    port, ref = tpd.FlyingThings3DSubsetHPL(cfgs), jpd.FlyingThings3DSubsetHPL(cfgs)
    assert port.samples == ref.samples and len(port) == 3824
    for i in (0, 1, 3823):
        np.random.seed(10 + i)
        want = ref[i]
        np.random.seed(10 + i)
        assert_same_sample(port[i], want)


def test_hpl_rejects_another_count(tmp_path):
    write_hpl(tmp_path, 3, n=40)
    with pytest.raises(ValueError, match="3824"):
        tpd.FlyingThings3DSubsetHPL(Config({"root_dir": str(tmp_path), "n_points": 32}))


def test_flownet3d_things_matches_jax(tmp_path):
    write_flownet3d_things(tmp_path)
    cfgs = Config({"root_dir": str(tmp_path), "n_points": 512})
    port, ref = tpd.FlyingThings3DSubsetFlowNet3D(cfgs), jpd.FlyingThings3DSubsetFlowNet3D(cfgs)
    assert port.datapath == ref.datapath and len(port) == 3
    for i in range(3):
        np.random.seed(20 + i)
        want = ref[i]
        np.random.seed(20 + i)
        assert_same_sample(port[i], want)


@pytest.mark.parametrize("reader", ["KITTIFlowNet3D", "KITTIPointPWC"])
def test_kitti_protocol_readers_match_jax(tmp_path, monkeypatch, reader):
    """Both read the reference's relative roots, so they run from a working
    directory that holds them; each seeds numpy's global state itself."""
    write_kitti_rm_ground(tmp_path)
    write_kitti_pointpwc(tmp_path)
    monkeypatch.chdir(tmp_path)
    port, ref = getattr(tpd, reader)(n_points=512), getattr(jpd, reader)(n_points=512)
    assert len(port) == len(ref) > 0
    for i in range(len(port)):
        np.random.seed(30 + i)  # neither reader depends on the state it finds
        want = ref[i]
        np.random.seed(40 + i)
        assert_same_sample(port[i], want)
