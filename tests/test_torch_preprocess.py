"""PyTorch port, `python -m camliflow_torch.preprocess_flyingthings3d_subset`
against the JAX package's preprocess_flyingthings3d_subset.py, on the CPU.

A small raw FlyingThings3D subset (train and val, 3 frames each at 60x80)
is written with the JAX package's writers (`save_pfm`, `save_flow`, OpenCV
PNGs): disparities of 25-240 px (depths 4.4-42 m, so the 35 m cut bites)
with a few NaNs, disparity changes, flows with a few beyond the 500 px cut,
occlusion maps as 8-bit grey, 8-bit colour and 16-bit grey PNGs, images.
Both modes of both scripts run on it, the JAX script with `--n_workers 1`
(it samples from the process-wide generator inside its thread pool: only
one worker makes its output depend on nothing but the seed). Held: the
`pc` arrays and `flow_3d` bit for bit, `occ_mask_3d` byte for byte, the
`flow_2d` PNGs decoded equal, the images and occlusion maps copied byte
for byte; the port with 4 workers equal to the port with 1; the occlusion
read equal to OpenCV's default colour read for every PNG kind the codec
takes; the port's PFM and .flo writers byte for byte the JAX package's.
"""

import argparse
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

import preprocess_flyingthings3d_subset as jax_script
from camliflow_tpu.data import io as jio
from camliflow_torch import preprocess_flyingthings3d_subset as port_script
from camliflow_torch.data import io as tio
from camliflow_torch.data.png import read_png, write_png

REPO = Path(__file__).resolve().parents[1]
H, W, FRAMES = 60, 80, 3
N_POINTS = (3000, 2000)


def write_raw(root: Path, seed: int) -> None:
    rng = np.random.RandomState(seed)
    occ_kinds = ("grey", "colour", "grey16")
    for split in ("train", "val"):
        base = root / split
        dirs = {"disp": base / "disparity" / "left",
                "change": base / "disparity_change" / "left" / "into_future",
                "flow": base / "flow" / "left" / "into_future",
                "occ": base / "flow_occlusions" / "left" / "into_future",
                "image": base / "image_clean" / "left"}
        for d in dirs.values():
            d.mkdir(parents=True, exist_ok=True)
        for i in range(FRAMES):
            name = "%07d" % i
            disp = rng.uniform(25.0, 240.0, (H, W)).astype(np.float32)
            disp[rng.rand(H, W) < 0.01] = np.nan
            jio.save_pfm(dirs["disp"] / f"{name}.pfm", -disp)
            cv2.imwrite(str(dirs["image"] / f"{name}.png"),
                        rng.randint(0, 256, (H, W, 3)).astype(np.uint8))
            if i == FRAMES - 1:
                continue  # the last frame has no pair of its own
            jio.save_pfm(dirs["change"] / f"{name}.pfm",
                         rng.uniform(-2.0, 2.0, (H, W)).astype(np.float32))
            flow = (4 * rng.randn(H, W, 2)).astype(np.float32)
            flow[rng.rand(H, W) < 0.02] = 700.0
            jio.save_flow(dirs["flow"] / f"{name}.flo", flow)
            occ = (rng.rand(H, W) < 0.2).astype(np.uint8) * 255
            kind = occ_kinds[(i + len(split)) % 3]
            if kind == "colour":
                occ = np.stack([occ, 255 - occ, occ // 2], -1)
            elif kind == "grey16":
                occ = occ.astype(np.uint16) * 257
            cv2.imwrite(str(dirs["occ"] / f"{name}.png"), occ)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    write_raw(root, 0)
    return root


def args(raw, out, remove, workers):
    return argparse.Namespace(input_dir=str(raw), output_dir=str(out), n_points=list(N_POINTS),
                              max_depth=35.0, remove_occluded_points=remove, n_workers=workers)


MODES = {"default": False, "remove_occluded_points": True}


@pytest.fixture(scope="module")
def outputs(raw, tmp_path_factory):
    """{(side, mode, workers): output dir}, each script run once."""
    runs = {}
    for mode, remove in MODES.items():
        for side, workers, script in (("jax", 1, jax_script), ("port", 1, port_script),
                                      ("port", 4, port_script)):
            out = tmp_path_factory.mktemp(f"{side}-{mode}-{workers}")
            script.main(args(raw, out, remove, workers))
            runs[side, mode, workers] = out
    return runs


def frames(out: Path, split: str) -> list[str]:
    return sorted(p.stem for p in (out / split / "pc").iterdir())


def assert_same_output(got: Path, want: Path) -> None:
    for split in ("train", "val"):
        names = frames(want, split)
        assert names == frames(got, split) == ["%07d" % i for i in range(FRAMES - 1)]
        for name in names:
            a, b = (np.load(out / split / "pc" / f"{name}.npz") for out in (got, want))
            assert sorted(a.files) == sorted(b.files) == ["pc1", "pc2"]
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{split} {name} {key}")
            a, b = (np.load(out / split / "flow_3d" / f"{name}.npy") for out in (got, want))
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            a, b = ((out / split / "occ_mask_3d" / f"{name}.npy").read_bytes()
                    for out in (got, want))
            assert a == b
            a, b = (read_png(out / split / "flow_2d" / f"{name}.png") for out in (got, want))
            assert a.dtype == b.dtype == np.uint16
            np.testing.assert_array_equal(a, b)
        for sub in ("image_clean", "occ_mask_2d"):
            match, mismatch, errors = filecmp.cmpfiles(
                got / split / sub, want / split / sub,
                sorted(os.listdir(want / split / sub)), shallow=False)
            assert not mismatch and not errors and match


@pytest.mark.parametrize("mode", sorted(MODES))
def test_preprocess_matches_the_jax_script(outputs, mode):
    """Every file of the `-prep` layout as the JAX script (one worker)
    writes it; the clouds hold n_points finite points nearer than 35 m."""
    got, want = outputs["port", mode, 1], outputs["jax", mode, 1]
    assert_same_output(got, want)
    for split, n in zip(("train", "val"), N_POINTS):
        for name in frames(got, split):
            pcs = np.load(got / split / "pc" / f"{name}.npz")
            flow_3d = np.load(got / split / "flow_3d" / f"{name}.npy")
            for pc in (pcs["pc1"], pcs["pc2"]):
                assert pc.shape == (n, 3) and pc.dtype == np.float32
                assert np.isfinite(pc).all() and (pc[:, 2] < 35.0).all()
            assert flow_3d.shape == (n, 3) and np.isfinite(flow_3d).all()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_preprocess_output_does_not_depend_on_the_workers(outputs, mode):
    assert_same_output(outputs["port", mode, 4], outputs["port", mode, 1])


@pytest.mark.parametrize("kind", ["grey", "grey_alpha", "colour", "colour_alpha", "grey16",
                                  "colour16"])
def test_occlusion_mask_reads_as_opencv(tmp_path, kind):
    """OpenCV's default read (8-bit BGR) channel 0, above 1: the grey
    value, a colour image's blue, a 16-bit sample's high byte (so 0x01ff
    is 1, below the cut)."""
    rng = np.random.RandomState(3)
    values = np.array([0, 1, 2, 255, 0x01FF, 0x0200, 0xFFFF], np.uint16)
    grey = rng.choice(values, (7, 9))
    if not kind.endswith("16"):
        grey = rng.choice([0, 1, 2, 3, 128, 255], (7, 9)).astype(np.uint8)
    inverse = np.iinfo(grey.dtype).max - grey
    image = {"grey": grey, "grey16": grey,
             "grey_alpha": np.stack([grey, inverse], -1),
             "colour": np.stack([grey, inverse, grey[::-1]], -1),
             "colour_alpha": np.stack([grey, inverse, grey[::-1], grey], -1),
             "colour16": np.stack([grey, grey[::-1], inverse], -1)}[kind]
    path = tmp_path / f"{kind}.png"
    write_png(path, image)  # OpenCV writes no grey + alpha
    want = cv2.imread(str(path))[..., 0] > 1
    np.testing.assert_array_equal(port_script.occlusion_mask(str(path)), want)


def test_pfm_and_flo_writers_match_the_jax_package(tmp_path):
    rng = np.random.RandomState(4)
    disp = rng.randn(5, 7).astype(np.float32)
    colour = rng.randn(5, 7, 3).astype(np.float32)
    flow = rng.randn(5, 7, 2).astype(np.float32)
    for name, array in (("grey", disp), ("colour", colour)):
        port, ref = tmp_path / f"{name}.t.pfm", tmp_path / f"{name}.j.pfm"
        tio.save_pfm(port, array)
        jio.save_pfm(ref, array)
        assert port.read_bytes() == ref.read_bytes()
        np.testing.assert_array_equal(tio.load_pfm(port), array)
    tio.save_flow(tmp_path / "t.flo", flow)
    jio.save_flow(tmp_path / "j.flo", flow)
    assert (tmp_path / "t.flo").read_bytes() == (tmp_path / "j.flo").read_bytes()
    np.testing.assert_array_equal(tio.load_flow(tmp_path / "t.flo"), flow)


def test_cli_runs_as_a_module(raw, tmp_path):
    """`python -m camliflow_torch.preprocess_flyingthings3d_subset` with
    the JAX script's arguments writes the same layout (the val split)."""
    out = tmp_path / "prep"
    subprocess.run([sys.executable, "-m", "camliflow_torch.preprocess_flyingthings3d_subset",
                    "--input_dir", str(raw), "--output_dir", str(out), "--n_points",
                    *map(str, N_POINTS), "--n_workers", "2"], cwd=REPO, check=True,
                   capture_output=True, timeout=120)
    want = tmp_path / "want"
    port_script.main(args(raw, want, False, 1))
    assert_same_output(out, want)
