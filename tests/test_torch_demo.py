"""PyTorch port: the demo (`camliflow_torch.demo`) against the repo's demo.py
on a synthetic pair with the same weights, and the flow visualisation
against the JAX one (which converts HSV to RGB through OpenCV), on the CPU.

The repo holds no demo pair, so the test writes one: two 8-bit PNG images
and two PFM disparities (stored negated, as the demo negates what it
reads), a few disparities NaN. The model is the flagship cut to size
(ResNet-18, 1 iteration, 256 points) by a conf/model file under the
working directory, where both demos look for it."""

import importlib.util
from pathlib import Path

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from camliflow_tpu.data import io as jio
from camliflow_tpu.models import camliraft as jm_flagship
from camliflow_tpu.runtime.checkpoint import save_variables
from camliflow_tpu.utils.visualization import viz_optical_flow as jax_viz
from camliflow_torch import demo
from camliflow_torch.data import png
from camliflow_torch.utils.visualization import hsv2rgb_8bit, viz_optical_flow

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
H, W, F = 60, 92, 100.0
TINY = {"name": "camliraft", "batch_size": 8, "freeze_bn": False, "backbone": {"depth": 18},
        "n_iters_train": 1, "n_iters_eval": 1, "fast_inference": "off",
        "fuse_fnet": True, "fuse_cnet": True, "fuse_corr": True, "fuse_motion": True,
        "fuse_hidden": False, "n_samples_list": [128, 64, 32, 16],
        "loss2d": {"gamma": 0.8, "order": "l2-norm"},
        "loss3d": {"gamma": 0.8, "order": "l2-norm"}}


@pytest.fixture(scope="module")
def demo_dir(tmp_path_factory):
    """A working directory with conf/model/camliraft_tiny.yaml, a synthetic
    pair and the JAX variables of the tiny model (.npz)."""
    root = tmp_path_factory.mktemp("demo")
    (root / "conf" / "model").mkdir(parents=True)
    (root / "conf" / "model" / "camliraft_tiny.yaml").write_text(yaml.safe_dump({"model": TINY}))
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    for i in (1, 2):
        image = np.stack([(xx * 2 + 30 * i) % 256, (yy * 3) % 256, rng.randint(0, 255, (H, W))],
                         -1).astype(np.uint8)
        cv2.imwrite(str(root / f"image{i}.png"), image)
        disp = 6.0 + 8.0 * yy / H + 0.5 * i + rng.rand(H, W).astype(np.float32)
        disp[3, 5 * i] = np.nan
        jio.save_pfm(root / f"disp{i}.pfm", -disp)
    inputs = {"images": jnp.asarray(rng.randint(0, 255, (1, H, W, 6)).astype(np.float32)),
              "pcs": jnp.asarray(np.concatenate([rng.randn(1, 256, 3) + [0, 0, 10]] * 2, -1)
                                 .astype(np.float32)),
              "intrinsics": jnp.asarray([[F, W / 2, H / 2]], jnp.float32)}
    model = jm_flagship.CamLiRAFT(cfgs=TINY, train_mode=False)
    save_variables(root / "tiny.npz", jax.jit(model.init)(jax.random.PRNGKey(0), inputs))
    return root


def demo_args(root, out_dir, *extra):
    return ["--model", "camliraft_tiny", "--image1", str(root / "image1.png"),
            "--image2", str(root / "image2.png"), "--disp1", str(root / "disp1.pfm"),
            "--disp2", str(root / "disp2.pfm"), "--out_dir", str(out_dir), "--n_points", "256",
            "--f", str(F), "--cx", str((W - 1) / 2), "--cy", str((H - 1) / 2), *extra]


def test_demo_matches_jax_demo(demo_dir, monkeypatch, capsys):
    """flow_3d.npz within 1e-4 m (the clouds equal), flow_2d.png within one
    level of the JAX demo's."""
    monkeypatch.chdir(demo_dir)
    spec = importlib.util.spec_from_file_location("jax_demo", REPO / "demo.py")
    jax_demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_demo)
    weights = ["--weights", str(demo_dir / "tiny.npz")]
    jax_demo.main(demo.parse_args(demo_args(demo_dir, demo_dir / "jax", *weights)))
    demo.main(demo.parse_args(demo_args(demo_dir, demo_dir / "port", *weights,
                                        "--device", "cpu", "--show")))
    assert "open3d not installed" in capsys.readouterr().out
    got, ref = (np.load(demo_dir / side / "flow_3d.npz") for side in ("port", "jax"))
    assert set(got.files) == set(ref.files) == {"pc1", "pc2", "flow_3d"}
    np.testing.assert_array_equal(got["pc1"], ref["pc1"])
    np.testing.assert_array_equal(got["pc2"], ref["pc2"])
    assert got["flow_3d"].shape == (256, 3) and np.isfinite(got["flow_3d"]).all()
    np.testing.assert_allclose(got["flow_3d"], ref["flow_3d"], rtol=0, atol=1e-4)
    image = png.read_png(demo_dir / "port" / "flow_2d.png")
    image_ref = cv2.imread(str(demo_dir / "jax" / "flow_2d.png"))[..., ::-1]
    assert image.shape == image_ref.shape == (3 * H, W, 3)
    np.testing.assert_array_equal(image[:2 * H], image_ref[:2 * H])  # the two images
    assert np.abs(image.astype(int) - image_ref).max() <= 1


def test_demo_without_weights_and_its_devices(demo_dir, monkeypatch, capsys):
    """Without --weights the demo warns and runs on seeded random weights
    (twice the same); it needs a card unless told --device cpu."""
    monkeypatch.chdir(demo_dir)
    outs = [demo.main(demo.parse_args(demo_args(demo_dir, demo_dir / f"rand{i}",
                                                "--device", "cpu"))) for i in range(2)]
    assert "WARNING: no --weights given" in capsys.readouterr().out
    np.testing.assert_array_equal(outs[0]["flow_3d"], outs[1]["flow_3d"])
    with pytest.raises(ValueError, match="cuda|cpu"):
        demo.main(demo.parse_args(demo_args(demo_dir, demo_dir / "x", "--device", "tpu")))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=cpu"):
            demo.main(demo.parse_args(demo_args(demo_dir, demo_dir / "x")))
    assert not (demo_dir / "x").exists()


def test_demo_takes_the_fast_path(demo_dir, monkeypatch):
    """--fast_inference on runs the demo's model on the fast path (int8
    volumes, bf16 gathers and update chain): its flows differ from the exact
    run's on the same random weights, within the JAX package's
    fast-vs-exact bounds (0.15 px, 0.02 m)."""
    monkeypatch.chdir(demo_dir)
    outs = {mode: demo.main(demo.parse_args(demo_args(
        demo_dir, demo_dir / f"mode_{mode}", "--device", "cpu", "--fast_inference", mode)))
        for mode in ("on", "off")}
    for key, bound in (("flow_3d", 0.02), ("flow_2d", 0.15)):
        fast, exact = outs["on"][key], outs["off"][key]
        assert np.isfinite(fast).all() and not np.array_equal(fast, exact)
        assert np.abs(fast - exact).max() <= bound


def all_codes_flow():
    """A [255, 256, 2] flow whose pixel (h, s) has hue code h and saturation
    code s in viz_optical_flow's 8-bit HSV (hue code 255 would need a hue of
    a whole turn, which the mod 1 never gives)."""
    h, s = np.meshgrid(np.arange(255), np.arange(256), indexing="ij")
    angle = 2 * np.pi * (h + 0.5) / 255
    magnitude = (s + 0.5) / 255 * 512 / 8
    return np.stack([magnitude * np.cos(angle), magnitude * np.sin(angle)], -1)


def test_viz_matches_jax_viz_on_every_code():
    """Every (hue, saturation) code a flow can draw, value 255, through
    viz_optical_flow: the port's numpy HSV -> RGB against the JAX one's
    OpenCV conversion, within one level. The port follows OpenCV's float
    formula (sector table, h * 6 / 180 mod 6, rounding to nearest). What it
    finds with OpenCV 5.0.0: 55,286 of the 65,280 codes differ by one level
    in some channel (OpenCV gives 205 where 255 * (1 - 49/255) = 206), none
    by more; the picture is the same to the eye, not to the bit."""
    flow = all_codes_flow()
    h = np.floor(np.mod(np.arctan2(flow[..., 1], flow[..., 0]) / (2 * np.pi) + 1, 1) * 255)
    s = np.floor(np.clip(np.hypot(flow[..., 0], flow[..., 1]) * 8 / 512, 0, 1) * 255)
    want_h, want_s = np.meshgrid(np.arange(255), np.arange(256), indexing="ij")
    assert (h == want_h).all() and (s == want_s).all()  # every code is drawn
    got, ref = viz_optical_flow(flow), jax_viz(flow)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (255, 256, 3)
    diff = np.abs(got.astype(int) - ref)
    assert diff.max() <= 1
    # hues past 180 wrap into the next sectors: they draw as hue - 180
    assert np.abs(got[181:].astype(int) - got[1:75]).max() <= 1


def test_hsv2rgb_matches_opencv_within_one_level():
    """hsv2rgb_8bit against cv2.cvtColor(COLOR_HSV2RGB) on all hue and
    saturation codes at three values."""
    h, s = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for value in (255, 128, 7):
        hsv = np.stack([h, s, np.full_like(h, value)], -1).astype(np.uint8)
        diff = np.abs(hsv2rgb_8bit(hsv).astype(int) - cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
        assert diff.max() <= 1, value
    grey = np.stack([h, np.zeros_like(h), s], -1).astype(np.uint8)  # s = 0: v, v, v
    np.testing.assert_array_equal(hsv2rgb_8bit(grey), np.repeat(grey[..., 2:], 3, -1))
