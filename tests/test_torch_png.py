"""PyTorch port: the PNG codec (camliflow_torch/data/png.py) against OpenCV,
and the KITTI PNG readers and writers of camliflow_torch/data/io.py against
the JAX package's (which go through OpenCV), bit for bit.

OpenCV writes each test file with one row filter for every row (None, Sub,
Up, Average, Paeth) or with its adaptive choice among all five; the test
reads the filter bytes back to show the file holds the filters it is meant
to. OpenCV returns BGR where the codec returns the file's RGB."""

import struct
import zlib

import cv2
import numpy as np
import pytest

from camliflow_tpu.data import io as jio
from camliflow_torch.data import io as tio
from camliflow_torch.data import png

FILTERS = {
    "none": (cv2.IMWRITE_PNG_FILTER_NONE, {0}),
    "sub": (cv2.IMWRITE_PNG_FILTER_SUB, {1}),
    "up": (cv2.IMWRITE_PNG_FILTER_UP, {2}),
    "average": (cv2.IMWRITE_PNG_FILTER_AVG, {3}),
    "paeth": (cv2.IMWRITE_PNG_FILTER_PAETH, {4}),
    "adaptive": (cv2.IMWRITE_PNG_ALL_FILTERS, None),
}


def picture(kind, h=29, w=41, seed=0):
    """A test image: smooth gradients (which the predictive filters fit)
    with a noisy band, as an 8-bit RGB, 16-bit grey, 16-bit 3-channel,
    8-bit grey or 8-bit RGBA array in OpenCV's channel order."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    channels = {"rgb8": 3, "grey16": 1, "rgb16": 3, "grey8": 1, "rgba8": 4}[kind]
    top = 255 if kind.endswith("8") else 65535
    planes = [(xx * (3 + c) + yy * (5 - c) + 40 * np.sin(yy / 4 + c)) * top / 600
              for c in range(channels)]
    image = np.clip(np.stack(planes, -1), 0, top)
    image[h // 3: h // 2] = rng.randint(0, top + 1, (h // 2 - h // 3, w, channels))
    image = image.astype(np.uint8 if top == 255 else np.uint16)
    return image[..., 0] if channels == 1 else image


def row_filters(path):
    """The filter byte of every row of a PNG file."""
    data = path.read_bytes()
    width, height, depth, color = struct.unpack(">IIBB", data[16:26])
    idat = b"".join(payload for kind, payload in png._chunks(data) if kind == b"IDAT")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return set(raw.reshape(height, -1)[:, 0].tolist())


def as_rgb(bgr):
    return bgr if bgr.ndim == 2 else bgr[..., [2, 1, 0, 3][: bgr.shape[2]]]


@pytest.mark.parametrize("kind", ["rgb8", "grey16", "rgb16"])
@pytest.mark.parametrize("name", list(FILTERS))
def test_decode_matches_opencv(tmp_path, kind, name):
    flag, expected = FILTERS[name]
    image = picture(kind)
    path = tmp_path / f"{kind}_{name}.png"
    cv2.imwrite(str(path), image, [cv2.IMWRITE_PNG_FILTER, flag])
    seen = row_filters(path)
    if expected is None:  # OpenCV's adaptive choice mixes the filters
        assert len(seen) >= 2, seen
    else:
        assert seen == expected, seen
    got = png.read_png(path)
    want = as_rgb(cv2.imread(str(path), cv2.IMREAD_UNCHANGED))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_adaptive_files_hold_every_filter(tmp_path):
    """Across the adaptive files above, OpenCV used Sub, Up, Average and
    Paeth, so the decoder's mixed-filter sweep saw each of them."""
    seen = set()
    for kind in ("rgb8", "grey16", "rgb16"):
        for seed in range(3):
            path = tmp_path / f"{kind}_{seed}.png"
            cv2.imwrite(str(path), picture(kind, seed=seed),
                        [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
            seen |= row_filters(path)
    assert {1, 2, 3, 4} <= seen, seen


@pytest.mark.parametrize("kind", ["rgb8", "grey16", "rgb16", "grey8", "rgba8"])
def test_encoded_files_decode_in_opencv(tmp_path, kind):
    image = picture(kind)  # OpenCV's channel order
    path = tmp_path / f"{kind}.png"
    png.write_png(path, as_rgb(image))
    assert row_filters(path) == {0}
    np.testing.assert_array_equal(cv2.imread(str(path), cv2.IMREAD_UNCHANGED), image)
    np.testing.assert_array_equal(png.read_png(path), as_rgb(image))


@pytest.mark.parametrize("kind", ["rgb8", "grey8", "rgb16", "rgba8"])
def test_load_image_rgb_matches_opencv_colour_read(tmp_path, kind):
    """io.load_image_rgb is OpenCV's default (colour) read, reversed to RGB:
    grey repeated, alpha dropped, 16 bits cut to 8."""
    path = tmp_path / f"{kind}.png"
    cv2.imwrite(str(path), picture(kind), [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    got = tio.load_image_rgb(path)
    assert got.dtype == np.uint8 and got.shape[2] == 3
    np.testing.assert_array_equal(got, cv2.imread(str(path))[..., ::-1])


def flow_and_mask(seed=0, h=23, w=31):
    rng = np.random.RandomState(seed)
    flow = (40 * rng.randn(h, w, 2)).astype(np.float32)
    return flow, rng.rand(h, w) > 0.3


@pytest.mark.parametrize("with_mask", [False, True])
def test_flow_png_matches_jax_io(tmp_path, with_mask):
    """save_flow_png writes what the JAX one writes (compared decoded) and
    load_flow_png reads either file as the JAX one does."""
    flow, mask = flow_and_mask()
    mask = mask if with_mask else None
    tio.save_flow_png(tmp_path / "port.png", flow, mask)
    jio.save_flow_png(tmp_path / "jax.png", flow, mask)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED))
    for name in ("port.png", "jax.png"):
        got, ref = tio.load_flow_png(tmp_path / name), jio.load_flow_png(tmp_path / name)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_flow_png_rejects_what_it_cannot_hold(tmp_path):
    flow, _ = flow_and_mask()
    flow[3, 4, 1] = 32767.0 / 64
    with pytest.raises(AssertionError):
        jio.save_flow_png(tmp_path / "jax.png", flow)
    with pytest.raises(ValueError, match="PNG holds under 511.98"):
        tio.save_flow_png(tmp_path / "port.png", flow)
    with pytest.raises(ValueError, match="H, W, 2"):
        tio.save_flow_png(tmp_path / "port.png", flow[..., :1])


@pytest.mark.parametrize("with_mask", [False, True])
def test_disp_png_matches_jax_io(tmp_path, with_mask):
    rng = np.random.RandomState(1)
    disp = (80 * rng.rand(23, 31) - 5).astype(np.float32)  # some <= 0: invalid
    disp[0, 0] = 300.0  # past 65535 / 256: clipped
    mask = (rng.rand(23, 31) > 0.2) if with_mask else None
    tio.save_disp_png(tmp_path / "port.png", disp, mask)
    jio.save_disp_png(tmp_path / "jax.png", disp, mask)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED),
                                  cv2.imread(str(tmp_path / "jax.png"), cv2.IMREAD_UNCHANGED))
    for name in ("port.png", "jax.png"):
        got, ref = tio.load_disp_png(tmp_path / name), jio.load_disp_png(tmp_path / name)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])


def test_grey_png_reads_as_opencv_grey(tmp_path):
    image = picture("grey8")
    cv2.imwrite(str(tmp_path / "a.png"), image, [cv2.IMWRITE_PNG_FILTER, cv2.IMWRITE_PNG_ALL_FILTERS])
    np.testing.assert_array_equal(tio.load_grey_png(tmp_path / "a.png"),
                                  cv2.imread(str(tmp_path / "a.png"), 0))
    tio.save_grey_png(tmp_path / "b.png", image)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "b.png"), 0), image)
    cv2.imwrite(str(tmp_path / "rgb.png"), picture("rgb8"))
    with pytest.raises(ValueError, match="greyscale"):
        tio.load_grey_png(tmp_path / "rgb.png")


def test_decode_rejects_what_it_does_not_read(tmp_path):
    data = png.encode(picture("grey8"))
    broken = bytearray(data)
    broken[40] ^= 0xFF  # inside IDAT: its CRC no longer holds
    with pytest.raises(ValueError, match="CRC"):
        png.decode(bytes(broken))
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a" + data[6:])
    cv2.imwrite(str(tmp_path / "b.png"), picture("grey8"), [cv2.IMWRITE_PNG_BILEVEL, 1])
    with pytest.raises(ValueError, match="bit depth 1"):
        png.read_png(tmp_path / "b.png")
    with pytest.raises(ValueError, match="uint8 or uint16"):
        png.encode(picture("grey8").astype(np.float32))
