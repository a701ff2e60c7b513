"""A PNG codec on zlib and numpy, for the readers and writers of the port.

Decodes non-interlaced 8- and 16-bit greyscale, grey + alpha, RGB and RGBA
images with any of the five row filters, and returns the samples in the
file's own channel order (RGB, not OpenCV's BGR) as uint8 or uint16. Encodes
the same kinds with filter 0 (None) on every row; 16-bit samples are
big-endian in the file, as the format says. Palette images, bit depths
below 8 and Adam7 interlacing raise ValueError.

Unfiltering: when every row is filtered None, Sub or Up, rows are undone one
after another, each in a few vectorised operations (Sub as a cumulative sum
mod 256 at the pixel's byte stride, Up as a sum with the row above). An
image with any Average or Paeth row, whose bytes each depend on the byte
one pixel to the left, is undone in one sweep over its anti-diagonals: pixel
(r, p) needs only (r, p - 1), (r - 1, p) and (r - 1, p - 1), all on earlier
diagonals, so each step does every row at once, H + W steps in all.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples a pixel
COLOR_TYPE = {1: 0, 3: 2, 2: 4, 4: 6}  # samples a pixel -> colour type


def _chunks(data: bytes):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(payload) != length or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"PNG chunk {kind!r}: truncated or bad CRC")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG file ends before IEND")


def _unfilter_up_sub(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Undo None / Sub / Up rows one after another, each vectorised."""
    out = np.empty_like(filt)
    prev = np.zeros(filt.shape[1], np.uint8)
    for r, kind in enumerate(kinds):
        row = filt[r]
        if kind == 1:  # Sub: a cumulative sum mod 256 over each byte lane
            row = np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_diagonals(filt: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """Undo rows of any filter in one sweep over the anti-diagonals of the
    pixel grid. The image is skewed so that diagonal d = r + p is column d:
    S[r, r + p] = pixel (r, p), with a zero column on the left for the pixel
    left of column 0 and a zero row on top for the row above row 0."""
    height, width = filt.shape[0], filt.shape[1] // bpp
    r = np.arange(height)[:, None]
    cols = r + np.arange(width)[None, :]
    skewed = np.zeros((height, height + width, bpp), np.int16)  # the filtered bytes
    skewed[r, cols] = filt.reshape(height, width, bpp)
    skew = np.zeros((height + 1, height + width + 1, bpp), np.int16)  # the image
    kinds = kinds[:, None]
    sub, up, average, paeth = (kinds == k for k in (1, 2, 3, 4))
    for d in range(height + width - 1):
        lo, hi = max(0, d - width + 1), min(height - 1, d)
        # pixel (r, p) at skew (r + 1, d + 1): a at (r + 1, d), b at (r, d),
        # c at (r, d - 1); the column d - 1 is the zero column when d = 0
        a = skew[lo + 1:hi + 2, d]
        b = skew[lo:hi + 1, d]
        c = skew[lo:hi + 1, d - 1] if d else np.zeros_like(b)
        pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
        pred = np.where(sub[lo:hi + 1], a, np.where(up[lo:hi + 1], b, 0))
        pred += np.where(average[lo:hi + 1], (a + b) >> 1, 0)
        pred += np.where(paeth[lo:hi + 1] & (pa <= pb) & (pa <= pc), a, 0)
        pred += np.where(paeth[lo:hi + 1] & ((pa > pb) | (pa > pc)),
                         np.where(pb <= pc, b, c), 0)
        skew[lo + 1:hi + 2, d + 1] = (skewed[lo:hi + 1, d] + pred) & 0xFF
    return skew[r + 1, cols + 1].astype(np.uint8).reshape(height, width * bpp)


def decode(data: bytes) -> np.ndarray:
    """The samples of a PNG file: [H, W] for grey, else [H, W, C] in the
    file's channel order; uint8 or uint16."""
    header, idat = None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError("PNG file has no IHDR")
    width, height, depth, color, compression, filter_method, interlace = header
    if color not in CHANNELS or depth not in (8, 16):
        raise ValueError(f"unsupported PNG: colour type {color}, bit depth {depth} "
                         "(only 8/16-bit grey, grey + alpha, RGB and RGBA)")
    if compression or filter_method or interlace:
        raise ValueError("unsupported PNG: interlaced or an unknown method")
    channels = CHANNELS[color]
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (1 + width * bpp):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected "
                         f"{height * (1 + width * bpp)}")
    rows = raw.reshape(height, 1 + width * bpp)
    kinds, filt = rows[:, 0], rows[:, 1:]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {kinds.max()} is not one of 0-4")
    if np.isin(kinds, (3, 4)).any():
        flat = _unfilter_diagonals(filt, kinds, bpp)
    else:
        flat = _unfilter_up_sub(filt, kinds, bpp)
    if depth == 16:
        samples = flat.view(">u2").astype(np.uint16)
    else:
        samples = flat
    shape = (height, width) if channels == 1 else (height, width, channels)
    return samples.reshape(shape)


def encode(image: np.ndarray) -> bytes:
    """A PNG file of an [H, W] or [H, W, C] (C in 1-4) uint8 or uint16
    array, channels in RGB(A) order, every row filtered None."""
    if image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"PNG samples must be uint8 or uint16, got {image.dtype}")
    channels = 1 if image.ndim == 2 else image.shape[2]
    if image.ndim not in (2, 3) or channels not in COLOR_TYPE:
        raise ValueError(f"cannot write an image of shape {image.shape} as PNG")
    height = image.shape[0]
    return _encode_rows(image, np.zeros(height, np.uint8))


def _filter_rows(rows: np.ndarray, kinds: np.ndarray, bpp: int) -> np.ndarray:
    """The encoder's side of the row filters: each row of raw bytes minus
    its predictor (from the raw bytes) for the row's filter kind, mod 256."""
    x = rows.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, bpp:], b[1:], c[1:, bpp:] = x[:, :-bpp], x[:-1], x[:-1, :-bpp]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    kind = kinds.astype(np.int16)[:, None]
    pred = np.select([kind == 1, kind == 2, kind == 3, kind == 4],
                     [a, b, (a + b) >> 1, paeth], 0)
    return ((x - pred) & 0xFF).astype(np.uint8)


def _encode_rows(image: np.ndarray, kinds: np.ndarray) -> bytes:
    """A PNG file of `image` with row r filtered by kinds[r], compressed at
    zlib level 1 (fast; the size matters less than the time)."""
    height, width = image.shape[:2]
    channels = 1 if image.ndim == 2 else image.shape[2]
    depth = 8 * image.dtype.itemsize
    samples = image.astype(">u2") if depth == 16 else image
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(height, -1)
    if kinds.any():
        rows = _filter_rows(rows, kinds, channels * depth // 8)
    raw = np.concatenate([kinds.astype(np.uint8)[:, None], rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    header = struct.pack(">IIBBBBB", width, height, depth, COLOR_TYPE[channels], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 1)) + chunk(b"IEND", b""))


def read_png(path: str | Path) -> np.ndarray:
    """`decode` of a file."""
    return decode(Path(path).read_bytes())


def write_png(path: str | Path, image: np.ndarray) -> None:
    """`encode` into a file."""
    Path(path).write_bytes(encode(image))


def time_kitti_frames(repeats: int = 3) -> None:
    """Print the host time to decode KITTI-sized files (375 x 1242) by row
    filter: an 8-bit RGB image, a 16-bit disparity and a 16-bit flow map,
    each filtered with one kind on every row, then with the five kinds in
    turn, and a test frame's reading (2 images, 2 disparities) at each."""
    import time

    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:375, 0:1242]
    files = {
        "image (RGB, 8-bit)": np.stack([(xx // 3 + yy) % 256, (2 * xx + yy // 2) % 256,
                                        rng.randint(0, 256, xx.shape)], -1).astype(np.uint8),
        "disparity (grey, 16-bit)": (256 * (10 + 30 * yy / 375)
                                     + rng.randint(0, 64, xx.shape)).astype(np.uint16),
        "flow (RGB, 16-bit)": np.stack([32768 + 64 * np.sin(xx / 50) * 20, 32768 + yy * 3,
                                        np.ones_like(xx)], -1).astype(np.uint16),
    }
    names = ("None", "Sub", "Up", "Average", "Paeth", "all five in turn")
    per_frame = dict.fromkeys(names, 0.0)
    for label, image in files.items():
        line = []
        for kind, name in enumerate(names):
            kinds = np.full(image.shape[0], kind, np.uint8) if kind < 5 else \
                (np.arange(image.shape[0]) % 5).astype(np.uint8)
            data = _encode_rows(image, kinds)
            if not np.array_equal(decode(data), image):
                raise AssertionError(f"{label}, {name}: the round trip differs")
            best = float("inf")
            for _ in range(repeats):
                start = time.perf_counter()
                decode(data)
                best = min(best, time.perf_counter() - start)
            line.append(f"{name} {1e3 * best:.1f}")
            if label != "flow (RGB, 16-bit)":
                per_frame[name] += 2e3 * best
        print(f"{label}: " + ", ".join(line) + " ms")
    print("a KITTI test frame's reading (2 images, 2 disparities): "
          + ", ".join(f"{name} {ms:.1f}" for name, ms in per_frame.items()) + " ms")


if __name__ == "__main__":
    time_kitti_frames()
