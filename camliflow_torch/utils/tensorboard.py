"""TensorBoard event files without TensorFlow: the port's copy of
camliflow_tpu/utils/tensorboard.py.

`EventWriter(log_dir)` writes `events.out.tfevents.<time>.<host>.<pid>.0`:
TFRecord-framed `Event` protos (a `brain.Event:2` record first), each
record's length and payload guarded by a masked CRC32C, the `Event` and
`Summary` protos encoded by hand with protobuf's wire rules. Any
TensorBoard reads them. Scalars (`add_scalar`) and RGB images (`add_image`)
are supported, which is all the trainer writes. Images go in as PNGs from
the port's own encoder (data/png.py, every row filtered None), where the
JAX writer prefers OpenCV's: the bytes differ, the pixels are the same.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from pathlib import Path

import numpy as np

from ..data.png import encode


def _crc_table() -> list[int]:
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
        table.append(crc)
    return table


_CRC_TABLE = _crc_table()  # CRC32C (Castagnoli), reflected polynomial 0x82F63B78


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc(data: bytes) -> int:
    """TFRecord's masked CRC32C of `data`."""
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# protobuf wire encoding, as far as Event and Summary need it


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if not value:
            out.append(byte)
            return bytes(out)
        out.append(byte | 0x80)


def _key(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _int_field(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _bytes_field(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _encode_event(wall_time: float, step: int | None = None, file_version: str | None = None,
                  summary: bytes | None = None) -> bytes:
    """Event: 1 wall_time (double), 2 step (int64), 3 file_version, 5 summary."""
    out = _key(1, 1) + struct.pack("<d", wall_time)
    if step is not None:
        out += _int_field(2, step)
    if file_version is not None:
        out += _bytes_field(3, file_version.encode("utf-8"))
    if summary is not None:
        out += _bytes_field(5, summary)
    return out


def _summary_value(tag: str, value: bytes) -> bytes:
    """Summary { repeated Value value = 1 }, one Value: 1 tag, then `value`."""
    return _bytes_field(1, _bytes_field(1, tag.encode("utf-8")) + value)


def _scalar_summary(tag: str, value: float) -> bytes:
    # Value: 2 simple_value (float)
    return _summary_value(tag, _key(2, 5) + struct.pack("<f", float(value)))


def _image_summary(tag: str, png: bytes, height: int, width: int) -> bytes:
    # Image: 1 height, 2 width, 3 colorspace (3: RGB), 4 the encoded image;
    # Value: 4 image
    image = _int_field(1, height) + _int_field(2, width) + _int_field(3, 3) + _bytes_field(4, png)
    return _summary_value(tag, _bytes_field(4, image))


class EventWriter:
    """An append-only TensorBoard event file under `log_dir`."""

    def __init__(self, log_dir: str | os.PathLike):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / (f"events.out.tfevents.{int(time.time())}."
                                    f"{socket.gethostname()}.{os.getpid()}.0")
        self._file = open(self.path, "ab")
        self._write_record(_encode_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._file.write(header + struct.pack("<I", masked_crc(header)) + data
                         + struct.pack("<I", masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write_record(_encode_event(time.time(), step=int(step),
                                         summary=_scalar_summary(tag, value)))

    def add_image(self, tag: str, rgb: np.ndarray, step: int) -> None:
        """rgb: uint8 [H, W, 3]."""
        rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
        height, width = rgb.shape[:2]
        summary = _image_summary(tag, encode(rgb), height, width)
        self._write_record(_encode_event(time.time(), step=int(step), summary=summary))

    def flush(self) -> None:
        self._file.flush()

    def close(self) -> None:
        if not self._file.closed:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
