"""Pure-Python TensorBoard event-file writer.

The reference logs scalars and image grids through tensorboardX to
``DSN_tb_logger/`` / SRN ``tb_logger`` directories (reference:
codes/DSN/train.py:186-191,244-279; codes/SRN/train.py:50-52,118-120).
This module writes the same on-disk artifact — ``events.out.tfevents.*``
TFRecord files readable by stock TensorBoard — with no tensorflow /
tensorboardX dependency (neither is in the image): the two protobuf
messages involved (Event, Summary) are hand-encoded, and the TFRecord
framing CRCs are computed with a table-based CRC32C.

Wire formats implemented:
  * TFRecord: <len:u64le> <masked_crc32c(len):u32le> <data>
              <masked_crc32c(data):u32le>
  * Event    { double wall_time=1; int64 step=2; string file_version=3;
               Summary summary=5; }
  * Summary  { repeated Value value=1; }
    Value    { string tag=1; float simple_value=2; Image image=4; }
    Image    { int32 height=1; int32 width=2; int32 colorspace=3;
               bytes encoded_image_string=4; }
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []
_POLY = 0x82F63B78  # Castagnoli, reflected
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ _POLY if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord CRC masking (tensorflow/core/lib/hash/crc32c.h)."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        bits = n & 0x7F
        n >>= 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _pb_bytes(field: int, value: bytes) -> bytes:
    return _key(field, 2) + _varint(len(value)) + value


def _pb_double(field: int, value: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", value)


def _pb_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


def _encode_image(png: bytes, height: int, width: int, channels: int) -> bytes:
    colorspace = {1: 1, 3: 3, 4: 4}[channels]
    return (
        _pb_varint(1, height)
        + _pb_varint(2, width)
        + _pb_varint(3, colorspace)
        + _pb_bytes(4, png)
    )


def _encode_event(
    wall_time: float,
    step: Optional[int] = None,
    file_version: Optional[str] = None,
    summary: Optional[bytes] = None,
) -> bytes:
    out = _pb_double(1, wall_time)
    if step is not None:
        out += _pb_varint(2, step)
    if file_version is not None:
        out += _pb_bytes(3, file_version.encode())
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


def _png_encode(img) -> bytes:
    """uint8 HWC (1/3/4 channels) -> PNG bytes (PIL, else stdlib zlib)."""
    import io

    import numpy as np

    img = np.ascontiguousarray(img)
    try:
        from PIL import Image

        buf = io.BytesIO()
        mode = {1: "L", 3: "RGB", 4: "RGBA"}[img.shape[-1] if img.ndim == 3 else 1]
        Image.fromarray(img.squeeze() if mode == "L" else img, mode).save(
            buf, format="PNG"
        )
        return buf.getvalue()
    except ImportError:  # pragma: no cover - PIL is in the image
        import zlib

        h, w = img.shape[:2]
        c = img.shape[2] if img.ndim == 3 else 1
        ctype = {1: 0, 3: 2, 4: 6}[c]
        raw = b"".join(b"\x00" + img[i].tobytes() for i in range(h))

        def chunk(tag, data):
            return (
                struct.pack(">I", len(data))
                + tag
                + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
            )

        return (
            b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b"")
        )


# --------------------------------------------------------------- writer


class TBWriter:
    """Minimal tensorboardX.SummaryWriter equivalent (scalars + images)."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s" % (
            int(time.time()),
            socket.gethostname(),
        )
        self.path = os.path.join(logdir, fname)
        self._f = open(self.path, "ab")
        self._record(_encode_event(time.time(), file_version="brain.Event:2"))
        self.flush()

    def _record(self, data: bytes):
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", masked_crc32c(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", masked_crc32c(data)))

    def add_scalar(self, tag: str, value: float, step: int):
        summary = _pb_bytes(
            1, _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
        )
        self._record(_encode_event(time.time(), step=step, summary=summary))

    def add_image(self, tag: str, img, step: int):
        """img: uint8 HWC array (or float in [0,1], converted)."""
        import numpy as np

        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        if img.ndim == 2:
            img = img[:, :, None]
        png = _png_encode(img)
        image = _encode_image(png, img.shape[0], img.shape[1], img.shape[2])
        summary = _pb_bytes(1, _pb_bytes(1, tag.encode()) + _pb_bytes(4, image))
        self._record(_encode_event(time.time(), step=step, summary=summary))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()
