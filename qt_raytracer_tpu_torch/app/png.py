"""A PNG writer from the standard library alone (``zlib``, ``struct``).

The JAX app saves through PIL; the port needs no imaging package. Writes
8-bit truecolour (colour type 2), one filter byte 0 per row, one IDAT chunk.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img) -> bytes:
    """The PNG file of a uint8 [H, W, 3] image (a numpy array, or anything
    ``np.asarray`` takes: a CPU tensor)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3 \
            or img.shape[0] < 1 or img.shape[1] < 1:
        raise ValueError(f"need a uint8 [H, W, 3] image, got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + 3 * w), np.uint8)    # filter type 0 (None)
    rows[:, 1:] = img.reshape(h, 3 * w)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img) -> None:
    """Write a uint8 [H, W, 3] image to ``path`` as PNG."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)
