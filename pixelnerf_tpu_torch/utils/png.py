"""A PNG writer with no image library: 8-bit RGB, one IDAT chunk, filter 0
on every row, zlib from the standard library."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) uint8 image."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3 or 0 in rgb.shape[:2]:
        raise ValueError(
            f"write_png writes (H, W, 3) uint8 RGB images, got {rgb.dtype} {rgb.shape}")
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), rgb.reshape(H, W * 3)], axis=1)
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)  # 8-bit truecolour, no interlace
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image to ``path`` as PNG; raises on any other
    array."""
    data = encode_png(rgb)
    with open(path, "wb") as f:
        f.write(data)
