"""Minimal PNG writer (stdlib zlib + struct): 8-bit gray or RGB, no filter."""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] (gray) or [H, W, 3] (RGB) image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected [H, W] or [H, W, 3], got {img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    # Each scanline starts with filter byte 0 (None).
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1
    ).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))
