"""Minimal PNG codec (stdlib zlib + struct), for files and in-memory bytes.

The writer stores 8-bit gray or RGB with no row filter. The reader takes
8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, with all five row
filters (None, Sub, Up, Average, Paeth): what PIL and most encoders write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# Color type -> channels, for 8-bit samples.
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 [H, W] (gray) or [H, W, 3] (RGB) image."""
    data = encode_png(img)
    with open(path, "wb") as f:
        f.write(data)


def encode_png(img: np.ndarray) -> bytes:
    """A uint8 [H, W] (gray) or [H, W, 3] (RGB) image as PNG bytes."""
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
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of decompressed scanlines -> uint8 [H, W*bpp]."""
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG image data has {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prior = np.zeros(stride, np.int32)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:      # Sub: running sum along each channel
            cur = np.cumsum(line.reshape(w, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:      # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.copy()
            left = np.zeros(bpp, np.int32)
            up_left = np.zeros(bpp, np.int32)
            for x in range(0, stride, bpp):
                up = prior[x:x + bpp]
                pred = (left + up) >> 1 if ftype == 3 else _paeth(left, up, up_left)
                left = (cur[x:x + bpp] + pred) & 0xFF
                cur[x:x + bpp] = left
                up_left = up
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prior = cur
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit, non-interlaced gray, gray+alpha, RGB or RGBA PNG as
    uint8 [H, W] (gray) or [H, W, C]."""
    with open(path, "rb") as f:
        return decode_png(f.read(), name=path)


def decode_png(data: bytes, name: str = "PNG data") -> np.ndarray:
    """`read_png` of in-memory PNG bytes; `name` labels its errors."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"{name}: PNG has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{name}: unsupported PNG (bit depth {depth}, color type {ctype}, "
                         f"interlace {interlace}); 8-bit non-interlaced gray/RGB(A) only")
    ch = _CHANNELS[ctype]
    img = _unfilter(zlib.decompress(b"".join(idat)), h, w, ch).reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img
