"""Headless image export (the reference's output is a live canvas; ours is
files). Pure-stdlib PNG (zlib) and PPM writers — no imaging deps.

A copy of `tendrils_tpu/io/export.py` (numpy and the standard library only;
importing that package imports JAX).
"""

import struct
import zlib

import numpy as np


def view_to_u8(view_image, background=(0.0, 0.0, 0.0)):
    """`f32[H, W, 4]` (straight alpha, row 0 top) -> `u8[H, W, 3]` over a
    background colour."""
    img = np.asarray(view_image, np.float32)
    a = np.clip(img[..., 3:4], 0.0, 1.0)
    bg = np.asarray(background, np.float32)
    rgb = np.clip(img[..., :3], 0.0, 1.0) * a + bg * (1.0 - a)
    return (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_ppm(path, rgb_u8):
    h, w, _ = rgb_u8.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(rgb_u8).tobytes())
    return path


def _png_chunk(tag, data):
    chunk = tag + data
    return (struct.pack(">I", len(data)) + chunk
            + struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF))


def save_png(path, rgb_u8):
    """Minimal RGB8 PNG writer (filter 0, single IDAT)."""
    h, w, c = rgb_u8.shape
    assert c in (3, 4)
    color_type = 2 if c == 3 else 6
    raw = b"".join(
        b"\x00" + np.ascontiguousarray(rgb_u8[y]).tobytes()
        for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_png_chunk(b"IEND", b""))
    return path
