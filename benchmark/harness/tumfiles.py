"""Writing a rendered sequence in the TUM RGB-D layout: 8-bit grey PNGs under
`rgb/`, 16-bit depth PNGs under `depth/` (metres times the depth factor),
and an association list.  The layout of `tools/make_tum_dataset.py`,
rewritten for one camera and without its imports.

The PNG encoder writes what `cv2.imwrite` writes with its defaults, as the
tool did: every row with the Sub filter, deflated at level 1 with the
run-length strategy.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
SUB = 1


def filter_rows(px: np.ndarray, bpp: int) -> np.ndarray:
    """[H, stride] bytes -> [H, 1 + stride]: each row's filter type (Sub),
    then its bytes less the bytes `bpp` to their left."""
    x = px.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    rows = ((x - left) & 255).astype(np.uint8)
    return np.concatenate([np.full((len(x), 1), SUB, np.uint8), rows], axis=1)


def encode_png(img: np.ndarray) -> bytes:
    """A grey [H, W] uint8 or uint16 image as PNG bytes."""
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError("encode_png takes a grey [H, W] uint8 or uint16 image")
    h, w = img.shape
    bpp = img.dtype.itemsize
    px = np.ascontiguousarray(img.astype(">u2") if bpp == 2 else img).view(np.uint8)
    rows = filter_rows(px.reshape(h, w * bpp), bpp)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return (SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8 * bpp, 0, 0, 0, 0))
            + chunk(b"IDAT", _deflate(rows.tobytes())) + chunk(b"IEND", b""))


def _deflate(data: bytes) -> bytes:
    z = zlib.compressobj(1, zlib.DEFLATED, zlib.MAX_WBITS, 9, zlib.Z_RLE)
    return z.compress(data) + z.flush()


def quantise(grey: np.ndarray, depth: np.ndarray, depth_factor: float):
    """The stored forms: grey as uint8, depth as uint16 in 1/depth_factor m."""
    g8 = np.clip(grey, 0, 255).astype(np.uint8)
    d16 = np.clip(depth * depth_factor, 0, 65535).astype(np.uint16)
    return g8, d16


def write_sequence(root: str, greys: np.ndarray, depths: np.ndarray, depth_factor: float,
                   order: list[int]) -> str:
    """Write frames [n, H, W] of one camera under `root` and an association
    list that plays them in `order`; returns the list's path."""
    os.makedirs(os.path.join(root, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(root, "depth"), exist_ok=True)
    names = []
    for i in range(len(greys)):
        name = f"{i / 30.0:.6f}.png"
        g8, d16 = quantise(greys[i], depths[i], depth_factor)
        for sub, img in (("rgb", g8), ("depth", d16)):
            with open(os.path.join(root, sub, name), "wb") as f:
                f.write(encode_png(img))
        names.append(name)
    path = os.path.join(root, "associations.txt")
    with open(path, "w") as f:
        for k, i in enumerate(order):
            t = k / 30.0
            f.write(f"{t:.6f} rgb/{names[i]} {t:.6f} depth/{names[i]}\n")
    return path
