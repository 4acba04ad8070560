"""PNG reading and writing on the standard library's `zlib` and numpy.

The drivers and `io/tum.py` decode every image through this module, on every
machine, so one lossless path gives the same array everywhere and nothing
depends on OpenCV or Pillow being installed.

`read_png` returns the stored samples: [H, W] for grey, [H, W, 2|3|4] for
grey + alpha, RGB and RGBA, as uint8 or uint16 (big-endian samples turned
into the machine's order).  `read_gray` returns what
`cv2.imread(path, cv2.IMREAD_GRAYSCALE)` returns: 8-bit grey as stored,
16-bit grey as its high byte, and 8-bit RGB / RGBA through libpng's
fixed-point `png_set_rgb_to_gray` weights for 0.299 / 0.587, truncated:
`(R*9797 + G*19234 + B*3737) >> 15` (alpha is ignored).  For a grey image
`read_png` is `cv2.imread(path, cv2.IMREAD_UNCHANGED)` (16-bit depth stays
16-bit); colour images keep the file's R, G, B order, where cv2 gives B, G, R.

Decoding undoes the five row filters exactly.  None, Sub and Up rows are one
numpy operation each (Sub as a wrapping cumulative sum per byte lane).
Average and Paeth rows depend on the reconstructed byte to their left, so a
run of such rows is reconstructed as a wavefront: the run is skewed so that
each anti-diagonal (row + column = d) is one column of an array, and the
pixels of one anti-diagonal depend only on the two before it; the loop runs
over the H + W - 1 anti-diagonals, each step vectorised over the rows.
A damaged file (what `cv2.imread` cannot read either: it returns None)
raises `PNGError`; a valid image in a form this reader does not decode
(interlaced, palette, bit depths below 8, 16-bit colour turned to grey, or
another format such as JPEG, all of which cv2 reads) raises
`UnsupportedImage`, so that a caller who skips damaged frames never skips
these without a word.

`read_png` and `read_gray` are each an `io/decode` span of the port's tracer
(`utils/metrics.py`), so that a profile names the host time spent decoding.

`write_png` writes 8- and 16-bit grey images with a chosen filter type (one
for every row, or one per row), so the tests can produce every filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..utils import metrics

SIGNATURE = b"\x89PNG\r\n\x1a\n"
NONE, SUB, UP, AVERAGE, PAETH = range(5)
# color type -> samples per pixel (palette images are not read)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
# leading bytes of the other image formats that cv2.imread reads
_OTHER_FORMATS = {b"\xff\xd8\xff": "JPEG", b"BM": "BMP", b"II*\x00": "TIFF",
                  b"MM\x00*": "TIFF", b"RIFF": "WebP", b"P5": "PGM", b"P6": "PPM"}


class PNGError(ValueError):
    """A damaged PNG file, or one that is no image at all."""


class UnsupportedImage(NotImplementedError):
    """A valid image in a form that this reader does not decode."""


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        for magic, name in _OTHER_FORMATS.items():
            if data.startswith(magic):
                raise UnsupportedImage(f"{name} images are not read")
        raise PNGError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + n > len(data):
            break
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        if zlib.crc32(kind + body) != crc:
            raise PNGError(f"PNG chunk {kind!r}: bad CRC")
        yield kind, body
        pos += 12 + n
        if kind == b"IEND":
            return
    raise PNGError("PNG file ends before IEND")


def _paeth(a, b, c):
    """The Paeth predictor of left a, up b, up-left c (signed arrays): with
    p = a + b - c, the one of a, b, c nearest p, in that order on ties."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter_run(filt: np.ndarray, types: np.ndarray, prior: np.ndarray) -> np.ndarray:
    """Average / Paeth rows [k, W, bpp] (filtered bytes) under the prior row
    [W, bpp] -> reconstructed [k, W, bpp] uint8, by anti-diagonals.

    Skewed store S[d, r] holds pixel x = d - r of row r, where row 0 is the
    prior row and rows 1..k the run: for run row r at diagonal d, its left
    pixel is S[d - 1, r], the pixel above S[d - 1, r - 1] and the one above
    and left S[d - 2, r - 1].  Cells that no pixel maps to stay 0, which is
    what the filters read left of column 0."""
    k, W, bpp = filt.shape
    D = k + W
    S = np.zeros((D + 1, k + 1, bpp), np.int16)   # index d + 1, so d = -1 exists
    rows = np.arange(k + 1)
    diag = rows[:, None] + np.arange(W)[None, :]               # d of every pixel
    S[diag[0] + 1, 0] = prior
    F = np.zeros((D + 1, k + 1, bpp), np.int16)
    F[diag[1:] + 1, rows[1:, None]] = filt
    paeth_rows = types == PAETH
    avg_rows = ~paeth_rows
    all_paeth, all_avg = bool(paeth_rows.all()), bool(avg_rows.all())
    for d in range(1, D):
        lo, hi = max(1, d - W + 1), min(k, d)
        left = S[d, lo:hi + 1]                   # diagonal d - 1, same rows
        up = S[d, lo - 1:hi]                     # diagonal d - 1, row above
        if all_avg:
            pred = (left + up) >> 1
        else:
            upleft = S[d - 1, lo - 1:hi]         # diagonal d - 2, row above
            pred = _paeth(left, up, upleft)
            if not all_paeth:
                pred = np.where(avg_rows[lo - 1:hi, None], (left + up) >> 1, pred)
        S[d + 1, lo:hi + 1] = (F[d + 1, lo:hi + 1] + pred) & 255
    return S[diag[1:] + 1, rows[1:, None]].astype(np.uint8)


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered scanlines [H, 1 + stride] -> reconstructed bytes [H, stride]."""
    types = raw[:, 0]
    if types.max(initial=0) > PAETH:
        raise PNGError(f"PNG: unknown row filter {int(types.max())}")
    filt = raw[:, 1:]
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    W = stride // bpp
    y = 0
    while y < height:
        t = types[y]
        if t >= AVERAGE:
            end = y
            while end < height and types[end] >= AVERAGE:
                end += 1
            out[y:end] = _unfilter_run(
                filt[y:end].reshape(end - y, W, bpp), types[y:end],
                prior.reshape(W, bpp)).reshape(end - y, stride)
            y = end
        else:
            row = filt[y]
            if t == SUB:
                row = np.cumsum(row.reshape(W, bpp), axis=0, dtype=np.uint8).reshape(stride)
            elif t == UP:
                row = row + prior          # uint8 addition wraps mod 256
            out[y] = row
            y += 1
        prior = out[y - 1]
    return out


def read_png(path: str) -> np.ndarray:
    """The stored samples of a PNG file: [H, W] or [H, W, channels],
    uint8 or uint16 (`cv2.IMREAD_UNCHANGED` for a grey image)."""
    with metrics.span("io/decode"):
        return _read_png(path)


def _read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR" and len(body) == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError(f"{path}: no IHDR chunk")
    width, height, depth, color, _comp, _filt, interlace = header
    if interlace:
        raise UnsupportedImage(f"{path}: interlaced PNG images are not read")
    if color not in _CHANNELS or depth not in (8, 16):
        raise UnsupportedImage(f"{path}: color type {color} at {depth} bits is not read")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = width * bpp
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PNGError(f"{path}: {e}") from None
    if raw.size != height * (stride + 1):
        raise PNGError(f"{path}: {raw.size} image bytes, expected {height * (stride + 1)}")
    px = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp)
    if depth == 16:
        px = px.view(">u2").astype(np.uint16)
    px = px.reshape(height, width, ch)
    return px[..., 0] if ch == 1 else px


def to_gray(px: np.ndarray) -> np.ndarray:
    """Stored samples -> 8-bit grey, as `cv2.IMREAD_GRAYSCALE` gives it."""
    if px.ndim == 2:
        return (px >> 8).astype(np.uint8) if px.dtype == np.uint16 else px
    if px.dtype != np.uint8:
        raise UnsupportedImage("16-bit colour images are not turned to grey")
    if px.shape[-1] == 2:              # grey + alpha
        return px[..., 0].copy()
    r, g, b = (px[..., i].astype(np.uint32) for i in range(3))
    return ((r * 9797 + g * 19234 + b * 3737) >> 15).astype(np.uint8)


def read_gray(path: str) -> np.ndarray:
    """`cv2.imread(path, cv2.IMREAD_GRAYSCALE)`: [H, W] uint8."""
    with metrics.span("io/decode"):
        return to_gray(_read_png(path))


def _filter_rows(px: np.ndarray, types: np.ndarray, bpp: int) -> np.ndarray:
    """Bytes [H, stride] -> filtered bytes, row filter `types[y]` each."""
    h, stride = px.shape
    x = px.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, bpp:] = x[:-1, :-bpp]
    pred = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, upleft)])
    return ((x - pred[types, np.arange(h)]) & 255).astype(np.uint8)


def write_png(path: str, img: np.ndarray, filter_type=PAETH) -> None:
    """Write a grey [H, W] uint8 or uint16 image.  `filter_type`: one of
    NONE, SUB, UP, AVERAGE, PAETH for every row, or a sequence of them,
    taken in turn row by row."""
    img = np.asarray(img)
    if img.ndim != 2 or img.dtype not in (np.uint8, np.uint16):
        raise ValueError("write_png takes a grey [H, W] uint8 or uint16 image")
    h, w = img.shape
    depth = 8 * img.dtype.itemsize
    bpp = img.dtype.itemsize
    px = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    px = px.reshape(h, w * bpp)
    types = np.resize(np.asarray(filter_type, np.int64).reshape(-1), h)
    if types.min() < NONE or types.max() > PAETH:
        raise ValueError(f"unknown PNG filter type in {filter_type}")
    rows = np.concatenate([types.astype(np.uint8)[:, None], _filter_rows(px, types, bpp)], axis=1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes())))
        f.write(chunk(b"IEND", b""))
