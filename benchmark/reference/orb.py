"""Plain numpy reference of the ORB features a frame carries: at each keypoint
the program reports (level-0 position, pyramid level), the FAST-9/16 corner
test, the intensity-centroid angle and the rotated-BRIEF descriptor, worked
out again in float64 from the image the benchmark fed.

The definition is the one the port and the JAX package share (ORB-SLAM2's
extractor recast for fixed shapes): pyramid levels by an antialiased
triangle-kernel resize to round(H / 1.2^l) x round(W / 1.2^l), each level
laid on a zero canvas of the level-0 size; a keypoint is a pixel whose FAST
score (the largest, over the 16 arcs of 9 ring pixels, of the least
brightness difference of one sign) is at least the lower threshold and no
less than its 8 neighbours'; its 45 x 45 patch starts 22 pixels up and left,
clamped into the canvas; the angle is atan2 of the intensity moments over
the radius-15 disc of the patch's central 39 x 39; the descriptor compares
256 point pairs (drawn from numpy's RandomState(1234), rotated into 30 bins)
on that 39 x 39 blurred by a 7-tap Gaussian (sigma 2) and rounded to
bfloat16.  Nothing here comes from the program: the tables are drawn again
from their definition.
"""

from __future__ import annotations

import functools

import numpy as np

N_ROT = 30
DESC_R = 19
PATCH_R = 15
BLUR_R = 3
SIDE45 = 2 * (DESC_R + BLUR_R) + 1
RING = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1))


def level_shapes(h: int, w: int, n_levels: int, scale: float) -> list:
    return [(max(int(round(h / scale ** l)), 32), max(int(round(w / scale ** l)), 32))
            for l in range(n_levels)]


def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of the antialiased triangle-kernel resize."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / ks
    w = np.maximum(0.0, 1.0 - x)
    tot = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(tot) > 1000.0 * np.finfo(np.float32).eps, w / np.where(tot != 0, tot, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def level_canvas(img: np.ndarray, level: int, n_levels: int, scale: float) -> np.ndarray:
    """Level `level` of the pyramid of `img` [H, W] on a zero [H, W] canvas."""
    h, w = img.shape
    hl, wl = level_shapes(h, w, n_levels, scale)[level]
    im = np.asarray(img, np.float64)
    lv = im if level == 0 else resize_weights(h, hl).T @ im @ resize_weights(w, wl)
    canvas = np.zeros((h, w))
    canvas[:hl, :wl] = lv
    return canvas


def to_bf16(x: np.ndarray) -> np.ndarray:
    """Round to the nearest bfloat16 (ties to even), returned as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def fast_scores(canvas: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """FAST-9/16 scores at pixels (ys, xs) of a zero-padded canvas."""
    p = np.pad(canvas, 3)
    c = p[ys + 3, xs + 3]
    d = np.stack([p[ys + 3 + dy, xs + 3 + dx] - c for dy, dx in RING])   # [16, N]
    arcs = np.stack([d[[(k + j) % 16 for j in range(9)]] for k in range(16)])   # [16, 9, N]
    bright = arcs.min(axis=1).max(axis=0)
    dark = (-arcs.max(axis=1)).max(axis=0)
    return np.maximum(bright, dark)


def gauss7(sigma: float = 2.0) -> np.ndarray:
    d = np.arange(-3, 4, dtype=np.float64)
    k = np.exp(-d * d / (2 * sigma * sigma))
    return k / k.sum()


@functools.lru_cache(maxsize=1)
def brief_index() -> tuple[np.ndarray, np.ndarray]:
    """(negative, positive) sample index into the 39 x 39 patch of each of
    the 256 tests, in each of the 30 rotation bins."""
    rng = np.random.RandomState(1234)
    sigma = 13 / 2.0
    pairs = []
    while len(pairs) < 256:
        p = np.clip(rng.randn(4) * sigma, -13, 13)
        if (p[0] - p[2]) ** 2 + (p[1] - p[3]) ** 2 < 4.0:
            continue
        pairs.append(p.astype(np.float32))
    side = 2 * DESC_R + 1
    neg = np.zeros((N_ROT, 256), np.int64)
    pos = np.zeros((N_ROT, 256), np.int64)
    for b in range(N_ROT):
        th = 2.0 * np.pi * b / N_ROT
        ca, sa = np.cos(th), np.sin(th)
        for s, (x1, y1, x2, y2) in enumerate(pairs):
            col = {}
            for px, py, sign in ((x1, y1, -1), (x2, y2, 1)):
                rx = int(np.clip(int(round(ca * px - sa * py)), -DESC_R, DESC_R))
                ry = int(np.clip(int(round(sa * px + ca * py)), -DESC_R, DESC_R))
                at = (ry + DESC_R) * side + (rx + DESC_R)
                col[at] = col.get(at, 0) + sign
            nz = {k: v for k, v in col.items() if v != 0}
            neg[b, s] = next((k for k, v in sorted(nz.items()) if v < 0), 0)
            pos[b, s] = next((k for k, v in sorted(nz.items()) if v > 0), 0)
    return neg, pos


def describe(canvas: np.ndarray, ys: np.ndarray, xs: np.ndarray):
    """(angle [N], descriptor words [N, 8] int32) at pixels (ys, xs)."""
    h, w = canvas.shape
    y0 = np.clip(ys - (DESC_R + BLUR_R), 0, h - SIDE45)
    x0 = np.clip(xs - (DESC_R + BLUR_R), 0, w - SIDE45)
    r = np.arange(SIDE45)
    patch = canvas[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]   # [N, 45, 45]
    side = 2 * DESC_R + 1
    inner = patch[:, BLUR_R:BLUR_R + side, BLUR_R:BLUR_R + side]
    df = np.arange(-DESC_R, DESC_R + 1, dtype=np.float64)
    disc = (df[:, None] ** 2 + df[None, :] ** 2) <= PATCH_R * PATCH_R
    pc = inner * disc
    m10 = (pc * df[None, None, :]).sum(axis=(1, 2))
    m01 = (pc * df[None, :, None]).sum(axis=(1, 2))
    angle = np.arctan2(m01, m10)
    k = gauss7()
    rows = sum(k[i] * patch[:, i:i + side, :] for i in range(7))
    blur = sum(k[i] * rows[:, :, i:i + side] for i in range(7))
    bp = to_bf16(blur.reshape(len(ys), side * side))
    two_pi = 2.0 * np.pi
    b = np.mod(np.round(np.mod(angle, two_pi) / two_pi * N_ROT).astype(np.int64), N_ROT)
    neg, pos = brief_index()
    diff = np.take_along_axis(bp, pos[b], 1) - np.take_along_axis(bp, neg[b], 1)
    bits = (diff > 0).astype(np.uint64).reshape(len(ys), 8, 32)
    words = (bits << np.arange(32, dtype=np.uint64)).sum(axis=2)
    return angle, words.astype(np.uint32).view(np.int32)


def check_features(img: np.ndarray, xy: np.ndarray, level: np.ndarray, angle: np.ndarray,
                   desc: np.ndarray, n_levels: int, scale: float, fast_min: float) -> dict:
    """The program's features of one camera image (level-0 `xy` [N, 2],
    `level` [N], `angle` [N], `desc` [N, 8] int32) against the reference
    at the same keypoints: per feature the angle gap (rad, wrapped), the
    descriptor's differing bits, and whether the keypoint fails the FAST
    test (score under `fast_min`, or under a neighbour's, by more than
    1e-3 of a grey level)."""
    gaps, bits, fails = [], [], []
    for lvl in np.unique(level):
        m = level == lvl
        s = scale ** int(lvl)
        xs = np.round(xy[m, 0] / s).astype(np.int64)
        ys = np.round(xy[m, 1] / s).astype(np.int64)
        canvas = level_canvas(img, int(lvl), n_levels, scale)
        a_ref, d_ref = describe(canvas, ys, xs)
        g = np.abs(np.angle(np.exp(1j * (angle[m].astype(np.float64) - a_ref))))
        x = np.bitwise_xor(desc[m].view(np.uint32), d_ref.view(np.uint32))
        nb = np.unpackbits(x.view(np.uint8), axis=1).sum(axis=1)
        sc = fast_scores(canvas, ys, xs)
        nbr = np.max([fast_scores(canvas, ys + dy, xs + dx)
                      for dy in (-1, 0, 1) for dx in (-1, 0, 1) if dy or dx], axis=0)
        fail = (sc < fast_min - 1e-3) | (sc < nbr - 1e-3)
        gaps.append(g)
        bits.append(nb)
        fails.append(fail)
    cat = (lambda v: np.concatenate(v) if v else np.zeros(0))
    return {"angle_gap": cat(gaps), "desc_bits": cat(bits), "fast_fail": cat(fails)}
