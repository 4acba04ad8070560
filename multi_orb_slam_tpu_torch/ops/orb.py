"""ORB feature extraction with the pyramid levels batched onto one canvas.

Counterpart of `multi_orb_slam_tpu/ops/orb.py` (`extract_orb`):

- 8-level x1.2 image pyramid (antialiased bilinear resampling with the
  weight matrices `jax.image.resize` builds)
- FAST-9/16 corner strength: the `fast_score` CUDA kernel, one launch over
  every (camera, level) image of the frame
- 3x3 non-max suppression, per-cell top-K and per-level top-N selection
- one 45x45 patch per keypoint: the `gather_patches` CUDA kernel
- intensity-centroid orientation, 7x7 Gaussian blur of the patches, and
  the rotation-binned steered BRIEF descriptor

Extraction is split into `build_pyramid` and `extract_from_pyramid` so a
test can feed the reference's pyramid in and demand exact keypoints.
Everything is batched over a leading camera axis: images [C, H, W] give
features [C, F, ...].

The reference's per-level extractor (`extract_orb_reference`, one image,
level by level: `fast_score` with the ring wrapping at the image border,
`detect_level`, `ic_angles`, `gaussian_blur7` and `brief_descriptors` on
the rotated pattern sampled pixel by pixel) is here too, in plain PyTorch
and graphed (`cfg` static) as the reference jits it; no path runs it, and
its FAST is not the kernel's (which reads zeros past the border).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import graphs
from . import kernels
from .hamming import top_k

# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


class ORBConfig(NamedTuple):
    n_features: int = 1024          # per camera
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 20.0    # iniThFAST
    fast_threshold_min: float = 7.0 # minThFAST
    cell_size: int = 32             # selection cell
    cell_top_k: int = 8             # candidates kept per cell before top-N
    edge_margin: int = 19           # EDGE_THRESHOLD


def pyramid_shapes(height: int, width: int, cfg: ORBConfig) -> list[tuple[int, int]]:
    shapes = []
    for lvl in range(cfg.n_levels):
        s = cfg.scale_factor ** lvl
        shapes.append((max(int(round(height / s)), 32), max(int(round(width / s)), 32)))
    return shapes


def level_feature_counts(cfg: ORBConfig) -> list[int]:
    """Per-level feature budget, geometric decay."""
    factor = 1.0 / cfg.scale_factor
    n_desired = cfg.n_features * (1.0 - factor) / (1.0 - factor ** cfg.n_levels)
    counts, total = [], 0
    for lvl in range(cfg.n_levels - 1):
        c = int(round(n_desired * factor ** lvl))
        counts.append(c)
        total += c
    counts.append(max(cfg.n_features - total, 0))
    return counts


@functools.lru_cache(maxsize=None)
def scale_table(scale_factor: float, n_levels: int, device: torch.device) -> torch.Tensor:
    """[n_levels] float32 scale factors sigma^level, built once per device
    (a constant, never a copy from the host inside a frame's work)."""
    return torch.tensor([scale_factor ** lvl for lvl in range(n_levels)],
                        dtype=torch.float32, device=device)


def scale_factors(cfg: ORBConfig, device=None) -> torch.Tensor:
    """Per-level scale factors sigma (the cached table: do not write to it)."""
    return scale_table(cfg.scale_factor, cfg.n_levels, torch.device(device or "cpu"))


def level_sigma2(cfg: ORBConfig, device=None) -> torch.Tensor:
    """Per-level sigma^2 used in chi2 weighting (reference mvLevelSigma2)."""
    return scale_factors(cfg, device) ** 2


# ---------------------------------------------------------------------------
# Deterministic BRIEF pattern and its rotation-bin tables (the "weights")
# ---------------------------------------------------------------------------


def make_brief_pattern(seed: int = 1234, n_bits: int = 256, patch_radius: int = 13):
    """256 point pairs ~ N(0, (patch/5)^2), clipped into the patch; pairs
    closer than 2 px are rejected.  Same numpy draw as the reference."""
    rng = np.random.RandomState(seed)
    sigma = patch_radius / 2.0
    pairs = np.zeros((n_bits, 4), np.float32)
    count = 0
    while count < n_bits:
        p = rng.randn(4) * sigma
        p = np.clip(p, -patch_radius, patch_radius)
        if (p[0] - p[2]) ** 2 + (p[1] - p[3]) ** 2 < 4.0:
            continue
        pairs[count] = p
        count += 1
    return pairs  # [256, 4] = (x1, y1, x2, y2)


N_ROT = 30
DESC_PATCH_R = 19  # covers rotated pattern offsets (13 * sqrt(2) ~ 18.4)
_PATCH_R = 15      # intensity-centroid radius (HALF_PATCH_SIZE)


def _make_rot_weights(pattern: np.ndarray, n_rot: int, radius: int):
    side = 2 * radius + 1
    W = np.zeros((n_rot, side * side, 256), np.float32)
    pat = np.asarray(pattern)
    for b in range(n_rot):
        th = 2.0 * np.pi * b / n_rot
        ca, sa = np.cos(th), np.sin(th)
        for s in range(256):
            x1, y1, x2, y2 = pat[s]
            for (px, py, sign) in ((x1, y1, -1.0), (x2, y2, 1.0)):
                rx = int(round(ca * px - sa * py))
                ry = int(round(sa * px + ca * py))
                rx = int(np.clip(rx, -radius, radius))
                ry = int(np.clip(ry, -radius, radius))
                W[b, (ry + radius) * side + (rx + radius), s] += sign
    return W


BRIEF_PATTERN = make_brief_pattern()
# [N_ROT, 39*39, 256] in {-1, 0, +1}: bit s of bin b is sign(W[b,:,s] . patch)
ROT_BRIEF_W = _make_rot_weights(BRIEF_PATTERN, N_ROT, DESC_PATCH_R).astype(np.int8)
# Each column of ROT_BRIEF_W holds one -1 and one +1 (or nothing, where the
# two rotated points land on one pixel), so the product with a patch is
# exactly patch[pos] - patch[neg]: the descriptor is computed as that
# difference of two gathered samples instead of a [F, 1521] x [1521, 7680]
# matmul.  A zero column gives pos == neg == 0 and a difference of 0.
_BRIEF_NEG = np.argmin(ROT_BRIEF_W, axis=1)   # [N_ROT, 256]
_BRIEF_POS = np.argmax(ROT_BRIEF_W, axis=1)


@functools.lru_cache(maxsize=None)
def _brief_index(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.from_numpy(_BRIEF_NEG).to(device),
            torch.from_numpy(_BRIEF_POS).to(device))


@functools.lru_cache(maxsize=None)
def _brief_pattern(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(BRIEF_PATTERN).to(device)


# ---------------------------------------------------------------------------
# Pyramid
# ---------------------------------------------------------------------------


def _resize_weights_np(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] antialiased triangle-kernel weights, computed in float32
    exactly as `jax.image.resize(method="bilinear", antialias=True)`
    computes them (jax/_src/image/scale.py `compute_weight_mat`)."""
    f32 = np.float32
    scale = out_size / in_size
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5))
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    tot = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, f32(1.0)), f32(0.0)).astype(f32)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=None)
def _resize_weights(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_weights_np(in_size, out_size)).to(device)


def build_pyramid(img: torch.Tensor, cfg: ORBConfig) -> list[torch.Tensor]:
    """Grayscale [..., H, W] float32 -> list of [..., H_l, W_l] per level."""
    h, w = img.shape[-2:]
    shapes = pyramid_shapes(h, w, cfg)
    out = [img]
    for lvl in range(1, cfg.n_levels):
        hl, wl = shapes[lvl]
        wy = _resize_weights(h, hl, img.device)     # [H, h_l]
        wx = _resize_weights(w, wl, img.device)     # [W, w_l]
        out.append(wy.transpose(0, 1) @ img @ wx)
    return out


# ---------------------------------------------------------------------------
# Extraction
# ---------------------------------------------------------------------------


class Features(NamedTuple):
    """Fixed-capacity feature set: [F, ...] per image, [C, F, ...] per rig."""

    xy: torch.Tensor        # [..., F, 2] level-0 pixel coords (distorted)
    xy_und: torch.Tensor    # [..., F, 2] undistorted (filled by frame build)
    level: torch.Tensor     # [..., F] int32 pyramid level
    angle: torch.Tensor     # [..., F] float32 radians
    response: torch.Tensor  # [..., F] float32
    desc: torch.Tensor      # [..., F, 8] int32 packed 256-bit descriptors
    valid: torch.Tensor     # [..., F] bool


@functools.lru_cache(maxsize=None)
def _border_mask(shapes: tuple, H0: int, W0: int, m: int,
                 device: torch.device) -> torch.Tensor:
    border = np.zeros((len(shapes), H0, W0), bool)
    for lvl, (h, w) in enumerate(shapes):
        border[lvl, m:h - m, m:w - m] = True
    return torch.from_numpy(border).to(device)


def _gauss7(sigma: float = 2.0) -> list[float]:
    d = np.arange(-3, 4).astype(np.float32)
    k = np.exp(-d * d / (2 * sigma * sigma))
    k /= k.sum()
    return [float(v) for v in k.astype(np.float32)]


def _blur_crop(x: torch.Tensor, crop: int, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian of [..., H, W] images (rows, then columns),
    keeping the [H - 2*crop, W - 2*crop] centre (crop >= 3, so no padding
    is ever read)."""
    k = _gauss7(sigma)
    nr, nc = x.shape[-2] - 2 * crop, x.shape[-1] - 2 * crop
    a = None
    for i in range(7):   # rows
        t = k[i] * x[..., crop - 3 + i:crop - 3 + i + nr, :]
        a = t if a is None else a + t
    b = None
    for i in range(7):   # columns
        t = k[i] * a[..., :, crop - 3 + i:crop - 3 + i + nc]
        b = t if b is None else b + t
    return b


def _ic_angle(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle (reference IC_Angle, ORBextractor.cc:77-104)
    of [N, S, S] patches centred on their keypoints, over the circle of
    radius `_PATCH_R`."""
    r = (patches.shape[-1] - 1) // 2
    df = torch.arange(-r, r + 1, device=patches.device, dtype=torch.float32)
    circ = (df[:, None] ** 2 + df[None, :] ** 2) <= _PATCH_R * _PATCH_R
    pc = patches * circ[None]
    m10 = torch.sum(pc * df[None, None, :], dim=(1, 2))
    m01 = torch.sum(pc * df[None, :, None], dim=(1, 2))
    return torch.atan2(m01, m10)


def extract_from_pyramid(pyr: list[torch.Tensor], cfg: ORBConfig = ORBConfig()) -> Features:
    """ORB features of [C, H_l, W_l] pyramid levels -> Features [C, F, ...].

    All levels of all cameras sit on one zero-padded [C*L, H0, W0] canvas,
    so FAST scoring and the patch gather are one kernel launch each.
    """
    C, H0, W0 = pyr[0].shape
    dev = pyr[0].device
    L = cfg.n_levels
    shapes = pyramid_shapes(H0, W0, cfg)
    counts = level_feature_counts(cfg)
    canvas = torch.zeros((C, L, H0, W0), dtype=torch.float32, device=dev)
    for lvl in range(L):
        h, w = shapes[lvl]
        canvas[:, lvl, :h, :w] = pyr[lvl]
    canvas = canvas.reshape(C * L, H0, W0)

    score = kernels.fast_score(canvas, [shapes[lvl] for _ in range(C) for lvl in range(L)])
    pooled = torch.nn.functional.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    score = torch.where(score >= pooled, score, torch.zeros_like(score))
    score = torch.where(score >= cfg.fast_threshold_min, score, torch.zeros_like(score))
    border = _border_mask(tuple(shapes), H0, W0, cfg.edge_margin, dev)
    score = torch.where(border.repeat(C, 1, 1), score, torch.zeros_like(score))
    rank = torch.where(score >= cfg.fast_threshold, score + 1e4, score)

    # cell top-K over all (camera, level) images
    cs = cfg.cell_size
    ph = (cs - H0 % cs) % cs
    pw = (cs - W0 % cs) % cs
    rank_p = torch.nn.functional.pad(rank, (0, pw, 0, ph))
    ncy, ncx = (H0 + ph) // cs, (W0 + pw) // cs
    cells = rank_p.reshape(C * L, ncy, cs, ncx, cs).permute(0, 1, 3, 2, 4)
    cells = cells.reshape(C * L, ncy * ncx, cs * cs)
    k = min(cfg.cell_top_k, cs * cs)
    cell_vals, cell_idx = top_k(cells, k)                  # [CL, ncells, k]
    cell_ids = torch.arange(ncy * ncx, device=dev)
    iy = (cell_ids // ncx)[None, :, None] * cs + cell_idx // cs
    ix = (cell_ids % ncx)[None, :, None] * cs + cell_idx % cs
    flat_vals = cell_vals.reshape(C * L, -1)
    flat_y = iy.reshape(C * L, -1)
    flat_x = ix.reshape(C * L, -1)

    # per-level top-cap selection (cap = level-0 budget)
    cap = max(counts)
    top_vals, top_i = top_k(flat_vals, cap)                # [CL, cap]
    sel_y = torch.gather(flat_y, 1, top_i).to(torch.float32).reshape(C, L, cap)
    sel_x = torch.gather(flat_x, 1, top_i).to(torch.float32).reshape(C, L, cap)
    top_vals = top_vals.reshape(C, L, cap)
    resp_all = torch.where(top_vals >= 1e4, top_vals - 1e4, top_vals)
    valid_all = top_vals > 0.0

    x_lv = torch.cat([sel_x[:, lvl, :counts[lvl]] for lvl in range(L)], dim=1)
    y_lv = torch.cat([sel_y[:, lvl, :counts[lvl]] for lvl in range(L)], dim=1)
    response = torch.cat([resp_all[:, lvl, :counts[lvl]] for lvl in range(L)], dim=1)
    valid = torch.cat([valid_all[:, lvl, :counts[lvl]] for lvl in range(L)], dim=1)
    level = torch.cat([torch.full((counts[lvl],), lvl, dtype=torch.int32, device=dev)
                       for lvl in range(L)])
    F = level.shape[0]
    level = level[None].expand(C, F)

    # one 45x45 patch per keypoint: pattern radius 19 + blur support 3
    rb = DESC_PATCH_R + 3
    side_b = 2 * rb + 1
    yi0 = torch.clamp(y_lv.to(torch.int32) - rb, 0, H0 - side_b)
    xi0 = torch.clamp(x_lv.to(torch.int32) - rb, 0, W0 - side_b)
    img_id = torch.arange(C, dtype=torch.int32, device=dev)[:, None] * L + level
    idx = torch.stack([img_id, yi0, xi0], dim=-1).reshape(C * F, 3).contiguous()
    patches45 = kernels.gather_patches(canvas, idx, side_b)   # [C*F, 45, 45]

    side = 2 * DESC_PATCH_R + 1
    angle = _ic_angle(patches45[:, 3:3 + side, 3:3 + side])

    # blur the patches; the reference casts them to bf16 before the
    # rotation-bin product, and so does the port (bits flip near 0 without)
    bp = _blur_crop(patches45, 3).reshape(C * F, side * side)
    bp = bp.to(torch.bfloat16).to(torch.float32)
    two_pi = 2.0 * math.pi
    ang_bin = torch.remainder(
        torch.round(torch.remainder(angle, two_pi) / two_pi * N_ROT).to(torch.int32),
        N_ROT).long()
    neg_idx, pos_idx = _brief_index(dev)
    diff = (torch.gather(bp, 1, pos_idx[ang_bin])
            - torch.gather(bp, 1, neg_idx[ang_bin]))      # [C*F, 256]
    bits = (diff > 0).to(torch.int64).reshape(C * F, 8, 32)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = torch.sum(bits << shifts, dim=-1)              # < 2^32
    desc = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)

    scale = scale_factors(cfg, dev)[level.long()]
    xy = torch.stack([x_lv, y_lv], dim=-1) * scale[..., None]
    return Features(
        xy=xy, xy_und=xy, level=level.contiguous(), angle=angle.reshape(C, F),
        response=response, desc=desc.reshape(C, F, 8), valid=valid,
    )


@graphs.graphed(static_argnames=("cfg",))
def extract_orb(img: torch.Tensor, cfg: ORBConfig = ORBConfig()) -> Features:
    """ORB features of one image [H, W] (-> [F, ...]) or a rig [C, H, W]
    (-> [C, F, ...]).  Graphed (`cfg` static) as the reference jits it; in
    `frame.build_frame`'s graphs it runs inline."""
    if img.dim() == 2:
        f = extract_from_pyramid(build_pyramid(img[None], cfg), cfg)
        return Features(*(t[0] for t in f))
    return extract_from_pyramid(build_pyramid(img, cfg), cfg)


# ---------------------------------------------------------------------------
# The reference's per-level extractor
# ---------------------------------------------------------------------------


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Segment-test corner strength of every pixel of [..., H, W] images:
    the largest t for which the pixel passes the FAST-9/16 test, with the
    ring read through `torch.roll` (it wraps at the image border, as the
    reference's `jnp.roll`; the kernel reads zeros there instead)."""
    ds = [torch.roll(img, (-dy, -dx), dims=(-2, -1)) - img for dy, dx in kernels.FAST_OFFSETS]
    return kernels.fast_arcs_loop(ds)


def _maxpool3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 maximum of [..., H, W] with -inf past the border."""
    lead = x.shape[:-2]
    out = torch.nn.functional.max_pool2d(x.reshape((-1, 1) + x.shape[-2:]), 3, stride=1,
                                         padding=1)
    return out.reshape(lead + x.shape[-2:])


def detect_level(img_l: torch.Tensor, n_target: int, cfg: ORBConfig):
    """Up to n_target FAST corners of one [H, W] pyramid level: 3x3 non-max
    suppression, the min threshold, the border margin, strong corners
    ranked above the rest, per-cell top-K, then the global top-N.  Returns
    (xy [n_target, 2] float32 level coords, response [n_target], valid
    [n_target] bool)."""
    h, w = img_l.shape
    dev = img_l.device
    zero = torch.zeros((), dtype=img_l.dtype, device=dev)
    score = fast_score(img_l)
    score = torch.where(score >= _maxpool3x3(score), score, zero)
    score = torch.where(score >= cfg.fast_threshold_min, score, zero)
    m = cfg.edge_margin
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    inb = (yy >= m) & (yy < h - m) & (xx >= m) & (xx < w - m)
    score = torch.where(inb, score, zero)
    rank = torch.where(score >= cfg.fast_threshold, score + 1e4, score)

    cs = cfg.cell_size
    ph, pw = (cs - h % cs) % cs, (cs - w % cs) % cs
    rank_p = torch.nn.functional.pad(rank, (0, pw, 0, ph))
    ncy, ncx = (h + ph) // cs, (w + pw) // cs
    cells = rank_p.reshape(ncy, cs, ncx, cs).permute(0, 2, 1, 3).reshape(ncy * ncx, cs * cs)
    cell_vals, cell_idx = top_k(cells, min(cfg.cell_top_k, cs * cs))
    cell_ids = torch.arange(ncy * ncx, device=dev)[:, None]
    flat_y = ((cell_ids // ncx) * cs + cell_idx // cs).reshape(-1)
    flat_x = ((cell_ids % ncx) * cs + cell_idx % cs).reshape(-1)
    flat_vals = cell_vals.reshape(-1)
    n_take = min(n_target, flat_vals.shape[0])
    top_vals, top_i = top_k(flat_vals, n_take)
    xy = torch.stack([flat_x[top_i], flat_y[top_i]], dim=-1).to(torch.float32)
    resp = torch.where(top_vals >= 1e4, top_vals - 1e4, top_vals)
    valid = top_vals > 0.0
    pad = n_target - n_take
    if pad:
        xy = torch.cat([xy, xy.new_zeros((pad, 2))])
        resp = torch.cat([resp, resp.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return xy, resp, valid


def _gather_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """[N, 2r+1, 2r+1] patches of [H, W] around the integer parts of xy,
    each pixel clipped into the image."""
    h, w = img.shape
    d = torch.arange(-radius, radius + 1, device=img.device)
    y = (xy[:, 1].to(torch.int32)[:, None, None] + d[None, :, None]).clamp(0, h - 1)
    x = (xy[:, 0].to(torch.int32)[:, None, None] + d[None, None, :]).clamp(0, w - 1)
    return img[y.long(), x.long()]


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid orientation in radians of keypoints xy [N, 2] of
    an [H, W] image (circular patch of radius 15)."""
    return _ic_angle(_gather_patches(img, xy, _PATCH_R))


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian of [..., H, W] images, the border replicated
    (reference GaussianBlur(..., Size(7, 7), 2, 2), ORBextractor.cc:1082)."""
    lead = img.shape[:-2]
    x = torch.nn.functional.pad(img.reshape((-1,) + img.shape[-2:]), (3, 3, 3, 3),
                                mode="replicate")
    return _blur_crop(x, 3, sigma).reshape(lead + img.shape[-2:])


def gaussian_blur7_batched(imgs: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """[B, H, W] separable 7x7 Gaussian, zeros past the border."""
    return _blur_crop(torch.nn.functional.pad(imgs, (3, 3, 3, 3)), 3, sigma)


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor, angles: torch.Tensor,
                      pattern=None) -> torch.Tensor:
    """Steered BRIEF: the pattern [256, 4] (default `BRIEF_PATTERN`) rotated
    by each keypoint's angle, each point sampled at the nearest pixel of the
    blurred [H, W] image, bit = first < second.  Returns [N, 8] int32 (the
    32 bits of each word, as `Features.desc` holds them)."""
    h, w = img_blur.shape
    dev = img_blur.device
    pat = (_brief_pattern(dev) if pattern is None
           else torch.as_tensor(pattern, dtype=torch.float32, device=dev))
    ca, sa = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    x0, y0 = xy[:, 0:1], xy[:, 1:2]

    def sample(px, py):
        rx = ca * px[None] - sa * py[None]
        ry = sa * px[None] + ca * py[None]
        xi = torch.round(x0 + rx).to(torch.int32).clamp(0, w - 1)
        yi = torch.round(y0 + ry).to(torch.int32).clamp(0, h - 1)
        return img_blur[yi.long(), xi.long()]              # [N, 256]

    bits = (sample(pat[:, 0], pat[:, 1]) < sample(pat[:, 2], pat[:, 3])).to(torch.int64)
    shifts = torch.arange(32, device=dev, dtype=torch.int64)
    words = torch.sum(bits.reshape(-1, 8, 32) << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def extract_reference_from_pyramid(pyr: list[torch.Tensor],
                                   cfg: ORBConfig = ORBConfig()) -> Features:
    """The per-level extraction of [H_l, W_l] pyramid levels -> Features
    [F, ...]: each level detected, oriented, blurred and described on its
    own."""
    counts = level_feature_counts(cfg)
    dev = pyr[0].device
    out = []
    for lvl in range(cfg.n_levels):
        img_l, n_l = pyr[lvl], counts[lvl]
        if n_l == 0:
            continue
        xy, resp, valid = detect_level(img_l, n_l, cfg)
        ang = ic_angles(img_l, xy)
        desc = brief_descriptors(gaussian_blur7(img_l), xy, ang)
        scale = float(np.float32(cfg.scale_factor ** lvl))
        out.append((xy * scale, torch.full((n_l,), lvl, dtype=torch.int32, device=dev),
                    ang, resp, desc, valid))
    xy, level, angle, response, desc, valid = (torch.cat(f) for f in zip(*out))
    return Features(xy=xy, xy_und=xy, level=level, angle=angle, response=response,
                    desc=desc, valid=valid)


@graphs.graphed(static_argnames=("cfg",))
def extract_orb_reference(img: torch.Tensor, cfg: ORBConfig = ORBConfig()) -> Features:
    """Per-level ORB extraction of one [H, W] image -> Features [F, ...]
    (the reference's readable form; `extract_orb` computes the same
    features with every level batched on one canvas)."""
    return extract_reference_from_pyramid(build_pyramid(img, cfg), cfg)
