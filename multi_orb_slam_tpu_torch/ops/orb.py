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
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

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


def scale_factors(cfg: ORBConfig, device=None) -> torch.Tensor:
    """Per-level scale factors sigma."""
    return torch.tensor([cfg.scale_factor ** lvl for lvl in range(cfg.n_levels)],
                        dtype=torch.float32, device=device)


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


def _blur_crop(patches: torch.Tensor, crop: int) -> torch.Tensor:
    """Separable 7x7 Gaussian of [N, S, S] patches, keeping the
    [S - 2*crop]^2 centre (crop >= 3, so no padding is ever read)."""
    k = _gauss7()
    S = patches.shape[-1]
    n = S - 2 * crop
    a = None
    for i in range(7):   # rows
        t = k[i] * patches[:, crop - 3 + i:crop - 3 + i + n, :]
        a = t if a is None else a + t
    b = None
    for i in range(7):   # columns
        t = k[i] * a[:, :, crop - 3 + i:crop - 3 + i + n]
        b = t if b is None else b + t
    return b


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

    r = DESC_PATCH_R
    side = 2 * r + 1
    raw39 = patches45[:, 3:3 + side, 3:3 + side]
    df = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
    circ = (df[:, None] ** 2 + df[None, :] ** 2) <= _PATCH_R * _PATCH_R
    pc = raw39 * circ[None]
    m10 = torch.sum(pc * df[None, None, :], dim=(1, 2))
    m01 = torch.sum(pc * df[None, :, None], dim=(1, 2))
    angle = torch.atan2(m01, m10)

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


def extract_orb(img: torch.Tensor, cfg: ORBConfig = ORBConfig()) -> Features:
    """ORB features of one image [H, W] (-> [F, ...]) or a rig [C, H, W]
    (-> [C, F, ...])."""
    if img.dim() == 2:
        f = extract_from_pyramid(build_pyramid(img[None], cfg), cfg)
        return Features(*(t[0] for t in f))
    return extract_from_pyramid(build_pyramid(img, cfg), cfg)
