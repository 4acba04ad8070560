"""The port's hand-written Hopper kernels, their wrappers and plain versions.

Counterpart of `multi_orb_slam_tpu/ops/pallas_kernels.py`.  Each kernel has

- a CUDA C++ source in `csrc/` (built by `ops/_build.py` on first use),
- a wrapper here that checks device, dtype, shape and contiguity, allocates
  the output with `torch.empty`, launches the kernel on PyTorch's current
  stream and raises if the launch reports an error,
- a plain PyTorch version with the same semantics (`*_plain`), which the
  wrapper runs only for tensors on the CPU,
- a launch count (`LAUNCHES[name]`), raised by one where the wrapper
  launches the kernel and nowhere else.

| kernel           | replaces (pallas_kernels.py)              | source                 |
| ---------------- | ----------------------------------------- | ---------------------- |
| `fast_score`     | `fast_score_pallas` / `_fast_kernel`      | csrc/fast_score.cu     |
| `gather_patches` | `gather_patches_pallas`                   | csrc/gather_patches.cu |
| `window_match`   | `window_match_pallas` / `_window_match_kernel` | csrc/window_match.cu |
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np
import torch

BIG = 1 << 20  # no-candidate distance of window_match

LAUNCHES = {"fast_score": 0, "gather_patches": 0, "window_match": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _route(*tensors: torch.Tensor) -> bool:
    """True to launch the kernel (CUDA), False for the plain version (CPU)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on different devices: {t.device} vs {dev}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"unsupported device {dev}")


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {ndim} dims")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(name: str, fn_name: str, *args) -> None:
    from . import _build

    err = getattr(_build.load(), fn_name)(
        *args, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# ---------------------------------------------------------------------------
# B1: FAST-9/16 corner strength
# ---------------------------------------------------------------------------

# Bresenham circle of radius 3 (dy, dx), FAST-16 order
FAST_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)


def _extent_mask(extents: Sequence[tuple[int, int]], H: int, W: int,
                 device) -> torch.Tensor:
    hs = torch.tensor([e[0] for e in extents], device=device)
    ws = torch.tensor([e[1] for e in extents], device=device)
    yy = torch.arange(H, device=device)
    xx = torch.arange(W, device=device)
    return (yy[None, :, None] < hs[:, None, None]) & (xx[None, None, :] < ws[:, None, None])


def fast_score_plain(canvas: torch.Tensor,
                     extents: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Zero-pad each image outside its extent, then 16 shifted slices."""
    B, H, W = canvas.shape
    inside = _extent_mask(extents, H, W, canvas.device)
    img = torch.where(inside, canvas, torch.zeros_like(canvas))
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    center = p[:, 3:3 + H, 3:3 + W]
    ds = [p[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - center
          for dy, dx in FAST_OFFSETS]
    bright = dark = None
    for k in range(16):
        amin = amax = ds[k]
        for j in range(1, 9):
            d = ds[(k + j) % 16]
            amin = torch.minimum(amin, d)
            amax = torch.maximum(amax, d)
        bright = amin if bright is None else torch.maximum(bright, amin)
        dark = -amax if dark is None else torch.maximum(dark, -amax)
    score = torch.maximum(bright, dark)
    return torch.where(inside, score, torch.zeros_like(score))


def fast_score(canvas: torch.Tensor,
               extents: Sequence[tuple[int, int]]) -> torch.Tensor:
    """FAST-9/16 corner strength of every image of a [B, H, W] canvas.

    Image b occupies rows [0, extents[b][0]) and columns [0, extents[b][1]);
    pixels outside read as zero and score 0.  Same values as
    `pallas_kernels.fast_score_pallas` run on each image at its true shape.
    """
    _check(canvas, "canvas", torch.float32, 3)
    B, H, W = canvas.shape
    if len(extents) != B:
        raise ValueError(f"{len(extents)} extents for {B} images")
    if not _route(canvas):
        return fast_score_plain(canvas, extents)
    out = torch.empty_like(canvas)
    hs = (ctypes.c_int * B)(*[int(e[0]) for e in extents])
    ws = (ctypes.c_int * B)(*[int(e[1]) for e in extents])
    _launch("fast_score", "fast_score_launch", _ptr(canvas),
            ctypes.cast(hs, ctypes.c_void_p), ctypes.cast(ws, ctypes.c_void_p),
            _ptr(out), B, H, W)
    return out


# ---------------------------------------------------------------------------
# B2: per-keypoint patch gather
# ---------------------------------------------------------------------------


def gather_patches_plain(canvas: torch.Tensor, idx: torch.Tensor,
                         side: int) -> torch.Tensor:
    """Advanced indexing, with the start indices clamped into range."""
    B, H, W = canvas.shape
    b = idx[:, 0].long().clamp(0, B - 1)
    y0 = idx[:, 1].long().clamp(0, H - side)
    x0 = idx[:, 2].long().clamp(0, W - side)
    d = torch.arange(side, device=canvas.device)
    return canvas[b[:, None, None], (y0[:, None] + d)[:, :, None],
                  (x0[:, None] + d)[:, None, :]]


def gather_patches(canvas: torch.Tensor, idx: torch.Tensor,
                   side: int) -> torch.Tensor:
    """[N, side, side] patches of a [B, H, W] canvas.

    idx: [N, 3] int32 rows (image b, y0, x0), pre-clipped by the caller to
    [0, H - side] / [0, W - side]; a start out of range is clamped into it
    (b to [0, B-1] too), so no read leaves the canvas.
    """
    _check(canvas, "canvas", torch.float32, 3)
    _check(idx, "idx", torch.int32, 2)
    B, H, W = canvas.shape
    if idx.shape[1] != 3 or not 0 < side <= min(H, W):
        raise ValueError(f"idx {tuple(idx.shape)}, side {side}, canvas {H}x{W}")
    if not _route(canvas, idx):
        return gather_patches_plain(canvas, idx, side)
    N = idx.shape[0]
    out = torch.empty((N, side, side), dtype=canvas.dtype, device=canvas.device)
    if N == 0:
        return out
    _launch("gather_patches", "gather_patches_launch", _ptr(canvas), _ptr(idx),
            _ptr(out), N, B, H, W, side)
    return out


# ---------------------------------------------------------------------------
# B3: fused gated best/second Hamming matcher
# ---------------------------------------------------------------------------


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 descriptor words (as unsigned 32-bit)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def window_match_plain(q_uv, q_rad, q_lmin, q_lmax, q_ur, q_desc,
                       f_xy, f_ur, f_level, f_mask, f_desc):
    """Masks, a dense [C, Q, F] Hamming matrix, then two first-argmins
    (the semantics of `pallas_kernels.window_match_reference`)."""
    du = torch.abs(q_uv[:, :, None, 0] - f_xy[:, None, :, 0])
    dv = torch.abs(q_uv[:, :, None, 1] - f_xy[:, None, :, 1])
    rad = q_rad[:, :, None]
    in_win = (du < rad) & (dv < rad)
    lv = f_level[:, None, :]
    lv_ok = (lv >= q_lmin[:, :, None]) & (lv <= q_lmax[:, :, None])
    fur = f_ur[:, None, :]
    qur = q_ur[:, :, None]
    ur_ok = (fur < 0) | (torch.abs(qur - fur) < rad) | (qur < -1e8)
    cand = in_win & lv_ok & ur_ok & f_mask[:, None, :]
    from . import hamming

    d = hamming.pairwise_hamming(q_desc, f_desc)
    dm = torch.where(cand, d, torch.full_like(d, BIG))
    bi = torch.argmin(dm, dim=-1)
    bd = torch.gather(dm, -1, bi[..., None])[..., 0]
    col = torch.arange(dm.shape[-1], device=dm.device)
    d2 = torch.where(col == bi[..., None], torch.full_like(dm, BIG), dm)
    b2i = torch.argmin(d2, dim=-1)
    b2 = torch.gather(d2, -1, b2i[..., None])[..., 0]
    i32 = torch.int32
    return bi.to(i32), bd.to(i32), b2.to(i32), b2i.to(i32)


def window_match(q_uv, q_rad, q_lmin, q_lmax, q_ur, q_desc,
                 f_xy, f_ur, f_level, f_mask, f_desc):
    """Gated best/second Hamming match per query, one launch for C cameras.

    Queries [C, Q]: q_uv [C, Q, 2] f32, q_rad / q_ur [C, Q] f32, q_lmin /
    q_lmax [C, Q] int32, q_desc [C or 1, Q, 8] int32 (one shared set of
    query descriptors when the leading dim is 1).  Frame [C, F]: f_xy
    [C, F, 2] f32, f_ur [C, F] f32, f_level [C, F] int32, f_mask [C, F]
    bool, f_desc [C, F, 8] int32.

    Returns (best_idx, best_d, second_d, second_idx), each [C, Q] int32;
    distance 2^20 where a query has no candidate.
    """
    f32, i32 = torch.float32, torch.int32
    for t, n, dt, nd in ((q_uv, "q_uv", f32, 3), (q_rad, "q_rad", f32, 2),
                         (q_lmin, "q_lmin", i32, 2), (q_lmax, "q_lmax", i32, 2),
                         (q_ur, "q_ur", f32, 2), (q_desc, "q_desc", i32, 3),
                         (f_xy, "f_xy", f32, 3), (f_ur, "f_ur", f32, 2),
                         (f_level, "f_level", i32, 2),
                         (f_mask, "f_mask", torch.bool, 2),
                         (f_desc, "f_desc", i32, 3)):
        _check(t, n, dt, nd)
    C, Q = q_rad.shape
    F = f_ur.shape[1]
    for t, shape in ((q_uv, (C, Q, 2)), (q_lmin, (C, Q)), (q_lmax, (C, Q)),
                     (q_ur, (C, Q)), (f_xy, (C, F, 2)), (f_ur, (C, F)),
                     (f_level, (C, F)), (f_mask, (C, F)), (f_desc, (C, F, 8))):
        if tuple(t.shape) != shape:
            raise ValueError(f"shape {tuple(t.shape)}, expected {shape}")
    if q_desc.shape[0] not in (1, C) or tuple(q_desc.shape[1:]) != (Q, 8):
        raise ValueError(f"q_desc shape {tuple(q_desc.shape)}")
    args = (q_uv, q_rad, q_lmin, q_lmax, q_ur, q_desc,
            f_xy, f_ur, f_level, f_mask, f_desc)
    if not _route(*args):
        return window_match_plain(*args)
    out = torch.empty((4, C, Q), dtype=i32, device=q_uv.device)
    if C * Q == 0:
        return out[0], out[1], out[2], out[3]
    if F == 0:
        raise ValueError("window_match needs at least one frame feature")
    qd_stride = 0 if q_desc.shape[0] == 1 else Q * 8
    _launch("window_match", "window_match_launch",
            _ptr(q_uv), _ptr(q_rad), _ptr(q_lmin), _ptr(q_lmax), _ptr(q_ur),
            _ptr(q_desc), ctypes.c_longlong(qd_stride), _ptr(f_xy), _ptr(f_ur),
            _ptr(f_level), _ptr(f_mask), _ptr(f_desc), _ptr(out), C, Q, F)
    return out[0], out[1], out[2], out[3]


def window_match_tie_rows() -> dict:
    """Hand-made tie rows for window_match: queries [1, 4], frame [1, 8].

    Frame features (level, position, distance from the all-zero query):
    f0 (0, origin, 2), f1 (1, origin, 3), f2 (1, origin, 3),
    f3 (0, (100, 100), 4), f4 (1, origin, 3), f5 (0, origin, 1),
    f6 (0, origin, 2), f7 (0, origin, 0, masked out).

    Row 0: the level window excludes every feature -> (0, 2^20, 2^20, 0).
    Row 1: a single candidate, f3 -> (3, 4, 2^20, 0).
    Row 2: three equal candidates f1, f2, f4 -> (1, 3, 3, 2).
    Row 3: f0 is displaced as best by f5 and ties f6 as second; the masked
           f7 is never chosen -> (5, 1, 2, 0).
    Returns the numpy inputs and the expected [4, 4] outputs.
    """
    F = 8
    dist_word = {0: (0, 0x3), 1: (1, 0x7), 2: (1, 0x7), 3: (2, 0xF),
                 4: (1, 0x7), 5: (0, 0x1), 6: (0, 0x3)}
    f_desc = np.zeros((1, F, 8), np.int32)
    for f, (w, bits) in dist_word.items():
        f_desc[0, f, w] = bits
    f_xy = np.zeros((1, F, 2), np.float32)
    f_xy[0, 3] = (100.0, 100.0)
    f_level = np.zeros((1, F), np.int32)
    f_level[0, [1, 2, 4]] = 1
    f_mask = np.ones((1, F), bool)
    f_mask[0, 7] = False
    q_uv = np.zeros((1, 4, 2), np.float32)
    q_uv[0, 1] = (100.0, 100.0)
    return dict(
        q_uv=q_uv,
        q_rad=np.ones((1, 4), np.float32),
        q_lmin=np.array([[5, 0, 1, 0]], np.int32),
        q_lmax=np.array([[6, 0, 1, 0]], np.int32),
        q_ur=np.full((1, 4), -1e9, np.float32),
        q_desc=np.zeros((1, 4, 8), np.int32),
        f_xy=f_xy, f_ur=np.full((1, F), -1.0, np.float32),
        f_level=f_level, f_mask=f_mask, f_desc=f_desc,
        expected=np.array([[0, BIG, BIG, 0], [3, 4, BIG, 0],
                           [1, 3, 3, 2], [5, 1, 2, 0]], np.int32),
    )
