"""The port's hand-written Hopper kernels, their wrappers and plain versions.

Counterpart of `multi_orb_slam_tpu/ops/pallas_kernels.py`.  Each kernel has

- a CUDA C++ source in `csrc/` (built by `ops/_build.py` on first use),
- a wrapper here that checks device, dtype, shape and contiguity, allocates
  the output with `torch.empty`, launches the kernel on PyTorch's current
  stream and raises if the launch reports an error,
- a plain PyTorch version with the same semantics (`*_plain`), which the
  wrapper runs only for tensors on the CPU,
- a launch count (`LAUNCHES[name]`), raised by one where the wrapper
  launches the kernel and nowhere else, and by the launches a captured CUDA
  graph holds on each of its replays (`add_launches`, from
  `utils/graphs.py` and `frontend/fused_graph.py`: a replay calls no wrapper).

| kernel           | replaces (pallas_kernels.py)              | source                 | bound on the H100 by |
| ---------------- | ----------------------------------------- | ---------------------- | -------------------- |
| `fast_score`     | `fast_score_pallas` / `_fast_kernel`      | csrc/fast_score.cu     | bytes; 3.4x above them: staging, ring loads and 119 min/max a live pixel add up (4 pixels a thread, grid sized per image) |
| `gather_patches` | `gather_patches_pallas`                   | csrc/gather_patches.cu | bytes (one block a patch) |
| `window_match`   | `window_match_pallas` / `_window_match_kernel` | csrc/window_match.cu | instruction issue on the gates, the popcount unit when every gate is open (a warp a query, lanes over features) |
| `point_sums`     | `point_sums_pallas` / `_point_sums_kernel` | csrc/point_sums.cu     | bytes, and under them the latency of a dependent pair of loads a value (a block a tile of 8 points, every (row, point) pair of a 128-row chunk in flight, rows added in order from shared memory) |

`window_match_split`, `fast_arcs_blocks` and `point_sums_tiled` are CPU
models of how the redesigned kernels arrive at their results (lane-strided
scan with a pairwise merge; arc extremes from block prefixes and suffixes;
tiles of points and chunks of rows with the sum carried across chunks).  The
tests hold them to the plain versions; nothing on the main path calls them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from .hamming import BIG, popcount32  # noqa: F401  (BIG: window_match's no-candidate distance)

LAUNCHES = {"fast_score": 0, "gather_patches": 0, "window_match": 0,
            "point_sums": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def add_launches(counts: dict) -> None:
    """Count one replay of a captured CUDA graph: `counts` are the launches
    its capture made, kernel by kernel."""
    for k, v in counts.items():
        LAUNCHES[k] += v


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
    """[B, H, W] bool: inside image b's extent (cached; do not write to it)."""
    return _extent_mask_cached(tuple((int(h), int(w)) for h, w in extents), H, W,
                               torch.device(device))


@functools.lru_cache(maxsize=64)
def _extent_mask_cached(extents: tuple, H: int, W: int, device: torch.device) -> torch.Tensor:
    hs = torch.tensor([e[0] for e in extents], device=device)
    ws = torch.tensor([e[1] for e in extents], device=device)
    yy = torch.arange(H, device=device)
    xx = torch.arange(W, device=device)
    return (yy[None, :, None] < hs[:, None, None]) & (xx[None, None, :] < ws[:, None, None])


def fast_arcs_loop(ds: Sequence[torch.Tensor]) -> torch.Tensor:
    """FAST score from the 16 ring differences: 16 arcs of 9, one by one."""
    bright = dark = None
    for k in range(16):
        amin = amax = ds[k]
        for j in range(1, 9):
            d = ds[(k + j) % 16]
            amin = torch.minimum(amin, d)
            amax = torch.maximum(amax, d)
        bright = amin if bright is None else torch.maximum(bright, amin)
        dark = -amax if dark is None else torch.maximum(dark, -amax)
    return torch.maximum(bright, dark)


def fast_arcs_blocks(ds: Sequence[torch.Tensor]) -> torch.Tensor:
    """The same score as `fast_arcs_loop`, the way the CUDA kernel computes
    it: the ring is two blocks of 8; suf[k] = min(d[k .. end of k's block]),
    pre[k] = min(d[start of k's block .. k]), and the arc k .. k+8 is
    min(suf[k], pre[k+8]) (indices mod 16); the maxima likewise; bright =
    max_k arcmin[k], dark = -min_k arcmax[k]: 119 min/max in all.  min and
    max do not round, so the two agree bit for bit."""
    def extreme(inner, outer):
        suf, pre = [None] * 16, [None] * 16
        for blk in (0, 8):
            suf[blk + 7], pre[blk] = ds[blk + 7], ds[blk]
            for i in range(1, 8):
                suf[blk + 7 - i] = inner(ds[blk + 7 - i], suf[blk + 8 - i])
                pre[blk + i] = inner(ds[blk + i], pre[blk + i - 1])
        best = None
        for k in range(16):
            m9 = inner(suf[k], pre[(k + 8) % 16])
            best = m9 if best is None else outer(best, m9)
        return best

    bright = extreme(torch.minimum, torch.maximum)
    return torch.maximum(bright, -extreme(torch.maximum, torch.minimum))


def fast_arcs_doubling(ds: Sequence[torch.Tensor]) -> torch.Tensor:
    """The same score again by doubling: m2[k] = min(d[k], d[k+1]), m4[k] =
    min(m2[k], m2[k+2]), m8[k] = min(m4[k], m4[k+4]), arc[k] = min(m8[k],
    d[k+8]): 159 min/max.  The kernel's first redesign; `fast_arcs_blocks`
    needs fewer and replaced it there."""
    def extreme(inner, outer):
        m2 = [inner(ds[k], ds[(k + 1) % 16]) for k in range(16)]
        m4 = [inner(m2[k], m2[(k + 2) % 16]) for k in range(16)]
        best = None
        for k in range(16):
            m9 = inner(inner(m4[k], m4[(k + 4) % 16]), ds[(k + 8) % 16])
            best = m9 if best is None else outer(best, m9)
        return best

    bright = extreme(torch.minimum, torch.maximum)
    return torch.maximum(bright, -extreme(torch.maximum, torch.minimum))


def fast_ring_differences(canvas: torch.Tensor,
                          extents: Sequence[tuple[int, int]]):
    """(the 16 ring-minus-centre differences of every pixel, zeros read
    outside each image's extent; the [B, H, W] inside-the-extent mask)."""
    B, H, W = canvas.shape
    inside = _extent_mask(extents, H, W, canvas.device)
    img = torch.where(inside, canvas, torch.zeros_like(canvas))
    p = torch.nn.functional.pad(img, (3, 3, 3, 3))
    center = p[:, 3:3 + H, 3:3 + W]
    ds = [p[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W] - center
          for dy, dx in FAST_OFFSETS]
    return ds, inside


def fast_score_plain(canvas: torch.Tensor,
                     extents: Sequence[tuple[int, int]]) -> torch.Tensor:
    """Zero-pad each image outside its extent, then 16 shifted slices."""
    ds, inside = fast_ring_differences(canvas, extents)
    score = fast_arcs_loop(ds)
    return torch.where(inside, score, torch.zeros_like(score))


@functools.lru_cache(maxsize=64)
def _extent_arrays(extents: tuple, B: int, H: int, W: int) -> tuple:
    """The extents of a [B, H, W] canvas, checked, as two C int arrays;
    done once per distinct argument."""
    if len(extents) != B:
        raise ValueError(f"{len(extents)} extents for {B} images")
    if any(not (0 <= h <= H and 0 <= w <= W) for h, w in extents):
        raise ValueError(f"extents {extents} leave the {H}x{W} canvas")
    return ((ctypes.c_int * B)(*[h for h, _ in extents]),
            (ctypes.c_int * B)(*[w for _, w in extents]))


def fast_score(canvas: torch.Tensor,
               extents: Sequence[tuple[int, int]]) -> torch.Tensor:
    """FAST-9/16 corner strength of every image of a [B, H, W] canvas.

    Image b occupies rows [0, extents[b][0]) and columns [0, extents[b][1]);
    pixels outside read as zero and score 0.  Same values as
    `pallas_kernels.fast_score_pallas` run on each image at its true shape.
    """
    _check(canvas, "canvas", torch.float32, 3)
    B, H, W = canvas.shape
    hs, ws = _extent_arrays(tuple((int(h), int(w)) for h, w in extents), B, H, W)
    if not _route(canvas):
        return fast_score_plain(canvas, extents)
    out = torch.empty_like(canvas)
    _launch("fast_score", "fast_score_launch", canvas.data_ptr(),
            ctypes.addressof(hs), ctypes.addressof(ws), out.data_ptr(), B, H, W)
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


def window_match_candidates(q_uv, q_rad, q_lmin, q_lmax, q_ur,
                            f_xy, f_ur, f_level, f_mask):
    """[C, Q, F] bool: the (query, feature) pairs that pass every gate."""
    du = torch.abs(q_uv[:, :, None, 0] - f_xy[:, None, :, 0])
    dv = torch.abs(q_uv[:, :, None, 1] - f_xy[:, None, :, 1])
    rad = q_rad[:, :, None]
    in_win = (du < rad) & (dv < rad)
    lv = f_level[:, None, :]
    lv_ok = (lv >= q_lmin[:, :, None]) & (lv <= q_lmax[:, :, None])
    fur = f_ur[:, None, :]
    qur = q_ur[:, :, None]
    ur_ok = (fur < 0) | (torch.abs(qur - fur) < rad) | (qur < -1e8)
    return in_win & lv_ok & ur_ok & f_mask[:, None, :]


def window_match_plain(q_uv, q_rad, q_lmin, q_lmax, q_ur, q_desc,
                       f_xy, f_ur, f_level, f_mask, f_desc):
    """Masks, a dense [C, Q, F] Hamming matrix, then two first-argmins
    (the semantics of `pallas_kernels.window_match_reference`)."""
    cand = window_match_candidates(q_uv, q_rad, q_lmin, q_lmax, q_ur,
                                   f_xy, f_ur, f_level, f_mask)
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
    C, Q = q_rad.shape if q_rad.dim() == 2 else (-1, -1)
    F = f_ur.shape[1] if f_ur.dim() == 2 else -1
    args = (q_uv, q_rad, q_lmin, q_lmax, q_ur, q_desc,
            f_xy, f_ur, f_level, f_mask, f_desc)
    # one pass: dtype, shape (so the number of dims too) and contiguity
    for t, name, dtype, shape in (
            (q_uv, "q_uv", f32, (C, Q, 2)), (q_rad, "q_rad", f32, (C, Q)),
            (q_lmin, "q_lmin", i32, (C, Q)), (q_lmax, "q_lmax", i32, (C, Q)),
            (q_ur, "q_ur", f32, (C, Q)),
            (q_desc, "q_desc", i32, (C, Q, 8)),
            (f_xy, "f_xy", f32, (C, F, 2)), (f_ur, "f_ur", f32, (C, F)),
            (f_level, "f_level", i32, (C, F)), (f_mask, "f_mask", torch.bool, (C, F)),
            (f_desc, "f_desc", i32, (C, F, 8))):
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if t.shape != shape and not (t is q_desc and t.shape == (1, Q, 8)):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: not contiguous")
    if not _route(*args):
        return window_match_plain(*args)
    out = torch.empty((4, C, Q), dtype=i32, device=q_uv.device)
    if C * Q == 0:
        return out[0], out[1], out[2], out[3]
    if F == 0:
        raise ValueError("window_match needs at least one frame feature")
    if q_desc.data_ptr() % 16 or f_desc.data_ptr() % 16:
        raise ValueError("q_desc and f_desc must start on a 16-byte boundary")
    _launch("window_match", "window_match_launch",
            q_uv.data_ptr(), q_rad.data_ptr(), q_lmin.data_ptr(), q_lmax.data_ptr(),
            q_ur.data_ptr(), q_desc.data_ptr(), 0 if q_desc.shape[0] == 1 else Q * 8,
            f_xy.data_ptr(), f_ur.data_ptr(), f_level.data_ptr(), f_mask.data_ptr(),
            f_desc.data_ptr(), out.data_ptr(), C, Q, F)
    return out[0], out[1], out[2], out[3]


_EMPTY_KEY = (1 << 62) - 1  # window_match_split: a slot that holds no candidate


def window_match_split(q_uv, q_rad, q_lmin, q_lmax, q_ur, q_desc,
                       f_xy, f_ur, f_level, f_mask, f_desc, lanes: int = 32):
    """`window_match_plain`'s results, reached the way the CUDA kernel
    reaches them (a model for the CPU tests; `lanes` a power of two).

    A candidate is one integer key, distance << 32 | feature index, so the
    order of the keys is the order (distance, index).  Lane l of a query
    sees features l, l + lanes, ... and keeps its two smallest keys; then
    log2(lanes) steps merge lane l with lane l ^ off, keeping the two
    smallest of the four.  A slot without a candidate holds a key above all
    others and no index: it decodes to (2^20, 0).  (The kernel's keys are 32
    bits, with the index inside a tile of 1024 features, and it merges tile
    by tile: the same order.)
    """
    if lanes < 1 or lanes & (lanes - 1):
        raise ValueError(f"lanes {lanes} is not a power of two")
    from . import hamming

    cand = window_match_candidates(q_uv, q_rad, q_lmin, q_lmax, q_ur,
                                   f_xy, f_ur, f_level, f_mask)
    C, Q, F = cand.shape
    d = hamming.pairwise_hamming(q_desc, f_desc).to(torch.int64)
    key = torch.where(cand, (d << 32) | torch.arange(F), torch.full_like(d, _EMPTY_KEY))
    strides = max(2, -(-F // lanes))
    pad = torch.full((C, Q, strides * lanes - F), _EMPTY_KEY, dtype=torch.int64)
    per_lane = torch.cat([key, pad], dim=-1).reshape(C, Q, strides, lanes)
    two = torch.sort(per_lane, dim=2).values[:, :, :2]          # each lane's own scan
    k1, k2 = two[:, :, 0], two[:, :, 1]                         # [C, Q, lanes]
    lane = torch.arange(lanes)
    off = lanes // 2
    while off:
        o1, o2 = k1[..., lane ^ off], k2[..., lane ^ off]
        k1, k2 = (torch.minimum(k1, o1),
                  torch.minimum(torch.maximum(k1, o1), torch.minimum(k2, o2)))
        off //= 2
    k1, k2 = k1[..., 0], k2[..., 0]
    i32 = torch.int32
    has1, has2 = k1 != _EMPTY_KEY, k2 != _EMPTY_KEY
    zero, big = torch.zeros_like(k1), torch.full_like(k1, BIG)
    return (torch.where(has1, k1 & 0xFFFFFFFF, zero).to(i32),
            torch.where(has1, k1 >> 32, big).to(i32),
            torch.where(has2, k2 >> 32, big).to(i32),
            torch.where(has2, k2 & 0xFFFFFFFF, zero).to(i32))


def window_match_tie_rows(strided: bool = False) -> dict:
    """Hand-made tie rows for window_match; returns the numpy inputs and
    the expected [Q, 4] outputs (best idx, best d, second d, second idx).

    The first set: queries [1, 4], frame [1, 8].
    Frame features (level, position, distance from the all-zero query):
    f0 (0, origin, 2), f1 (1, origin, 3), f2 (1, origin, 3),
    f3 (0, (100, 100), 4), f4 (1, origin, 3), f5 (0, origin, 1),
    f6 (0, origin, 2), f7 (0, origin, 0, masked out).

    Row 0: the level window excludes every feature -> (0, 2^20, 2^20, 0).
    Row 1: a single candidate, f3 -> (3, 4, 2^20, 0).
    Row 2: three equal candidates f1, f2, f4 -> (1, 3, 3, 2).
    Row 3: f0 is displaced as best by f5 and ties f6 as second; the masked
           f7 is never chosen -> (5, 1, 2, 0).

    `strided=True`, the second set: queries [1, 7], frame [1, 70], for a scan
    that strides 32 lanes over the features (lane = f mod 32).  Every
    feature sits at the origin; query r takes the features of level r + 1,
    all others have level 0.  (feature: distance) per row:

    Row 0: equal distances in one lane, f3: 5 and f35: 5 -> (3, 5, 5, 35).
    Row 1: equal distances in three lanes, f10, f20, f41: 4 -> (10, 4, 4, 20).
    Row 2: the best in the last, partial stride, f66: 1 beside f5: 2 and
           f37: 2 -> (66, 1, 2, 5).
    Row 3: a single candidate at the last feature, f69: 7 -> (69, 7, 2^20, 0).
    Row 4: the tied seconds' lower index in the higher lane, f40: 2, f33: 6,
           f2: 6 -> (40, 2, 6, 2).
    Row 5: a tie across the stride's end, f31: 3 and f32: 3, while f0: 0 is
           masked out -> (31, 3, 3, 32).
    Row 6: no feature has level 7 -> (0, 2^20, 2^20, 0).
    """
    if strided:
        F = 70
        rows = [{3: 5, 35: 5}, {10: 4, 20: 4, 41: 4}, {66: 1, 5: 2, 37: 2},
                {69: 7}, {40: 2, 33: 6, 2: 6}, {31: 3, 32: 3, 0: 0}, {}]
        Q = len(rows)
        f_desc = np.zeros((1, F, 8), np.int32)
        f_level = np.zeros((1, F), np.int32)
        for r, feats in enumerate(rows):
            for f, dist in feats.items():
                f_level[0, f] = r + 1
                f_desc[0, f, f % 8] = (1 << dist) - 1
        f_mask = np.ones((1, F), bool)
        f_mask[0, 0] = False
        q_level = np.arange(1, Q + 1, dtype=np.int32)[None]
        return dict(
            q_uv=np.zeros((1, Q, 2), np.float32),
            q_rad=np.ones((1, Q), np.float32),
            q_lmin=q_level, q_lmax=q_level.copy(),
            q_ur=np.full((1, Q), -1e9, np.float32),
            q_desc=np.zeros((1, Q, 8), np.int32),
            f_xy=np.zeros((1, F, 2), np.float32),
            f_ur=np.full((1, F), -1.0, np.float32),
            f_level=f_level, f_mask=f_mask, f_desc=f_desc,
            expected=np.array([[3, 5, 5, 35], [10, 4, 4, 20], [66, 1, 2, 5],
                               [69, 7, BIG, 0], [40, 2, 6, 2], [31, 3, 3, 32],
                               [0, BIG, BIG, 0]], np.int32),
        )
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


# ---------------------------------------------------------------------------
# B4: row-wise gather through an inverse observation map + sum over rows
# ---------------------------------------------------------------------------


def point_sums_plain(V: torch.Tensor, inv: torch.Tensor):
    """`torch.gather` on the clamped index, zero where `inv < 0`, and the
    sum over rows accumulated in ascending row order (the kernel's order,
    so `summed` can be bit-equal too)."""
    LC, F, D = V.shape
    P = inv.shape[1]
    g = torch.gather(V, 1, inv.clamp(0, F - 1).long()[..., None].expand(LC, P, D))
    gathered = torch.where((inv >= 0)[..., None], g, torch.zeros_like(g))
    summed = torch.zeros((P, D), dtype=V.dtype, device=V.device)
    for r in range(LC):
        summed = summed + gathered[r]
    return summed, gathered


def point_sums_tiled(V: torch.Tensor, inv: torch.Tensor, tile_points: int = 8,
                     chunk_rows: int = 128):
    """`point_sums_plain`'s results, reached the way the CUDA kernel reaches
    them at D = 4 (a model for the CPU tests).

    A block owns `tile_points` consecutive points (the last tile may be
    ragged) and walks the rows in chunks of `chunk_rows`: it gathers the
    chunk's values for its tile at once (every (row, point) pair an
    independent load), writes them to `gathered`, stages them, and then adds
    the staged rows in ascending order into one accumulator per (point, d)
    that it carries from chunk to chunk.  The adds are the plain version's,
    in its order, so both outputs are bit-equal to it.
    """
    if tile_points < 1 or chunk_rows < 1:
        raise ValueError(f"tile_points {tile_points}, chunk_rows {chunk_rows}")
    LC, F, D = V.shape
    P = inv.shape[1]
    gathered = torch.empty((LC, P, D), dtype=V.dtype)
    summed = torch.empty((P, D), dtype=V.dtype)
    for p0 in range(0, P, tile_points):
        p1 = min(p0 + tile_points, P)
        acc = torch.zeros((p1 - p0, D), dtype=V.dtype)
        for r0 in range(0, LC, chunk_rows):
            r1 = min(r0 + chunk_rows, LC)
            f = inv[r0:r1, p0:p1]
            rows = torch.arange(r0, r1)[:, None].expand_as(f)
            stage = V[rows, f.clamp(0, F - 1).long()]
            stage = torch.where((f >= 0)[..., None], stage, torch.zeros_like(stage))
            gathered[r0:r1, p0:p1] = stage
            for r in range(r1 - r0):
                acc = acc + stage[r]
        summed[p0:p1] = acc
    return summed, gathered


def point_sums(V: torch.Tensor, inv: torch.Tensor):
    """V [LC, F, D] f32, inv [LC, P] int32 (-1 = no observation) ->
    (summed [P, D], gathered [LC, P, D]).

    gathered[r, p] = V[r, inv[r, p]], zeros where inv < 0; summed =
    gathered summed over r in ascending order.  Exact: a selection in
    float32.  Any D >= 1 (D = 4 with 16-byte aligned storage takes the
    kernel's vector path, anything else its scalar path).  An index >= F is
    a caller error and reads row F - 1 in both versions.

    The local-BA solver uses `gathered` (its one-time re-layout of the
    observations from feature-indexed to point-indexed rows); nothing on
    that path reads `summed`.
    """
    _check(V, "V", torch.float32, 3)
    _check(inv, "inv", torch.int32, 2)
    LC, F, D = V.shape
    if inv.shape[0] != LC or F < 1 or D < 1:
        raise ValueError(f"V {tuple(V.shape)}, inv {tuple(inv.shape)}")
    if not _route(V, inv):
        return point_sums_plain(V, inv)
    P = inv.shape[1]
    summed = torch.empty((P, D), dtype=V.dtype, device=V.device)
    gathered = torch.empty((LC, P, D), dtype=V.dtype, device=V.device)
    if LC * P == 0:
        return summed.zero_(), gathered
    _launch("point_sums", "point_sums_launch", _ptr(V), _ptr(inv),
            _ptr(summed), _ptr(gathered), LC, F, P, D)
    return summed, gathered
