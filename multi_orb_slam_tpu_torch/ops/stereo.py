"""Stereo matching: left / right ORB features -> per-feature depth.

Counterpart of `multi_orb_slam_tpu/ops/stereo.py` (which replaces
`Frame::ComputeStereoMatches`, reference src/Frame.cc:782-956): for each left
keypoint, the right keypoints in a row band that widens with the left
keypoint's level, at a level within one of it, with a disparity in
[0.5, 192] px, are candidates; the Hamming best among them is the match if
it is within TH_HIGH and clearly better than the second (ratio 0.9).
Depth is bf / disparity.  `subpixel_refine` then slides an 11x11 SAD window
over +/-5 columns of the right image and fits a parabola.

The [F, F] Hamming matrix is one float32 product of +-1 descriptors
(`hamming.pairwise_hamming`, exact), masked by the gates above;
`window_match`'s square search window cannot express the row band with an
asymmetric disparity range, so this is no kernel launch.
"""

from __future__ import annotations

import torch

from . import hamming


def stereo_match_depth(featsL, featsR, bf, scale_factor: float = 1.2,
                       min_disp: float = 0.5, max_disp: float = 192.0,
                       th_hamming: int = hamming.TH_HIGH, row_band: float = 2.0):
    """Left / right `orb.Features` of one image each ([F, ...]) -> (depth [F],
    uright [F]) for the left features (0 and -1 where unmatched)."""
    xL, yL = featsL.xy[:, 0], featsL.xy[:, 1]
    xR, yR = featsR.xy[:, 0], featsR.xy[:, 1]
    # row band scales with the left keypoint's level (reference Frame.cc:807)
    band = row_band * (scale_factor ** featsL.level.to(torch.float32))
    dy = torch.abs(yL[:, None] - yR[None, :])
    disp = xL[:, None] - xR[None, :]
    lvl_l, lvl_r = featsL.level[:, None], featsR.level[None, :]
    cand = ((dy <= band[:, None])
            & (disp >= min_disp) & (disp <= max_disp)
            & (lvl_r >= lvl_l - 1) & (lvl_r <= lvl_l + 1)
            & featsL.valid[:, None] & featsR.valid[None, :])
    d = hamming.pairwise_hamming(featsL.desc, featsR.desc)
    bi, bd, b2 = hamming.masked_argmin2(d, cand)
    ok = (bd <= th_hamming) & (bd.to(torch.float32) <= 0.9 * b2.to(torch.float32))
    xr_best = xR[bi]
    bf = torch.as_tensor(bf, dtype=torch.float32, device=xL.device)
    depth = torch.where(ok, bf / torch.clamp(xL - xr_best, min=min_disp),
                        torch.zeros_like(xL))
    uright = torch.where(ok, xr_best, torch.full_like(xL, -1.0))
    return depth, uright


def subpixel_refine(gray_left: torch.Tensor, gray_right: torch.Tensor,
                    xL: torch.Tensor, yL: torch.Tensor, uright: torch.Tensor,
                    bf, win: int = 5, search: int = 5):
    """SAD parabola subpixel disparity (reference Frame.cc:860-940).

    An 11x11 left patch is slid over +/-`search` px of the matched right
    column; the SAD minimum (the first one among equals, as `jnp.argmin`)
    is refined by parabola interpolation.  gray_* [H, W]; xL, yL, uright
    [F] (uright -1 where unmatched).  Returns (depth [F], uright_refined
    [F]).  `torch.round` rounds half to even, as `jnp.round` does.
    """
    H, W = gray_left.shape
    side = 2 * win + 1
    n_off = 2 * search + 1
    strip_w = side + 2 * search
    dev = gray_left.device
    ixL = torch.round(xL).to(torch.int64)
    y0 = torch.clamp(torch.round(yL).to(torch.int64) - win, 0, H - side)
    xl0 = torch.clamp(ixL - win, 0, W - side)
    xr0 = torch.clamp(torch.round(uright).to(torch.int64) - win - search, 0, W - strip_w)

    # one flat index tensor per image: [F, 11, 11] left patches and
    # [F, 11, 21] right strips
    rows = (y0[:, None] + torch.arange(side, device=dev))[:, :, None] * W
    lp = gray_left.reshape(-1)[rows + (xl0[:, None, None] + torch.arange(side, device=dev))]
    rp = gray_right.reshape(-1)[rows + (xr0[:, None, None] + torch.arange(strip_w, device=dev))]
    # [F, 11 offsets, 11, 11] windows of the strip; SAD per offset
    win_idx = torch.arange(n_off, device=dev)[:, None] + torch.arange(side, device=dev)[None, :]
    rwin = rp[:, :, win_idx].permute(0, 2, 1, 3)             # [F, n_off, side, side]
    sads = torch.sum(torch.abs(lp[:, None] - rwin), dim=(2, 3))   # [F, n_off]
    best = hamming.first_argmin(sads, dim=-1)
    b_ok = (best > 0) & (best < 2 * search)
    c0 = torch.gather(sads, 1, torch.clamp(best - 1, min=0)[:, None])[:, 0]
    c1 = torch.gather(sads, 1, best[:, None])[:, 0]
    c2 = torch.gather(sads, 1, torch.clamp(best + 1, max=2 * search)[:, None])[:, 0]
    denom = torch.clamp(c0 + c2 - 2.0 * c1, min=1e-6)
    delta = torch.clamp(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    delta = torch.where(b_ok, delta, torch.zeros_like(delta))
    # refined right x: strip origin + best offset + subpixel + window centre.
    # The disparity is taken against the INTEGER left patch centre (the patch
    # was cut there); the float xL would bias it by frac(xL).
    xr_ref = xr0.to(torch.float32) + best.to(torch.float32) + delta + win
    disp = (xl0 + win).to(torch.float32) - xr_ref
    valid = (uright >= 0) & (disp > 0.1)
    bf = torch.as_tensor(bf, dtype=torch.float32, device=dev)
    depth = torch.where(valid, bf / torch.clamp(disp, min=0.1), torch.zeros_like(disp))
    # uright consistent with the float keypoint coordinate
    return depth, torch.where(valid, xL - disp, torch.full_like(disp, -1.0))
