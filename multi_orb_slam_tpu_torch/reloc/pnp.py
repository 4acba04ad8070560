"""Batched P3P/PnP RANSAC for relocalization.

Counterpart of `multi_orb_slam_tpu/reloc/pnp.py` (which replaces `PnPsolver`,
src/PnPsolver.cc): given 2D-3D correspondences with no pose prior, estimate
the camera pose.  A batch of minimal hypotheses is generated at once, each
from 3 correspondences: the depth ratios of Grunert's P3P by a 2-D Newton
iteration from 4 starts (12 steps, the 2x2 Jacobian written out), a rigid
alignment of the 3 back-projected points per depth solution, then every
hypothesis is scored by reprojection in parallel and the best is polished
by two rounds of motion-only BA.

The function is split where the random numbers enter: `sample_triplets`
draws the minimal sets from an explicit `torch.Generator`, `pnp_solve` takes
them.  The reference draws its triplets from a JAX key; the two generators
give other numbers from the same seed, so a comparison hands both solvers
the same triplets.

`pnp_solve` is `graphs.graphed` (`inlier_px` static): one CUDA graph replay
a call on the card, where the reference jits `pnp_ransac`.  The draw stays
outside the graph, on the caller's generator.  The rigid alignment of each
hypothesis is `align.umeyama_quat`, which needs no SVD: `torch.linalg.svd`
reads its convergence flags back to the host, which a capture refuses.
"""

from __future__ import annotations

import functools

import torch

from ..geometry import align, se3
from ..ops import hamming
from ..optim import pose_opt
from ..utils import graphs

_NEWTON_STARTS = ((1.0, 1.0), (0.5, 1.5), (1.5, 0.5), (2.0, 2.0))
_NEWTON_STEPS = 12


@functools.lru_cache(maxsize=None)
def _newton_starts(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[4, 2] Newton starts (x, y), filled in on the device once."""
    return graphs.filled([v for xy in _NEWTON_STARTS for v in xy], dtype, device).reshape(4, 2)


def _p3p_depths(rays: torch.Tensor, Xw: torch.Tensor):
    """Grunert's P3P for H minimal sets: rays [H, 3, 3] unit bearing vectors,
    Xw [H, 3, 3] world points.

    Returns up to 4 candidate depth triples [H, 4, 3] + validity [H, 4].
    With x = d1/d3, y = d2/d3 the law of cosines gives two polynomial
    equations in (x, y); they are solved by 2-D Newton from 4 starts.
    """
    a = torch.linalg.norm(Xw[:, 1] - Xw[:, 2], dim=-1)
    b = torch.linalg.norm(Xw[:, 0] - Xw[:, 2], dim=-1)
    c = torch.linalg.norm(Xw[:, 0] - Xw[:, 1], dim=-1)
    a2, b2, c2 = a * a, b * b, c * c
    p = 2.0 * torch.sum(rays[:, 1] * rays[:, 2], dim=-1)
    q = 2.0 * torch.sum(rays[:, 0] * rays[:, 2], dim=-1)
    r = 2.0 * torch.sum(rays[:, 0] * rays[:, 1], dim=-1)
    a2, b2, c2, p, q, r = (v[:, None] for v in (a2, b2, c2, p, q, r))   # [H, 1]

    def F(x, y):
        f1 = a2 * (x * x + 1.0 - x * q) - b2 * (y * y + 1.0 - y * p)
        f2 = c2 * (x * x + 1.0 - x * q) - b2 * (x * x + y * y - x * y * r)
        return f1, f2

    starts = _newton_starts(rays.dtype, rays.device)
    H = rays.shape[0]
    x = starts[:, 0].expand(H, 4).clone()
    y = starts[:, 1].expand(H, 4).clone()
    for _ in range(_NEWTON_STEPS):
        f1, f2 = F(x, y)
        j00 = a2 * (2.0 * x - q)
        j01 = -b2 * (2.0 * y - p)
        j10 = c2 * (2.0 * x - q) - b2 * (2.0 * x - y * r)
        j11 = -b2 * (2.0 * y - x * r)
        det = j00 * j11 - j01 * j10
        det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
        x, y = (x - ((j11 / det) * f1 + (-j01 / det) * f2),
                y - ((-j10 / det) * f1 + (j00 / det) * f2))
    denom = x * x + 1.0 - x * q
    ok = (denom > 1e-9) & (x > 0) & (y > 0)
    d3 = torch.sqrt(b2 / torch.clamp(denom, min=1e-9))
    f1, f2 = F(x, y)
    resid = torch.sqrt(f1 * f1 + f2 * f2)
    ok = ok & (resid < 1e-3 * b2)
    return torch.stack([x * d3, y * d3, d3], dim=-1), ok      # [H, 4, 3], [H, 4]


def sample_triplets(valid: torch.Tensor, n_hyp: int,
                    generator: torch.Generator) -> torch.Tensor:
    """[n_hyp, 3] int64: three distinct indices per hypothesis, drawn
    uniformly without replacement among the valid correspondences (the
    largest three of one uniform draw per index; an invalid index draws
    below every valid one).  With fewer than 3 valid correspondences a
    triplet is filled with invalid indices, still distinct and in range.
    `generator` lives on `valid`'s device."""
    N = valid.shape[0]
    if N < 3:
        raise ValueError(f"{N} correspondences: a minimal set needs 3")
    u = torch.rand((n_hyp, N), generator=generator, device=valid.device)
    u = torch.where(valid[None, :], u, u - 2.0)
    return hamming.top_k(u, 3)[1]


@graphs.graphed(static_argnames=("inlier_px",))
def pnp_solve(
    tri: torch.Tensor,      # [H, 3] indices of the minimal sets
    uv: torch.Tensor,       # [N, 2] undistorted pixel observations (one cam)
    Xw: torch.Tensor,       # [N, 3] world points
    valid: torch.Tensor,    # [N]
    K: torch.Tensor,        # [4] fx fy cx cy
    inlier_px: float = 5.991,
):
    """The pose from given minimal sets.  Returns (Tcw [4,4], inliers [N],
    n_inliers int32 tensor).  Pose maps world->cam."""
    N = uv.shape[0]
    dev, f32 = uv.device, uv.dtype
    fx, fy, cx, cy = K[0], K[1], K[2], K[3]
    rays = torch.stack(
        [(uv[:, 0] - cx) / fx, (uv[:, 1] - cy) / fy, torch.ones(N, dtype=f32, device=dev)],
        dim=-1)
    rays = rays / torch.linalg.norm(rays, dim=-1, keepdim=True)

    r3 = rays[tri]                                   # [H, 3, 3]
    X3 = Xw[tri]
    depths, oks = _p3p_depths(r3, X3)                # [H, 4, 3], [H, 4]
    # camera-frame points for each depth solution; a solution that failed
    # (possibly non-finite) is aligned to itself instead: its pose is never
    # chosen, and the SVD sees finite numbers only
    Xc = depths[..., None] * r3[:, None, :, :]       # [H, 4, 3, 3]
    src = X3[:, None].expand_as(Xc)
    Xc = torch.where(oks[..., None, None], Xc, src)
    # absolute orientation: camera points <- world points
    _, R, t = align.umeyama_quat(src.reshape(-1, 3, 3), Xc.reshape(-1, 3, 3), with_scale=False)
    Ts = se3.from_rt(R, t)                           # [4H, 4, 4]
    oks = oks.reshape(-1)

    Xc_all = torch.einsum("hij,nj->hni", Ts[:, :3, :3], Xw) + Ts[:, None, :3, 3]
    okz = Xc_all[..., 2] > 0.01
    z = torch.clamp(Xc_all[..., 2], min=1e-6)
    u = fx * Xc_all[..., 0] / z + cx
    v = fy * Xc_all[..., 1] / z + cy
    e2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    inls = valid[None, :] & okz & (e2 < inlier_px)   # [4H, N]
    n_inl = torch.where(oks, inls.sum(dim=-1, dtype=torch.int32), -1)
    # first maximum wins, as `jnp.argmax`; rows taken with `index_select`
    # (indexing with a 0-dim tensor would read it back to the host)
    best = hamming.first_argmin(-n_inl, dim=0).reshape(1)
    T_best, inl_best, n_best = (x.index_select(0, best)[0] for x in (Ts, inls, n_inl))
    # polish on the inlier set (the reference refines via the Gauss-Newton
    # stage inside EPnP + the follow-up PoseOptimization)
    uvr = torch.cat([uv, -torch.ones((N, 1), dtype=f32, device=dev)], dim=-1)
    obs = pose_opt.PoseObs(
        pw=Xw, uvr=uvr, cam_idx=torch.zeros(N, dtype=torch.int32, device=dev),
        inv_sigma2=torch.ones(N, dtype=f32, device=dev), mask=inl_best)
    T_ref, inl_ref, n_ref = pose_opt.optimize_pose(
        T_best, obs, torch.eye(4, dtype=f32, device=dev)[None], K[None],
        torch.zeros((), dtype=f32, device=dev), n_rounds=2)
    better = n_ref >= n_best
    T_out = torch.where(better, T_ref, T_best)
    inl_out = torch.where(better, inl_ref, inl_best)
    return T_out, inl_out, torch.clamp(torch.where(better, n_ref, n_best), min=0)


def pnp_ransac(generator: torch.Generator, uv, Xw, valid, K,
               n_hyp: int = 256, inlier_px: float = 5.991):
    """`sample_triplets` (eager, on `generator`) then `pnp_solve` (one
    replay on the card): (Tcw [4,4], inliers [N], n_inliers)."""
    return pnp_solve(sample_triplets(valid, n_hyp, generator), uv, Xw, valid, K,
                     inlier_px)
