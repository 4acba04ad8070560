"""Closed-form point-set alignment (Umeyama) and trajectory ATE.

Counterpart of `multi_orb_slam_tpu/geometry/align.py`.
"""

from __future__ import annotations

import torch


def umeyama(src: torch.Tensor, dst: torch.Tensor,
            weights: torch.Tensor | None = None, with_scale: bool = True):
    """(s, R, t) minimizing sum_i w_i || dst_i - (s R src_i + t) ||^2.

    src, dst: (..., N, 3); weights: optional (..., N).
    """
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    mu_src = torch.sum(src * w, dim=-2) / wsum
    mu_dst = torch.sum(dst * w, dim=-2) / wsum
    src_c = src - mu_src[..., None, :]
    dst_c = dst - mu_dst[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", weights, dst_c, src_c) / wsum[..., None]
    U, D, Vt = torch.linalg.svd(cov)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.ones(src.shape[:-2] + (3,), dtype=src.dtype, device=src.device)
    S[..., 2] = torch.where(det < 0, -1.0, 1.0)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        var_src = torch.sum(weights * torch.sum(src_c * src_c, dim=-1), dim=-1) / wsum[..., 0]
        s = torch.sum(D * S, dim=-1) / torch.clamp(var_src, min=1e-12)
    else:
        s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_dst - s[..., None] * (R @ mu_src[..., None])[..., 0]
    return s, R, t


def ate_rmse(est_xyz: torch.Tensor, gt_xyz: torch.Tensor) -> torch.Tensor:
    """Absolute trajectory error RMSE after rigid (no-scale) alignment."""
    _, R, t = umeyama(est_xyz, gt_xyz, with_scale=False)
    aligned = est_xyz @ R.transpose(-1, -2) + t[..., None, :]
    err = aligned - gt_xyz
    return torch.sqrt(torch.mean(torch.sum(err * err, dim=-1), dim=-1))
