"""Shared reprojection residuals/Jacobians for the BA problems.

Counterpart of `multi_orb_slam_tpu/optim/residuals.py`: the rig-aware
stereo reprojection edge (error = obs - project(T_rc * Tcw * Xw)) with
analytic Jacobians, vectorized over observation batches.
"""

from __future__ import annotations

import torch


def reproj_residual(
    Tcw: torch.Tensor,      # [..., 4, 4] rig pose per observation
    Xw: torch.Tensor,       # [..., 3] world point per observation
    T_rc: torch.Tensor,     # [..., 4, 4] rig->camera extrinsic per observation
    K: torch.Tensor,        # [..., 4] per-observation intrinsics
    bf: torch.Tensor,       # [] or broadcastable
    uvr: torch.Tensor,      # [..., 3] measured (u, v, ur); ur<0 => mono
    want_jac: bool = True,
):
    """Returns (e [...,3], J_pose [...,3,6], J_point [...,3,3],
    is_stereo [...], pos_depth [...]).

    J_pose is wrt a left-multiplied se3 tangent on Tcw; J_point wrt Xw.
    Mono rows must be masked with row weights [1, 1, 0] by the caller.
    """
    R = Tcw[..., :3, :3]
    t = Tcw[..., :3, 3]
    Xr = (R @ Xw[..., None])[..., 0] + t
    Rm = T_rc[..., :3, :3]
    tm = T_rc[..., :3, 3]
    Xc = (Rm @ Xr[..., None])[..., 0] + tm
    fx, fy = K[..., 0], K[..., 1]
    cx, cy = K[..., 2], K[..., 3]

    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    if not isinstance(bf, torch.Tensor):
        bf = torch.full((), bf)
    bfo = bf.to(x.device, x.dtype).expand(torch.broadcast_shapes(bf.shape, fx.shape, x.shape))
    pos_depth = z > 1e-3
    zs = torch.where(pos_depth, z, torch.ones_like(z))
    invz = 1.0 / zs
    invz2 = invz * invz
    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bfo * invz
    pred = torch.stack([u, v, ur], dim=-1)
    is_stereo = uvr[..., 2] >= 0
    target = torch.where(is_stereo[..., None], uvr,
                         torch.cat([uvr[..., :2], ur[..., None]], dim=-1))
    e = target - pred
    if not want_jac:
        return e, None, None, is_stereo, pos_depth

    r0 = (fx * invz)[..., None] * Rm[..., 0, :] - (fx * x * invz2)[..., None] * Rm[..., 2, :]
    r1 = (fy * invz)[..., None] * Rm[..., 1, :] - (fy * y * invz2)[..., None] * Rm[..., 2, :]
    r2 = r0 + (bfo * invz2)[..., None] * Rm[..., 2, :]
    ARm = torch.stack([r0, r1, r2], dim=-2)          # [..., 3, 3]
    vx, vy, vz = Xr[..., 0, None], Xr[..., 1, None], Xr[..., 2, None]
    c0 = vz * ARm[..., :, 1] - vy * ARm[..., :, 2]
    c1 = -vz * ARm[..., :, 0] + vx * ARm[..., :, 2]
    c2 = vy * ARm[..., :, 0] - vx * ARm[..., :, 1]
    ARm_hat = torch.stack([c0, c1, c2], dim=-1)      # [..., 3, 3]
    J_pose = torch.cat([-ARm, ARm_hat], dim=-1)      # [..., 3, 6]
    J_point = -(ARm[..., :, 0, None] * R[..., None, 0, :]
                + ARm[..., :, 1, None] * R[..., None, 1, :]
                + ARm[..., :, 2, None] * R[..., None, 2, :])
    return e, J_pose, J_point, is_stereo, pos_depth


def bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matvec [..., i, j] @ [..., j] -> [..., i]."""
    return torch.sum(M * v[..., None, :], dim=-1)


def bmtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched M^T v: [..., i, j] with [..., i] -> [..., j]."""
    return torch.sum(M * v[..., :, None], dim=-2)


def outer_rows(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """sum_r A[..., r, i] B[..., r, j] -> [..., i, j], r unrolled (=3)."""
    return (A[..., 0, :, None] * B[..., 0, None, :]
            + A[..., 1, :, None] * B[..., 1, None, :]
            + A[..., 2, :, None] * B[..., 2, None, :])


def jte_rows(A: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """sum_r A[..., r, i] e[..., r] -> [..., i], r unrolled (=3)."""
    return (A[..., 0, :] * e[..., 0, None]
            + A[..., 1, :] * e[..., 1, None]
            + A[..., 2, :] * e[..., 2, None])


def row_weights(is_stereo: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., 3] row mask: mono rows drop the virtual-right residual."""
    one = torch.ones_like(is_stereo, dtype=dtype)
    return torch.stack([one, one, is_stereo.to(dtype)], dim=-1)
