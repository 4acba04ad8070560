"""Pinhole camera model with radial-tangential distortion, batched.

Counterpart of `multi_orb_slam_tpu/geometry/camera.py`.  Intrinsics are
packed as (..., 4) [fx, fy, cx, cy]; distortion as (..., 5)
[k1, k2, p1, p2, k3] (OpenCV order); every function takes per-camera
intrinsics.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraParams(NamedTuple):
    """Static rig description: per-camera intrinsics + rig extrinsics.

    `T_rc[c]` maps rig-body coordinates to camera-c coordinates (camera 0 is
    the identity).
    """

    K: torch.Tensor        # [C, 4]  fx, fy, cx, cy
    dist: torch.Tensor     # [C, 5]  k1, k2, p1, p2, k3
    T_rc: torch.Tensor     # [C, 4, 4] rig-body -> camera-c
    bf: torch.Tensor       # [] baseline*fx for virtual stereo
    width: int
    height: int


def _inv_safe_z(z: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project(K: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixel coords (..., 2). No distortion."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    invz = _inv_safe_z(xc[..., 2])
    u = fx * xc[..., 0] * invz + cx
    v = fy * xc[..., 1] * invz + cy
    return torch.stack([u, v], dim=-1)


def distort_normalized(dist: torch.Tensor, xn: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (..., 2)."""
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_pixels(
    K: torch.Tensor, dist: torch.Tensor, uv: torch.Tensor, iters: int = 8
) -> torch.Tensor:
    """Undistort pixel coords (..., 2) by fixed-point iteration
    (cv::undistortPoints' iterative solver)."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    xd0 = (uv[..., 0] - cx) / fx
    xd1 = (uv[..., 1] - cy) / fy
    k1, k2, p1, p2, k3 = (dist[..., i] for i in range(5))
    x, y = xd0, xd1
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv_radial = 1.0 / torch.clamp(radial, min=1e-6)
        x, y = (xd0 - dx) * inv_radial, (xd1 - dy) * inv_radial
    return torch.stack([fx * x + cx, fy * y + cy], dim=-1)


def distort_project(K: torch.Tensor, dist: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """Full projection: camera points -> distorted pixel coords."""
    invz = _inv_safe_z(xc[..., 2])
    xn = torch.stack([xc[..., 0] * invz, xc[..., 1] * invz], dim=-1)
    xd = distort_normalized(dist, xn)
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    return torch.stack([fx * xd[..., 0] + cx, fy * xd[..., 1] + cy], dim=-1)


def backproject(K: torch.Tensor, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels (..., 2) + depth (...) -> camera-frame points (..., 3)."""
    fx, fy, cx, cy = K[..., 0], K[..., 1], K[..., 2], K[..., 3]
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def virtual_right_u(bf: torch.Tensor, u: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """RGB-D virtual-stereo right x-coordinate `ur = u - bf/d`; -1 if no depth."""
    valid = depth > 0
    safe_d = torch.where(valid, depth, torch.ones_like(depth))
    return torch.where(valid, u - bf / safe_d, torch.full_like(u, -1.0))


def in_image(uv: torch.Tensor, width: int, height: int, border: float = 0.0) -> torch.Tensor:
    """Bounds mask for pixel coords (..., 2)."""
    u, v = uv[..., 0], uv[..., 1]
    return (u >= border) & (u < width - border) & (v >= border) & (v < height - border)


def frustum_check(
    K: torch.Tensor,
    Tcw: torch.Tensor,
    pw: torch.Tensor,
    width: int,
    height: int,
    min_dist: torch.Tensor,
    max_dist: torch.Tensor,
    normal: torch.Tensor,
    view_cos_limit: float = 0.5,
):
    """Vectorized Frame::isInFrustum.

    K [4], Tcw [4, 4], pw [N, 3], min_dist/max_dist [N], normal [N, 3].
    Returns (mask [N], uv [N, 2], inv_z [N], dist [N], view_cos [N]).
    """
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    xc = pw @ R.T + t
    z = xc[..., 2]
    pos_z = z > 0
    uv = project(K, xc)
    inside = in_image(uv, width, height)
    Ow = -R.T @ t
    po = pw - Ow
    dist = torch.linalg.norm(po, dim=-1)
    in_range = (dist >= min_dist) & (dist <= max_dist)
    view_cos = torch.sum(po * normal, dim=-1) / torch.clamp(dist, min=1e-9)
    good_view = view_cos >= view_cos_limit
    mask = pos_z & inside & in_range & good_view
    invz = 1.0 / torch.where(pos_z, z, torch.ones_like(z))
    return mask, uv, invz, dist, view_cos
