"""Closed-form point-set alignment (Umeyama) and trajectory ATE.

Counterpart of `multi_orb_slam_tpu/geometry/align.py`.  `umeyama` takes the
rotation from an SVD, as the reference does.  `umeyama_quat` solves the same
problem with no SVD, for the RANSAC solvers that run inside CUDA graphs:
`torch.linalg.svd` reads its convergence flags back to the host, which a
graph's capture refuses.  Its eigen-solver, `jacobi_eigh` (cyclic Jacobi at
a fixed sweep count, any n), also gives the two-view initializer its null
vectors and 3x3 SVDs.
"""

from __future__ import annotations

import functools
import itertools

import torch

from ..utils import graphs
from . import se3

JACOBI_SWEEPS = 5


def _rounds(n: int, parallel: bool) -> tuple:
    """One Jacobi sweep over a symmetric n x n matrix as rounds of (p, q)
    pairs, the pairs of a round disjoint (so their rotations commute and
    one product applies them): one pair a round, row by row (cyclic), or
    the round-robin tournament's n - 1 rounds of n / 2 pairs (parallel)."""
    if not parallel:
        return tuple(((p, q),) for p, q in itertools.combinations(range(n), 2))
    m = n + n % 2               # a bye for odd n
    rounds = []
    for r in range(m - 1):
        pairs = [(r, m - 1)] + [((r + k) % (m - 1), (r - k) % (m - 1))
                                for k in range(1, m // 2)]
        rounds.append(tuple(sorted((min(p, q), max(p, q)) for p, q in pairs if max(p, q) < n)))
    return tuple(rounds)


@functools.lru_cache(maxsize=None)
def _rotation_basis(n: int, parallel: bool, dtype: torch.dtype, device: torch.device):
    """Per round: its pairs' indices p and q [r] and (E_pp + E_qq, E_pq -
    E_qp) [r, n, n] of each, filled in on the device once (constants, never
    a copy from the host)."""
    out = []
    for pairs in _rounds(n, parallel):
        diag, skew = [], []
        for p, q in pairs:
            d = [[0.0] * n for _ in range(n)]
            o = [[0.0] * n for _ in range(n)]
            d[p][p] = d[q][q] = 1.0
            o[p][q], o[q][p] = 1.0, -1.0
            diag += [v for row in d for v in row]
            skew += [v for row in o for v in row]
        r = len(pairs)
        out.append((graphs.filled([p for p, _ in pairs], torch.int64, device),
                    graphs.filled([q for _, q in pairs], torch.int64, device),
                    graphs.filled(diag, dtype, device).reshape(r, n, n),
                    graphs.filled(skew, dtype, device).reshape(r, n, n)))
    return out


def jacobi_eigh(N: torch.Tensor, sweeps: int,
                parallel: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Eigen-decomposition of symmetric (..., n, n) matrices by `sweeps`
    Jacobi sweeps (each rotation zeroes one off-diagonal pair; quadratic
    convergence), in the cyclic order or in rounds of disjoint pairs
    (`parallel`: n / 2 rotations a step, for n > 4): (eigenvalues (..., n),
    in no order, and the eigenvectors as the columns of (..., n, n), a
    proper rotation).  A fixed trip count and no `torch.linalg` call, so
    nothing is read back to the host."""
    n = N.shape[-1]
    A = N
    eye = torch.eye(n, dtype=N.dtype, device=N.device)
    V = eye.expand(N.shape)
    for _ in range(sweeps):
        for P, Q, D, O in _rotation_basis(n, parallel, N.dtype, N.device):
            app, aqq, apq = A[..., P, P], A[..., Q, Q], A[..., P, Q]
            nz = apq != 0
            tau = (aqq - app) / (2.0 * torch.where(nz, apq, 1.0))
            t = torch.where(tau >= 0, 1.0, -1.0) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(nz, t, 0.0)
            c = torch.rsqrt(1.0 + t * t)
            s = t * c
            J = (eye + ((c - 1.0)[..., None, None] * D).sum(-3)
                 + (s[..., None, None] * O).sum(-3))
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    return torch.diagonal(A, dim1=-2, dim2=-1), V


def column(V: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Column k (...,) of (..., n, n) matrices: (..., n)."""
    return torch.gather(V, -1, k[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def top_eigenvector_4(N: torch.Tensor, sweeps: int = JACOBI_SWEEPS) -> torch.Tensor:
    """Unit eigenvector (..., 4) of the largest eigenvalue of symmetric
    (..., 4, 4) matrices (`jacobi_eigh`): the column of the largest
    eigenvalue, the lowest among equals."""
    w, V = jacobi_eigh(N, sweeps)
    return column(V, (-w).argmin(dim=-1))


def umeyama_quat(src: torch.Tensor, dst: torch.Tensor,
                 weights: torch.Tensor | None = None, with_scale: bool = True):
    """`umeyama`'s (s, R, t) with the rotation from Horn's unit-quaternion
    form of the same least-squares problem: R maximises trace(R^T cov) over
    proper rotations, so it is Umeyama's reflection-corrected rotation, here
    the eigenvector of the largest eigenvalue of a symmetric 4x4 matrix
    (`top_eigenvector_4`).  The scale is trace(R^T cov) / var(src), which is
    Umeyama's sum(D * S) / var(src)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype, device=src.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-9)
    mu_src = torch.sum(src * w, dim=-2) / wsum
    mu_dst = torch.sum(dst * w, dim=-2) / wsum
    src_c = src - mu_src[..., None, :]
    dst_c = dst - mu_dst[..., None, :]
    cov = torch.einsum("...n,...ni,...nj->...ij", weights, dst_c, src_c) / wsum[..., None]
    S = cov.transpose(-1, -2)            # S[a, b] = sum w src_a dst_b (Horn's M)
    sxx, sxy, sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    syx, syy, syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    szx, szy, szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], -1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], -1),
        torch.stack([szx - sxz, sxy + syx, syy - sxx - szz, syz + szy], -1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, szz - sxx - syy], -1)], -2)
    q = top_eigenvector_4(N)             # (w, x, y, z)
    R = se3.from_quaternion(torch.cat([q[..., 1:], q[..., :1]], dim=-1))
    if with_scale:
        var_src = torch.sum(weights * torch.sum(src_c * src_c, dim=-1), dim=-1) / wsum[..., 0]
        s = torch.sum(R * cov, dim=(-2, -1)) / torch.clamp(var_src, min=1e-12)
    else:
        s = torch.ones(src.shape[:-2], dtype=src.dtype, device=src.device)
    t = mu_dst - s[..., None] * (R @ mu_src[..., None])[..., 0]
    return s, R, t


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
