"""Plain numpy reference of the poses a run returns: the ground truth the
scene was rendered from.

- `relative_errors`: for each pair of frames that a run tracked (both OK,
  one system), the rig's motion between them as the program returned it,
  T_j inv(T_i), against the same motion in the ground truth: the
  translation gap (m) and the rotation gap (rad), 2 arcsin(|dR - I|_F /
  2 sqrt 2) of dR = R_est R_gt^T: the angle where dR is a rotation, and
  larger by any departure of the returned rotations from a rotation (the
  arccos of the trace, clipped at 1, reads such a departure as no gap).  A
  motion between two frames does not depend on where the system put its
  world, so no alignment is needed.
- `ate_rmse`: the RMS distance of the camera centres from the ground
  truth's after the best rigid alignment (Horn / Umeyama, no scale).
"""

from __future__ import annotations

import numpy as np


def _inv(T: np.ndarray) -> np.ndarray:
    R, t = T[..., :3, :3], T[..., :3, 3]
    out = np.zeros_like(T)
    Rt = np.swapaxes(R, -1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ t[..., None])[..., 0]
    out[..., 3, 3] = 1.0
    return out


def relative_errors(est: np.ndarray, gt: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """est, gt [n, 2, 4, 4]: (earlier, later) world -> rig poses of n
    pairs.  Returns (translation gap m [n], rotation gap rad [n])."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    d_est = est[:, 1] @ _inv(est[:, 0])
    d_gt = gt[:, 1] @ _inv(gt[:, 0])
    dt = np.linalg.norm(d_est[:, :3, 3] - d_gt[:, :3, 3], axis=1)
    dR = d_est[:, :3, :3] @ np.swapaxes(d_gt[:, :3, :3], 1, 2)
    fro = np.linalg.norm(dR - np.eye(3), axis=(1, 2))
    return dt, 2.0 * np.arcsin(np.minimum(fro / (2.0 * np.sqrt(2.0)), 1.0))


def centres(Tcw: np.ndarray) -> np.ndarray:
    return _inv(np.asarray(Tcw, np.float64))[..., :3, 3]


def ate_rmse(est_Tcw: np.ndarray, gt_Tcw: np.ndarray) -> float:
    """Over the poses whose every entry is finite; NaN where none is."""
    a, b = centres(est_Tcw), centres(gt_Tcw)
    fin = np.isfinite(a).all(axis=1)
    if not fin.any():
        return float("nan")
    a, b = a[fin], b[fin]
    ma, mb = a.mean(0), b.mean(0)
    U, _, Vt = np.linalg.svd((b - mb).T @ (a - ma))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    aligned = (a - ma) @ R.T + mb
    return float(np.sqrt(np.mean(np.sum((aligned - b) ** 2, axis=1))))
