"""Plain numpy reference of the map a run leaves: every square of the scene
lies on a wall of the room, so every map point, seen from a keyframe that
observes it, must lie on a wall once that keyframe is put at its
ground-truth pose.

For each observation (keyframe k, map point m): X_rig = Tcw_k X_m with the
program's keyframe pose and point, then X = inv(G_k) X_rig with the ground
truth G_k of the frame keyframe k was made from; the gap is the distance of
X to the nearest wall plane (|x_a| = box_a / 2).  It measures how well the
mapping stage's local BA, and the loop stage's corrections of keyframes and
points, agree with the scene, keyframe by keyframe, whatever the drift of
the whole map.
"""

from __future__ import annotations

import numpy as np


def wall_gaps(kf_Tcw: np.ndarray, kf_gt: np.ndarray, obs_kf: np.ndarray, obs_pos: np.ndarray,
              box) -> np.ndarray:
    """kf_Tcw [K, 4, 4] program poses, kf_gt [K, 4, 4] ground truth,
    observations: keyframe index [n] and point position [n, 3].
    Returns the gap of each observation to the nearest wall (m)."""
    T = np.asarray(kf_Tcw, np.float64)[obs_kf]
    G = np.asarray(kf_gt, np.float64)[obs_kf]
    X = np.asarray(obs_pos, np.float64)
    x_rig = (T[:, :3, :3] @ X[..., None])[..., 0] + T[:, :3, 3]
    Rt = np.swapaxes(G[:, :3, :3], 1, 2)
    x = (Rt @ (x_rig - G[:, :3, 3])[..., None])[..., 0]
    half = np.asarray(box, np.float64) / 2.0
    return np.min(np.abs(np.abs(x) - half[None, :]), axis=1)
