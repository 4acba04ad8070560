"""TUM RGB-D dataset tools: association, loading, trajectory export.

Counterpart of `multi_orb_slam_tpu/io/tum.py`.  Poses are numpy arrays on the
host here; the quaternion conversions go through `geometry/se3.py` on CPU
tensors.  Python-3 re-implementations of the reference tooling:
- `associate` pairs rgb and depth lists by closest timestamp
  (Examples/RGB-D/associate.py, run once per camera per README §3)
- trajectory writers byte-compatible with the reference's savers
  (SaveTrajectoryTUM src/System.cc:353-411 — world-to-camera INVERTED to
  camera-to-world, quaternion x y z w; SaveTrajectoryKITTI
  src/System.cc:450-503 — 3x4 row-major Twc)
"""

from __future__ import annotations

import os

import numpy as np

import torch

from ..geometry import se3
from . import png


def read_file_list(path: str) -> dict:
    """TUM-format file list: `timestamp filename` per line, '#' comments."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            out[float(parts[0])] = parts[1:]
    return out


def associate(a: dict, b: dict, offset: float = 0.0,
              max_difference: float = 0.02) -> list:
    """Greedy closest-timestamp matching (Examples/RGB-D/associate.py:86-107).

    Returns sorted list of (t_a, t_b).
    """
    a_keys = set(a.keys())
    b_keys = set(b.keys())
    potential = [
        (abs(ta - (tb + offset)), ta, tb)
        for ta in a_keys
        for tb in b_keys
        if abs(ta - (tb + offset)) < max_difference
    ]
    potential.sort()
    matches = []
    for diff, ta, tb in potential:
        if ta in a_keys and tb in b_keys:
            a_keys.remove(ta)
            b_keys.remove(tb)
            matches.append((ta, tb))
    matches.sort()
    return matches


def load_tum_sequence(seq_dir: str, assoc=None, depth_factor: float = 5000.0):
    """Yield (timestamp, gray [H,W] f32, depth [H,W] f32 meters) frames.

    `assoc`: list of (t_rgb, t_depth); built from rgb.txt/depth.txt if None.
    Images are decoded with `io/png.py` (what `cv2.imread` gives with
    IMREAD_GRAYSCALE / IMREAD_UNCHANGED).  A frame whose image is missing or
    damaged is skipped, as the reference skips what cv2 cannot read; an
    image that cv2 reads and `io/png.py` does not (a JPEG, an interlaced
    PNG) raises `png.UnsupportedImage`.
    """
    rgb_list = read_file_list(os.path.join(seq_dir, "rgb.txt"))
    depth_list = read_file_list(os.path.join(seq_dir, "depth.txt"))
    if assoc is None:
        assoc = associate(rgb_list, depth_list)
    for t_rgb, t_depth in assoc:
        rgb_path = os.path.join(seq_dir, rgb_list[t_rgb][0])
        d_path = os.path.join(seq_dir, depth_list[t_depth][0])
        try:
            im = png.read_gray(rgb_path)
            dp = png.read_png(d_path)
        except (OSError, png.PNGError):
            continue
        depth = dp.astype(np.float32) / depth_factor
        yield t_rgb, im.astype(np.float32), depth


def pose_to_tum_line(t: float, Tcw: np.ndarray) -> str:
    """One TUM trajectory line: `t tx ty tz qx qy qz qw` of Twc."""
    Twc = np.linalg.inv(Tcw)
    q = se3.to_quaternion(
        torch.from_numpy(np.ascontiguousarray(Twc[:3, :3], dtype=np.float32))).numpy()
    tw = Twc[:3, 3]
    return (f"{t:.6f} {tw[0]:.7f} {tw[1]:.7f} {tw[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}")


def write_trajectory_tum(path: str, stamped_poses) -> None:
    """stamped_poses: iterable of (timestamp, Tcw 4x4 ndarray)."""
    with open(path, "w") as f:
        for t, Tcw in stamped_poses:
            f.write(pose_to_tum_line(t, np.asarray(Tcw)) + "\n")


def write_trajectory_kitti(path: str, poses) -> None:
    """poses: iterable of Tcw; writes 3x4 row-major Twc per line
    (reference src/System.cc:450-503)."""
    with open(path, "w") as f:
        for Tcw in poses:
            Twc = np.linalg.inv(np.asarray(Tcw))
            row = Twc[:3].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def read_trajectory_tum(path: str) -> dict:
    """timestamp -> Twc [4,4] from a TUM trajectory/groundtruth file."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            if len(v) < 8:
                continue
            t, tx, ty, tz, qx, qy, qz, qw = v[:8]
            R = se3.from_quaternion(
                torch.tensor([qx, qy, qz, qw], dtype=torch.float32)).numpy()
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = [tx, ty, tz]
            out[t] = T
    return out
