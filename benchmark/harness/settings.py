"""What the benchmark reads itself from a configuration's settings files:
the intrinsics, image size and depth factor of an ORB-SLAM2 settings YAML,
and the rig extrinsic of the reference fork's `calibration.txt`.  The
program reads the same files its own way; the scenes are rendered from
this reading, so a program that misread them would not track."""

from __future__ import annotations

import re

import numpy as np


def read_yaml(path) -> dict:
    """The `key: value` lines of an OpenCV settings YAML, numbers as floats."""
    out = {}
    with open(path) as f:
        for line in f:
            m = re.match(r"^([A-Za-z0-9_.]+):\s*([-+0-9.eE]+)\s*$", line.strip())
            if m:
                out[m.group(1)] = float(m.group(2))
    return out


def read_calibration(path) -> np.ndarray:
    """`calibration.txt`: three rows of R_cam12, then t_cam12, with
    x_cam1 = R_cam12 x_cam2 + t_cam12.  Returns T_cam12 [4, 4] float64."""
    rows = [[float(v) for v in line.split()] for line in open(path) if line.split()]
    arr = np.asarray(rows, np.float64)
    if arr.shape != (4, 3):
        raise ValueError(f"{path}: a calibration is 4 rows of 3 numbers, got {arr.shape}")
    T = np.eye(4)
    T[:3, :3] = arr[:3]
    T[:3, 3] = arr[3]
    return T


class Rig:
    """K [4] (fx, fy, cx, cy), the image size, the depth factor, and T_rc
    [C, 4, 4] float32 (rig body = camera 1 -> camera c)."""

    def __init__(self, cfg: dict):
        y = read_yaml(cfg["dir"] / cfg["settings"])
        self.K = np.array([y["Camera.fx"], y["Camera.fy"], y["Camera.cx"], y["Camera.cy"]],
                          np.float32)
        self.width, self.height = int(y["Camera.width"]), int(y["Camera.height"])
        self.depth_factor = y.get("DepthMapFactor", 1.0)
        T_rc = [np.eye(4)]
        if cfg.get("calibration"):
            T_rc.append(np.linalg.inv(read_calibration(cfg["dir"] / cfg["calibration"])))
        self.T_rc = np.stack(T_rc).astype(np.float32)
        self.n_cams = len(T_rc)
