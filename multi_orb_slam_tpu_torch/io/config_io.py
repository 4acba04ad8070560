"""Settings and calibration loading.

Reads the reference's two config files byte-compatibly:
- OpenCV FileStorage YAML settings (OtherFiles/multi.yaml: camera intrinsics,
  distortion, bf, fps, RGB order, ThDepth, DepthMapFactor, ORB extractor
  parameters, viewer parameters) as parsed by the reference at
  src/Tracking.cc:67-175.
- the whitespace 4x3 `calibration.txt`: rows 1-3 = Rcam12, row 4 = tcam12
  (cam2 -> cam1 rig extrinsic), parsed at src/System.cc:63-72.

Counterpart of `multi_orb_slam_tpu/io/config_io.py`: the parsing is numpy on
the host; `camera_params_from` puts the rig on the CUDA device unless the
caller names another.

Extends the reference by allowing per-camera intrinsics (`Camera2.fx` etc.);
the reference forces both cameras to share one K (src/Frame.cc:156).
"""

from __future__ import annotations

import re
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry import camera as cam_mod
from ..ops import orb


class Settings(NamedTuple):
    K: np.ndarray           # [C, 4]
    dist: np.ndarray        # [C, 5]
    bf: float
    fps: float
    rgb_order: int
    th_depth: float         # raw ThDepth (scaled by bf/fx like the reference)
    depth_map_factor: float
    n_features: int
    n_features_cam2: int
    scale_factor: float
    n_levels: int
    fast_th: int
    fast_th_min: int
    width: int
    height: int


def parse_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV FileStorage YAML into a flat dict (scalars only).

    PyYAML rejects the `%YAML:1.0` directive and `!!opencv-matrix` tags the
    reference files carry, so parse the `Key.Sub: value` lines directly.
    """
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].rstrip()
            m = re.match(r"^([A-Za-z0-9_.]+):\s*(.+)$", line)
            if not m:
                continue
            key, val = m.group(1), m.group(2).strip().strip('"')
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


def load_settings(path: str, n_cams: int = 2,
                  width: int = 640, height: int = 480) -> Settings:
    y = parse_opencv_yaml(path)

    def cam(prefix, key, default=0.0):
        return float(y.get(f"{prefix}.{key}", y.get(f"Camera.{key}", default)))

    Ks, dists = [], []
    for c in range(n_cams):
        prefix = "Camera" if c == 0 else f"Camera{c + 1}"
        Ks.append([cam(prefix, "fx"), cam(prefix, "fy"),
                   cam(prefix, "cx"), cam(prefix, "cy")])
        dists.append([cam(prefix, "k1"), cam(prefix, "k2"),
                      cam(prefix, "p1"), cam(prefix, "p2"),
                      cam(prefix, "k3")])
    nf = int(y.get("ORBextractor.nFeatures", 1000))
    return Settings(
        K=np.asarray(Ks, np.float32),
        dist=np.asarray(dists, np.float32),
        bf=float(y.get("Camera.bf", 40.0)),
        fps=float(y.get("Camera.fps", 30.0)),
        rgb_order=int(y.get("Camera.RGB", 1)),
        th_depth=float(y.get("ThDepth", 40.0)),
        depth_map_factor=float(y.get("DepthMapFactor", 1.0)),
        n_features=nf,
        # reference gives cam2 half the features (src/Tracking.cc:144-145)
        n_features_cam2=nf // 2,
        scale_factor=float(y.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(y.get("ORBextractor.nLevels", 8)),
        fast_th=int(y.get("ORBextractor.iniThFAST", 20)),
        fast_th_min=int(y.get("ORBextractor.minThFAST", 7)),
        width=int(y.get("Camera.width", width)),
        height=int(y.get("Camera.height", height)),
    )


def load_calibration(path: str) -> np.ndarray:
    """calibration.txt -> T_cam12 [4, 4] (cam2 coords -> cam1/rig coords)."""
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if vals:
                rows.append(vals)
    arr = np.asarray(rows, np.float32)
    if arr.shape != (4, 3):
        raise ValueError(f"calibration must be 4x3, got {arr.shape}")
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = arr[:3]
    T[:3, 3] = arr[3]
    return T


def camera_params_from(settings: Settings, T_cam12: np.ndarray | None,
                       n_cams: int, device=None) -> cam_mod.CameraParams:
    """Build rig CameraParams.  T_rc[c] maps rig-body -> camera-c; camera 0
    is the rig body, so T_rc[1] = inv(T_cam12).  The tensors land on
    `device` (the CUDA device when None, raising where there is none)."""
    device = resolve_device(device)
    T_rc = [np.eye(4, dtype=np.float32)]
    if n_cams > 1:
        if T_cam12 is None:
            raise ValueError("dual-camera rig needs calibration.txt")
        T_rc.append(np.linalg.inv(T_cam12).astype(np.float32))
    return cam_mod.CameraParams(
        K=torch.from_numpy(settings.K[:n_cams].copy()).to(device),
        dist=torch.from_numpy(settings.dist[:n_cams].copy()).to(device),
        T_rc=torch.from_numpy(np.stack(T_rc)).to(device),
        bf=torch.tensor(settings.bf, dtype=torch.float32, device=device),
        width=settings.width,
        height=settings.height,
    )


def orb_config_from(settings: Settings) -> orb.ORBConfig:
    return orb.ORBConfig(
        n_features=settings.n_features,
        n_levels=settings.n_levels,
        scale_factor=settings.scale_factor,
        fast_threshold=float(settings.fast_th),
        fast_threshold_min=float(settings.fast_th_min),
    )
