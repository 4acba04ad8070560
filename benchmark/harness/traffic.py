"""The one generator of the benchmark's traffic: a traffic file's parameters
and a seed in, the frames a cell feeds and their ground truth out.

Parameters of a traffic file (`traffic/<mix>.json`):

- `scene`: `orbit` (`orbit_trajectory`: `radius`, `height_amp`,
  `yaw_range`); `frames`; the room: `squares`, `box` [x, y, z] m;
- `degrade` (optional): the `SensorModel` fields, applied from the seed;
- `pass_order`: `forward_back` (0 .. n-1, then n-2 .. 1, so that passes
  played one after another turn smoothly);
- `feed`: `arrays` (float32 numpy arrays, as a camera driver hands them) or
  `tum_png` (one camera written as TUM PNGs with `depth_factor`, read back
  by the driver's decoder for every frame).

The seed chooses the room's squares and the sensor noise, and the checks
draw their samples from it; the path, the frame count and everything else
are the file's.
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from . import scene, tumfiles


class Scene(NamedTuple):
    world: scene.World
    poses_gt: np.ndarray        # [n, 4, 4] float64 world -> rig
    pass_order: list            # frame indices of one pass
    greys: np.ndarray | None    # [n, C, H, W] float32 (feed `arrays`)
    depths: np.ndarray | None
    stored: tuple | None        # (uint8 greys, uint16 depths) [n, H, W] (feed `tum_png`)
    tum_dir: str | None
    assoc: str | None
    depth_factor: float


def trajectory(t: dict) -> np.ndarray:
    if t["scene"] == "orbit":
        o = t["orbit"]
        return scene.orbit_trajectory(t["frames"], o["radius"], o["height_amp"], o["yaw_range"])
    raise ValueError(f"unknown scene {t['scene']!r}")


def pass_order(kind: str, n: int) -> list:
    if kind == "forward_back":
        return list(range(n)) + list(range(n - 2, 0, -1))
    raise ValueError(f"unknown pass_order {kind!r}")


def build(t: dict, rig, seed: int, device, frames: int | None = None) -> Scene:
    """Render the traffic of `t` for `rig` from `seed` on `device`.
    `frames` cuts the path short (the CPU tests)."""
    world_seed, noise_seed = scene.sub_seeds(seed, 2)
    world = scene.make_box_world(world_seed, t["squares"], tuple(t["box"]))
    poses = trajectory(t)
    n = len(poses) if frames is None else min(frames, len(poses))
    poses = poses[:n]
    greys, depths = scene.render_rig(world, rig.K, rig.T_rc, poses, rig.height, rig.width, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    greys, depths = greys.cpu().numpy(), depths.cpu().numpy()
    if t.get("degrade") is not None:
        greys, depths = scene.degrade(greys, depths, poses, scene.SensorModel(**t["degrade"]),
                                      noise_seed)
    order = pass_order(t["pass_order"], n)
    poses64 = np.asarray(poses, np.float64)
    if t["feed"] == "arrays":
        return Scene(world, poses64, order, greys, depths, None, None, None, 1.0)
    if t["feed"] == "tum_png":
        if rig.n_cams != 1:
            raise ValueError("the TUM PNG feed writes one camera")
        factor = float(t.get("depth_factor", rig.depth_factor))
        root = tempfile.mkdtemp(prefix="bench_tum_")
        assoc = tumfiles.write_sequence(root, greys[:, 0], depths[:, 0], factor, order)
        stored = [tumfiles.quantise(greys[i, 0], depths[i, 0], factor) for i in range(n)]
        stored = (np.stack([g for g, _ in stored]), np.stack([d for _, d in stored]))
        return Scene(world, poses64, order, None, None, stored, root, assoc, factor)
    raise ValueError(f"unknown feed {t['feed']!r}")


def remove(sc: Scene) -> None:
    """Delete the files a `tum_png` scene wrote."""
    if sc.tum_dir and os.path.isdir(sc.tum_dir):
        import shutil

        shutil.rmtree(sc.tum_dir, ignore_errors=True)
