"""The benchmark's scenes: a box room of textured squares, camera paths through
it, and the views of every rig camera, rendered on the device from the seed.

A frozen rewrite of the port's synthetic scene generator (`io/synthetic.py`:
`make_box_world`, `orbit_trajectory`, `render_rgbd`, `degrade_sequence`),
kept here so that the yardstick does not move when the
program does.  The world and the paths are the same numpy draws; the
painter's algorithm of `render_rgbd` is recast as a z-buffer in torch, so
that a thousand 640x480 views take seconds on the card instead of most of a
minute of numpy in eight processes: every square is drawn as a
(2h+1)-pixel block of 2 x 2 quadrant greys at the supersampled resolution,
the nearest square wins each pixel, the depth of a pixel is the ray's
intersection with the winning square's wall plane, and the 2 x 2
supersampled grey is box-filtered down (depth: the top-left sample).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class World(NamedTuple):
    points: np.ndarray      # [N, 3] float32 world positions
    intensity: np.ndarray   # [N, 2, 2] float32 quadrant greys in [30, 235]
    size: np.ndarray        # [N] float32 half-size of a square (m)
    plane_axis: np.ndarray  # [N] int32 axis of the wall's normal
    plane_val: np.ndarray   # [N] float32 the wall plane's coordinate on that axis
    box: tuple              # (bx, by, bz) room extents (m)


def make_box_world(seed: int, n_points: int, box) -> World:
    """Textured squares on the six inside walls of a box centred at the origin."""
    rng = np.random.RandomState(seed)
    bx, by, bz = box
    n_per_wall = n_points // 6
    pts, axes, vals = [], [], []
    for axis, sign in [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]:
        p = rng.uniform(-0.5, 0.5, size=(n_per_wall, 3))
        p[:, 0] *= bx
        p[:, 1] *= by
        p[:, 2] *= bz
        p[:, axis] = sign * (box[axis] / 2.0)
        pts.append(p)
        axes.append(np.full(n_per_wall, axis, np.int32))
        vals.append(np.full(n_per_wall, sign * (box[axis] / 2.0), np.float32))
    points = np.concatenate(pts, axis=0).astype(np.float32)
    n = points.shape[0]
    intensity = rng.uniform(30.0, 235.0, size=(n, 2, 2)).astype(np.float32)
    size = rng.uniform(0.02, 0.06, size=n).astype(np.float32)
    return World(points, intensity, size, np.concatenate(axes), np.concatenate(vals),
                 tuple(float(b) for b in box))


def orbit_trajectory(n_frames: int, radius: float = 1.2, height_amp: float = 0.15,
                     yaw_range: float = 0.8) -> np.ndarray:
    """A slow arc with a small yaw, looking at the +z wall: [n, 4, 4] Tcw."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        ang = (s - 0.5) * yaw_range
        center = np.array([radius * np.sin(ang), height_amp * np.sin(2 * np.pi * s),
                           -radius * 0.3 * np.cos(ang)], np.float32)
        cy_, sy_ = np.cos(ang * 0.7), np.sin(ang * 0.7)
        Rwc = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], np.float32)
        Rcw = Rwc.T
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ center
        poses[i] = T
    return poses


class DeviceWorld(NamedTuple):
    points: torch.Tensor
    intensity: torch.Tensor   # [N, 4]: quadrant (qy, qx) at 2 * qy + qx
    size: torch.Tensor
    plane_axis: torch.Tensor
    plane_val: torch.Tensor


def to_device(world: World, device) -> DeviceWorld:
    return DeviceWorld(torch.as_tensor(world.points, device=device),
                       torch.as_tensor(world.intensity.reshape(-1, 4), device=device),
                       torch.as_tensor(world.size, device=device),
                       torch.as_tensor(world.plane_axis, device=device).long(),
                       torch.as_tensor(world.plane_val, device=device))


def render_view(w: DeviceWorld, K, Tcw: np.ndarray, height: int, width: int,
                background: float = 100.0, max_half_px: int = 12, supersample: int = 2):
    """(grey [H, W], depth [H, W]) float32 on the world's device, from the
    world -> camera pose `Tcw`; depth 0 where no square is seen."""
    dev = w.points.device
    s = supersample
    fx, fy = float(K[0]) * s, float(K[1]) * s
    cx, cy = s * float(K[2]) + (s - 1) / 2.0, s * float(K[3]) + (s - 1) / 2.0
    Hs, Ws, mh = height * s, width * s, max_half_px * s
    T = torch.as_tensor(np.asarray(Tcw, np.float32), device=dev)
    R, t = T[:3, :3], T[:3, 3]
    xc = w.points @ R.T + t
    z = xc[:, 2]
    vis = z > 0.2
    zs = torch.where(vis, z, torch.ones_like(z))
    u = fx * xc[:, 0] / zs + cx
    v = fy * xc[:, 1] / zs + cy
    half = torch.clamp(fx * w.size / zs, 1.0, float(mh))
    vis &= (u > -mh) & (u < Ws + mh) & (v > -mh) & (v < Hs + mh)
    sq = torch.nonzero(vis)[:, 0]
    h = half[sq].floor().long()
    xq = torch.round(u[sq]).long()
    yq = torch.round(v[sq]).long()
    zq = z[sq]
    d = torch.arange(2 * mh + 1, device=dev)
    shape = (len(sq), len(d), len(d))
    X = ((xq - h)[:, None, None] + d[None, None, :]).expand(shape)
    Y = ((yq - h)[:, None, None] + d[None, :, None]).expand(shape)
    inside = ((d[None, None, :] <= 2 * h[:, None, None]) & (d[None, :, None] <= 2 * h[:, None, None])
              & (X >= 0) & (X < Ws) & (Y >= 0) & (Y < Hs))
    pix = (Y * Ws + X)[inside]
    zpix = zq[:, None, None].expand(shape)[inside]
    spix = torch.arange(len(sq), device=dev)[:, None, None].expand(shape)[inside]
    zbuf = torch.full((Hs * Ws,), float("inf"), device=dev)
    zbuf.scatter_reduce_(0, pix, zpix, "amin")
    near = zpix == zbuf[pix]
    win = torch.full((Hs * Ws,), -1, dtype=torch.long, device=dev)
    win.scatter_reduce_(0, pix[near], spix[near], "amax")
    drawn = torch.nonzero(win >= 0)[:, 0]
    k = win[drawn]
    x, y = drawn % Ws, drawn // Ws
    qx = (x >= xq[k]).long()
    qy = (y >= yq[k]).long()
    gid = sq[k]
    grey = torch.full((Hs * Ws,), background, device=dev)
    grey[drawn] = w.intensity[gid, 2 * qy + qx]
    # depth along each pixel's ray to the wall plane of its square
    Rwc = R.T
    o = -Rwc @ t
    a = w.plane_axis[gid]
    xs = (x.float() - cx) / fx
    ys = (y.float() - cy) / fy
    den = Rwc[a, 0] * xs + Rwc[a, 1] * ys + Rwc[a, 2]
    num = w.plane_val[gid] - o[a]
    den = torch.where(den.abs() > 1e-6, den, torch.sign(den) * 1e-6 + 1e-12)
    tt = num / den
    depth = torch.zeros((Hs * Ws,), device=dev)
    depth[drawn] = torch.where(tt > 0, tt, zq[k])
    grey = grey.reshape(height, s, width, s).mean(dim=(1, 3))
    depth = depth.reshape(height, s, width, s)[:, 0, :, 0].contiguous()
    return grey, depth


def render_rig(world: World, K, T_rc: np.ndarray, poses: np.ndarray, height: int, width: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """Every rig camera's view from every rig pose: greys and depths
    [n, C, H, W] float32 on `device`."""
    w = to_device(world, device)
    n, C = len(poses), len(T_rc)
    greys = torch.empty((n, C, height, width), device=device)
    depths = torch.empty((n, C, height, width), device=device)
    for i, T in enumerate(poses):
        for c in range(C):
            greys[i, c], depths[i, c] = render_view(w, K, T_rc[c] @ T, height, width)
    return greys, depths


class SensorModel(NamedTuple):
    """Kinect-style degradation (Khoshelham & Elberink 2012 depth noise,
    dropouts, exposure drift, shot noise, motion blur)."""

    depth_sigma_quad: float = 1.425e-3
    depth_dropout: float = 0.02
    exposure_amp: float = 0.15
    exposure_period: float = 90.0
    shot_noise_std: float = 2.0
    blur_px_per_degps: float = 0.03


def _motion_blur(grey: np.ndarray, blur_px: float) -> np.ndarray:
    n = int(round(blur_px))
    if n < 1:
        return grey
    n = min(n, 7)
    acc = np.copy(grey)
    for k in range(1, n + 1):
        acc[:, k:] += grey[:, :-k]
        acc[:, :k] += grey[:, :1]
    return acc / (n + 1.0)


def degrade(greys: np.ndarray, depths: np.ndarray, poses: np.ndarray, model: SensorModel,
            seed: int) -> tuple[np.ndarray, np.ndarray]:
    """The sensor model applied frame by frame to [n, C, H, W] renders, from
    one numpy stream seeded with `seed`."""
    rng = np.random.RandomState(seed)
    g_out, d_out = np.empty_like(greys), np.empty_like(depths)
    for i in range(len(greys)):
        if i > 0:
            dR = poses[i][:3, :3] @ poses[i - 1][:3, :3].T
            ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
            yaw_rate = ang * 30.0
        else:
            yaw_rate = 0.0
        blur_px = model.blur_px_per_degps * yaw_rate
        exposure = 1.0 + 0.5 * model.exposure_amp * np.sin(2.0 * np.pi * i / model.exposure_period)
        for c in range(greys.shape[1]):
            gc = _motion_blur(greys[i, c].astype(np.float32), blur_px) * exposure
            gc = gc + rng.normal(0.0, model.shot_noise_std, gc.shape)
            g_out[i, c] = np.clip(gc, 0.0, 255.0)
            dc = depths[i, c]
            valid = dc > 0
            noise = rng.normal(0.0, 1.0, dc.shape).astype(np.float32)
            dc = np.where(valid, dc + noise * model.depth_sigma_quad * dc * dc, 0.0)
            drop = rng.uniform(size=dc.shape) < model.depth_dropout
            d_out[i, c] = np.where(drop, 0.0, dc)
    return g_out, d_out


def sub_seeds(seed: int, n: int) -> list[int]:
    """`n` 32-bit seeds drawn from any whole number `seed`."""
    return [int(v) for v in np.random.SeedSequence(int(seed)).generate_state(n)]
