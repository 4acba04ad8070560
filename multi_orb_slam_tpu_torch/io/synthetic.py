"""Synthetic RGB-D world rendering for tests and benchmarks (host-side numpy).

A numpy-only copy of `multi_orb_slam_tpu/io/synthetic.py`.  The JAX
package's `__init__` imports jax, so its renderer cannot be imported where
jax is absent; this copy lets the PyTorch port render the same scenes on
its own.  `tests/test_torch_geometry.py` asserts that both copies render
identical arrays.

Controlled synthetic RGB-D sequences with exact ground truth: a box room
whose walls carry textured squares (squares give strong FAST corners),
rendered with a z-buffered painter's algorithm, plus a depth image.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class World(NamedTuple):
    points: np.ndarray      # [N, 3] float32 world positions
    intensity: np.ndarray   # [N, 2, 2] float32 quadrant intensities [0, 255]
    size: np.ndarray        # [N] float32 physical half-size (meters)
    plane_axis: np.ndarray  # [N] int32 wall normal axis (0/1/2)
    plane_val: np.ndarray   # [N] float32 wall plane coordinate on that axis


def make_box_world(
    seed: int = 0,
    n_points: int = 3000,
    box: tuple[float, float, float] = (6.0, 4.0, 6.0),
) -> World:
    """Textured squares on the inside walls of a box centered at origin."""
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
    # per-square 2x2 quadrant intensities: locally distinctive texture so
    # BRIEF descriptors can disambiguate repeated structure.  (3x3 cells
    # were tried for extra descriptor entropy but the smaller cells blur
    # into weak corners at fine square sizes and HALVE the match counts;
    # the renderer itself supports any QxQ grid.)
    intensity = rng.uniform(30.0, 235.0, size=(n, 2, 2)).astype(np.float32)
    size = rng.uniform(0.02, 0.06, size=n).astype(np.float32)
    return World(points, intensity, size,
                 np.concatenate(axes), np.concatenate(vals))


def render_rgbd(
    world: World,
    K: np.ndarray,          # [4] fx, fy, cx, cy
    Tcw: np.ndarray,        # [4, 4] world -> camera
    height: int = 480,
    width: int = 640,
    background: float = 100.0,
    max_half_px: int = 12,
    supersample: int = 2,
) -> tuple[np.ndarray, np.ndarray]:
    """Render (gray [H, W], depth [H, W]) of the world from a camera pose.

    Painter's algorithm far-to-near; each world point is drawn as a filled
    square whose pixel size follows perspective.  Depth is 0 where nothing
    projects (mimicking RGB-D holes).  `supersample` renders at s x
    resolution and box-filters down so edges carry subpixel information
    (needed for stereo subpixel disparity and corner localization).
    """
    if supersample > 1:
        s = supersample
        Ks = np.asarray(K, np.float64) * s
        # principal point scales as s*c + (s-1)/2 for pixel-center alignment
        Ks[2] = s * K[2] + (s - 1) / 2.0
        Ks[3] = s * K[3] + (s - 1) / 2.0
        g, d = render_rgbd(world, Ks, Tcw, height * s, width * s,
                           background, max_half_px * s, supersample=1)
        g = g.reshape(height, s, width, s).mean(axis=(1, 3))
        d = d.reshape(height, s, width, s)[:, 0, :, 0]
        return g, d
    fx, fy, cx, cy = K
    R = Tcw[:3, :3]
    t = Tcw[:3, 3]
    xc = world.points @ R.T + t
    z = xc[:, 2]
    vis = z > 0.2
    u = fx * xc[:, 0] / np.where(vis, z, 1.0) + cx
    v = fy * xc[:, 1] / np.where(vis, z, 1.0) + cy
    half = np.clip((fx * world.size / np.where(vis, z, 1.0)), 1.0, max_half_px)
    vis &= (u > -max_half_px) & (u < width + max_half_px)
    vis &= (v > -max_half_px) & (v < height + max_half_px)

    # per-pixel plane depth precomputation: for a square on wall plane
    # axis=a, value=pv, the depth along the ray of pixel (x, y) is
    # t = (pv - o[a]) / d_w[a] with d_w = Rwc @ ((x-cx)/fx, (y-cy)/fy, 1)
    # and camera-frame depth = t (the cam-frame ray has z = 1).  Without
    # this, oblique walls carry a constant depth per square — up to ~6 cm
    # of structured depth error that poisons map points at 45 deg walls.
    Rwc = R.T
    o = -Rwc @ t
    xs = (np.arange(width, dtype=np.float32) - cx) / fx
    ys = (np.arange(height, dtype=np.float32) - cy) / fy
    # d_w[a] over the pixel grid, per axis: Rwc[a,0]*xs + Rwc[a,1]*ys + Rwc[a,2]
    dwa = (Rwc[:, 0][:, None, None] * xs[None, None, :]
           + Rwc[:, 1][:, None, None] * ys[None, :, None]
           + Rwc[:, 2][:, None, None])          # [3, H, W]

    order = np.argsort(-z)  # far first
    gray = np.full((height, width), background, np.float32)
    depth = np.zeros((height, width), np.float32)
    ui = u[order]
    vi = v[order]
    zi = z[order]
    hi = half[order]
    ii = world.intensity[order]
    ax_o = world.plane_axis[order]
    pv_o = world.plane_val[order]
    msk = vis[order]
    for idx in np.nonzero(msk)[0]:
        h = int(hi[idx])
        xc_ = int(round(ui[idx]))
        yc_ = int(round(vi[idx]))
        quads = ii[idx]
        a = int(ax_o[idx])
        num = pv_o[idx] - o[a]
        # draw QxQ cell blocks (multi-tone texture -> distinctive BRIEF)
        Q = quads.shape[0]
        side = 2 * h
        for qy in range(Q):
            for qx in range(Q):
                x0 = xc_ - h + (qx * side) // Q
                x1 = xc_ - h + ((qx + 1) * side) // Q + (1 if qx == Q - 1 else 0)
                y0 = yc_ - h + (qy * side) // Q
                y1 = yc_ - h + ((qy + 1) * side) // Q + (1 if qy == Q - 1 else 0)
                x0c, x1c = max(x0, 0), min(x1, width)
                y0c, y1c = max(y0, 0), min(y1, height)
                if x0c >= x1c or y0c >= y1c:
                    continue
                gray[y0c:y1c, x0c:x1c] = quads[qy, qx]
                den = dwa[a, y0c:y1c, x0c:x1c]
                tt = num / np.where(np.abs(den) > 1e-6, den,
                                    np.sign(den) * 1e-6 + 1e-12)
                depth[y0c:y1c, x0c:x1c] = np.where(
                    tt > 0.0, tt, zi[idx]).astype(np.float32)
    return gray, depth


def orbit_trajectory(
    n_frames: int,
    radius: float = 1.2,
    height_amp: float = 0.15,
    yaw_range: float = 0.8,
    seed: int = 1,
) -> np.ndarray:
    """Smooth camera trajectory inside the box: slow arc with small yaw.

    Returns [n_frames, 4, 4] world->camera poses (Tcw).
    """
    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        ang = (s - 0.5) * yaw_range
        # camera center moves along an arc
        center = np.array(
            [radius * np.sin(ang), height_amp * np.sin(2 * np.pi * s), -radius * 0.3 * np.cos(ang)],
            np.float32,
        )
        # camera yaws with the arc, looking toward +z wall
        cy_, sy_ = np.cos(ang * 0.7), np.sin(ang * 0.7)
        Rwc = np.array(
            [[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]], np.float32
        )
        Rcw = Rwc.T
        tcw = -Rcw @ center
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = tcw
        poses[i] = T
    return poses


def out_and_back_trajectory(
    n_frames: int,
    extent: float = 1.5,
) -> np.ndarray:
    """Camera moves out along +x and returns to the start (loop closure
    test trajectory).  Returns [n_frames, 4, 4] Tcw."""
    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        x = extent * np.sin(np.pi * s)          # 0 -> extent -> 0
        center = np.array([x, 0.05 * np.sin(2 * np.pi * s), 0.0], np.float32)
        Rcw = np.eye(3, dtype=np.float32)       # always facing +z wall
        tcw = -Rcw @ center
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = tcw
        poses[i] = T
    return poses


def circuit_trajectory(
    n_frames: int,
    radius: float = 2.5,
    laps: float = 1.3,
    height_amp: float = 0.05,
) -> np.ndarray:
    """Full circular circuit facing outward: true loop topology.

    The camera walks a circle looking at the surrounding walls; every view
    direction eventually leaves the field of view (long occlusion), and on
    re-entering the starting arc the map is only reachable through place
    recognition — unlike `out_and_back_trajectory`, where the tracker
    re-associates through the covisibility graph and no loop event should
    fire.  `laps` > 1 revisits the starting arc long enough for the
    loop detector's temporal-consistency gate.  Returns [n, 4, 4] Tcw.
    """
    poses = np.zeros((n_frames, 4, 4), np.float32)
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        phi = 2.0 * np.pi * laps * s
        c, snp = np.cos(phi), np.sin(phi)
        center = np.array([radius * snp,
                           height_amp * np.sin(6.0 * np.pi * s),
                           -radius * c], np.float32)
        # camera +z looks radially outward; +x along the travel tangent
        z_cam = np.array([snp, 0.0, -c], np.float32)
        x_cam = np.array([-c, 0.0, -snp], np.float32)
        y_cam = np.cross(z_cam, x_cam)
        Rwc = np.stack([x_cam, y_cam, z_cam], axis=1).astype(np.float32)
        Rcw = Rwc.T
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rcw
        T[:3, 3] = -Rcw @ center
        poses[i] = T
    return poses


class SyntheticSequence(NamedTuple):
    grays: list          # per frame: [C, H, W] float32
    depths: list         # per frame: [C, H, W] float32
    poses_gt: np.ndarray # [T, 4, 4] rig (cam0) world->camera
    timestamps: np.ndarray


class SensorModel(NamedTuple):
    """Kinect-style sensor degradation applied to ideal renders.

    The reference's acceptance regime is real TUM RGB-D (README §3,
    OtherFiles/evaluate_ate.py); real Kinect frames carry depth noise that
    grows quadratically with range (Khoshelham & Elberink 2012:
    sigma_z ~= 1.425e-3 * z^2 m), missing-depth dropouts at oblique/edge
    pixels, rolling exposure drift, pixel shot noise, and motion blur.
    This model injects all five so synthetic acceptance numbers are earned
    on degraded input rather than exact renders (VERDICT round-3 item 4).
    """

    depth_sigma_quad: float = 1.425e-3  # sigma_z = quad * z^2 (meters)
    depth_dropout: float = 0.02         # fraction of valid pixels zeroed
    exposure_amp: float = 0.15          # peak-to-peak multiplicative drift
    exposure_period: float = 90.0       # frames per drift cycle
    shot_noise_std: float = 2.0         # gray-level gaussian noise (0-255)
    blur_px_per_degps: float = 0.03     # blur length per deg/s of rig yaw


def _motion_blur(gray: np.ndarray, blur_px: float) -> np.ndarray:
    """Horizontal box blur of `blur_px` pixels (small-rotation approx)."""
    n = int(round(blur_px))
    if n < 1:
        return gray
    n = min(n, 7)
    acc = np.copy(gray)
    for k in range(1, n + 1):
        acc[:, k:] += gray[:, :-k]
        acc[:, :k] += gray[:, :1]
    return acc / (n + 1.0)


def degrade_sequence(
    seq: "SyntheticSequence",
    model: SensorModel = SensorModel(),
    seed: int = 7,
) -> "SyntheticSequence":
    """Apply the sensor model to an ideal rendered sequence (in place shapes).

    Deterministic given `seed`; both systems (ours and the reference C++)
    can be fed the identical degraded frames for a paired ATE baseline.
    """
    rng = np.random.RandomState(seed)
    n = len(seq.grays)
    grays_out, depths_out = [], []
    # per-frame rig yaw rate from consecutive GT poses (deg/s at 30 fps)
    for i in range(n):
        g = np.asarray(seq.grays[i], np.float32).copy()
        d = np.asarray(seq.depths[i], np.float32).copy()
        if i > 0:
            dR = seq.poses_gt[i][:3, :3] @ seq.poses_gt[i - 1][:3, :3].T
            ang = np.degrees(np.arccos(
                np.clip((np.trace(dR) - 1.0) / 2.0, -1.0, 1.0)))
            yaw_rate = ang * 30.0
        else:
            yaw_rate = 0.0
        blur_px = model.blur_px_per_degps * yaw_rate
        exposure = 1.0 + 0.5 * model.exposure_amp * np.sin(
            2.0 * np.pi * i / model.exposure_period)
        for c in range(g.shape[0]):
            gc = _motion_blur(g[c], blur_px)
            gc = gc * exposure
            gc = gc + rng.normal(0.0, model.shot_noise_std, gc.shape)
            g[c] = np.clip(gc, 0.0, 255.0)
            dc = d[c]
            valid = dc > 0
            noise = rng.normal(0.0, 1.0, dc.shape).astype(np.float32)
            dc = np.where(
                valid, dc + noise * model.depth_sigma_quad * dc * dc, 0.0)
            drop = rng.uniform(size=dc.shape) < model.depth_dropout
            d[c] = np.where(drop, 0.0, dc)
        grays_out.append(g)
        depths_out.append(d)
    return SyntheticSequence(grays_out, depths_out, seq.poses_gt,
                             seq.timestamps)


def make_sequence(
    n_frames: int = 30,
    K: np.ndarray | None = None,
    T_rc: np.ndarray | None = None,   # [C, 4, 4] rig->camera extrinsics
    height: int = 480,
    width: int = 640,
    seed: int = 0,
    n_points: int = 3000,
    trajectory: str = "orbit",
    box: tuple[float, float, float] = (6.0, 4.0, 6.0),
) -> SyntheticSequence:
    """Render a full (optionally multi-camera) RGB-D sequence with GT poses."""
    if K is None:
        K = np.array([520.9, 521.0, width / 2.0, height / 2.0], np.float32)
    if T_rc is None:
        T_rc = np.eye(4, dtype=np.float32)[None]
    world = make_box_world(seed=seed, n_points=n_points, box=box)
    if trajectory == "out_and_back":
        poses = out_and_back_trajectory(n_frames)
    elif trajectory == "circuit":
        poses = circuit_trajectory(n_frames)
    else:
        poses = orbit_trajectory(n_frames, seed=seed + 1)
    grays, depths = [], []
    for i in range(n_frames):
        gs, ds = [], []
        for c in range(T_rc.shape[0]):
            Tcw = T_rc[c] @ poses[i]
            g, d = render_rgbd(world, K, Tcw, height, width)
            gs.append(g)
            ds.append(d)
        grays.append(np.stack(gs))
        depths.append(np.stack(ds))
    ts = np.arange(n_frames, dtype=np.float64) / 30.0
    return SyntheticSequence(grays, depths, poses, ts)
