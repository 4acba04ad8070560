"""PyTorch port vs JAX reference on Kinect-degraded input
(`tests/test_degraded.py`'s counterpart).

- `io/synthetic.degrade_sequence`: the port's numpy copy gives the
  reference's arrays exactly (both draw from `np.random.RandomState(seed)`
  in the same order) on a clean sequence: one camera at 320x240, and the
  dual rig at 640x480 with another seed and a harsher sensor model.
- The port's `System(RGBD)` on `test_degraded.py`'s 40 frames (one 320x240
  camera, 2500 squares, the default `SensorModel`, seed 7), held to that
  test's bounds: the degradation bites (> 100 valid depth pixels dropped on
  frame 10, a mean depth change > 1e-4 m on the rest), no frame lost, ATE <
  0.10 m.
"""

import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.io import synthetic as j_syn
from multi_orb_slam_tpu_torch import system as t_system
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.geometry import align as t_align
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.io import synthetic as t_syn
from multi_orb_slam_tpu_torch.ops import orb as t_orb

torch.set_num_threads(2)

K_SMALL = np.array([260.0, 260.0, 160.0, 120.0], np.float32)


def _rig():
    """The real ~90-degree dual rig (rig -> camera)."""
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    T[:3, 3] = [0.161, 0.004, -0.071]
    return np.stack([np.eye(4, dtype=np.float32), T])


@pytest.mark.parametrize("case", ["one camera, default model, seed 7",
                                  "dual rig at 640x480, harsher model, seed 3"])
def test_degrade_sequence_is_the_references(case):
    if case.startswith("one camera"):
        kw = dict(n_frames=6, K=K_SMALL, height=240, width=320, n_points=2500)
        model, seed = dict(), 7
    else:
        kw = dict(n_frames=3, K=np.array([520.9, 521.0, 320.0, 240.0], np.float32),
                  T_rc=_rig(), height=480, width=640, n_points=4000, trajectory="circuit")
        model, seed = dict(depth_dropout=0.1, shot_noise_std=5.0, blur_px_per_degps=0.5), 3
    clean_j, clean_t = j_syn.make_sequence(**kw), t_syn.make_sequence(**kw)
    out_j = j_syn.degrade_sequence(clean_j, j_syn.SensorModel(**model), seed=seed)
    out_t = t_syn.degrade_sequence(clean_t, t_syn.SensorModel(**model), seed=seed)
    for field in ("grays", "depths", "poses_gt", "timestamps"):
        a, b = getattr(out_j, field), getattr(out_t, field)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert np.asarray(y).dtype == np.asarray(x).dtype, field
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=field)
    # and the degradation changed the frames
    assert not np.array_equal(np.asarray(out_t.grays[1]), np.asarray(clean_t.grays[1]))


def test_degraded_sequence_tracks_with_bounded_ate():
    cfg = TCfg(n_cams=1, max_feat=512, max_kf=32, max_mp=8192, local_cap=1024,
               new_mp_per_cam=128, width=320, height=240, th_depth=6.0,
               orb=t_orb.ORBConfig(n_features=512))
    calib = t_cam.CameraParams(
        K=torch.from_numpy(K_SMALL)[None], dist=torch.zeros((1, 5)), T_rc=torch.eye(4)[None],
        bf=torch.tensor(20.0), width=320, height=240)
    clean = t_syn.make_sequence(n_frames=40, K=K_SMALL, height=240, width=320, n_points=2500)
    seq = t_syn.degrade_sequence(clean, t_syn.SensorModel(), seed=7)

    # the degradation must bite: depth must differ beyond mm noise and some
    # valid depth must be dropped
    d0c, d0n = np.asarray(clean.depths[10][0]), np.asarray(seq.depths[10][0])
    assert np.sum((d0c > 0) & (d0n == 0)) > 100, "depth dropout not applied"
    both = (d0c > 0) & (d0n > 0)
    assert float(np.abs(d0c[both] - d0n[both]).mean()) > 1e-4

    slam = t_system.System(sensor=t_system.Sensor.RGBD, calib=calib, cfg=cfg,
                           enable_loop_closing=False, device="cpu")
    for g, d in zip(seq.grays, seq.depths):
        slam.track_rgbd(g[0], d[0])
    traj = slam.tracker.absolute_trajectory()
    n_lost = sum(1 for *_, lost in traj if lost)
    assert n_lost == 0, f"{n_lost}/40 frames lost on degraded input"
    est = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for _, _, T, _ in traj])
    gt = np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in seq.poses_gt])
    rmse = float(t_align.ate_rmse(torch.from_numpy(est), torch.from_numpy(gt)))
    assert rmse < 0.10, f"degraded ATE RMSE {rmse:.4f} m"
