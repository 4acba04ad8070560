"""PyTorch port vs JAX reference: the tracking slice (no mapping callback).

Dual 320x240 rig (camera 1 yawed 0.9 rad), 512 features per camera, the
small configuration of `tests/test_dual_cam.py`.  One JAX `Tracker` run
over 10 frames is shared by every test:

- stage parity: the JAX tracker's state just before a keyframe frame goes
  through the reference's and the port's `track_frame_fused`: Tcw to atol
  1e-4 (two 4x10 LM pose solves in float32, summed in another order), all
  status scalars equal, >= 99% of the frame's map-point ids equal;
- end to end: the port's `Tracker` (pipelined, depth 3, as `chip_smoke.py`
  runs it) tracks every frame, inserts as many keyframes as the reference,
  keeps every camera centre within 5 mm of the reference's (the port's
  pyramid resampling differs by ~1e-4 grey levels, which moves a few
  keypoints) and has ATE < 0.05 m;
- the port imports no jax; `convert.py` round-trips a `MapState`.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.config import SlamConfig as JCfg
from multi_orb_slam_tpu.frontend import frame as j_frame
from multi_orb_slam_tpu.frontend import tracking as j_tr
from multi_orb_slam_tpu.geometry import camera as j_cam
from multi_orb_slam_tpu.geometry import se3 as j_se3
from multi_orb_slam_tpu.io import synthetic
from multi_orb_slam_tpu.mapping import map_state as j_ms
from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu.ops import search as j_search
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.frontend import frame as t_frame
from multi_orb_slam_tpu_torch.frontend import tracking as t_tr
from multi_orb_slam_tpu_torch.geometry import align as t_align
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.ops import orb as t_orb
from multi_orb_slam_tpu_torch.ops import search as t_search

torch.set_num_threads(2)
C, H, W, NF, N_FRAMES, STAGE_K = 2, 240, 320, 512, 10, 7
CFG_KW = dict(n_cams=C, max_feat=NF, max_kf=32, max_mp=12288, local_cap=2048,
              new_mp_per_cam=128, width=W, height=H, th_depth=6.0, max_frames_kf=4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _centers(poses):
    return np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in poses])


@pytest.fixture(scope="module")
def ref_run():
    K = jnp.tile(jnp.asarray([[260.0, 260.0, 160.0, 120.0]]), (C, 1))
    Ry = j_se3.so3_exp(jnp.asarray([0.0, 0.9, 0.0]))
    T_c12 = jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(jnp.asarray([0.16, 0.004, -0.07]))
    T_rc = jnp.stack([jnp.eye(4), jnp.linalg.inv(T_c12)])
    jcal = j_cam.CameraParams(K=K, dist=jnp.zeros((C, 5)), T_rc=T_rc,
                              bf=jnp.asarray(20.0), width=W, height=H)
    jcfg = JCfg(**CFG_KW, orb=j_orb.ORBConfig(n_features=NF))
    seq = synthetic.make_sequence(n_frames=N_FRAMES, K=np.asarray(K[0]),
                                  T_rc=np.asarray(T_rc), height=H, width=W, n_points=5000)
    tracker = j_tr.Tracker(jcal, jcfg)
    snap = None
    for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
        if i == STAGE_K:
            snap = dict(
                state=tracker.map, prev=tracker.prev_frame, prev_Tcw=tracker.prev_Tcw,
                prev_mp=tracker.prev_mp, velocity=tracker.velocity,
                tstate=np.array([tracker.last_kf_frame, tracker.ref_kf_tracked, 0], np.int32),
                local_pts=tracker._ensure_local_pts(),
                cur=j_frame.build_frame(jnp.asarray(g), jnp.asarray(d), jcal, jcfg.orb))
        tracker.process(g, d)
    traj = tracker.absolute_trajectory()
    return dict(jcal=jcal, jcfg=jcfg, seq=seq, snap=snap, n_kf=int(tracker.map.n_kf),
                centers=_centers([T for _, _, T, _ in traj]), state=tracker.map)


def test_track_frame_fused_stage_parity(ref_run):
    s, jcal, jcfg = ref_run["snap"], ref_run["jcal"], ref_run["jcfg"]
    out_j = j_tr.track_frame_fused(
        s["state"], s["prev"], s["prev_Tcw"], s["prev_mp"], s["velocity"],
        jnp.asarray(s["tstate"]), s["local_pts"], s["cur"], jcal, jcfg,
        jnp.asarray(STAGE_K, jnp.int32))
    T = lambda x: convert._field_to_torch(x, None)  # noqa: E731
    out_t = t_tr.track_frame_fused(
        convert.to_torch(s["state"], t_ms.MapState),
        convert.to_torch(s["prev"], t_frame.FrameData), T(s["prev_Tcw"]), T(s["prev_mp"]),
        T(s["velocity"]), T(s["tstate"]),
        convert.to_torch(s["local_pts"], t_search.LocalPoints),
        convert.to_torch(s["cur"], t_frame.FrameData),
        convert.to_torch(jcal, t_cam.CameraParams), TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF)),
        STAGE_K)
    scal_j = np.asarray(out_j[5])
    assert scal_j[0] == 1 and scal_j[2] == 1, f"frame {STAGE_K} should track and insert a KF"
    np.testing.assert_array_equal(out_t[5].numpy(), scal_j)
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=1e-4)
    np.testing.assert_allclose(out_t[3].numpy(), np.asarray(out_j[3]), atol=1e-4)
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    fmp_j, fmp_t = np.asarray(out_j[2]), out_t[2].numpy()
    assert (fmp_j == fmp_t).mean() >= 0.99
    st_j, st_t = out_j[0], out_t[0]
    assert int(st_t.n_kf) == int(st_j.n_kf) and int(st_t.n_mp) == int(st_j.n_mp)
    assert (np.asarray(st_j.kf_mp) == st_t.kf_mp.numpy()).mean() >= 0.99
    assert int(out_t[6]) == int(out_j[6])


def test_tracker_end_to_end(ref_run):
    seq, jcal = ref_run["seq"], ref_run["jcal"]
    tcfg = TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF))
    tracker = t_tr.Tracker(convert.to_torch(jcal, t_cam.CameraParams), tcfg,
                           pipelined=True, pipeline_depth=3)
    for g, d in zip(seq.grays, seq.depths):
        tracker.process(g, d)
    traj = tracker.absolute_trajectory()
    assert all(not lost for _, _, _, lost in traj), [lost for *_, lost in traj]
    assert int(tracker.map.n_kf) == ref_run["n_kf"]
    centers = _centers([T for _, _, T, _ in traj])
    assert np.abs(centers - ref_run["centers"]).max() < 0.005
    gt = _centers(seq.poses_gt)
    ate = float(t_align.ate_rmse(torch.from_numpy(centers), torch.from_numpy(gt)))
    assert ate < 0.05, ate


def test_tracker_stepwise_matches_pipelined(ref_run):
    """The unpipelined host path agrees with the pipelined fused path."""
    seq, jcal = ref_run["seq"], ref_run["jcal"]
    tcfg = TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF))
    tcal = convert.to_torch(jcal, t_cam.CameraParams)
    outs = []
    for pipe in (False, True):
        tracker = t_tr.Tracker(tcal, tcfg, pipelined=pipe, fuse_extraction=pipe)
        for g, d in zip(seq.grays[:6], seq.depths[:6]):
            tracker.process(g, d)
        est = np.stack([T for _, _, T, _ in tracker.absolute_trajectory()])
        outs.append((est, int(tracker.map.n_kf), int(tracker.map.n_mp)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-5)
    assert outs[0][1:] == outs[1][1:]


def test_convert_map_state_round_trip(ref_run):
    st = ref_run["state"]
    back = convert.to_numpy(convert.to_torch(st, t_ms.MapState))
    rebuilt = j_ms.MapState(**back)
    for name in st._fields:
        a, b = np.asarray(getattr(st, name)), np.asarray(getattr(rebuilt, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    pts = j_search.gather_local_points(st, st.mp_valid, 64)
    back = j_search.LocalPoints(**convert.to_numpy(convert.to_torch(pts, t_search.LocalPoints)))
    np.testing.assert_array_equal(np.asarray(back.desc), np.asarray(pts.desc))


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import multi_orb_slam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert len(mods) >= 15, mods\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('multi_orb_slam_tpu.') or m == 'multi_orb_slam_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
