"""PyTorch port vs JAX reference: the `System` facade, its files and its IO.

The port's copies of `tests/test_system.py` (`TestSystemFacade`, `TestTumIO`),
`tests/test_config_io.py` and `tests/test_reloc.py::test_recover_after_blackout`
run on the port alone, on the CPU.

Against the JAX package, both `System`s (mapping and the loop stage on,
unpipelined, a small online vocabulary as the reference's own tests build
it) take the same 20 frames of the dual 320x240 rig of
`tests/test_torch_tracking.py` with frames 12-14 blanked out (grey 100,
depth 0): the same tracking state on every frame, the same keyframe count,
camera centres within 5 mm up to the blackout (the tolerance of the tracking
and mapping slices' end-to-end tests) and within 1 cm after it: each package
relocalizes from its own random minimal sets and from its own map, and the
first frames after a relocalization track from a motion model that starts at
rest.  (The single-camera configuration of the reference's own blackout test
is not used for this: there the reference itself ends 0.15 m from ground
truth of the 0.2 m it allows, and a 1 cm difference in a local BA decides
which way the frames after the relocalization fall.)

A checkpoint written by either `System` loads in the other, every array of
the map equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu import system as j_system
from multi_orb_slam_tpu.config import SlamConfig as JCfg
from multi_orb_slam_tpu.geometry import camera as j_cam
from multi_orb_slam_tpu.geometry import se3 as j_se3
from multi_orb_slam_tpu.io import synthetic
from multi_orb_slam_tpu.loop import loop_closing as j_lc
from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch import system as t_system
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.geometry import align as t_align
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.geometry import se3 as t_se3
from multi_orb_slam_tpu_torch.io import config_io as t_config_io
from multi_orb_slam_tpu_torch.io import tum as t_tum
from multi_orb_slam_tpu_torch.eval import ate as t_ate
from multi_orb_slam_tpu_torch.loop import loop_closing as t_lc
from multi_orb_slam_tpu_torch.ops import orb as t_orb
from multi_orb_slam_tpu_torch.reloc import relocalization as t_reloc
from multi_orb_slam_tpu_torch.utils import metrics as t_metrics

torch.set_num_threads(2)
OK, LOST = 1, 2
H, W, NF = 240, 320, 512
BLACKOUT = range(12, 15)


def _small_cfg(n_cams=1, **over):
    kw = dict(n_cams=n_cams, max_feat=NF, max_kf=32, max_mp=8192, local_cap=1024,
              new_mp_per_cam=128, width=W, height=H, th_depth=6.0,
              orb=t_orb.ORBConfig(n_features=NF))
    kw.update(over)
    return TCfg(**kw)


def _small_calib(n_cams=1):
    return t_cam.CameraParams(
        K=torch.tensor([[260.0, 260.0, 160.0, 120.0]]).repeat(n_cams, 1),
        dist=torch.zeros((n_cams, 5)), T_rc=torch.eye(4).repeat(n_cams, 1, 1),
        bf=torch.tensor(20.0), width=W, height=H)


def make_system(enable_loop=False, **cfg_over):
    cfg_over.setdefault("max_frames_kf", 4)
    cfg, calib = _small_cfg(**cfg_over), _small_calib()
    sys_ = t_system.System(sensor=t_system.Sensor.RGBD, calib=calib, cfg=cfg,
                           enable_loop_closing=enable_loop, device="cpu")
    return sys_, cfg, calib


def _sequence(n_frames, n_points=2500):
    return synthetic.make_sequence(n_frames=n_frames, K=np.array([260.0, 260.0, 160.0, 120.0]),
                                   height=H, width=W, n_points=n_points)


class TestSystemFacade:
    def test_track_and_save_trajectories(self, tmp_path):
        sys_, cfg, calib = make_system()
        seq = _sequence(10)
        with t_metrics.tracing():       # the stage timers below read the tracer's spans
            for i, (grays, depths) in enumerate(zip(seq.grays, seq.depths)):
                Tcw = sys_.track_rgbd(grays[0], depths[0], timestamp=seq.timestamps[i])
                assert isinstance(Tcw, np.ndarray) and Tcw.shape == (4, 4)
        assert sys_.get_tracking_state() == OK
        assert sys_.get_tracked_map_points() > 50

        tum_path = str(tmp_path / "traj.txt")
        sys_.save_trajectory_tum(tum_path)
        traj = t_tum.read_trajectory_tum(tum_path)
        assert len(traj) == 10
        kf_path = str(tmp_path / "kf.txt")
        sys_.save_keyframe_trajectory_tum(kf_path)
        assert len(t_tum.read_trajectory_tum(kf_path)) >= 2
        kitti_path = str(tmp_path / "kitti.txt")
        sys_.save_trajectory_kitti(kitti_path)
        assert len(open(kitti_path).readlines()) == 10
        # the saved trajectory against itself, and the stage timers
        res = t_ate.evaluate_ate(tum_path, tum_path)
        assert res["compared_pose_pairs"] == 10
        assert res["absolute_translational_error.rmse"] < 1e-5
        report = sys_.timing_report()
        assert "system/track_rgbd" in report and "mapping/stage" in report
        sys_.shutdown()

    def test_localization_mode(self):
        sys_, cfg, calib = make_system()
        seq = _sequence(10)
        for i in range(6):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        n_kf_before = int(sys_.map.n_kf)
        sys_.activate_localization_mode()
        for i in range(6, 10):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        assert int(sys_.map.n_kf) == n_kf_before  # no new keyframes
        assert sys_.get_tracking_state() == OK
        sys_.deactivate_localization_mode()
        assert not sys_.tracker.only_tracking

    def test_reset(self):
        sys_, cfg, calib = make_system(enable_loop=True)
        resets = []
        sys_.loop_closer.reset = lambda: resets.append(1)
        seq = _sequence(6)
        for i in range(4):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        sys_.reset()
        sys_.track_rgbd(seq.grays[4][0], seq.depths[4][0])
        assert sys_.tracker.frame_id == 1  # restarted
        assert resets == [1]               # the loop stage was told, once

    def test_map_checkpoint_roundtrip(self, tmp_path):
        sys_, cfg, calib = make_system()
        seq = _sequence(6)
        for i in range(6):
            sys_.track_rgbd(seq.grays[i][0], seq.depths[i][0])
        path = str(tmp_path / "map.ckpt")
        sys_.save_map(path)
        sys2, _, _ = make_system()
        sys2.load_map(path)
        assert int(sys2.map.n_kf) == int(sys_.map.n_kf)
        assert torch.equal(sys2.map.kf_valid, sys_.map.kf_valid)
        assert sys2.get_tracking_state() == LOST and sys2.tracker._local_pts is None
        assert sys2.tracker.frame_id == 6
        a, b = sys_.tracker.absolute_trajectory(), sys2.tracker.absolute_trajectory()
        np.testing.assert_array_equal(np.stack([T for *_, T, _ in a]),
                                      np.stack([T for *_, T, _ in b]))

    def test_stereo_is_not_ported(self):
        """Stereo input was refused before the stereo sensor was ported; it
        is ported now (held against the reference in test_torch_stereo.py).
        Here: a STEREO system builds, and a featureless pair leaves it
        NOT_INITIALIZED with a 4x4 pose."""
        _, cfg, calib = make_system()
        sys_ = t_system.System(sensor=t_system.Sensor.STEREO, calib=calib, cfg=cfg,
                               enable_loop_closing=False, device="cpu")
        Tcw = sys_.track_stereo(np.zeros((H, W)), np.zeros((H, W)))
        assert Tcw.shape == (4, 4) and sys_.get_tracking_state() == 0

    def test_runs_on_the_cuda_device_unless_asked(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default device is usable")
        with pytest.raises(RuntimeError):
            t_system.System(sensor=t_system.Sensor.RGBD, calib=_small_calib(), cfg=_small_cfg())
        with pytest.raises(ValueError):
            t_system.System(sensor=t_system.Sensor.RGBD, device="cpu")


class TestTumIO:
    def test_associate(self):
        a = {1.00: ["a1"], 1.05: ["a2"], 2.00: ["a3"]}
        b = {1.01: ["b1"], 1.06: ["b2"], 3.00: ["b3"]}
        m = t_tum.associate(a, b, max_difference=0.02)
        assert m == [(1.00, 1.01), (1.05, 1.06)]

    def test_trajectory_roundtrip(self, tmp_path):
        rng = np.random.RandomState(0)
        poses = []
        for i in range(5):
            xi = torch.from_numpy(rng.randn(6).astype(np.float32) * 0.3)
            poses.append((float(i) * 0.1, t_se3.exp(xi).numpy()))
        path = str(tmp_path / "t.txt")
        t_tum.write_trajectory_tum(path, poses)
        back = t_tum.read_trajectory_tum(path)
        assert len(back) == 5
        for t, Tcw in poses:
            Twc = np.linalg.inv(Tcw)
            got = back[round(t, 6)]
            np.testing.assert_allclose(got, Twc, atol=1e-5)

    def test_files_equal_the_reference_writers(self, tmp_path):
        """Both packages write the same bytes for the same poses."""
        from multi_orb_slam_tpu.io import tum as j_tum

        rng = np.random.RandomState(1)
        poses = [(0.05 * i, np.asarray(j_se3.exp(jnp.asarray(rng.randn(6) * 0.4, jnp.float32))))
                 for i in range(6)]
        for writer_j, writer_t, arg in (
                (j_tum.write_trajectory_tum, t_tum.write_trajectory_tum, poses),
                (j_tum.write_trajectory_kitti, t_tum.write_trajectory_kitti,
                 [T for _, T in poses])):
            pj, pt = tmp_path / "j.txt", tmp_path / "t.txt"
            writer_j(str(pj), arg)
            writer_t(str(pt), arg)
            rows_j = np.loadtxt(pj)
            np.testing.assert_allclose(np.loadtxt(pt), rows_j, atol=2e-7)
        assert rows_j.shape == (6, 12)     # the KITTI rows, written last


class TestConfigIO:
    def test_load_reference_style_settings(self):
        st = t_config_io.load_settings("configs/multi.yaml", n_cams=2)
        assert abs(st.K[0][0] - 522.6) < 1e-3
        assert st.bf == 40.0
        assert st.n_features == 1000
        assert st.n_features_cam2 == 500  # reference halves cam2 features
        assert st.depth_map_factor == 1000.0
        assert st.n_levels == 8 and abs(st.scale_factor - 1.2) < 1e-6

    def test_load_calibration(self, tmp_path):
        T = t_config_io.load_calibration("configs/calibration.txt")
        # ~90 deg about Y, translation ~[0.16, 0.004, -0.07]
        assert abs(T[0, 2] - 1.0) < 1e-6
        assert abs(T[2, 0] + 1.0) < 1e-6
        np.testing.assert_allclose(T[:3, 3], [0.161, 0.004, -0.071], atol=1e-6)
        R = T[:3, :3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
        bad = tmp_path / "bad.txt"
        bad.write_text("1 0 0\n0 1 0\n")
        with pytest.raises(ValueError):
            t_config_io.load_calibration(str(bad))

    def test_system_from_files(self):
        sys_ = t_system.System(
            settings_path="configs/multi.yaml", calibration_path="configs/calibration.txt",
            sensor=t_system.Sensor.DUAL_RGBD, enable_loop_closing=False, device="cpu")
        assert sys_.cfg.n_cams == 2
        # ThDepth scaled to meters: bf*ThDepth/fx = 40*40/522.6
        assert abs(sys_.cfg.th_depth - 40.0 * 40.0 / 522.6) < 1e-3
        assert sys_.calib.T_rc.shape == (2, 4, 4)
        # the same rig and configuration as the reference builds from the files
        ref = j_system.System(
            settings_path="configs/multi.yaml", calibration_path="configs/calibration.txt",
            sensor=j_system.Sensor.DUAL_RGBD, enable_loop_closing=False)
        for f in ("K", "dist", "T_rc", "bf"):
            np.testing.assert_allclose(getattr(sys_.calib, f).numpy(),
                                       np.asarray(getattr(ref.calib, f)), atol=1e-6, err_msg=f)
        for f in ("max_feat", "width", "height", "n_levels", "max_frames_kf"):
            assert getattr(sys_.cfg, f) == getattr(ref.cfg, f), f
        assert sys_.cfg.orb.n_features == ref.cfg.orb.n_features

    def test_change_calibration(self, tmp_path):
        sys_ = t_system.System(
            settings_path="configs/multi.yaml", calibration_path="configs/calibration.txt",
            sensor=t_system.Sensor.DUAL_RGBD, enable_loop_closing=False, device="cpu")
        alt = tmp_path / "alt.yaml"
        alt.write_text(open("configs/multi.yaml").read().replace(
            "Camera.fx: 522.6", "Camera.fx: 600.0"))
        sys_.change_calibration(str(alt), "configs/calibration.txt")
        assert abs(float(sys_.calib.K[0][0]) - 600.0) < 1e-3
        assert sys_.tracker.calib is sys_.calib

    def test_tracked_keypoints_un(self):
        sys_ = t_system.System(
            sensor=t_system.Sensor.RGBD, calib=_small_calib(), cfg=_small_cfg(),
            enable_loop_closing=False, enable_mapping=False, device="cpu")
        xy, matched = sys_.get_tracked_keypoints_un()
        assert xy.shape == (0, 2) and matched.shape == (0,)
        seq = _sequence(3, n_points=2000)
        for g, d in zip(seq.grays, seq.depths):
            sys_.track_rgbd(g[0], d[0])
        xy, matched = sys_.get_tracked_keypoints_un()
        assert xy.shape[0] > 100
        assert matched.sum() > 50


def test_metrics_spans_and_counters():
    m = t_metrics.Metrics()
    with t_metrics.tracing():
        for _ in range(3):
            with m.span("stage"):
                pass
    m.count("frames", 2)
    s = m.summary()
    assert s["stage"]["n"] == 3 and s["frames"] == 2 and "stage" in m.report()
    m.reset()
    assert m.summary() == {}


# ---------------------------------------------------------------------------
# both Systems on the blackout sequence
# ---------------------------------------------------------------------------

C = 2
CFG_KW = dict(n_cams=C, max_feat=NF, max_kf=32, max_mp=12288, local_cap=2048,
              new_mp_per_cam=128, width=W, height=H, th_depth=6.0, max_frames_kf=3)
VOCAB_KW = dict(vocab_min_descs=1200, vocab_k=6, vocab_depth=3)


def _centre(Tcw):
    return np.linalg.inv(np.asarray(Tcw, np.float64))[:3, 3]


@pytest.fixture(scope="module")
def blackout_runs(tmp_path_factory):
    K = jnp.tile(jnp.asarray([[260.0, 260.0, 160.0, 120.0]]), (C, 1))
    Ry = j_se3.so3_exp(jnp.asarray([0.0, 0.9, 0.0]))
    T_c12 = jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(jnp.asarray([0.16, 0.004, -0.07]))
    T_rc = jnp.stack([jnp.eye(4), jnp.linalg.inv(T_c12)])
    jcal = j_cam.CameraParams(K=K, dist=jnp.zeros((C, 5)), T_rc=T_rc,
                              bf=jnp.asarray(20.0), width=W, height=H)
    jcfg = JCfg(**CFG_KW, orb=j_orb.ORBConfig(n_features=NF))
    tcfg = TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF))
    seq = synthetic.make_sequence(n_frames=20, K=np.asarray(K[0]), T_rc=np.asarray(T_rc),
                                  height=H, width=W, n_points=5000)
    js = j_system.System(sensor=j_system.Sensor.DUAL_RGBD, calib=jcal, cfg=jcfg)
    js.loop_closer = j_lc.LoopCloser(jcal, jcfg, **VOCAB_KW)
    ts = t_system.System(sensor=t_system.Sensor.DUAL_RGBD,
                         calib=convert.to_torch(jcal, t_cam.CameraParams, "cpu"),
                         cfg=tcfg, device="cpu")
    ts.loop_closer = t_lc.LoopCloser(ts.calib, tcfg, **VOCAB_KW)
    blank, zero = np.full_like(seq.grays[0], 100.0), np.zeros_like(seq.depths[0])
    reloc0 = dict(t_reloc.STATS)
    rows = []
    with t_metrics.tracing():          # `timing_report` reads the tracer's spans
        for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
            if i in BLACKOUT:
                g, d = blank, zero
            Tj = js.track_rgbd(g[0], d[0], g[1], d[1], timestamp=seq.timestamps[i])
            Tt = ts.track_rgbd(g[0], d[0], g[1], d[1], timestamp=seq.timestamps[i])
            rows.append((js.get_tracking_state(), ts.get_tracking_state(), _centre(Tj),
                         _centre(Tt)))
    reloc = {k: t_reloc.STATS[k] - reloc0[k] for k in reloc0}
    return dict(js=js, ts=ts, rows=rows, seq=seq, reloc=reloc,
                dir=tmp_path_factory.mktemp("ckpt"))


def test_recover_after_blackout(blackout_runs):
    """The port's copy of `tests/test_reloc.py::test_recover_after_blackout`,
    on the dual rig."""
    ts, seq, rows = blackout_runs["ts"], blackout_runs["seq"], blackout_runs["rows"]
    states = [r[1] for r in rows]
    assert ts.loop_closer.voc is not None        # vocabulary must exist
    assert states[12:15] == [LOST] * 3           # lost during blackout
    assert states[-1] == OK, states              # recovered afterwards
    # recovered pose accurate (in the map gauge: world = frame-0 camera)
    gt_c = _centre(seq.poses_gt[-1] @ np.linalg.inv(seq.poses_gt[0]))
    assert np.linalg.norm(rows[-1][3] - gt_c) < 0.2
    assert np.linalg.norm(rows[-1][3] - gt_c) < 0.02
    # the first blank frame loses track; each later frame tries to
    # relocalize, and the first one that shows the scene again succeeds
    assert blackout_runs["reloc"]["calls"] == 3 and blackout_runs["reloc"]["found"] == 1
    assert "relocalize" in ts.timing_report()
    traj = ts.tracker.absolute_trajectory()
    assert [lost for *_, lost in traj] == [i in BLACKOUT for i in range(20)]
    tracked = [i for i in range(20) if i not in BLACKOUT]
    est = torch.from_numpy(np.stack([_centre(traj[i][2]) for i in tracked]))
    gt = torch.from_numpy(np.stack([_centre(seq.poses_gt[i]) for i in tracked]))
    assert float(t_align.ate_rmse(est, gt)) < 0.02


def test_same_states_keyframes_and_centres_as_the_reference(blackout_runs):
    js, ts, rows = blackout_runs["js"], blackout_runs["ts"], blackout_runs["rows"]
    assert [r[1] for r in rows] == [r[0] for r in rows]
    assert int(ts.map.n_kf) == int(js.map.n_kf) >= 5
    assert int(ts.map.next_kf_id) == int(js.map.next_kf_id)
    gap = np.array([np.linalg.norm(r[2] - r[3]) for r in rows])
    assert gap[:BLACKOUT.start].max() < 0.005, gap
    assert gap[BLACKOUT.stop:].max() < 0.01, gap
    # the place-recognition state went the same way
    assert ts.loop_closer.voc.depth == js.loop_closer.voc.depth
    assert abs(ts.loop_closer.voc.n_words - js.loop_closer.voc.n_words) < 20
    np.testing.assert_array_equal(ts.loop_closer.db.has_bow.numpy(),
                                  np.asarray(js.loop_closer.db.has_bow))
    assert ts.loop_closer.n_loops_closed == 0 == js.loop_closer.n_loops_closed


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_between_the_packages(blackout_runs, writer):
    js, ts = blackout_runs["js"], blackout_runs["ts"]
    path = str(blackout_runs["dir"] / f"{writer}.ckpt")
    src = js if writer == "jax" else ts
    src.save_map(path)
    if writer == "jax":
        dst = t_system.System(sensor=t_system.Sensor.DUAL_RGBD, calib=ts.calib, cfg=ts.cfg,
                              device="cpu")
        want = convert.to_numpy(convert.to_torch(js.map, type(ts.map), "cpu"))
    else:
        dst = j_system.System(sensor=j_system.Sensor.DUAL_RGBD, calib=js.calib, cfg=js.cfg)
        want = convert.to_numpy(ts.map)
    dst.load_map(path)
    got = (convert.to_numpy(dst.map) if writer == "jax"
           else {f: np.asarray(getattr(dst.map, f)) for f in dst.map._fields})
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        assert got[f].dtype == want[f].dtype, f
    assert dst.get_tracking_state() == LOST
    assert dst.tracker.frame_id == src.tracker.frame_id == 20
    assert int(dst.tracker.last_kf_slot) == int(src.tracker.last_kf_slot)
    # the trajectory came along: the loader exports what the writer would
    a = src.tracker.absolute_trajectory()
    b = dst.tracker.absolute_trajectory()
    assert [x[0] for x in a] == [x[0] for x in b] and [x[3] for x in a] == [x[3] for x in b]
    np.testing.assert_allclose(np.stack([np.asarray(x[2]) for x in b]),
                               np.stack([np.asarray(x[2]) for x in a]), atol=1e-6)
