"""PyTorch port vs JAX reference: hamming, map state, searches, pose BA.

The searches run on frames and a map that the JAX package built (dual
320x240 rig, 512 features per camera), carried over with `convert.py`,
so both sides see identical inputs:

- hamming and map-state primitives: exact;
- `search_prev_frame`, `search_points_in_frame`, `match_frame_kf_brute`:
  equal match arrays (their gated inner loop is the port's `window_match`,
  whose tie rules equal the reference's first-argmin);
- `optimize_pose` on the same `PoseObs`: Tcw to atol 1e-4 (float32 normal
  equations summed and solved in another order over 40 LM iterations),
  inlier counts within 1.
"""

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
from multi_orb_slam_tpu.ops import hamming as j_ham
from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu.ops import search as j_search
from multi_orb_slam_tpu.optim import pose_opt as j_po
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.frontend import frame as t_frame
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.ops import hamming as t_ham
from multi_orb_slam_tpu_torch.ops import search as t_search
from multi_orb_slam_tpu_torch.optim import pose_opt as t_po

torch.set_num_threads(2)
C, H, W, NF = 2, 240, 320, 512


def _t(x):
    """numpy/jax array -> torch tensor (descriptor words viewed as int32)."""
    a = np.asarray(x)
    return torch.from_numpy(np.array(a.view(np.int32) if a.dtype == np.uint32 else a))


def _n(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def world():
    K = jnp.tile(jnp.asarray([[260.0, 260.0, 160.0, 120.0]]), (C, 1))
    Ry = j_se3.so3_exp(jnp.asarray([0.0, 0.9, 0.0]))
    T_c12 = jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(jnp.asarray([0.16, 0.004, -0.07]))
    T_rc = jnp.stack([jnp.eye(4), jnp.linalg.inv(T_c12)])
    jcal = j_cam.CameraParams(K=K, dist=jnp.zeros((C, 5)), T_rc=T_rc,
                              bf=jnp.asarray(20.0), width=W, height=H)
    cfg = JCfg(n_cams=C, max_feat=NF, max_kf=8, max_mp=4096, local_cap=1024,
               new_mp_per_cam=128, width=W, height=H, th_depth=6.0,
               orb=j_orb.ORBConfig(n_features=NF))
    seq = synthetic.make_sequence(n_frames=12, K=np.asarray(K[0]), T_rc=np.asarray(T_rc),
                                  height=H, width=W, n_points=5000)
    fr0 = j_frame.build_frame(jnp.asarray(seq.grays[0]), jnp.asarray(seq.depths[0]),
                              jcal, cfg.orb)
    fr1 = j_frame.build_frame(jnp.asarray(seq.grays[1]), jnp.asarray(seq.depths[1]),
                              jcal, cfg.orb)
    state, _, frame_mp = j_tr.initialize_map(
        j_ms.make_empty(cfg.max_kf, C, NF, cfg.max_mp), fr0, jcal, cfg, jnp.asarray(0))
    # map frame = rig frame 0; the true pose of frame 1 in it
    Tcw1 = jnp.asarray(seq.poses_gt[1] @ np.linalg.inv(seq.poses_gt[0]))
    return dict(jcal=jcal, cfg=cfg, fr0=fr0, fr1=fr1, state=state, frame_mp=frame_mp,
                Tcw1=Tcw1, tcal=convert.to_torch(jcal, t_cam.CameraParams, "cpu"),
                tfr0=convert.to_torch(fr0, t_frame.FrameData, "cpu"),
                tfr1=convert.to_torch(fr1, t_frame.FrameData, "cpu"),
                tstate=convert.to_torch(state, t_ms.MapState, "cpu"))


# ---------------------------------------------------------------------------
# hamming and map-state primitives
# ---------------------------------------------------------------------------


def test_hamming_big_and_popcount32_are_the_reference_names():
    """`ops/hamming.py` defines the reference's `BIG` and `popcount32` at the
    same path: the sentinel's value, and the popcount of 4096 seeded uint32
    words (0, all ones and each end bit among them) bit-equal to JAX's."""
    rng = np.random.RandomState(7)
    w = rng.randint(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    w[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x00000001]
    assert t_ham.BIG == int(j_ham.BIG)
    assert t_ham.popcount32.__module__ == t_ham.__name__
    got = _n(t_ham.popcount32(_t(w)))
    np.testing.assert_array_equal(got, np.asarray(j_ham.popcount32(jnp.asarray(w))))
    assert got[:4].tolist() == [0, 32, 1, 1]


def test_hamming_primitives():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2**32, (40, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, (60, 8), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(_n(t_ham.popcount32(_t(a))), np.asarray(j_ham.popcount32(a)))
    np.testing.assert_array_equal(_n(t_ham.hamming_distance(_t(a[:20]), _t(b[:20]))),
                                  np.asarray(j_ham.hamming_distance(a[:20], b[:20])))
    d_j = np.asarray(j_ham.pairwise_hamming(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(_n(t_ham.pairwise_hamming(_t(a), _t(b))), d_j)
    mask = rng.rand(40, 60) < 0.3
    mask[3] = False
    d = np.minimum(d_j, 130)      # many equal distances: tie order matters
    for fj, ft in ((j_ham.masked_argmin2, t_ham.masked_argmin2),
                   (j_ham.mutual_best, t_ham.mutual_best)):
        for r_j, r_t in zip(fj(jnp.asarray(d), jnp.asarray(mask)),
                            ft(torch.from_numpy(d), torch.from_numpy(mask))):
            np.testing.assert_array_equal(_n(r_t), np.asarray(r_j))
    delta = rng.uniform(-7, 7, 300).astype(np.float32)
    delta[:100] = 0.25
    ok = rng.rand(300) < 0.7
    np.testing.assert_array_equal(
        _n(t_ham.rotation_histogram_filter(torch.from_numpy(delta), torch.from_numpy(ok))),
        np.asarray(j_ham.rotation_histogram_filter(jnp.asarray(delta), jnp.asarray(ok))))


def test_map_state_primitives(world):
    st_j, st_t = world["state"], world["tstate"]
    rng = np.random.RandomState(1)
    valid = rng.rand(500) < 0.6
    want = rng.rand(300) < 0.5
    np.testing.assert_array_equal(
        _n(t_ms.allocate_mp_slots(torch.from_numpy(valid), torch.from_numpy(want))),
        np.asarray(j_ms.allocate_mp_slots(jnp.asarray(valid), jnp.asarray(want))))
    rows = rng.randint(-1, 30, (3, 2, 64)).astype(np.int32)
    keep = rng.rand(3, 2, 64) < 0.5
    np.testing.assert_array_equal(
        _n(t_ms.dedupe_obs_rows(torch.from_numpy(rows), torch.from_numpy(keep))),
        np.asarray(j_ms.dedupe_obs_rows(jnp.asarray(rows), jnp.asarray(keep))))
    for fj, ft in ((j_ms.covisibility, t_ms.covisibility),
                   (j_ms.mp_observation_count, t_ms.mp_observation_count)):
        np.testing.assert_array_equal(_n(ft(st_t)), np.asarray(fj(st_j)))
    ids = rng.randint(-1, 4096, 200).astype(np.int32)
    np.testing.assert_array_equal(_n(t_ms.resolve_mp_ids(st_t, torch.from_numpy(ids))),
                                  np.asarray(j_ms.resolve_mp_ids(st_j, jnp.asarray(ids))))
    buf = rng.randint(0, 2**32, (50, 4, 8), dtype=np.uint64).astype(np.uint32)
    buf[:, 2] = buf[:, 0]         # equal totals: the first slot must win
    n = rng.randint(0, 7, 50).astype(np.int32)
    np.testing.assert_array_equal(
        _n(t_ms.update_mp_descriptor(_t(buf), torch.from_numpy(n))).view(np.uint32),
        np.asarray(j_ms.update_mp_descriptor(jnp.asarray(buf), jnp.asarray(n))))
    dist = rng.uniform(0.2, 8, 200).astype(np.float32)
    lvl = rng.randint(0, 8, 200).astype(np.int32)
    for a, b in zip(t_ms.scale_range_from_obs(torch.from_numpy(dist), torch.from_numpy(lvl), 1.2, 8),
                    j_ms.scale_range_from_obs(jnp.asarray(dist), jnp.asarray(lvl), 1.2, 8)):
        np.testing.assert_allclose(_n(a), np.asarray(b), rtol=1e-6)
    maxd = (dist * rng.uniform(0.5, 6, 200)).astype(np.float32)
    np.testing.assert_array_equal(
        _n(t_ms.predict_scale(torch.from_numpy(dist), torch.from_numpy(maxd), 1.2, 8)),
        np.asarray(j_ms.predict_scale(jnp.asarray(dist), jnp.asarray(maxd), 1.2, 8)))


# ---------------------------------------------------------------------------
# searches and pose optimization on reference-built frames and map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def prev_search(world):
    cfg, fr0, fr1 = world["cfg"], world["fr0"], world["fr1"]
    jcal = world["jcal"]
    pw, ok = j_tr.unproject_features(fr0, jnp.eye(4), jcal)
    args_j = (pw, ok, fr0.desc, fr0.level, fr0.angle, world["frame_mp"],
              fr1.xy_und, fr1.uright, fr1.level, fr1.angle, fr1.desc, fr1.valid,
              world["Tcw1"], jcal.T_rc, jcal.K, jcal.bf)
    static = (W, H, cfg.scale_factor, cfg.n_levels)
    ref = j_search.search_prev_frame(*args_j, *static)
    got = t_search.search_prev_frame(*[_t(a) for a in args_j], *static)
    return ref, got


def test_search_prev_frame(prev_search):
    ref, got = prev_search
    assert int((np.asarray(ref[0]) >= 0).sum()) > 200
    np.testing.assert_array_equal(_n(got[0]), np.asarray(ref[0]))
    np.testing.assert_allclose(_n(got[1]), np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_array_equal(_n(got[2]), np.asarray(ref[2]))


def test_search_points_in_frame(world):
    cfg, fr1, jcal = world["cfg"], world["fr1"], world["jcal"]
    st_j, st_t = world["state"], world["tstate"]
    pts_j = j_search.gather_local_points(st_j, st_j.mp_valid, cfg.local_cap)
    pts_t = t_search.gather_local_points(st_t, st_t.mp_valid, cfg.local_cap)
    for name in pts_j._fields:
        np.testing.assert_array_equal(_n(getattr(pts_t, name)),
                                      np.asarray(getattr(pts_j, name)).view(
                                          np.int32) if name == "desc" else
                                      np.asarray(getattr(pts_j, name)), err_msg=name)
    taken = np.zeros((C, NF), bool)
    taken[:, ::7] = True
    fargs = (fr1.xy_und, fr1.uright, fr1.level, fr1.desc, fr1.valid, jnp.asarray(taken),
             world["Tcw1"], jcal.T_rc, jcal.K, jcal.bf)
    static = (W, H, cfg.scale_factor, cfg.n_levels)
    ref = j_search.search_points_in_frame(pts_j, *fargs, *static, th_radius=4.0, nn_ratio=0.8)
    got = t_search.search_points_in_frame(pts_t, *[_t(a) for a in fargs], *static,
                                          th_radius=4.0, nn_ratio=0.8)
    assert int((np.asarray(ref[0]) >= 0).sum()) > 200
    np.testing.assert_array_equal(_n(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(_n(got[1]), np.asarray(ref[1]))


@pytest.mark.parametrize("use_view_cos", [True, False])
def test_search_points_in_frame_with_fuse_arguments(world, use_view_cos):
    """The arguments `fusion._fuse_step` passes: radius 3, no ratio test,
    TH_LOW, the 60-degree view gate, and no feature taken."""
    cfg, fr1, jcal = world["cfg"], world["fr1"], world["jcal"]
    st_j, st_t = world["state"], world["tstate"]
    pts_j = j_search.gather_local_points(st_j, st_j.mp_valid, cfg.local_cap)
    pts_t = t_search.gather_local_points(st_t, st_t.mp_valid, cfg.local_cap)
    fargs = (fr1.xy_und, fr1.uright, fr1.level, fr1.desc, fr1.valid,
             jnp.zeros((C, NF), bool), world["Tcw1"], jcal.T_rc, jcal.K, jcal.bf)
    static = (W, H, cfg.scale_factor, cfg.n_levels)
    kw = dict(th_radius=3.0, nn_ratio=1.0, th_hamming=50, use_view_cos=use_view_cos)
    ref = j_search.search_points_in_frame(pts_j, *fargs, *static, **kw)
    got = t_search.search_points_in_frame(pts_t, *[_t(a) for a in fargs], *static, **kw)
    assert int((np.asarray(ref[0]) >= 0).sum()) > 200
    np.testing.assert_array_equal(_n(got[0]), np.asarray(ref[0]))
    np.testing.assert_array_equal(_n(got[1]), np.asarray(ref[1]))


def test_match_frame_kf_brute(world):
    fr1, st_j = world["fr1"], world["state"]
    args = (st_j.kf_desc[0], st_j.kf_feat_valid[0], st_j.kf_mp[0], st_j.kf_angle[0],
            fr1.desc, fr1.valid, fr1.angle)
    ref = j_search.match_frame_kf_brute(*args)
    got = t_search.match_frame_kf_brute(*[_t(a) for a in args])
    assert int((np.asarray(ref) >= 0).sum()) > 100
    np.testing.assert_array_equal(_n(got), np.asarray(ref))


def test_optimize_pose(world, prev_search):
    ref, _ = prev_search
    fr1, cfg, jcal = world["fr1"], world["cfg"], world["jcal"]
    matched = np.asarray(ref[0]) >= 0
    obs_j = j_tr._pose_obs_from_matches(fr1, ref[1], jnp.asarray(matched), cfg)
    T_j, inl_j, n_j = j_po.optimize_pose(jnp.eye(4), obs_j, jcal.T_rc, jcal.K, jcal.bf)
    obs_t = convert.to_torch(obs_j, t_po.PoseObs, "cpu")
    T_t, inl_t, n_t = t_po.optimize_pose(torch.eye(4), obs_t, _t(jcal.T_rc), _t(jcal.K),
                                         _t(jcal.bf))
    np.testing.assert_allclose(_n(T_t), np.asarray(T_j), atol=1e-4)
    assert abs(int(n_t) - int(n_j)) <= 1
    assert int(n_j) > 100
    # the pose moved from the identity start toward the truth
    err = np.abs(_n(T_t) - np.asarray(world["Tcw1"]))[:3, 3].max()
    assert err < 0.01, err


def test_optimize_pose_stereo_mono_mix():
    """Synthetic observations with outliers and mono rows: the schedule
    (Huber rounds, reclassification, settled rounds) matches."""
    rng = np.random.RandomState(7)
    N = 400
    T_rc = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    T_rc[1, 0, 3] = -0.1
    K = np.array([[260.0, 260.0, 160.0, 120.0]] * 2, np.float32)
    T_true = np.asarray(j_se3.exp(jnp.asarray([0.05, -0.02, 0.03, 0.01, 0.02, -0.01])))
    pw = np.concatenate([rng.uniform(-2, 2, (N, 2)), rng.uniform(2, 6, (N, 1))], 1).astype(np.float32)
    cam = rng.randint(0, 2, N).astype(np.int32)
    Xc = np.einsum("nij,nj->ni", T_rc[cam][:, :3, :3],
                   pw @ T_true[:3, :3].T + T_true[:3, 3]) + T_rc[cam][:, :3, 3]
    u = K[cam, 0] * Xc[:, 0] / Xc[:, 2] + K[cam, 2]
    v = K[cam, 1] * Xc[:, 1] / Xc[:, 2] + K[cam, 3]
    ur = np.where(rng.rand(N) < 0.6, u - 20.0 / Xc[:, 2], -1.0)
    uvr = np.stack([u, v, ur], 1).astype(np.float32) + rng.randn(N, 3).astype(np.float32) * 0.5
    uvr[:40, :2] += 25.0          # outliers
    obs = dict(pw=pw, uvr=uvr, cam_idx=cam,
               inv_sigma2=(1.2 ** (-2.0 * rng.randint(0, 4, N))).astype(np.float32),
               mask=rng.rand(N) < 0.95)
    T_j, inl_j, n_j = j_po.optimize_pose(
        jnp.eye(4), j_po.PoseObs(**{k: jnp.asarray(v) for k, v in obs.items()}),
        jnp.asarray(T_rc), jnp.asarray(K), jnp.asarray(20.0))
    T_t, inl_t, n_t = t_po.optimize_pose(
        torch.eye(4), t_po.PoseObs(**{k: torch.from_numpy(v) for k, v in obs.items()}),
        torch.from_numpy(T_rc), torch.from_numpy(K), torch.tensor(20.0))
    np.testing.assert_allclose(_n(T_t), np.asarray(T_j), atol=1e-4)
    assert abs(int(n_t) - int(n_j)) <= 1
    assert not _n(inl_t)[:40].any()
