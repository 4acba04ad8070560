"""PyTorch port vs JAX reference: the loop closer's matching roles, the guided
Sim3 search, global BA, the GBA merge, the loop correction and the Sim3
verification.

Maps come from the JAX package's own tracker (the scenes of
`tests/test_global_ba.py` and `tests/test_loop_e2e.py`: one 320x240 camera,
mapping without local BA or culling) and are converted to the port's tensors
on the CPU.  Tolerances:

- the word-gated match, the projection count and `search_by_sim3`: integer
  outputs equal;
- `global_ba` on `test_global_ba`'s perturbed map (8 outer iterations):
  keyframe poses to 1e-4, points that two or more observations hold to 1e-3
  m, slot 0 unchanged;
- `merge_gba` (both scenarios of `test_global_ba.TestAsyncGBAMerge`): 1e-5;
- `_correct_loop` on `test_loop_e2e`'s drifted map: keyframe poses to 1e-3,
  and in both packages the drifted keyframe's error falls below 0.35 of what
  it was; a second loop on the same map with the first loop's GBA still
  pending: the same accumulated loop pairs, the pending GBA replaced (not
  merged) in both, its poses and the merged map's to 1e-3;
- `_compute_sim3` with the reference's RANSAC triplets handed to the port
  (`LoopCloser.triplet_source`): the same loop keyframe and the same total.

The loop stage's graphed functions (`word_match_stage`, `search_by_sim3`,
`guided_count_stage`, the global BA's `run_global_ba_arrays`, `merge_gba`,
and the loop fusion `fuse_into_kfs` on `_correct_loop`'s inputs: one CUDA
graph replay a call on the card) leave their inputs bit-unchanged
and read nothing back through their entries; two keyframe pairs (traced
slots) or two `old_kf` snapshots go through one entry; and `_compute_sim3`,
`_correct_loop` and the merge with every graphed call sent through its
entry are the direct run, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.geometry import se3 as j_se3, sim3 as j_sim3
from multi_orb_slam_tpu.loop import loop_closing as j_lc
from multi_orb_slam_tpu.loop import sim3_solver as j_solver
from multi_orb_slam_tpu.mapping import map_state as j_ms
from multi_orb_slam_tpu.ops import hamming as j_ham
from multi_orb_slam_tpu.optim import global_ba as j_gba
from multi_orb_slam_tpu.placerec import vocabulary as j_voc
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.loop import loop_closing as t_lc
from multi_orb_slam_tpu_torch.loop import sim3_solver as t_solver
from multi_orb_slam_tpu_torch.mapping import fusion as t_fus
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.optim import global_ba as t_gba
from multi_orb_slam_tpu_torch.placerec import vocabulary as t_voc

import test_global_ba
from test_torch_graphs import (_equal, _routed, assert_pure, assert_reads_nothing_back,
                               assert_traced_values)
from test_torch_sim3 import _reference_triplets

torch.set_num_threads(2)


def _t(a):
    return convert._field_to_torch(np.asarray(a), "cpu")


def _state(st):
    return convert.to_torch(st, t_ms.MapState, "cpu")


def _port_cfg(cfg):
    return TCfg(**{f: getattr(cfg, f) for f in TCfg._fields if f != "orb"})


# ---------------------------------------------------------------------------
# the three matching roles against the reference's dense formulas
# ---------------------------------------------------------------------------


def test_word_gated_match_equals_the_masked_dense_matrix():
    """`word_gated_match` (a `window_match` call with the word as the level)
    against `_compute_sim3`'s dense Hamming matrix, word-equality mask and
    `masked_argmin2`: many equal distances, word ids up to 10^6."""
    rng = np.random.RandomState(0)
    Na, Nb = 300, 280
    da = rng.randint(0, 4, (Na, 8)).astype(np.uint32)
    db = rng.randint(0, 4, (Nb, 8)).astype(np.uint32)
    words = rng.choice([3, 17, 999_999, 123_456, 0], 5)
    wa, wb = words[rng.randint(0, 5, Na)], words[rng.randint(0, 5, Nb)]
    has_a, has_b = rng.rand(Na) < 0.8, rng.rand(Nb) < 0.8
    d = j_ham.pairwise_hamming(jnp.asarray(da), jnp.asarray(db))
    cand = (jnp.asarray(has_a)[:, None] & jnp.asarray(has_b)[None, :]
            & (jnp.asarray(wa)[:, None] == jnp.asarray(wb)[None, :]))
    want = j_ham.masked_argmin2(d, cand)
    got = t_lc.word_gated_match(_t(da), _t(has_a), _t(wa.astype(np.int32)),
                                _t(db), _t(has_b), _t(wb.astype(np.int32)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] == t_lc.kernels.BIG).sum()) >= 0.2 * Na


def test_projection_count_equals_the_dense_formula():
    """`count_guided_matches` against `_guided_matches`' dense
    `any(near & d <= TH_LOW)` over [Q, F]."""
    rng = np.random.RandomState(1)
    Q, F = 2000, 300
    uv = rng.uniform(0, 100, (Q, 2)).astype(np.float32)
    # each feature near the query it was copied from (some past 8 px), its
    # descriptor that query's with a few words flipped
    src = rng.randint(0, Q, F)
    fx = (uv[src] + rng.uniform(-10, 10, (F, 2))).astype(np.float32)
    fx[:20] = uv[src[:20]] + 8.0               # on the window's edge: out
    proj_ok, fval = rng.rand(Q) < 0.9, rng.rand(F) < 0.9
    qd = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
    fd = qd[src] ^ (rng.rand(F, 8) < 0.15).astype(np.uint32) * np.uint32(0xFF)
    near = ((np.abs(uv[:, None, 0] - fx[None, :, 0]) < 8.0)
            & (np.abs(uv[:, None, 1] - fx[None, :, 1]) < 8.0) & fval[None] & proj_ok[:, None])
    d = np.asarray(j_ham.pairwise_hamming(jnp.asarray(qd), jnp.asarray(fd)))
    want = int(np.any(near & (d <= j_ham.TH_LOW), axis=1).sum())
    got = t_lc.count_guided_matches(_t(uv), _t(proj_ok), _t(qd), _t(fx), _t(fval), _t(fd))
    assert int(got) == want > 10


# ---------------------------------------------------------------------------
# search_by_sim3 and global BA on a tracked map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tracked():
    tracker, seq, cfg, calib = test_global_ba.build_map()
    return dict(state=tracker.map, seq=seq, cfg=cfg, calib=calib)


def test_search_by_sim3_on_a_tracked_map(tracked):
    st, cfg, calib = tracked["state"], tracked["cfg"], tracked["calib"]
    kfs = [int(k) for k in np.nonzero(np.asarray(st.kf_valid))[0]]
    st_t = _state(st)
    n_found = 0
    for a, b, pert in ((kfs[-1], kfs[0], 0.0), (kfs[1], kfs[0], 0.0), (kfs[-1], kfs[1], 0.01)):
        # g_ab from the two poses (b-rig -> a-rig), optionally perturbed
        g = j_sim3.compose(j_sim3.from_se3(st.kf_Tcw[a]),
                           j_sim3.inverse(j_sim3.from_se3(st.kf_Tcw[b])))
        g = j_sim3.compose(j_sim3.exp(jnp.full((7,), pert).at[6].set(0.0)), g)
        want = np.asarray(j_solver.search_by_sim3(
            st, jnp.asarray(a), jnp.asarray(b), g, calib.K[0], cfg.max_mp,
            cfg.scale_factor, cfg.n_levels))
        got = t_solver.search_by_sim3(st_t, a, b, _t(g), _t(calib.K[0]), cfg.max_mp,
                                      cfg.scale_factor, cfg.n_levels)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{a} {b}")
        n_found += int((want >= 0).sum())
    assert n_found > 100


def _perturbed(state):
    """`test_global_ba.test_gba_reduces_perturbation`'s perturbation."""
    rng = np.random.RandomState(0)
    K = state.kf_Tcw.shape[0]
    pert = np.zeros((K, 6), np.float32)
    pert[1:] = rng.randn(K - 1, 6) * 0.05
    Tcw = jnp.asarray(np.stack([np.asarray(j_se3.exp(jnp.asarray(pert[k])) @ state.kf_Tcw[k])
                                for k in range(K)]))
    pos = state.mp_pos + jnp.asarray(
        rng.randn(*state.mp_pos.shape).astype(np.float32) * 0.05) * state.mp_valid[:, None]
    return state._replace(kf_Tcw=Tcw, mp_pos=pos)


def test_global_ba_on_the_perturbed_map(tracked):
    st, cfg, calib = _perturbed(tracked["state"]), tracked["cfg"], tracked["calib"]
    out_j = j_gba.run_global_ba(st, calib, cfg, n_outer=8)
    st_t = _state(st)
    out_t = t_gba.run_global_ba(st_t, convert.to_torch(calib, t_cam.CameraParams, "cpu"),
                                _port_cfg(cfg), n_outer=8)
    valid = np.asarray(st.kf_valid)
    Tj, Tt = np.asarray(out_j.kf_Tcw), out_t.kf_Tcw.numpy()
    np.testing.assert_allclose(Tt[valid], Tj[valid], atol=1e-4)
    assert np.array_equal(Tt[0], np.asarray(st.kf_Tcw[0]))
    # it did work: the poses moved by far more than the tolerance
    assert np.abs(Tj[valid] - np.asarray(st.kf_Tcw)[valid]).max() > 1e-2
    # points that two or more valid observations hold
    kf_mp = np.where(np.asarray(st.kf_feat_valid) & valid[:, None, None], np.asarray(st.kf_mp), -1)
    n_obs = np.bincount(kf_mp[kf_mp >= 0], minlength=st.mp_pos.shape[0])
    held = np.asarray(st.mp_valid) & (n_obs >= 2)
    assert held.sum() > 300
    np.testing.assert_allclose(out_t.mp_pos.numpy()[held], np.asarray(out_j.mp_pos)[held],
                               atol=1e-3)


def test_run_global_ba_jit_on_the_reference_arrays(tracked):
    """`run_global_ba_jit` on the arrays of the perturbed map (3 outer
    iterations), through both packages: poses to 1e-4, points that two or
    more observations hold to 1e-3 m, as `run_global_ba` is held."""
    st, cfg, calib = _perturbed(tracked["state"]), tracked["cfg"], tracked["calib"]
    state_arrays, calib_arrays, kf_free = t_gba.global_ba_arrays(
        _state(st), convert.to_torch(calib, t_cam.CameraParams, "cpu"), _port_cfg(cfg))
    as_j = lambda xs: tuple(jnp.asarray(x.numpy()) for x in xs)  # noqa: E731
    Tj, pj = j_gba.run_global_ba_jit(as_j(state_arrays), as_j(calib_arrays),
                                     jnp.asarray(kf_free.numpy()), cfg, 3)
    Tt, pt = t_gba.run_global_ba_jit(state_arrays, calib_arrays, kf_free, _port_cfg(cfg), 3)
    valid = np.asarray(st.kf_valid)
    np.testing.assert_allclose(Tt.numpy()[valid], np.asarray(Tj)[valid], atol=1e-4)
    assert np.abs(np.asarray(Tj)[valid] - np.asarray(st.kf_Tcw)[valid]).max() > 1e-2
    kf_mp = state_arrays[2].numpy()
    n_obs = np.bincount(kf_mp[(kf_mp >= 0) & valid[:, None, None]], minlength=st.mp_pos.shape[0])
    held = np.asarray(st.mp_valid) & (n_obs >= 2)
    assert held.sum() > 300
    np.testing.assert_allclose(pt.numpy()[held], np.asarray(pj)[held], atol=1e-3)


# ---------------------------------------------------------------------------
# the GBA merge
# ---------------------------------------------------------------------------


def _merge_case(name):
    """The two scenarios of `test_global_ba.TestAsyncGBAMerge`, as
    reference arrays: (state, args of `_merge_gba`)."""
    exp = lambda v: j_se3.exp(jnp.asarray(v, jnp.float32))  # noqa: E731
    if name == "recycled slot":
        state = j_ms.make_empty(4, 1, 8, 16)
        T_new = exp([0.5, 0.0, 0.0, 0.0, 0.0, 0.0])
        state = state._replace(
            kf_Tcw=state.kf_Tcw.at[1].set(T_new), kf_valid=state.kf_valid.at[:2].set(True),
            kf_frame_id=state.kf_frame_id.at[0].set(0).at[1].set(99),
            n_kf=jnp.asarray(2, jnp.int32))
        return state, (jnp.tile(jnp.eye(4, dtype=jnp.float32), (4, 1, 1)), state.mp_pos,
                       jnp.zeros(4, bool).at[:2].set(True), jnp.asarray([0, 5, -1, -1], jnp.int32),
                       jnp.zeros(16, bool), state.mp_first_frame)
    state = j_ms.make_empty(8, 1, 32, 64)
    Ts = [jnp.eye(4, dtype=jnp.float32), exp([0.1, -0.05, 0.2, 0.02, -0.03, 0.01]),
          exp([0.3, 0.1, -0.1, -0.02, 0.04, 0.05])]
    kf_Tcw = state.kf_Tcw.at[0].set(Ts[0]).at[1].set(Ts[1]).at[2].set(Ts[2])
    kf_mp = np.full((8, 1, 32), -1, np.int32)
    kf_mp[0, 0, :12] = np.arange(12)
    kf_mp[1, 0, :16] = np.arange(16)
    kf_mp[1, 0, 16:20] = np.arange(56, 60)
    kf_mp[2, 0, :16] = np.arange(16)
    kf_mp[2, 0, 16:20] = np.arange(56, 60)
    pos = jnp.asarray(np.random.RandomState(0).uniform(-1, 1, (64, 3)), jnp.float32)
    state = state._replace(
        kf_Tcw=kf_Tcw, kf_mp=jnp.asarray(kf_mp), kf_valid=state.kf_valid.at[:3].set(True),
        kf_frame_id=state.kf_frame_id.at[:3].set(jnp.asarray([0, 10, 20])),
        kf_feat_valid=state.kf_feat_valid.at[:3].set(True), mp_pos=pos,
        mp_valid=state.mp_valid.at[:60].set(True),
        mp_first_kf=state.mp_first_kf.at[:56].set(0).at[56:60].set(2),
        mp_first_frame=state.mp_first_frame.at[:56].set(0).at[56:60].set(20),
        n_kf=jnp.asarray(3, jnp.int32))
    G = exp([0.05, 0.02, -0.04, 0.01, 0.02, -0.01])
    return state, (jnp.einsum("kij,jl->kil", kf_Tcw, j_se3.inverse(G)),
                   pos @ G[:3, :3].T + G[:3, 3], jnp.zeros(8, bool).at[:2].set(True),
                   state.kf_frame_id, jnp.zeros(64, bool).at[:56].set(True), state.mp_first_frame)


@pytest.mark.parametrize("name", ["new keyframe and points", "recycled slot"])
def test_merge_gba(name):
    state, args = _merge_case(name)
    want = j_lc._merge_gba(state, *args)
    st_t = _state(state)
    args_t = [_t(a) for a in args]
    kf_before, mp_before = st_t.kf_Tcw.clone(), st_t.mp_pos.clone()
    got = t_lc.merge_gba(st_t, *args_t)
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(want.kf_Tcw), atol=1e-5)
    np.testing.assert_allclose(got.mp_pos.numpy(), np.asarray(want.mp_pos), atol=1e-5)
    # out of place: the live map's tensors are untouched
    assert torch.equal(st_t.kf_Tcw, kf_before) and torch.equal(st_t.mp_pos, mp_before)
    if name == "recycled slot":      # slot 1 holds another keyframe now: not overwritten
        assert torch.equal(got.kf_Tcw[1], kf_before[1])
    else:                            # the child follows its parent's rigid move
        np.testing.assert_allclose(got.kf_Tcw[2].numpy(), (kf_before[2] @ torch.linalg.inv(
            kf_before[1]) @ args_t[0][1]).numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# Sim3 verification and loop correction on a drifted map
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def drifted():
    return _drifted_map()


def _drifted_map():
    """`test_loop_e2e.test_correct_loop_reduces_drift`'s map: 15 frames, the
    last keyframe's frame id moved 100 frames on so that the first keyframe
    is old enough to close on; `state` has its pose moved by a known drift,
    `clean` has not."""
    from multi_orb_slam_tpu.frontend import tracking
    from multi_orb_slam_tpu.io import synthetic
    from multi_orb_slam_tpu.mapping import local_mapping
    from test_tracking import small_calib, small_cfg

    calib = small_calib()
    cfg = small_cfg()._replace(max_frames_kf=3)
    seq = synthetic.make_sequence(n_frames=15, K=np.asarray(calib.K[0]), height=240, width=320,
                                  n_points=2500)
    tr = tracking.Tracker(calib, cfg)
    tr.kf_inserted_cb = lambda k: local_mapping.run_mapping_stage(
        tr.map, k, tr.frame_id, calib, cfg, do_ba=False, do_cull=False)
    for g, d in zip(seq.grays, seq.depths):
        tr.process(g, d)
    state = tr.map
    fids = np.asarray(state.kf_frame_id)
    order = sorted(np.nonzero(np.asarray(state.kf_valid))[0], key=lambda k: fids[k])
    kf_b, kf_a = int(order[0]), int(order[-1])
    drift = j_se3.exp(jnp.asarray([0.15, -0.1, 0.08, 0.02, -0.04, 0.03]))
    Tcw_a = state.kf_Tcw[kf_a]
    state = state._replace(kf_frame_id=state.kf_frame_id.at[kf_a].add(100))
    state_d = state._replace(kf_Tcw=state.kf_Tcw.at[kf_a].set(drift @ Tcw_a))
    g_ab = j_sim3.compose(j_sim3.from_se3(Tcw_a), j_sim3.inverse(j_sim3.from_se3(state.kf_Tcw[kf_b])))
    train = np.asarray(state.kf_desc)[np.asarray(state.kf_feat_valid)]
    return dict(state=state_d, clean=state, Tcw_a=np.asarray(Tcw_a), kf_a=kf_a, kf_b=kf_b, g_ab=g_ab,
                calib=calib, cfg=cfg, train=train)


def _closers(d, run_gba=False):
    lj = j_lc.LoopCloser(d["calib"], d["cfg"], run_gba=run_gba)
    lt = t_lc.LoopCloser(convert.to_torch(d["calib"], t_cam.CameraParams, "cpu"),
                         _port_cfg(d["cfg"]), run_gba=run_gba)
    return lj, lt


def _pose_err(T, T_true):
    return float(np.linalg.norm(np.asarray(j_se3.log(jnp.asarray(T) @ j_se3.inverse(
        jnp.asarray(T_true))))))


def test_correct_loop_on_the_drifted_map(drifted):
    d = drifted
    lj, lt = _closers(d)
    a, b = d["kf_a"], d["kf_b"]
    out_j = lj._correct_loop(d["state"], a, b, d["g_ab"])
    st_t = _state(d["state"])
    before = st_t.kf_Tcw.clone()
    out_t = lt._correct_loop(st_t, a, b, _t(d["g_ab"]))
    assert torch.equal(st_t.kf_Tcw, before)          # the input map is not written
    valid = np.asarray(out_j.kf_valid)
    np.testing.assert_allclose(out_t.kf_Tcw.numpy()[valid], np.asarray(out_j.kf_Tcw)[valid],
                               atol=1e-3)
    np.testing.assert_array_equal(out_t.kf_mp.numpy(), np.asarray(out_j.kf_mp))
    e_before = _pose_err(np.asarray(d["state"].kf_Tcw[a]), d["Tcw_a"])
    for out in (np.asarray(out_j.kf_Tcw[a]), out_t.kf_Tcw[a].numpy()):
        assert _pose_err(out, d["Tcw_a"]) < 0.35 * e_before
    assert lt.loop_pairs == lj.loop_pairs == [(a, b)]


def test_second_loop_supersedes_the_pending_gba(drifted):
    """Two `_correct_loop` calls on one map with the first loop's GBA still
    pending (no keyframe boundary, so no merge, between them): in both
    packages the loop pairs accumulate alike, the second dispatch replaces
    the first (dropped, never merged), the second map's poses agree to
    1e-3, and the merge at the next boundary folds in the second GBA only."""
    d = drifted
    lj, lt = _closers(d, run_gba=True)
    a, b, clean = d["kf_a"], d["kf_b"], d["clean"]
    fids = np.asarray(clean.kf_frame_id)
    order = sorted(np.nonzero(np.asarray(clean.kf_valid))[0], key=lambda k: fids[k])
    a2 = int(order[-2])       # the keyframe before kf_a closes on kf_b too
    g_ab2 = j_sim3.compose(j_sim3.from_se3(clean.kf_Tcw[a2]),
                           j_sim3.inverse(j_sim3.from_se3(clean.kf_Tcw[b])))
    out1_j = lj._correct_loop(d["state"], a, b, d["g_ab"])
    first_j = lj._gba_pending
    out2_j = lj._correct_loop(out1_j, a2, b, g_ab2)
    out1_t = lt._correct_loop(_state(d["state"]), a, b, _t(d["g_ab"]))
    first_t = lt._gba_pending
    out2_t = lt._correct_loop(out1_t, a2, b, _t(g_ab2))
    assert lt.loop_pairs == lj.loop_pairs == [(a, b), (a2, b)]
    for lc, first in ((lj, first_j), (lt, first_t)):
        assert lc.n_gba_merged == 0
        assert lc._gba_pending is not None and lc._gba_pending is not first
    valid = np.asarray(out2_j.kf_valid)
    np.testing.assert_allclose(out2_t.kf_Tcw.numpy()[valid], np.asarray(out2_j.kf_Tcw)[valid],
                               atol=1e-3)
    # the pending GBA is the second map's, in both: its snapshot and poses
    for k, name in ((2, "kf_valid"), (3, "kf_frame_id"), (4, "mp_valid")):
        np.testing.assert_array_equal(lt._gba_pending[k].numpy(), np.asarray(lj._gba_pending[k]))
        np.testing.assert_array_equal(lt._gba_pending[k].numpy(),
                                      np.asarray(getattr(out2_j, name)))
    np.testing.assert_allclose(lt._gba_pending[0].numpy()[valid],
                               np.asarray(lj._gba_pending[0])[valid], atol=1e-3)
    second_t = lt._gba_pending
    merged_j, merged_t = lj.merge_pending_gba(out2_j), lt.merge_pending_gba(out2_t)
    assert lj.n_gba_merged == lt.n_gba_merged == 1
    assert lj._gba_pending is None and lt._gba_pending is None
    np.testing.assert_allclose(merged_t.kf_Tcw.numpy()[valid], np.asarray(merged_j.kf_Tcw)[valid],
                               atol=1e-3)
    # the merge took the second GBA's poses, not the superseded first's
    assert torch.equal(merged_t.kf_Tcw, t_lc.merge_gba(out2_t, *second_t).kf_Tcw)
    assert not torch.equal(merged_t.kf_Tcw, t_lc.merge_gba(out2_t, *first_t).kf_Tcw)


def test_compute_sim3_with_the_reference_triplets(drifted):
    d = drifted
    lj, lt = _closers(d)
    lj.voc = j_voc.build_vocabulary(d["train"], k=10, depth=3)
    lt.voc = t_voc.build_vocabulary(d["train"], k=10, depth=3, device="cpu")
    lt.triplet_source = lambda valid, a, b: torch.from_numpy(_reference_triplets(
        jax.random.PRNGKey(a * 1000 + b), jnp.asarray(valid.numpy()))).long()
    a, b = d["kf_a"], d["kf_b"]
    want = lj._compute_sim3(d["clean"], a, [b])
    got = lt._compute_sim3(_state(d["clean"]), a, [b])
    assert want is not None and got is not None
    assert got[0] == want[0] == b and got[2] == want[2] >= t_lc.MIN_TOTAL_MATCHES
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-3)
    rec = lt.verifications[-1]
    assert rec["accepted"] and rec["total"] == got[2]
    assert rec["bow"] >= t_lc.MIN_MATCHES_BOW
    assert min(rec["ransac"], rec["lm"]) >= t_lc.MIN_INLIERS_SIM3
    # the Sim3 is the keyframes' relative pose, to the map's own accuracy
    assert np.abs(got[1].numpy() - np.asarray(d["g_ab"]))[:7].max() < 0.1
    # with the last keyframe's pose drifted and its points not, the Sim3 LM
    # keeps too few inliers: both packages reject the candidate alike
    assert lj._compute_sim3(d["state"], a, [b]) is None
    assert lt._compute_sim3(_state(d["state"]), a, [b]) is None
    assert lt.verifications[-1]["lm"] < t_lc.MIN_INLIERS_SIM3


# ---------------------------------------------------------------------------
# the facade: the correction queued on the closing keyframe
# ---------------------------------------------------------------------------


def test_loop_correction_moves_the_live_pose(monkeypatch):
    """`System._on_keyframe` queues inv(T_before) @ T_after of the closing
    keyframe for the live tracking pose.  A loop stage that writes the pose
    tensor in place must not turn that into the identity: the pose from
    before the loop stage is a copy, not a view."""
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.geometry import se3

    cfg = TCfg(n_cams=1, max_feat=16, max_kf=8, max_mp=64, width=320, height=240)
    calib = t_cam.CameraParams(
        K=torch.tensor([[260.0, 260.0, 160.0, 120.0]]), dist=torch.zeros((1, 5)),
        T_rc=torch.eye(4)[None], bf=torch.tensor(20.0), width=320, height=240)
    sys_ = system_mod.System(sensor=system_mod.Sensor.RGBD, calib=calib, cfg=cfg, device="cpu")
    monkeypatch.setattr(system_mod.local_mapping, "run_mapping_stage", lambda m, *a, **k: m)
    T_old = se3.exp(torch.tensor([0.1, 0.0, 0.2, 0.0, 0.05, 0.0]))
    T_new = se3.exp(torch.tensor([0.3, -0.1, 0.2, 0.02, 0.05, 0.0]))
    m = sys_.tracker.map
    sys_.tracker.map = m._replace(kf_Tcw=m.kf_Tcw.clone().index_put_(
        (torch.tensor([2]),), T_old[None]))

    def close_in_place(state, kf_slot):
        state.kf_Tcw[kf_slot] = T_new          # an in-place write
        sys_.loop_closer.n_loops_closed += 1
        return state

    monkeypatch.setattr(sys_.loop_closer, "process_keyframe", close_in_place)
    sys_._on_keyframe(2)
    D = sys_.tracker._pending_pose_corr
    assert D is not None and not torch.allclose(D, torch.eye(4), atol=1e-3)
    torch.testing.assert_close(D, se3.inverse(T_old) @ T_new)


# ---------------------------------------------------------------------------
# the loop stage's graphed functions (one CUDA graph replay a call on the
# card), driven through their entries on the CPU
# ---------------------------------------------------------------------------

LOOP_GRAPHED = ("word_match_stage", "search_by_sim3", "guided_count_stage",
                "run_global_ba_arrays", "merge_gba", "fuse_into_kfs")


@pytest.fixture(scope="module")
def loop_voc(drifted):
    return t_voc.build_vocabulary(drifted["train"], k=10, depth=3, device="cpu")


def _search_args(tracked, a, b):
    st, cfg, calib = tracked["state"], tracked["cfg"], tracked["calib"]
    g = j_sim3.compose(j_sim3.from_se3(st.kf_Tcw[a]), j_sim3.inverse(j_sim3.from_se3(st.kf_Tcw[b])))
    return (_state(st), a, b, _t(g), _t(calib.K[0]), cfg.max_mp, cfg.scale_factor, cfg.n_levels)


@pytest.fixture(scope="module")
def loop_calls(tracked, drifted, loop_voc):
    """{name: (graphed function, arguments, other arguments of the same
    signature)}: the search and the global BA on the tracked map (BA on its
    perturbed copy, 3 outer iterations), the word match and the projection
    count on the drifted map's loop pair and on another candidate, the merge
    on `test_merge_gba`'s first case with two snapshots of `old_kf`."""
    kfs = [int(k) for k in np.nonzero(np.asarray(tracked["state"].kf_valid))[0]]
    d = drifted
    clean, a, b = _state(d["clean"]), d["kf_a"], d["kf_b"]
    fids = clean.kf_frame_id.numpy()
    b2 = int(sorted(np.nonzero(clean.kf_valid.numpy())[0], key=lambda k: fids[k])[1])
    cal_d, cfg_d = convert.to_torch(d["calib"], t_cam.CameraParams, "cpu"), _port_cfg(d["cfg"])
    cfg_t = _port_cfg(tracked["cfg"])
    gba = t_gba.global_ba_arrays(_state(_perturbed(tracked["state"])),
                                 convert.to_torch(tracked["calib"], t_cam.CameraParams, "cpu"),
                                 cfg_t)
    state, args = _merge_case("new keyframe and points")
    merge = (_state(state),) + tuple(_t(x) for x in args)
    return {
        "fuse_into_kfs": (t_fus.fuse_into_kfs, _loop_fusion_args(d), None),
        "search_by_sim3": (t_solver.search_by_sim3, _search_args(tracked, kfs[-1], kfs[0]),
                           _search_args(tracked, kfs[1], kfs[0])),
        "word_match_stage": (t_lc.word_match_stage, (clean.kf_desc, clean.kf_mp,
                                                     clean.kf_feat_valid, loop_voc, a, b),
                             (clean.kf_desc, clean.kf_mp, clean.kf_feat_valid, loop_voc, a, b2)),
        "guided_count_stage": (t_lc.guided_count_stage, (clean, a, b, _t(d["g_ab"]), cal_d, cfg_d),
                               (clean, a, b2, _t(d["g_ab"]), cal_d, cfg_d)),
        "run_global_ba_arrays": (t_gba.run_global_ba_arrays, gba + (cfg_t, 3), None),
        "merge_gba": (t_lc.merge_gba, merge,
                      merge[:3] + (torch.tensor([True] + [False] * 7),) + merge[4:]),
    }


def _loop_fusion_args(d):
    """`_correct_loop`'s fusion on the drifted map: the loop keyframe b's
    points into a and its camera-0 covisibility neighbourhood (weight >= 15),
    padded to FUSE_CAP slots with the dummy K - 1."""
    state, a, b = _state(d["state"]), d["kf_a"], d["kf_b"]
    K, M = state.kf_mp.shape[0], state.mp_pos.shape[0]
    W = t_ms.covisibility(state, cam0_only=True).numpy()
    slots = [a] + [int(n) for n in np.nonzero(W[a] >= 15.0)[0] if n != a]
    slots = torch.tensor((slots + [K - 1] * t_lc.FUSE_CAP)[:t_lc.FUSE_CAP])
    mp_b = state.kf_mp[b].reshape(-1)
    mask = torch.zeros(M, dtype=torch.bool)
    mask[mp_b[mp_b >= 0].long()] = True
    return (state, mask, slots, _port_cfg(d["cfg"]),
            convert.to_torch(d["calib"], t_cam.CameraParams, "cpu"))


def test_loop_fusion_entry_is_its_body(loop_calls):
    """`fuse_into_kfs` through its entry (the card's route but for the
    graph) gives its body's bits on the loop's inputs, and it merges."""
    fn, args, _ = loop_calls["fuse_into_kfs"]
    out = fn.entry(*args).run(*args)
    assert _equal(out, fn.__wrapped__(*args))
    assert int(out[1]) >= 0 and int(out[0].n_mp) <= int(args[0].n_mp)


@pytest.mark.parametrize("name", LOOP_GRAPHED)
def test_loop_graphed_function_leaves_inputs_unchanged(loop_calls, name):
    assert_pure(*loop_calls[name][:2])


@pytest.mark.parametrize("name", LOOP_GRAPHED)
def test_loop_graphed_function_reads_nothing_back(loop_calls, monkeypatch, name):
    assert_reads_nothing_back(monkeypatch, *loop_calls[name][:2])


@pytest.mark.parametrize("name", ["search_by_sim3", "word_match_stage", "guided_count_stage",
                                  "merge_gba"])
def test_loop_graphed_function_takes_each_input_through_one_entry(loop_calls, name):
    """Two keyframe pairs (traced slots), or for the merge two snapshots of
    the keyframes that existed at launch: one entry, each the direct call's
    result."""
    fn, args, other = loop_calls[name]
    assert_traced_values(fn, [args, other])


def test_loop_stage_through_entries_is_the_direct_run(drifted, loop_voc):
    """`_compute_sim3` on the clean map (the reference's RANSAC triplets, as
    `test_compute_sim3_with_the_reference_triplets`), `_correct_loop` on the
    drifted one with the global BA dispatched, and its merge, once directly
    and once with every graphed call sent through its entry, as on the card:
    the same bits, the same verification record, one entry a function."""
    d = drifted
    a, b = d["kf_a"], d["kf_b"]

    def run():
        _, lt = _closers(d, run_gba=True)
        lt.voc = loop_voc
        lt.triplet_source = lambda valid, ka, kb: torch.from_numpy(_reference_triplets(
            jax.random.PRNGKey(ka * 1000 + kb), jnp.asarray(valid.numpy()))).long()
        found = lt._compute_sim3(_state(d["clean"]), a, [b])
        corrected = lt._correct_loop(_state(d["state"]), a, b, _t(d["g_ab"]))
        return found, corrected, lt.merge_pending_gba(corrected), lt.verifications

    direct = run()
    routed, used = _routed(run)
    assert direct[0] is not None and direct[0][0] == routed[0][0] == b
    assert direct[0][2] == routed[0][2] and torch.equal(direct[0][1], routed[0][1])
    assert _equal(direct[1], routed[1]) and _equal(direct[2], routed[2])
    assert direct[3] == routed[3] and routed[3][-1]["accepted"]
    assert set(used) == {"word_match_stage", "solve_sim3", "search_by_sim3", "optimize_sim3",
                         "guided_count_stage", "fuse_into_kfs", "optimize_essential_graph",
                         "run_global_ba_arrays", "merge_gba"}, used
    assert all(n <= 1 and c == 1 for n, c in used.values()), used


def test_map_point_information_is_the_distributed_bas(tracked):
    """`global_ba.map_point_information` (the metric the card holds two
    global BA solutions' points in) against `dist_ba.point_information` on
    the same problem flattened at world 1: each point's H_pp, summed over
    its observations in another order, to 1e-4 of its scale; symmetric."""
    from multi_orb_slam_tpu_torch.parallel import dist_ba

    st = _state(_perturbed(tracked["state"]))
    cal = convert.to_torch(tracked["calib"], t_cam.CameraParams, "cpu")
    state_arrays, calib_arrays, kf_free = t_gba.global_ba_arrays(st, cal, _port_cfg(
        tracked["cfg"]))
    H = t_gba.map_point_information(state_arrays, calib_arrays, st.kf_Tcw, st.mp_pos)
    Tcw, kf_valid, kf_mp, uvr, is2, pos, mp_valid = state_arrays
    flat = dist_ba.flatten_problem(Tcw.numpy(), kf_valid.numpy(), kf_free.numpy(), kf_mp.numpy(),
                                   uvr.numpy(), is2.numpy(), pos.numpy(), mp_valid.numpy(), 1)
    H_dist = dist_ba.point_information(dist_ba.FlatBA(*(torch.from_numpy(a) for a in flat)),
                                       *calib_arrays, st.kf_Tcw, st.mp_pos)
    scale = H.abs().amax(dim=(1, 2), keepdim=True) + 1e-9
    assert float(((H - H_dist).abs() / scale).max()) < 1e-4
    assert torch.allclose(H, H.transpose(1, 2), atol=1e-3)
    assert int((H.abs().amax(dim=(1, 2)) > 0).sum()) > 300
