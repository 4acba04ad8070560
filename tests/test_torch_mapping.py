"""PyTorch port vs JAX reference: the mapping slice.

One JAX `Tracker` run with the mapping callback set as `bench.py` sets it
(mapping stage, then `covis_kf_count` as the next keyframe's window hint)
over the small dual rig of `tests/test_torch_tracking.py` is shared by every
test.  The `MapState` just before the mapping stage of the last keyframe
(`n_kf > 2`) is carried across with `convert.to_torch`, and each stage of the
port is held against its JAX counterpart ON THE JAX STAGE'S INPUT, so that
differences do not compound:

- integer and boolean fields (observations, validity, counters, slots) equal;
- float fields to atol 1e-4; new-point positions, one closed-form two-ray
  midpoint per point in float32, to atol 1e-4 on >= 85% of the points and
  1e-3 on all (the parallax gate admits 1.1 degrees, where the midpoint's
  depth amplifies round-off in the ray directions some fifty times: against
  the same formula in float64 either package is off by up to 3e-4 m);
  normals and depth ranges, scatter-added sums in another order, atol 1e-5;
- `build_local_problem`: every field equal (poses / positions are copies);
- the slice as a whole, `run_mapping_stage`: the same keyframes valid, the
  same `n_kf`, `n_mp` within 1%, keyframe poses atol 1e-3 (a float32 LM
  solve over 24 keyframes whose dense solve pivots in another order);
- the port's `Tracker` with the mapping callback over the sequence: every
  frame tracked, the same keyframe count as the JAX run, camera centres
  within 5 mm of it.  The reference run is unpipelined (the callback runs
  in the keyframe's own frame), so the 5 mm hold for the port's unpipelined
  tracker; pipelined at depth 3, as `chip_smoke.py` runs it, the callback
  runs three frames later and the centres are held to 2 cm and ATE < 0.05 m.

The stepwise path's functions are graph entries, as the reference jits them
(`cull_map_points`, `triangulate_new_points`, `fuse_neighbors`,
`build_local_problem`, `solve_ba_jit`, `apply_ba_result`, `cull_keyframes`,
`update_point_geometry`): through its entry each leaves its inputs
bit-unchanged, reads nothing back and gives its body's bits; and
`run_mapping_stage` with each stage switched off, every graphed call sent
through its entry, is the direct run to the bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.config import SlamConfig as JCfg
from multi_orb_slam_tpu.frontend import tracking as j_tr
from multi_orb_slam_tpu.geometry import camera as j_cam
from multi_orb_slam_tpu.geometry import se3 as j_se3
from multi_orb_slam_tpu.io import synthetic
from multi_orb_slam_tpu.mapping import fusion as j_fus
from multi_orb_slam_tpu.mapping import local_mapping as j_lm
from multi_orb_slam_tpu.mapping import map_state as j_ms
from multi_orb_slam_tpu.mapping import triangulation as j_tri
from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.frontend import tracking as t_tr
from multi_orb_slam_tpu_torch.geometry import align as t_align
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.mapping import fusion as t_fus
from multi_orb_slam_tpu_torch.mapping import local_mapping as t_lm
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.mapping import triangulation as t_tri
from multi_orb_slam_tpu_torch.ops import orb as t_orb
from multi_orb_slam_tpu_torch.optim import local_ba as t_ba
from test_torch_fused import _NoHostRead, _raiser
from test_torch_graphs import _equal, _routed, assert_pure, assert_reads_nothing_back

torch.set_num_threads(2)
C, H, W, NF, N_FRAMES = 2, 240, 320, 512, 14
CFG_KW = dict(n_cams=C, max_feat=NF, max_kf=32, max_mp=12288, local_cap=2048,
              new_mp_per_cam=128, width=W, height=H, th_depth=6.0, max_frames_kf=4)


def _centers(poses):
    return np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in poses])


def _tstate(jstate):
    return convert.to_torch(jstate, t_ms.MapState, "cpu")


def _assert_same(j, t, atol=1e-4, skip=(), only=None):
    """Field-wise comparison of a reference tuple and the port's."""
    for name in (only or j._fields):
        if name in skip:
            continue
        a = np.asarray(getattr(j, name))
        b = convert.to_numpy(t)[name]
        assert a.shape == b.shape, name
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, atol=atol, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _mapping_cb(tracker, lm, cfg, calib, count, snaps=None):
    """The keyframe callback of `bench.py`, for either package."""
    pending = [None]

    def cb(kf_slot):
        hint = int(pending[0]) if pending[0] is not None else None
        if snaps is not None:
            snaps.append(dict(state=tracker.map, kf=int(kf_slot),
                              fid=int(tracker.frame_id), hint=hint))
        m = lm.run_mapping_stage(tracker.map, kf_slot, tracker.frame_id, calib, cfg,
                                 covis_hint=hint)
        pending[0] = count(m, kf_slot)
        return m

    return cb


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
    snaps = []
    tracker.kf_inserted_cb = _mapping_cb(
        tracker, j_lm, jcfg, jcal,
        lambda m, k: j_lm.covis_kf_count(m, jnp.asarray(k, jnp.int32)), snaps)
    for g, d in zip(seq.grays, seq.depths):
        tracker.process(g, d)
    traj = tracker.absolute_trajectory()
    assert all(not lost for *_, lost in traj)
    snap = [s for s in snaps if int(s["state"].n_kf) > 2][-1]
    early = [s for s in snaps if int(s["state"].n_kf) <= 2][0]
    tcfg = TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF))
    return dict(jcal=jcal, jcfg=jcfg, tcfg=tcfg, tcal=convert.to_torch(jcal, t_cam.CameraParams, "cpu"),
                seq=seq, snap=snap, early=early, n_kf=int(tracker.map.n_kf), n_mapped=len(snaps),
                centers=_centers([T for _, _, T, _ in traj]))


@pytest.fixture(scope="module")
def stages(ref_run):
    """The reference's stage-by-stage states from the snapshot on."""
    s, jcfg, jcal = ref_run["snap"], ref_run["jcfg"], ref_run["jcal"]
    kf = jnp.asarray(s["kf"], jnp.int32)
    s0 = s["state"]
    s1 = j_lm.cull_map_points(s0, jnp.asarray(s["fid"], jnp.int32), jcfg)
    s2, n_tri = j_tri.triangulate_new_points(s1, s["kf"], jcal, jcfg)
    s3, n_fused = j_fus.fuse_neighbors(s2, s["kf"], jcal, jcfg)
    prob = j_lm.build_local_problem(s3, kf, jcfg, 12, 12)
    sol = j_lm.solve_ba_jit(prob, jcal.T_rc, jcal.K, jcal.bf, ((5, True), (8, False)))
    s4 = j_lm.apply_ba_result(s3, prob, *sol, jcfg)
    s5 = j_lm.cull_keyframes(s4, kf, jcfg)
    s6 = j_tr.update_point_geometry(s5, jcfg)
    return dict(kf=s["kf"], fid=s["fid"], s0=s0, s1=s1, s2=s2, s3=s3, s4=s4, s5=s5, s6=s6,
                n_tri=int(n_tri), n_fused=int(n_fused), prob=prob, sol=sol)


def test_cull_map_points(ref_run, stages):
    out = t_lm.cull_map_points(_tstate(stages["s0"]), stages["fid"], ref_run["tcfg"])
    _assert_same(stages["s1"], out)


def test_triangulate_new_points(ref_run, stages):
    out, n = t_tri.triangulate_new_points(
        _tstate(stages["s1"]), stages["kf"], ref_run["tcal"], ref_run["tcfg"])
    assert stages["n_tri"] > 20, "the scenario must triangulate"
    assert int(n) == stages["n_tri"]
    _assert_same(stages["s2"], out, atol=1e-3)
    new = np.asarray(stages["s2"].mp_valid) & ~np.asarray(stages["s1"].mp_valid)
    err = np.abs(out.mp_pos.numpy() - np.asarray(stages["s2"].mp_pos))[new].max(axis=1)
    assert new.sum() == stages["n_tri"] and (err <= 1e-4).mean() >= 0.85, err.max()


def test_fuse_neighbors(ref_run, stages):
    out, n = t_fus.fuse_neighbors(
        _tstate(stages["s2"]), stages["kf"], ref_run["tcal"], ref_run["tcfg"])
    assert stages["n_fused"] > 0, "the scenario must merge"
    assert int(n) == stages["n_fused"]
    _assert_same(stages["s3"], out)


def test_fuse_into_kfs_matches_reference(ref_run, stages):
    """The batched entry point (search inside each step, padding slots)."""
    s2, kf = stages["s2"], stages["kf"]
    K = s2.kf_mp.shape[0]
    own = np.asarray(s2.kf_mp[kf]).reshape(-1)
    mask = np.zeros(s2.mp_pos.shape[0], bool)
    mask[own[own >= 0]] = True
    Wc = np.asarray(j_ms.covisibility(s2))
    nbrs = [int(n) for n in np.argsort(-Wc[kf], kind="stable")[:2] if Wc[kf][n] > 0]
    slots = np.array(nbrs + [K - 1], np.int32)
    out_j, n_j = j_fus.fuse_into_kfs(s2, jnp.asarray(mask), jnp.asarray(slots),
                                     ref_run["jcfg"], ref_run["jcal"])
    out_t, n_t = t_fus.fuse_into_kfs(_tstate(s2), torch.from_numpy(mask),
                                     torch.from_numpy(slots), ref_run["tcfg"], ref_run["tcal"])
    assert int(n_j) > 0 and int(n_t) == int(n_j)
    _assert_same(out_j, out_t)
    one_j, _ = j_fus.fuse_into_kf(s2, jnp.asarray(mask), jnp.asarray(nbrs[0]),
                                  ref_run["jcfg"], ref_run["jcal"])
    one_t, _ = t_fus.fuse_into_kf(_tstate(s2), torch.from_numpy(mask), nbrs[0],
                                  ref_run["tcfg"], ref_run["tcal"])
    _assert_same(one_j, one_t)


def test_build_local_problem(ref_run, stages):
    prob = t_lm.build_local_problem(_tstate(stages["s3"]), stages["kf"], ref_run["tcfg"], 12, 12)
    jp = stages["prob"]
    assert int(np.asarray(jp.kf_valid).sum()) > 2 and int(np.asarray(jp.mp_valid).sum()) > 100
    _assert_same(jp, prob, atol=0.0)


def test_apply_ba_result(ref_run, stages):
    tprob = convert.to_torch(stages["prob"], t_ba.BAProblem, "cpu")
    sol = [torch.from_numpy(np.asarray(x).copy()) for x in stages["sol"]]
    out = t_lm.apply_ba_result(_tstate(stages["s3"]), tprob, *sol, ref_run["tcfg"])
    _assert_same(stages["s4"], out, atol=0.0)


def test_run_local_ba(ref_run, stages):
    """build -> solve -> apply on one state: the free keyframes move as the
    reference's do (atol 1e-3), the same observations are erased but for
    those whose chi2 sits on its gate (<= 0.5% of them)."""
    out = t_lm.run_local_ba(_tstate(stages["s3"]), stages["kf"], ref_run["tcal"],
                            ref_run["tcfg"], n_free=12, n_fixed=12)
    s4 = stages["s4"]
    np.testing.assert_allclose(out.kf_Tcw.numpy(), np.asarray(s4.kf_Tcw), atol=1e-3)
    assert not np.array_equal(np.asarray(s4.kf_Tcw), np.asarray(stages["s3"].kf_Tcw))
    # points that two or more observations still hold (one mono ray, or
    # none, leaves the depth to round-off)
    n_obs = np.bincount(np.asarray(s4.kf_mp)[np.asarray(s4.kf_mp) >= 0],
                        minlength=s4.mp_pos.shape[0])
    held = np.asarray(s4.mp_valid) & (n_obs >= 2)
    assert held.sum() > 500
    np.testing.assert_allclose(out.mp_pos.numpy()[held], np.asarray(s4.mp_pos)[held], atol=5e-3)
    assert (out.kf_mp.numpy() != np.asarray(s4.kf_mp)).mean() <= 0.005


def _redundant_kfs(ms, levels):
    """5 keyframes observing the same 16 close points (the reference's
    keyframe-culling scenarios): numpy fields for `make_empty(8, 1, 16, 128)`."""
    kf_mp = np.full((8, 1, 16), -1, np.int32)
    kf_level = np.zeros((8, 1, 16), np.int32)
    kf_depth = np.zeros((8, 1, 16), np.float32)
    kf_mp[:5, 0, :] = np.arange(16)
    for k in range(5):
        kf_level[k, 0, :] = levels[k]
    kf_depth[:5] = 1.0
    valid5 = np.arange(8) < 5
    return dict(kf_mp=kf_mp, kf_level=kf_level, kf_depth=kf_depth, kf_valid=valid5,
                kf_feat_valid=np.broadcast_to(valid5[:, None, None], (8, 1, 16)).copy(),
                mp_valid=np.arange(128) < 16, n_kf=np.asarray(5, np.int32))


@pytest.mark.parametrize("levels,expect_valid", [
    ((0, 0, 0, 0, 0), None),                       # serial: two culled, not three
    ((3, 0, 3, 3, 0), (True, True, False, False, True)),   # octave condition
])
def test_cull_keyframes_synthetic(ref_run, levels, expect_valid):
    fields = _redundant_kfs(j_ms, levels)
    js = j_ms.make_empty(8, 1, 16, 128)._replace(**{k: jnp.asarray(v) for k, v in fields.items()})
    ts = t_ms.make_empty(8, 1, 16, 128, device="cpu")._replace(
        **{k: torch.from_numpy(np.asarray(v).copy()) for k, v in fields.items()})
    jcfg = ref_run["jcfg"]._replace(n_cams=1, max_feat=16, max_kf=8, max_mp=128)
    tcfg = ref_run["tcfg"]._replace(n_cams=1, max_feat=16, max_kf=8, max_mp=128)
    out_j = j_lm.cull_keyframes(js, jnp.asarray(4, jnp.int32), jcfg)
    out_t = t_lm.cull_keyframes(ts, 4, tcfg)
    assert int(out_j.n_kf) == 3
    _assert_same(out_j, out_t, only=("kf_valid", "kf_mp", "n_kf"))
    if expect_valid is not None:
        assert tuple(out_t.kf_valid[:5].tolist()) == expect_valid


def test_cull_keyframes_on_map(ref_run, stages):
    out = t_lm.cull_keyframes(_tstate(stages["s4"]), stages["kf"], ref_run["tcfg"])
    _assert_same(stages["s5"], out, atol=0.0)


def test_covis_kf_count(ref_run, stages):
    for name in ("s0", "s5"):
        want = int(j_lm.covis_kf_count(stages[name], jnp.asarray(stages["kf"], jnp.int32)))
        assert int(t_lm.covis_kf_count(_tstate(stages[name]), stages["kf"])) == want
    assert want >= 2


def test_update_point_geometry(ref_run, stages):
    out = t_tr.update_point_geometry(_tstate(stages["s5"]), ref_run["tcfg"])
    _assert_same(stages["s6"], out, atol=1e-5)
    assert not np.array_equal(np.asarray(stages["s6"].mp_normal), np.asarray(stages["s5"].mp_normal))


def test_map_state_functions(ref_run, stages):
    """`mp_weighted_obs`, `kf_tracked_points`, `relieve_capacity`."""
    s5 = stages["s5"]
    ts = _tstate(s5)
    np.testing.assert_array_equal(t_ms.mp_weighted_obs(ts).numpy(),
                                  np.asarray(j_ms.mp_weighted_obs(s5)))
    for min_obs in (1, 3):
        want = int(j_ms.kf_tracked_points(s5, jnp.asarray(stages["kf"], jnp.int32),
                                          jnp.asarray(min_obs, jnp.int32)))
        assert int(t_ms.kf_tracked_points(ts, stages["kf"], min_obs)) == want
    assert want > 50
    # ask for more free slots than there are: the weakest unprotected
    # points go, in the same order
    M = s5.mp_pos.shape[0]
    target = int(M - int(s5.n_mp) + 200)
    out_j = j_ms.relieve_capacity(s5, target)
    out_t = t_ms.relieve_capacity(ts, target)
    _assert_same(out_j, out_t, atol=0.0)


def test_run_mapping_stage(ref_run, stages):
    """The slice as a whole, on the snapshot, all stages on."""
    s = ref_run["snap"]
    out_j = j_lm.run_mapping_stage(s["state"], s["kf"], s["fid"], ref_run["jcal"],
                                   ref_run["jcfg"], covis_hint=s["hint"])
    before = t_lm.BA_WINDOWS.read()
    out_t = t_lm.run_mapping_stage(_tstate(s["state"]), s["kf"], s["fid"], ref_run["tcal"],
                                   ref_run["tcfg"], covis_hint=s["hint"])
    assert sum(t_lm.BA_WINDOWS.read().values()) == sum(before.values()) + 1
    _hold_stage(out_j, out_t)


def _hold_stage(out_j, out_t):
    """The slice's tolerances (`test_run_mapping_stage`)."""
    _assert_same(out_j, out_t, only=("kf_valid", "n_kf", "mp_replaced"))
    assert abs(int(out_t.n_mp) - int(out_j.n_mp)) <= 0.01 * int(out_j.n_mp)
    np.testing.assert_allclose(out_t.kf_Tcw.numpy(), np.asarray(out_j.kf_Tcw), atol=1e-3)
    assert (out_t.kf_mp.numpy() == np.asarray(out_j.kf_mp)).mean() >= 0.995
    assert torch.isfinite(out_t.mp_pos).all() and torch.isfinite(out_t.kf_Tcw).all()


def _counts():
    return t_lm.STATS.read(), t_lm.BA_WINDOWS.read(), t_ba.STATS.read()


def _delta(after, before):
    return [{k: v - b.get(k, 0) for k, v in a.items() if v != b.get(k, 0)}
            for a, b in zip(after, before)]


def test_run_mapping_stage_skips_ba_on_two_keyframes(ref_run):
    """The stage's first branch on the first keyframe mapped (n_kf = 2):
    local BA is computed and not taken, as the reference skips it; the
    stage counts, no window and no solve do, and the solve's trips are
    all dead."""
    s = ref_run["early"]
    assert int(s["state"].n_kf) == 2
    out_j = j_lm.run_mapping_stage(s["state"], s["kf"], s["fid"], ref_run["jcal"],
                                   ref_run["jcfg"], covis_hint=s["hint"])
    before = _counts()
    out_t = t_lm.run_mapping_stage(_tstate(s["state"]), s["kf"], s["fid"], ref_run["tcal"],
                                   ref_run["tcfg"], covis_hint=s["hint"])
    stages, windows, ba = _delta(_counts(), before)
    assert stages == {"stages": 1} and windows == {}
    assert set(ba) == {"trips"}, ba
    _hold_stage(out_j, out_t)
    # without local BA no keyframe pose moves but by the culling stages
    kf = np.asarray(out_j.kf_valid)
    np.testing.assert_array_equal(out_t.kf_Tcw.numpy()[kf], np.asarray(s["state"].kf_Tcw)[kf])


def _over_ninety_percent(state):
    """`state` with filler points (valid, long tracked, observed by no
    keyframe) in the lowest free slots until the store is over 90% full:
    numpy fields for both packages."""
    f = {k: np.asarray(v).copy() for k, v in state._asdict().items()}
    M = f["mp_valid"].shape[0]
    n_fill = int(0.90 * M) + 100 - int(f["n_mp"])
    free = np.nonzero(~f["mp_valid"][:M - 1])[0][:n_fill]
    f["mp_valid"][free] = True
    f["mp_visible"][free] = 40
    f["mp_found"][free] = 10 + free % 30
    f["mp_first_frame"][free] = -1
    f["n_mp"] = np.asarray(int(f["n_mp"]) + n_fill, np.int32)
    return f


def test_run_mapping_stage_relieves_capacity(ref_run):
    """The stage's second branch: a point store over 90% full is relieved
    to >= M / 10 free slots by evicting the weakest unprotected points, as
    the reference does on the same snapshot."""
    s = ref_run["snap"]
    f = _over_ninety_percent(s["state"])
    js = type(s["state"])(**{k: jnp.asarray(v) for k, v in f.items()})
    M = f["mp_valid"].shape[0]
    assert int(js.n_mp) > int(0.90 * M)
    out_j = j_lm.run_mapping_stage(js, s["kf"], s["fid"], ref_run["jcal"], ref_run["jcfg"],
                                   covis_hint=s["hint"])
    out_t = t_lm.run_mapping_stage(_tstate(js), s["kf"], s["fid"], ref_run["tcal"],
                                   ref_run["tcfg"], covis_hint=s["hint"])
    assert M - int(out_j.n_mp) >= M // 10
    assert M - int(out_t.n_mp) >= M // 10
    _hold_stage(out_j, out_t)
    assert (out_t.mp_valid.numpy() == np.asarray(out_j.mp_valid)).mean() >= 0.995


def test_run_mapping_stage_reads_nothing_back(ref_run, monkeypatch):
    """Every stage on, the window hint given: no host read and no tensor
    made from host data (the checks of `test_torch_fused.py`) in
    `run_mapping_stage`, buffers, loads and copies included, and the same
    bits as the call before the check."""
    s = ref_run["snap"]
    state = _tstate(s["state"])
    args = (state, s["kf"], s["fid"], ref_run["tcal"], ref_run["tcfg"])
    expect = t_lm.run_mapping_stage(*args, covis_hint=s["hint"])   # makes the step
    for name in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, _raiser(f"Tensor.{name}"))
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raiser(f"torch.{name}"))
    with _NoHostRead():
        out = t_lm.run_mapping_stage(*args, covis_hint=s["hint"])
    monkeypatch.undo()
    for name in t_ms.MapState._fields:
        assert torch.equal(getattr(out, name), getattr(expect, name)), name


@pytest.mark.parametrize("off", ["do_triangulate", "do_fuse", "do_ba", "do_cull"])
def test_run_mapping_stage_with_a_stage_off(ref_run, off):
    """The path with a stage switched off (no capacity relief), computing
    its own covisibility count."""
    s = ref_run["snap"]
    kw = {off: False}
    out_j = j_lm.run_mapping_stage(s["state"], s["kf"], s["fid"], ref_run["jcal"],
                                   ref_run["jcfg"], **kw)
    out_t = t_lm.run_mapping_stage(_tstate(s["state"]), s["kf"], s["fid"], ref_run["tcal"],
                                   ref_run["tcfg"], **kw)
    _assert_same(out_j, out_t, only=("kf_valid", "n_kf"))
    assert abs(int(out_t.n_mp) - int(out_j.n_mp)) <= 0.01 * int(out_j.n_mp)
    np.testing.assert_allclose(out_t.kf_Tcw.numpy(), np.asarray(out_j.kf_Tcw), atol=1e-3)


@pytest.mark.parametrize("pipelined,limit_m", [(False, 0.005), (True, 0.02)])
def test_tracker_with_mapping_end_to_end(ref_run, pipelined, limit_m):
    seq, tcal, tcfg = ref_run["seq"], ref_run["tcal"], ref_run["tcfg"]
    tracker = t_tr.Tracker(tcal, tcfg, pipelined=pipelined, pipeline_depth=3, device="cpu")
    snaps = []
    tracker.kf_inserted_cb = _mapping_cb(tracker, t_lm, tcfg, tcal, t_lm.covis_kf_count, snaps)
    for g, d in zip(seq.grays, seq.depths):
        tracker.process(g, d)
    traj = tracker.absolute_trajectory()
    assert all(not lost for *_, lost in traj), [lost for *_, lost in traj]
    assert int(tracker.map.n_kf) == ref_run["n_kf"]
    assert len(snaps) == ref_run["n_mapped"]
    centers = _centers([T for _, _, T, _ in traj])
    assert np.abs(centers - ref_run["centers"]).max() < limit_m
    gt = _centers(seq.poses_gt)
    assert float(t_align.ate_rmse(torch.from_numpy(centers), torch.from_numpy(gt))) < 0.05
    assert torch.isfinite(tracker.map.mp_pos).all()
    assert sum(t_lm.BA_WINDOWS.read().values()) >= 1


STEPWISE = ("cull_map_points", "triangulate_new_points", "fuse_neighbors", "build_local_problem",
            "solve_ba_jit", "apply_ba_result", "cull_keyframes", "update_point_geometry")


@pytest.fixture(scope="module")
def stepwise_calls(ref_run, stages):
    """{name: (graphed function, arguments)}: each stepwise function on the
    reference's input state of its stage (slots and the frame id as ints,
    traced on the card)."""
    tc, tcal, kf = ref_run["tcfg"], ref_run["tcal"], stages["kf"]
    prob = convert.to_torch(stages["prob"], t_ba.BAProblem, "cpu")
    sol = tuple(torch.from_numpy(np.asarray(x).copy()) for x in stages["sol"])
    return {
        "cull_map_points": (t_lm.cull_map_points, (_tstate(stages["s0"]), stages["fid"], tc)),
        "triangulate_new_points": (t_tri.triangulate_new_points,
                                   (_tstate(stages["s1"]), kf, tcal, tc)),
        "fuse_neighbors": (t_fus.fuse_neighbors, (_tstate(stages["s2"]), kf, tcal, tc)),
        "build_local_problem": (t_lm.build_local_problem, (_tstate(stages["s3"]), kf, tc, 12, 12)),
        "solve_ba_jit": (t_lm.solve_ba_jit, (prob, tcal.T_rc, tcal.K, tcal.bf,
                                             ((5, True), (8, False)))),
        "apply_ba_result": (t_lm.apply_ba_result, (_tstate(stages["s3"]), prob) + sol + (tc,)),
        "cull_keyframes": (t_lm.cull_keyframes, (_tstate(stages["s4"]), kf, tc)),
        "update_point_geometry": (t_tr.update_point_geometry, (_tstate(stages["s5"]), tc)),
    }


@pytest.mark.parametrize("name", STEPWISE)
def test_stepwise_entry_is_pure_reads_nothing_back_and_is_its_body(stepwise_calls, monkeypatch,
                                                                   name):
    fn, args = stepwise_calls[name]
    assert_pure(fn, args)
    assert _equal(fn.entry(*args).run(*args), fn.__wrapped__(*args))
    assert_reads_nothing_back(monkeypatch, fn, args)


@pytest.mark.parametrize("off", ["do_triangulate", "do_fuse", "do_ba", "do_cull"])
def test_stepwise_stage_through_entries_is_the_direct_run(ref_run, off):
    """`run_mapping_stage` with a stage off, directly and with every graphed
    call sent through its entry (the card's route but for the graph): the
    same bits, one entry a function, every stage that ran through its own."""
    s = ref_run["snap"]

    def run():
        return t_lm.run_mapping_stage(_tstate(s["state"]), s["kf"], s["fid"], ref_run["tcal"],
                                      ref_run["tcfg"], covis_hint=s["hint"], **{off: False})

    direct = run()
    routed, used = _routed(run)
    assert _equal(direct, routed)
    ran = {"do_cull": {"cull_map_points", "cull_keyframes"},
           "do_triangulate": {"triangulate_new_points"}, "do_fuse": {"fuse_neighbors"},
           "do_ba": {"build_local_problem", "solve_ba_jit", "apply_ba_result"}}
    expect = {"update_point_geometry"}.union(*(v for k, v in ran.items() if k != off))
    assert set(used) == expect, used
    assert all(c == 1 for _, c in used.values()), used
