"""PyTorch port vs JAX reference: the fused tracking step as the JAX package
defines it (`track_frame_fused`, `track_frame_fused_images`,
`track_frames_scan`), on the CPU.

The dual 320x240 rig of `tests/test_torch_tracking.py` (camera 1 yawed 0.9
rad, 512 features per camera).  One stepwise JAX `Tracker` run over 10
frames gives the snapshots; each goes through both packages on identical
inputs (`convert.py`):

- `track_frame_fused` on three snapshots: the inserting frame 7, a frame
  that inserts nothing, and frame 7 with its motion model made to fail
  (`prev_mp` all -1, so the reference-KF fallback fires): status scalars and
  `tstate` equal, Tcw to 1e-4 (two or three 4x10 LM pose solves in float32,
  summed in another order), >= 99% of the frame's map-point ids equal;
- `track_frame_fused_images` against the port's own `build_frame` +
  `track_frame_fused`: the same bits;
- `track_frame_fused_images` against the reference's, as each package's
  `Tracker(pipelined=True, pipeline_depth=3)` with `fuse_extraction` runs
  it over the 10 frames: the same keyframes, every camera centre within the
  5 mm of `test_tracker_end_to_end` (the port's pyramid resampling differs by
  ~1e-4 grey levels, which moves a few keypoints);
- `track_frames_scan`, G = 3 from the snapshot of a keyframe frame (so the
  later two frames search the cache rebuilt on the device): the same stacked
  `ok` and `inserted`, camera centres within 5 mm;
- no host read in the port's `track_frame_fused` or
  `track_frame_fused_images`: `Tensor.tolist / item / __bool__ / __int__ /
  __float__ / __index__`, `torch.tensor`, `torch.as_tensor` and
  `torch.from_numpy` patched to raise, under a `TorchDispatchMode` that
  raises on `aten._local_scalar_dense` and `aten.nonzero`, and on
  `aten.lift_fresh` (a tensor made from host data, as `x[i] = 1` makes one:
  a copy from the host, which a CUDA graph's capture refuses);
- the port's `Tracker` with `fuse_extraction=True` (the `FusedStep`'s CPU
  route: buffers, loads and copies, the body called directly) gives the same
  bits as `pipelined=True` without it on the same frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from multi_orb_slam_tpu.config import SlamConfig as JCfg
from multi_orb_slam_tpu.frontend import frame as j_frame
from multi_orb_slam_tpu.frontend import tracking as j_tr
from multi_orb_slam_tpu.geometry import camera as j_cam
from multi_orb_slam_tpu.geometry import se3 as j_se3
from multi_orb_slam_tpu.io import synthetic
from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.frontend import frame as t_frame
from multi_orb_slam_tpu_torch.frontend import tracking as t_tr
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.ops import orb as t_orb
from multi_orb_slam_tpu_torch.ops import search as t_search

torch.set_num_threads(2)
C, H, W, NF, N_FRAMES, STAGE_K = 2, 240, 320, 512, 10, 7
CFG_KW = dict(n_cams=C, max_feat=NF, max_kf=32, max_mp=12288, local_cap=2048,
              new_mp_per_cam=128, width=W, height=H, th_depth=6.0, max_frames_kf=4)
TCFG = TCfg(**CFG_KW, orb=t_orb.ORBConfig(n_features=NF))
G = 3


def _centers(poses):
    return np.stack([np.linalg.inv(np.asarray(T, np.float64))[:3, 3] for T in poses])


def _t(x):
    return convert._field_to_torch(x, "cpu")


def _tensors(x):
    """Every tensor of a nest of tuples and NamedTuples, in order."""
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for f in x if f is not None for t in _tensors(f)]


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
    snaps, kf_frames = {}, []
    for i, (g, d) in enumerate(zip(seq.grays, seq.depths)):
        if i > 0:
            snaps[i] = dict(
                state=tracker.map, prev=tracker.prev_frame, prev_Tcw=tracker.prev_Tcw,
                prev_mp=tracker.prev_mp, velocity=tracker.velocity,
                tstate=np.array([tracker.last_kf_frame, tracker.ref_kf_tracked, 0], np.int32),
                local_pts=tracker._ensure_local_pts())
        tracker.process(g, d)
        if i > 0 and tracker.last_kf_frame == i:
            kf_frames.append(i)
    return dict(jcal=jcal, jcfg=jcfg, seq=seq, snaps=snaps, kf_frames=kf_frames,
                tcal=convert.to_torch(jcal, t_cam.CameraParams, "cpu"))


def _port_inputs(s):
    return (convert.to_torch(s["state"], t_ms.MapState, "cpu"),
            convert.to_torch(s["prev"], t_frame.FrameData, "cpu"), _t(s["prev_Tcw"]),
            _t(s["prev_mp"]), _t(s["velocity"]), _t(s["tstate"]),
            convert.to_torch(s["local_pts"], t_search.LocalPoints, "cpu"))


def _ref_inputs(s):
    return (s["state"], s["prev"], s["prev_Tcw"], s["prev_mp"], s["velocity"],
            jnp.asarray(s["tstate"]), s["local_pts"])


def _snapshot(ref_run, case):
    """(frame index, snapshot) of a case; the fallback case is frame 7 with
    every previous map-point id dropped."""
    kfs = ref_run["kf_frames"]
    if case == "insert":
        i = STAGE_K
    elif case == "plain":
        i = next(k for k in range(2, N_FRAMES) if k not in kfs)
    else:
        i = STAGE_K
    s = dict(ref_run["snaps"][i])
    if case == "fallback":
        s["prev_mp"] = jnp.full_like(s["prev_mp"], -1)
    return i, s


@pytest.mark.parametrize("case", ["insert", "plain", "fallback"])
def test_track_frame_fused_matches_reference(ref_run, case):
    jcal, jcfg, seq, tcal = ref_run["jcal"], ref_run["jcfg"], ref_run["seq"], ref_run["tcal"]
    i, s = _snapshot(ref_run, case)
    cur = j_frame.build_frame(jnp.asarray(seq.grays[i]), jnp.asarray(seq.depths[i]), jcal, jcfg.orb)
    out_j = j_tr.track_frame_fused(*_ref_inputs(s), cur, jcal, jcfg, jnp.asarray(i, jnp.int32))
    ins = _port_inputs(s)
    tcur = convert.to_torch(cur, t_frame.FrameData, "cpu")
    out_t = t_tr.track_frame_fused(*ins, tcur, tcal, TCFG, torch.full((), i, dtype=torch.int32))
    scal_j = np.asarray(out_j[5])
    assert scal_j[0] == 1 and scal_j[2] == (case != "plain"), (case, scal_j)
    if case == "fallback":
        # the motion model alone fails here, so the step took the fallback
        _, _, _, n_inl1, n_map_inl1 = t_tr.track_motion_model(
            ins[0], ins[1], ins[2], ins[3], ins[4], tcur, tcal, TCFG)
        assert int(n_inl1) < TCFG.min_matches_motion or int(n_map_inl1) < 10
    np.testing.assert_array_equal(out_t[5].numpy(), scal_j)
    np.testing.assert_array_equal(out_t[4].numpy(), np.asarray(out_j[4]))
    np.testing.assert_allclose(out_t[1].numpy(), np.asarray(out_j[1]), atol=1e-4)
    np.testing.assert_allclose(out_t[3].numpy(), np.asarray(out_j[3]), atol=1e-4)
    assert (np.asarray(out_j[2]) == out_t[2].numpy()).mean() >= 0.99
    st_j, st_t = out_j[0], out_t[0]
    assert int(st_t.n_kf) == int(st_j.n_kf) and int(st_t.n_mp) == int(st_j.n_mp)
    assert (np.asarray(st_j.kf_mp) == st_t.kf_mp.numpy()).mean() >= 0.99
    assert int(out_t[6]) == int(out_j[6]) and int(out_t[8]) == int(out_j[8])
    np.testing.assert_allclose(out_t[7].numpy(), np.asarray(out_j[7]), atol=1e-4)


def test_images_step_is_build_frame_then_step(ref_run):
    seq, tcal = ref_run["seq"], ref_run["tcal"]
    i, s = _snapshot(ref_run, "insert")
    g, d = torch.from_numpy(seq.grays[i]), torch.from_numpy(seq.depths[i])
    fid = torch.full((), i, dtype=torch.int32)
    out_i = t_tr.track_frame_fused_images(*_port_inputs(s), g, d, tcal, TCFG, fid)
    fr = t_frame.build_frame(g, d, tcal, TCFG.orb)
    out_s = (fr,) + tuple(t_tr.track_frame_fused(*_port_inputs(s), fr, tcal, TCFG, fid))
    a, b = _tensors(out_i), _tensors(out_s)
    assert len(a) == len(b) > 40
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def fused_trackers(ref_run):
    """Each package's pipelined tracker with `fuse_extraction` over the 10
    frames, and the port's without it: (trajectory, keyframe frames, map)."""
    seq = ref_run["seq"]

    def run(tracker):
        kfs = []
        tracker.kf_inserted_cb = lambda slot: kfs.append(tracker.last_kf_frame)
        for g, d in zip(seq.grays, seq.depths):
            tracker.process(g, d)
        traj = tracker.absolute_trajectory()
        return np.stack([np.asarray(T) for _, _, T, _ in traj]), kfs, tracker

    jt = j_tr.Tracker(ref_run["jcal"], ref_run["jcfg"], pipelined=True, pipeline_depth=3)
    jt.fuse_extraction = True
    out = {"jax": run(jt)}
    for fuse in (True, False):
        out[fuse] = run(t_tr.Tracker(ref_run["tcal"], TCFG, pipelined=True, pipeline_depth=3,
                                     fuse_extraction=fuse, device="cpu"))
    return out


def test_images_step_tracker_matches_reference(fused_trackers):
    (traj_j, kfs_j, _), (traj_t, kfs_t, tracker) = fused_trackers["jax"], fused_trackers[True]
    assert tracker.fused is not None and tracker.fused.graph is None   # the CPU route
    assert kfs_t == kfs_j and len(kfs_t) >= 1
    assert np.abs(_centers(traj_t) - _centers(traj_j)).max() < 0.005


def test_images_tracker_equals_unfused_pipelined(fused_trackers):
    (traj_a, kfs_a, ta), (traj_b, kfs_b, tb) = fused_trackers[True], fused_trackers[False]
    assert kfs_a == kfs_b
    np.testing.assert_array_equal(traj_a, traj_b)
    for name in t_ms.MapState._fields:
        assert torch.equal(getattr(ta.map, name), getattr(tb.map, name)), name


def test_track_frames_scan_matches_reference(ref_run):
    jcal, jcfg, seq, tcal = ref_run["jcal"], ref_run["jcfg"], ref_run["seq"], ref_run["tcal"]
    i0 = next(k for k in ref_run["kf_frames"] if k + G <= N_FRAMES)
    s = ref_run["snaps"][i0]
    grays = np.stack(seq.grays[i0:i0 + G]).astype(np.float32)
    depths = np.stack(seq.depths[i0:i0 + G]).astype(np.float32)
    out_j = j_tr.track_frames_scan(*_ref_inputs(s), jnp.asarray(grays), jnp.asarray(depths),
                                   jcal, jcfg, jnp.asarray(i0, jnp.int32))
    out_t = t_tr.track_frames_scan(*_port_inputs(s), torch.from_numpy(grays),
                                   torch.from_numpy(depths), tcal, TCFG, i0)
    scal_j, scal_t = np.asarray(out_j[7][0]), out_t[7][0].numpy()
    assert scal_j[0, 2] == 1, scal_j          # the chunk's first frame inserts
    np.testing.assert_array_equal(scal_t[:, 0], scal_j[:, 0])
    np.testing.assert_array_equal(scal_t[:, 2], scal_j[:, 2])
    assert scal_t[:, 0].all()
    assert np.abs(_centers(out_t[7][4].numpy()) - _centers(np.asarray(out_j[7][4]))).max() < 0.005
    # the carry is the last frame's: its pose and the chunk's next frame id
    np.testing.assert_array_equal(out_t[2].numpy(), out_t[7][4][-1].numpy())
    assert int(out_t[0].n_kf) == int(out_j[0].n_kf)
    # the local points were rebuilt on the device after the insertion
    assert not torch.equal(out_t[6].idx, _port_inputs(s)[6].idx)


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
                                   torch.ops.aten.lift_fresh):
            raise AssertionError(f"host read, or a tensor from host data, in the fused step: "
                                 f"{func}")
        return func(*args, **(kwargs or {}))


def _raiser(name):
    def f(*a, **k):
        raise AssertionError(f"{name} called in the fused step")
    return f


@pytest.mark.parametrize("fn", ["track_frame_fused", "track_frame_fused_images"])
def test_fused_step_reads_nothing_back(ref_run, monkeypatch, fn):
    seq, tcal = ref_run["seq"], ref_run["tcal"]
    i, s = _snapshot(ref_run, "fallback")   # all branches run on every frame
    g, d = torch.from_numpy(seq.grays[i]), torch.from_numpy(seq.depths[i])
    fid = torch.full((), i, dtype=torch.int32)
    ins = _port_inputs(s)
    if fn == "track_frame_fused":
        args = ins + (t_frame.build_frame(g, d, tcal, TCFG.orb), tcal, TCFG, fid)
        step = t_tr.track_frame_fused
    else:
        args = ins + (g, d, tcal, TCFG, fid)
        step = t_tr.track_frame_fused_images
    expect = step(*args)      # first use builds the per-device constant tables
    for name in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, _raiser(f"Tensor.{name}"))
    for name in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, name, _raiser(f"torch.{name}"))
    with _NoHostRead():
        out = step(*args)
    monkeypatch.undo()
    for x, y in zip(_tensors(out), _tensors(expect)):
        assert torch.equal(x, y)
