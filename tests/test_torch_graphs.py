"""The port's `jax.jit` boundaries (`utils/graphs.graphed`), on the CPU.

On the card a graphed function is one CUDA graph replay a call, on fixed
input buffers, captured once per input signature, with its Python ints
traced as 0-dim device buffers; on the CPU it calls its body.  Each
signature's `Entry` also runs on the CPU (the body on its buffers, the
outputs copied out), which is what these tests drive: the card's route but
for the graph itself.  `tests/test_torch_cuda.py` holds the replays to the
eager calls on the card.

The scene is `tests/test_torch_fused.py`'s dual 320x240 rig (camera 1 yawed
0.9 rad, 512 features a camera), tracked by the port's stepwise `Tracker`;
the stereo scene is `tests/test_torch_stereo.py`'s.

- keying: a new shape, a tensor in place of an int, or another static
  value makes a new entry; new int values do not;
- traced scalars: two slots or frame ids through one entry give the two
  eager results, and the two differ;
- purity: each of the eight functions leaves its inputs bit-unchanged (a
  capture's warm-up runs the body on the buffers, so an update in place
  would be applied twice);
- no host read in any of the eight through its entry (`test_torch_fused`'s
  patched readers and `_NoHostRead` dispatch mode);
- the stepwise and the pipelined `Tracker`, and `System(STEREO)` with its
  mapping stage, with every graphed function sent through its entry: the
  same bits as the direct calls (which `test_torch_tracking`,
  `test_torch_fused` and `test_torch_stereo` hold to the JAX package), one
  entry a function and signature over the whole run.
"""

import numpy as np
import pytest
import torch

from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch import system as t_system
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg
from multi_orb_slam_tpu_torch.frontend import frame as t_frame
from multi_orb_slam_tpu_torch.frontend import tracking as t_tr
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.geometry import se3 as t_se3
from multi_orb_slam_tpu_torch.io import synthetic
from multi_orb_slam_tpu_torch.mapping import map_state as t_ms
from multi_orb_slam_tpu_torch.ops import orb as t_orb
from multi_orb_slam_tpu_torch.utils import graphs

from test_stereo import render_stereo_seq
from test_torch_fused import _NoHostRead, _raiser
from test_tracking import small_calib, small_cfg

torch.set_num_threads(2)
C, H, W, NF, N_FRAMES, SNAP = 2, 240, 320, 512, 8, 7
CFG = TCfg(n_cams=C, max_feat=NF, max_kf=32, max_mp=12288, local_cap=2048, new_mp_per_cam=128,
           width=W, height=H, th_depth=6.0, max_frames_kf=4,
           orb=t_orb.ORBConfig(n_features=NF))
N_STEREO = 6
NAMES = ("build_frame", "build_frame_stereo", "track_motion_model", "track_reference_kf",
         "build_local_points_cache", "track_local_map", "insert_keyframe_jit",
         "track_frame_fused")


def _calib():
    K = torch.tensor([[260.0, 260.0, 160.0, 120.0]] * C)
    T_c12 = torch.eye(4)
    T_c12[:3, :3] = t_se3.so3_exp(torch.tensor([0.0, 0.9, 0.0]))
    T_c12[:3, 3] = torch.tensor([0.16, 0.004, -0.07])
    T_rc = torch.stack([torch.eye(4), torch.linalg.inv(T_c12)])
    return t_cam.CameraParams(K=K, dist=torch.zeros((C, 5)), T_rc=T_rc, bf=torch.tensor(20.0),
                              width=W, height=H)


def _through_entries(monkeypatch):
    """Send every graphed call through its entry, as on the card; inside an
    entry's body the graphed functions call their bodies, as inside a
    capture."""
    monkeypatch.setattr(graphs, "_calls_body",
                        lambda device: getattr(graphs._local, "inline", 0) > 0)


def _equal(a, b):
    ta, tb = graphs.tensors(a), graphs.tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


def assert_pure(fn, args):
    """`fn(*args)` leaves its inputs bit-unchanged (a capture's warm-up
    runs the body on the buffers, so an update in place would be applied
    twice)."""
    before = graphs.clone(args)
    fn(*args)
    assert _equal(args, before)


def assert_reads_nothing_back(monkeypatch, fn, args):
    """`fn`'s entry for `args` run with every host reader patched to
    raise and under `_NoHostRead`: the same bits as a run without."""
    entry = fn.entry(*args)
    expect = entry.run(*args)      # first use builds the per-device constant tables
    for attr in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, attr, _raiser(f"Tensor.{attr}"))
    for attr in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, attr, _raiser(f"torch.{attr}"))
    with _NoHostRead():
        out = entry.run(*args)
    monkeypatch.undo()
    assert _equal(out, expect)


def assert_traced_values(fn, calls):
    """Two calls that differ in traced values only go through one entry
    (the card's route, the body on the entry's buffers), each equal to its
    direct call, and the two results differ."""
    entry = fn.entry(*calls[0])
    assert fn.entry(*calls[1]) is entry
    outs = [entry.run(*args) for args in calls]
    for args, out in zip(calls, outs):
        assert _equal(out, fn(*args))
    assert not _equal(outs[0], outs[1])


@pytest.fixture(scope="module")
def scene():
    calib = _calib()
    seq = synthetic.make_sequence(n_frames=N_FRAMES, K=calib.K[0].numpy(),
                                  T_rc=calib.T_rc.numpy(), height=H, width=W, n_points=5000)
    frames = [(torch.from_numpy(np.asarray(g, np.float32)),
               torch.from_numpy(np.asarray(d, np.float32)))
              for g, d in zip(seq.grays, seq.depths)]
    tracker = t_tr.Tracker(calib, CFG, device="cpu")
    snap = None
    for i, (g, d) in enumerate(frames):
        if i == SNAP:
            snap = dict(state=tracker.map, prev=tracker.prev_frame, prev_Tcw=tracker.prev_Tcw,
                        prev_mp=tracker.prev_mp, velocity=tracker.velocity,
                        slot=tracker.last_kf_slot, last_kf_frame=tracker.last_kf_frame,
                        tstate=torch.tensor([tracker.last_kf_frame, tracker.ref_kf_tracked, 0],
                                            dtype=torch.int32),
                        pts=tracker._ensure_local_pts(), grays=g, depths=d)
        tracker.process(g, d)
    assert int(snap["state"].n_kf) >= 2 and snap["slot"] > 0
    snap["cur"] = t_frame.build_frame(snap["grays"], snap["depths"], calib, CFG.orb)
    Tcw, fmp, *_ = t_tr.track_motion_model(snap["state"], snap["prev"], snap["prev_Tcw"],
                                           snap["prev_mp"], snap["velocity"], snap["cur"],
                                           calib, CFG)
    snap["Tcw"], snap["frame_mp"] = Tcw, fmp

    calib_j, cfg_j = small_calib(), small_cfg()
    lefts, rights, _ = render_stereo_seq(calib_j, n_frames=N_STEREO)
    stereo = dict(calib=convert.to_torch(calib_j, t_cam.CameraParams, "cpu"),
                  cfg=TCfg(**{**cfg_j._asdict(), "orb": t_orb.ORBConfig(**cfg_j.orb._asdict())}),
                  lefts=[g for g, _ in lefts], rights=rights)
    return dict(calib=calib, frames=frames, snap=snap, stereo=stereo)


def _call(scene, name, slot=None, frame_id=SNAP):
    """(graphed function, its arguments on the snapshot)."""
    s, calib = scene["snap"], scene["calib"]
    slot = s["slot"] if slot is None else slot
    if name == "build_frame":
        return t_frame.build_frame, (s["grays"], s["depths"], calib, CFG.orb)
    if name == "build_frame_stereo":
        st = scene["stereo"]
        return t_frame.build_frame_stereo, (
            torch.from_numpy(np.asarray(st["lefts"][0], np.float32)),
            torch.from_numpy(np.asarray(st["rights"][0], np.float32)), st["calib"], st["cfg"].orb)
    if name == "track_motion_model":
        return t_tr.track_motion_model, (s["state"], s["prev"], s["prev_Tcw"], s["prev_mp"],
                                         s["velocity"], s["cur"], calib, CFG)
    if name == "track_reference_kf":
        return t_tr.track_reference_kf, (s["state"], slot, s["prev_Tcw"], s["cur"], calib, CFG)
    if name == "build_local_points_cache":
        return t_tr.build_local_points_cache, (s["state"], slot, CFG)
    if name == "track_local_map":
        return t_tr.track_local_map, (s["state"], s["Tcw"], s["cur"], s["frame_mp"], s["pts"],
                                      calib, CFG)
    if name == "insert_keyframe_jit":
        return t_tr.insert_keyframe_jit, (s["state"], s["cur"], s["Tcw"], s["frame_mp"], calib,
                                          CFG, frame_id)
    return t_tr.track_frame_fused, (s["state"], s["prev"], s["prev_Tcw"], s["prev_mp"],
                                    s["velocity"], s["tstate"], s["pts"], s["cur"], calib, CFG,
                                    frame_id)


def test_entry_keys_follow_shapes_not_int_values(scene):
    s, calib = scene["snap"], scene["calib"]
    fn = t_tr.build_local_points_cache
    e = fn.entry(s["state"], 0, CFG)
    assert fn.entry(s["state"], s["slot"], CFG) is e
    assert fn.entry(state=s["state"], anchor_slot=5, cfg=CFG) is e
    assert e.inputs["anchor_slot"].shape == () and e.inputs["anchor_slot"].dtype == torch.int64
    bigger = t_ms.make_empty(CFG.max_kf + 1, C, NF, CFG.max_mp, "cpu")
    others = [fn.entry(bigger, 0, CFG._replace(max_kf=CFG.max_kf + 1)),
              fn.entry(s["state"], torch.tensor(0), CFG),
              fn.entry(s["state"], 0, CFG._replace(local_cap=1024))]
    assert len({id(x) for x in [e] + others}) == 4
    bf = t_frame.build_frame
    a = bf.entry(s["grays"], s["depths"], calib, CFG.orb)
    assert bf.entry(s["grays"] + 1, s["depths"], calib, CFG.orb) is a
    half = bf.entry(s["grays"][:, :120], s["depths"][:, :120], calib._replace(height=120),
                    CFG.orb)
    assert half is not a
    with pytest.raises(TypeError):
        fn.entry(s["state"], 0, [1])      # an argument that is neither static nor traceable


@pytest.mark.parametrize("name,values", [
    ("build_local_points_cache", (0, None)), ("track_reference_kf", (0, None)),
    ("insert_keyframe_jit", (SNAP, SNAP + 3)), ("track_frame_fused", (SNAP - 2, SNAP + 3))])
def test_traced_scalars_give_each_call_its_own_value(scene, name, values):
    """Two values through one entry (the card's route, the body on the
    entry's buffers) equal the two direct calls, and differ."""
    kw = "frame_id" if name in ("insert_keyframe_jit", "track_frame_fused") else "slot"
    calls = [_call(scene, name, **{kw: v}) for v in values]
    assert_traced_values(calls[0][0], [args for _, args in calls])


@pytest.mark.parametrize("name", NAMES)
def test_graphed_function_leaves_inputs_unchanged(scene, name):
    assert_pure(*_call(scene, name))


@pytest.mark.parametrize("name", NAMES)
def test_graphed_function_reads_nothing_back(scene, monkeypatch, name):
    assert_reads_nothing_back(monkeypatch, *_call(scene, name))


def _track(scene, pipelined):
    tracker = t_tr.Tracker(scene["calib"], CFG, pipelined=pipelined, pipeline_depth=3,
                           device="cpu")
    kfs = []
    tracker.kf_inserted_cb = lambda slot: kfs.append(tracker.last_kf_frame)
    for g, d in scene["frames"]:
        tracker.process(g, d)
    traj = np.stack([T for _, _, T, _ in tracker.absolute_trajectory()])
    return traj, kfs, tracker.map


def _counts():
    """{function: (entries, calls through them)}."""
    return {fn.__name__: (len(fn.entries), sum(e.n_calls for e in fn.entries.values()))
            for fn in graphs.GRAPHED}


def _routed(run):
    """`run()` with every graphed call sent through its entry, and per
    function that took calls: (new entries, calls)."""
    before = _counts()
    with pytest.MonkeyPatch.context() as mp:
        _through_entries(mp)
        out = run()
    used = {k: (n - before[k][0], c - before[k][1]) for k, (n, c) in _counts().items()
            if c > before[k][1]}
    return out, used


@pytest.mark.parametrize("pipelined", [False, True])
def test_tracker_through_entries_is_the_direct_run(scene, pipelined):
    direct = _track(scene, pipelined)
    routed, used = _routed(lambda: _track(scene, pipelined))
    assert direct[1] == routed[1] and len(routed[1]) >= 1
    np.testing.assert_array_equal(direct[0], routed[0])
    assert _equal(direct[2], routed[2])
    # at most one new entry a function, whatever the frame and slot ids
    names = ({"track_frame_fused"} if pipelined else
             {"track_motion_model", "build_local_points_cache", "track_local_map",
              "insert_keyframe_jit"})
    assert names | {"build_frame"} <= set(used), used
    assert all(n <= 1 for n, _ in used.values()), used
    assert used["build_frame"][1] == N_FRAMES


def _stereo_run(st):
    sys_ = t_system.System(sensor=t_system.Sensor.STEREO, calib=st["calib"], cfg=st["cfg"],
                           enable_loop_closing=False, device="cpu")
    for i, (gl, gr) in enumerate(zip(st["lefts"], st["rights"])):
        sys_.track_stereo(gl, gr, timestamp=i / 30.0)
    traj = np.stack([T for _, _, T, _ in sys_.tracker.absolute_trajectory()])
    return traj, sys_.map, sys_.metrics.counters["keyframes_inserted"]


def test_stereo_system_through_entries_is_the_direct_run(scene):
    direct = _stereo_run(scene["stereo"])
    routed, used = _routed(lambda: _stereo_run(scene["stereo"]))
    np.testing.assert_array_equal(direct[0], routed[0])
    assert _equal(direct[1], routed[1])
    assert direct[2] == routed[2] >= 1
    assert {"build_frame_stereo", "track_motion_model", "_mapping_stage_fused"} <= set(used)
    assert used["build_frame_stereo"][1] == N_STEREO
    assert all(n <= 1 for n, _ in used.values()), used
