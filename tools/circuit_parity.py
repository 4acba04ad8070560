"""Per-frame record of a tracker over one of the bench's scenes, for either
package, and the comparison of two such records.

    python3 tools/circuit_parity.py run --package torch --out torch.json
    python3 tools/circuit_parity.py run --package jax   --out jax.json
    python3 tools/circuit_parity.py compare jax.json torch.json

`run` renders the scene (the 160-frame outward-facing circuit by default, the
bench's rig and sizes: 640x480, 2 cameras ~90 degrees apart, 1024 features
per camera, default `SlamConfig`), drives `Tracker.process` over `--frames`
of it and writes, per frame: the tracker's state, its inlier count, the
keyframe and map-point counts and the error of the camera centre against
ground truth.  `--mapping` sets the mapping callback as `bench.py` sets it;
`--pipelined` runs the tracker pipelined at depth 3 (per-frame values then
lag by up to three frames; the trajectory at the end does not).  `--noise S
--seed N` adds Gaussian noise of S grey levels to every image: a run's
sensitivity to a change far below one grey level.

`--system` drives `System.track_rgbd` (mapping on) instead of the bare
tracker; `--system --loop` runs the loop circuit of
`tests/test_circuit_e2e.py` instead of the bench's scenes: 240 frames at
320x240 (the bench's 640x480 circuit is not tracked to the end by either
package), the same rig, K = (260, 260, 160, 120), bf = 20, a 15% depth-scale
ramp for 0.08 <= s < 0.60, the test's `make_cfg()` (512 features,
`max_frames_kf=12`, `th_depth=4.0`, `local_cap=1024`, default `max_kf` and
`max_mp`), a vocabulary from camera-0 ORB of every 8th frame (k = 10, depth
4, 3 iterations) and loop closing with global BA on.  The record then holds,
for each loop candidate that reached Sim3 verification, its keyframes and
frame, the matches passed to RANSAC (capped at 256), the RANSAC and LM
inliers, the total and the decision; and at the end `n_loops_closed`,
`n_gba_merged`, the keyframes, the frames lost and the ATE over all frames
after rigid alignment.  About 6 minutes per package on 8 CPU cores.

`--system --scene longrun` runs `tests/test_longrun.py`'s scene: 520 frames
of an outward circuit of 2.2 laps (radius 2.2 m) in a 7 x 4 x 7 m box of 5000
squares (seed 11), frames 200-279 at half contrast, the same rig, loop
closing with global BA on and the vocabulary built as for `--loop`.
`--size test` (the default) is the test's: 320x240, K = (260, 260, 160, 120),
bf = 20, 512 features, `max_kf=96, max_mp=16384, local_cap=1024,
new_mp_per_cam=128`; `--size full` is the bench's width: 640x480, K =
(520.9, 521.0, 320, 240), bf = 40, 1024 features and the default
`SlamConfig`.  Both set `th_depth=4.0` as the test does.  Each frame's row
then also carries the loops closed, the GBAs merged, whether a GBA is
pending and whether the frame inserted a keyframe; the record ends with the
test's four checks (frames not OK, keyframe cadence, the low-contrast
stretch's cadence, the map's capacity) and the loops' frames and keyframes.

Each run imports ONE package: `--package torch` the PyTorch port (on
`--device`, default cpu), `--package jax` the reference on the CPU.  Both
render the same frames with their own copy of the same numpy renderer.
`compare` prints the first frame at which the states differ, where the
inlier counts drift apart, each run's first lost frame, and the loop records;
for two tracker runs also the frames that inserted a keyframe (with
`--mapping`), the ATE over the tracked frames, and how far the camera centres
of the final trajectories part.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, C = 480, 640, 2
K4 = K4_BENCH = [520.9, 521.0, 320.0, 240.0]
T_RC1_ROTVEC, T_RC1_T = [0.0, np.pi / 2, 0.0], [0.161, 0.004, -0.071]


def render(synthetic, scene, n_frames, T_rc, noise=0.0, seed=0):
    grays, depths, poses = _render(synthetic, scene, n_frames, T_rc)
    if noise > 0.0:
        rng = np.random.RandomState(seed)
        grays = [np.clip(g + rng.normal(0.0, noise, g.shape), 0, 255).astype(np.float32)
                 for g in grays]
    return grays, depths, poses


def _render(synthetic, scene, n_frames, T_rc):
    Kc = np.asarray(K4, np.float32)
    if scene == "orbit":
        seq = synthetic.make_sequence(n_frames=60, K=Kc, T_rc=T_rc, height=H, width=W,
                                      n_points=4000)
        return seq.grays[:n_frames], seq.depths[:n_frames], np.asarray(seq.poses_gt)[:n_frames]
    world = synthetic.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = synthetic.circuit_trajectory(160, radius=2.2, laps=1.1)[:n_frames]
    grays, depths = [], []
    for T in poses:
        views = [synthetic.render_rgbd(world, Kc, T_rc[c] @ T, H, W) for c in range(C)]
        grays.append(np.stack([v[0] for v in views]).astype(np.float32))
        depths.append(np.stack([v[1] for v in views]).astype(np.float32))
    return grays, depths, np.asarray(poses)


LONG_FRAMES, LONG_LOWTEX = 520, (200, 280)
LONG_SIZES = {"test": ((240, 320), [260.0, 260.0, 160.0, 120.0], 20.0, 512),
              "full": ((480, 640), K4_BENCH, 40.0, 1024)}


def render_longrun(synthetic, T_rc, size):
    """`tests/test_longrun.py`'s frames at `size` ("test" or "full"):
    (grays, depths) lists of [2, H, W] arrays and the poses."""
    (h, w), K, _, _ = LONG_SIZES[size]
    world = synthetic.make_box_world(seed=11, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = synthetic.circuit_trajectory(LONG_FRAMES, radius=2.2, laps=2.2)
    grays, depths = [], []
    for i, T in enumerate(poses):
        views = [synthetic.render_rgbd(world, np.asarray(K, np.float32), T_rc[c] @ T, h, w)
                 for c in range(C)]
        g = np.stack([v[0] for v in views])
        if LONG_LOWTEX[0] <= i < LONG_LOWTEX[1]:
            g = 100.0 + (g - 100.0) * 0.5
        grays.append(g.astype(np.float32))
        depths.append(np.stack([v[1] for v in views]).astype(np.float32))
    return grays, depths, np.asarray(poses)


def longrun_cfg_kw(size):
    (h, w), _, _, n_feat = LONG_SIZES[size]
    kw = dict(n_cams=C, width=w, height=h, th_depth=4.0)
    if size == "test":
        kw.update(max_feat=512, max_kf=96, max_mp=16384, local_cap=1024, new_mp_per_cam=128)
    return kw, n_feat


def longrun_checks(kf_frames, n_not_ok, st_n_kf, st_n_mp, n_alloc_failed, cfg):
    """`tests/test_longrun.py`'s four assertions, as values and verdicts."""
    n = len(kf_frames)
    lo, hi = LONG_LOWTEX
    rate_low = sum(1 for f in kf_frames if lo <= f < hi) / (hi - lo)
    rate_all = n / LONG_FRAMES
    return {"not_ok": n_not_ok, "not_ok_ok": n_not_ok <= 10,
            "keyframes_created": n, "cadence": LONG_FRAMES / max(n, 1),
            "cadence_ok": LONG_FRAMES // 20 <= n <= LONG_FRAMES // 6,
            "rate_low": rate_low, "rate_all": rate_all,
            "rate_low_ok": rate_low <= 2.5 * rate_all + 0.02,
            "n_alloc_failed": n_alloc_failed, "n_kf": st_n_kf, "n_mp": st_n_mp,
            "capacity_ok": (n_alloc_failed == 0 and st_n_kf < cfg.max_kf - 1
                            and st_n_mp < cfg.max_mp)}


LOOP_H, LOOP_W, LOOP_FRAMES, LOOP_DRIFT = 240, 320, 240, 0.15
LOOP_K4 = [260.0, 260.0, 160.0, 120.0]


def render_loop_circuit(synthetic, T_rc, noise=0.0, seed=0):
    """`tests/test_circuit_e2e.py`'s frames: (grays, depths) lists of [2, H,
    W] arrays and the poses; `noise` as in `render`."""
    Kc = np.asarray(LOOP_K4, np.float32)
    world = synthetic.make_box_world(seed=3, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = synthetic.circuit_trajectory(LOOP_FRAMES, radius=2.2, laps=1.25)
    grays, depths = [], []
    for i, T in enumerate(poses):
        s = i / (LOOP_FRAMES - 1)
        gs, ds = [], []
        for c in range(C):
            g, d = synthetic.render_rgbd(world, Kc, T_rc[c] @ T, LOOP_H, LOOP_W)
            if 0.08 <= s < 0.60:
                d = d * (1.0 + LOOP_DRIFT * np.sin(np.pi * (s - 0.08) / 0.52))
            gs.append(g)
            ds.append(d)
        grays.append(np.stack(gs).astype(np.float32))
        depths.append(np.stack(ds).astype(np.float32))
    if noise > 0.0:
        rng = np.random.RandomState(seed)
        grays = [np.clip(g + rng.normal(0.0, noise, g.shape), 0, 255).astype(np.float32)
                 for g in grays]
    return grays, depths, np.asarray(poses)


def loop_on(args):
    return args.loop or args.scene == "longrun"


def loop_cfg_kw():
    return dict(n_cams=C, max_feat=512, width=LOOP_W, height=LOOP_H, max_frames_kf=12,
                th_depth=4.0, local_cap=1024, ba_local_cap=2048)


def record_jax_verifications(lc, j_lc):
    """Per-candidate gate counts of the reference's `LoopCloser`, which keeps
    none: its debug messages (one per rejection or acceptance) with the
    inputs and outputs of its RANSAC, LM and projection count, in order."""
    recs, last = [], {}
    ransac, refine, guided = (j_lc.sim3_solver.solve_sim3_ransac, lc._refine_sim3,
                              lc._guided_matches)

    def ransac_(key, pts_a, pts_b, cam_a, cam_b, valid, *a, **k):
        out = ransac(key, pts_a, pts_b, cam_a, cam_b, valid, *a, **k)
        last.update(bow=int(np.asarray(valid).sum()), ransac=int(out[2]))
        return out

    def refine_(*a, **k):
        out = refine(*a, **k)
        last["lm"] = int(out[1])
        return out

    def guided_(*a, **k):
        out = guided(*a, **k)
        last["guided"] = int(out)
        return out

    def dbg(msg):
        head, _, tail = msg.partition(": ")
        a, b = (int(x.split("=")[1]) for x in head.split())
        if tail.startswith("age-skip"):
            return
        rec = {"kf_a": a, "kf_b": b, "bow": None, "ransac": None, "lm": None, "total": None,
               "accepted": tail.startswith("ACCEPT")}
        if tail.startswith("bow-matches"):
            rec["bow"] = int(tail.split()[1])
        else:
            rec.update(bow=last.get("bow"), ransac=last.get("ransac"))
            if not tail.startswith("ransac"):
                rec["lm"] = last.get("lm")
            if rec["lm"] is not None and rec["lm"] >= 20:
                rec["total"] = rec["lm"] + last.get("guided", 0)
        recs.append(rec)
        last.clear()

    j_lc.sim3_solver.solve_sim3_ransac = ransac_
    lc._refine_sim3, lc._guided_matches = refine_, guided_
    j_lc._dbg = dbg
    return recs


def run_system(args, pkg):
    """Drive the package's `System` (its modules given in `pkg`) over the
    frames; with `--loop`, the loop circuit with loop closing."""
    system_mod, synthetic, grays, depths, poses_gt, slam, to_np = pkg(args)
    rows, frame_of_rec, recs = [], [], None
    lc = slam.loop_closer
    tr = slam.tracker
    kf_frames = []
    tr.kf_inserted_cb = recording_keyframes(tr, tr.kf_inserted_cb, kf_frames)
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = time.perf_counter()
        n_kf_before = len(kf_frames)
        slam.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0)
        n_rec = len(lc.verifications) if lc is not None else 0
        frame_of_rec.extend([i] * (n_rec - len(frame_of_rec)))
        events = {"kf_inserted": len(kf_frames) > n_kf_before}
        if lc is not None:
            events.update(loops_closed=lc.n_loops_closed, gba_merged=lc.n_gba_merged,
                          gba_pending=lc._gba_pending is not None)
        rows.append(frame_row(i, int(slam.get_tracking_state()), int(tr.last_n_inliers),
                              int(tr.map.n_kf), int(tr.map.n_mp), to_np(tr.Tcw), poses_gt,
                              time.perf_counter() - t, **events))
    slam.kf_frames = kf_frames
    slam.shutdown()
    traj = slam.tracker.absolute_trajectory()
    if lc is not None:
        recs = [dict(r, at_frame=f) for r, f in zip(lc.verifications, frame_of_rec)]
    return rows, traj, poses_gt, recs, lc, slam


def centre(T):
    return np.linalg.inv(np.asarray(T, np.float64))[:3, 3]


def run_torch(args):
    import torch

    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.ops import orb

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    T_rc1 = torch.eye(4)
    T_rc1[:3, :3] = se3.so3_exp(torch.tensor(T_RC1_ROTVEC, dtype=torch.float32))
    T_rc1[:3, 3] = torch.tensor(T_RC1_T)
    T_rc = torch.stack([torch.eye(4), T_rc1])
    calib = cam_mod.CameraParams(
        K=torch.tensor([K4] * C, device=dev), dist=torch.zeros((C, 5), device=dev),
        T_rc=T_rc.to(dev), bf=torch.tensor(40.0, device=dev), width=W, height=H)
    cfg = SlamConfig(n_cams=C, width=W, height=H, orb=orb.ORBConfig(n_features=1024))
    grays, depths, poses_gt = render(synthetic, args.scene, args.frames, T_rc.numpy(),
                                    args.noise, args.seed)
    tracker = tracking.Tracker(calib, cfg, pipelined=args.pipelined, pipeline_depth=3,
                               device=dev)
    pending = [None]

    def kf_cb(kf_slot):
        hint = int(pending[0]) if pending[0] is not None else None
        m = local_mapping.run_mapping_stage(tracker.map, kf_slot, tracker.frame_id,
                                            tracker.calib, cfg, covis_hint=hint)
        pending[0] = local_mapping.covis_kf_count(m, kf_slot)
        return m

    kf_frames = []
    if args.mapping:
        tracker.kf_inserted_cb = recording_keyframes(tracker, kf_cb, kf_frames)
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = time.perf_counter()
        state = tracker.process(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev))
        rows.append(frame_row(i, int(state), tracker.last_n_inliers, int(tracker.map.n_kf),
                              int(tracker.map.n_mp), tracker.Tcw.cpu().numpy(), poses_gt,
                              time.perf_counter() - t))
    traj = tracker.absolute_trajectory()
    return (rows, [bool(lost) for *_, lost in traj], [np.asarray(T) for _, _, T, _ in traj],
            poses_gt, kf_frames)


def recording_keyframes(tracker, kf_cb, kf_frames):
    """`kf_cb` that first appends the keyframe's frame id to `kf_frames`."""
    def on_keyframe(kf_slot):
        kf_frames.append(int(tracker.last_kf_frame))
        return kf_cb(kf_slot)
    return on_keyframe


def system_torch(args):
    import torch

    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.ops import orb
    from multi_orb_slam_tpu_torch.placerec import database, vocabulary

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    T_rc1 = torch.eye(4)
    T_rc1[:3, :3] = se3.so3_exp(torch.tensor(T_RC1_ROTVEC, dtype=torch.float32))
    T_rc1[:3, 3] = torch.tensor(T_RC1_T)
    T_rc = torch.stack([torch.eye(4), T_rc1])
    if args.loop:
        K4, bf, (Hh, Ww) = LOOP_K4, 20.0, (LOOP_H, LOOP_W)
        cfg = SlamConfig(**loop_cfg_kw(), orb=orb.ORBConfig(n_features=512))
        grays, depths, poses_gt = render_loop_circuit(synthetic, T_rc.numpy(), args.noise,
                                                      args.seed)
    elif args.scene == "longrun":
        (Hh, Ww), K4, bf, _ = LONG_SIZES[args.size]
        kw, n_feat = longrun_cfg_kw(args.size)
        cfg = SlamConfig(**kw, orb=orb.ORBConfig(n_features=n_feat))
        grays, depths, poses_gt = render_longrun(synthetic, T_rc.numpy(), args.size)
    else:
        K4, bf, (Hh, Ww) = K4_BENCH, 40.0, (H, W)
        cfg = SlamConfig(n_cams=C, width=W, height=H, orb=orb.ORBConfig(n_features=1024))
        grays, depths, poses_gt = render(synthetic, args.scene, args.frames, T_rc.numpy(),
                                        args.noise, args.seed)
    calib = cam_mod.CameraParams(
        K=torch.tensor([K4] * C, device=dev), dist=torch.zeros((C, 5), device=dev),
        T_rc=T_rc.to(dev), bf=torch.tensor(bf, device=dev), width=Ww, height=Hh)
    slam = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg,
                             enable_loop_closing=loop_on(args), pipelined=args.pipelined,
                             pipeline_depth=3, device=dev)
    if loop_on(args):
        descs = [orb.extract_orb(torch.from_numpy(grays[i][0]).to(dev), cfg.orb)
                 for i in range(0, len(grays), 8)]
        descs = np.concatenate([f.desc[f.valid].cpu().numpy() for f in descs])
        voc = vocabulary.build_vocabulary(descs, k=10, depth=4, iters=3, device=dev)
        slam.loop_closer.voc = voc
        slam.loop_closer.db = database.make_empty_db(cfg.max_kf, voc.n_words, device=dev)
    return (system_mod, synthetic, grays, depths, poses_gt, slam,
            lambda T: T.cpu().numpy() if isinstance(T, torch.Tensor) else np.asarray(T))


def system_jax(args):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.extend.backend

    jax.config.update("jax_platforms", "cpu")
    jax.extend.backend.clear_backends()
    import jax.numpy as jnp

    from multi_orb_slam_tpu import system as system_mod
    from multi_orb_slam_tpu.config import SlamConfig
    from multi_orb_slam_tpu.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu.io import synthetic
    from multi_orb_slam_tpu.loop import loop_closing as j_lc
    from multi_orb_slam_tpu.ops import orb
    from multi_orb_slam_tpu.placerec import database, vocabulary

    Ry = se3.so3_exp(jnp.asarray(T_RC1_ROTVEC, jnp.float32))
    T_rc = jnp.stack([jnp.eye(4), jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(
        jnp.asarray(T_RC1_T))]).astype(jnp.float32)
    if args.loop:
        K4, bf, (Hh, Ww) = LOOP_K4, 20.0, (LOOP_H, LOOP_W)
        cfg = SlamConfig(**loop_cfg_kw(), orb=orb.ORBConfig(n_features=512))
        grays, depths, poses_gt = render_loop_circuit(synthetic, np.asarray(T_rc), args.noise,
                                                      args.seed)
    elif args.scene == "longrun":
        (Hh, Ww), K4, bf, _ = LONG_SIZES[args.size]
        kw, n_feat = longrun_cfg_kw(args.size)
        cfg = SlamConfig(**kw, orb=orb.ORBConfig(n_features=n_feat))
        grays, depths, poses_gt = render_longrun(synthetic, np.asarray(T_rc), args.size)
    else:
        K4, bf, (Hh, Ww) = K4_BENCH, 40.0, (H, W)
        cfg = SlamConfig(n_cams=C, width=W, height=H, orb=orb.ORBConfig(n_features=1024))
        grays, depths, poses_gt = render(synthetic, args.scene, args.frames, np.asarray(T_rc),
                                        args.noise, args.seed)
    calib = cam_mod.CameraParams(K=jnp.tile(jnp.asarray([K4]), (C, 1)), dist=jnp.zeros((C, 5)),
                                 T_rc=T_rc, bf=jnp.asarray(bf), width=Ww, height=Hh)
    slam = system_mod.System(calib=calib, cfg=cfg, sensor=system_mod.Sensor.DUAL_RGBD,
                             enable_loop_closing=loop_on(args), pipelined=args.pipelined,
                             pipeline_depth=3)
    if loop_on(args):
        descs = []
        for i in range(0, len(grays), 8):
            f = orb.extract_orb(jnp.asarray(grays[i][0]), cfg.orb)
            descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
        voc = vocabulary.build_vocabulary(np.concatenate(descs), k=10, depth=4, iters=3)
        lc = slam.loop_closer
        lc.voc, lc.db = voc, database.make_empty_db(cfg.max_kf, voc.n_words)
        lc.verifications = record_jax_verifications(lc, j_lc)
    return system_mod, synthetic, grays, depths, poses_gt, slam, np.asarray


def run_jax(args):
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.extend.backend

    jax.config.update("jax_platforms", "cpu")
    jax.extend.backend.clear_backends()
    import jax.numpy as jnp

    from multi_orb_slam_tpu.config import SlamConfig
    from multi_orb_slam_tpu.frontend import tracking
    from multi_orb_slam_tpu.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu.io import synthetic
    from multi_orb_slam_tpu.mapping import local_mapping
    from multi_orb_slam_tpu.ops import orb

    Ry = se3.so3_exp(jnp.asarray(T_RC1_ROTVEC, jnp.float32))
    T_rc1 = jnp.eye(4).at[:3, :3].set(Ry).at[:3, 3].set(jnp.asarray(T_RC1_T))
    T_rc = jnp.stack([jnp.eye(4), T_rc1])
    calib = cam_mod.CameraParams(K=jnp.tile(jnp.asarray([K4]), (C, 1)), dist=jnp.zeros((C, 5)),
                                 T_rc=T_rc, bf=jnp.asarray(40.0), width=W, height=H)
    cfg = SlamConfig(n_cams=C, width=W, height=H, orb=orb.ORBConfig(n_features=1024))
    grays, depths, poses_gt = render(synthetic, args.scene, args.frames, np.asarray(T_rc),
                                    args.noise, args.seed)
    tracker = tracking.Tracker(calib, cfg, pipelined=args.pipelined, pipeline_depth=3)
    pending = [None]

    def kf_cb(kf_slot):
        hint = int(pending[0]) if pending[0] is not None else None
        m = local_mapping.run_mapping_stage(tracker.map, kf_slot, tracker.frame_id,
                                            calib, cfg, covis_hint=hint)
        pending[0] = local_mapping.covis_kf_count(m, jnp.asarray(kf_slot, jnp.int32))
        return m

    kf_frames = []
    if args.mapping:
        tracker.kf_inserted_cb = recording_keyframes(tracker, kf_cb, kf_frames)
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = time.perf_counter()
        state = tracker.process(jnp.asarray(g), jnp.asarray(d))
        rows.append(frame_row(i, int(state), int(tracker.last_n_inliers),
                              int(tracker.map.n_kf), int(tracker.map.n_mp),
                              np.asarray(tracker.Tcw), poses_gt, time.perf_counter() - t))
    traj = tracker.absolute_trajectory()
    return (rows, [bool(lost) for *_, lost in traj], [np.asarray(T) for _, _, T, _ in traj],
            poses_gt, kf_frames)


def frame_row(i, state, n_inl, n_kf, n_mp, Tcw, poses_gt, seconds, **events):
    # ground truth starts at poses_gt[0], the tracker at the identity
    gt_rel = np.asarray(poses_gt[i], np.float64) @ np.linalg.inv(np.asarray(poses_gt[0], np.float64))
    err = float(np.linalg.norm(centre(Tcw) - centre(gt_rel)))
    row = {"frame": i, "state": state, "inliers": int(n_inl), "n_kf": n_kf, "n_mp": n_mp,
           "centre_err_m": err, "seconds": seconds, **events}
    print(json.dumps(row), flush=True)
    return row


def cmd_system(args):
    pkg = system_torch if args.package == "torch" else system_jax
    rows, traj, poses_gt, recs, lc, slam = run_system(args, pkg)
    lost = [bool(x[-1]) for x in traj]
    fids = [fid for fid, *_ in traj]
    est = np.stack([centre(T) for _, _, T, _ in traj])
    gt = np.stack([centre(poses_gt[min(f, len(poses_gt) - 1)]) for f in fids])
    ate = ate_rmse(est, gt)
    last_err = float(np.linalg.norm(centre(traj[-1][2]) - centre(
        np.asarray(poses_gt[fids[-1]], np.float64) @ np.linalg.inv(np.asarray(poses_gt[0], np.float64)))))
    st = slam.tracker.map
    scene = "loop-circuit" if args.loop else args.scene
    if args.scene == "longrun":
        scene = f"longrun-{args.size}"
    out = {"package": args.package, "scene": scene,
           "system": True, "loop": loop_on(args), "pipelined": args.pipelined,
           "device": args.device if args.package == "torch" else "cpu", "frames": rows,
           "lost": lost, "ate_m": ate, "last_pose_err_m": last_err,
           "keyframes": int(rows[-1]["n_kf"]), "keyframe_frames": slam.kf_frames,
           "n_alloc_failed": int(st.n_alloc_failed), "verifications": recs,
           "n_loops_closed": None if lc is None else lc.n_loops_closed,
           "n_gba_merged": None if lc is None else lc.n_gba_merged}
    if args.scene == "longrun":
        n_not_ok = sum(1 for r in rows if r["state"] != 1)
        out["checks"] = longrun_checks(slam.kf_frames, n_not_ok, int(st.n_kf), int(st.n_mp),
                                       int(st.n_alloc_failed), slam.cfg)
    with open(args.out, "w") as f:
        json.dump(out, f)
    print(f"{args.package} System {out['scene']}: {len(lost) - sum(lost)}/{len(lost)} frames "
          f"tracked, keyframes {out['keyframes']}, ATE {ate:.4f} m (last pose {last_err:.4f} m), "
          f"loops closed {out['n_loops_closed']}, GBAs merged {out['n_gba_merged']}, "
          f"n_alloc_failed {out['n_alloc_failed']}")
    for r in recs or []:
        print(f"  verification at frame {r['at_frame']}: {r}")
    if "checks" in out:
        print(f"  keyframes created at frames {slam.kf_frames}")
        print(f"  test_longrun's checks: {json.dumps(out['checks'])}")


def ate_rmse(est, gt):
    """RMSE of camera centres after rigid (no-scale) alignment (numpy)."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    U, _, Vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ S @ Vt
    err = (est - mu_e) @ R.T + mu_g - gt
    return float(np.sqrt(np.mean(np.sum(err * err, -1))))


def cmd_run(args):
    if (args.loop or args.scene == "longrun") and not args.system:
        raise SystemExit("--loop and --scene longrun need --system")
    if args.system:
        return cmd_system(args)
    rows, lost, traj, poses_gt, kf_frames = (run_torch if args.package == "torch"
                                             else run_jax)(args)
    gt0_inv = np.linalg.inv(np.asarray(poses_gt[0], np.float64))
    gt_c = np.stack([centre(np.asarray(poses_gt[i], np.float64) @ gt0_inv)
                     for i in range(len(traj))])
    est_c = np.stack([centre(T) for T in traj])
    final_err = [float(x) for x in np.linalg.norm(est_c - gt_c, axis=1)]
    ok = [i for i, x in enumerate(lost) if not x]
    ate = ate_rmse(est_c[ok], gt_c[ok])
    out = {"package": args.package, "scene": args.scene, "mapping": args.mapping,
           "pipelined": args.pipelined, "noise": args.noise, "seed": args.seed,
           "device": args.device if args.package == "torch" else "cpu",
           "frames": rows, "lost": lost, "final_centre_err_m": final_err,
           "keyframe_frames": kf_frames, "centres": est_c.tolist(), "ate_m": ate}
    with open(args.out, "w") as f:
        json.dump(out, f)
    first = lost.index(True) if True in lost else None
    print(f"{args.package} {args.scene} mapping={args.mapping} pipelined={args.pipelined}: "
          f"{len(ok)}/{len(lost)} frames tracked, first lost frame {first}, "
          f"keyframes {rows[-1]['n_kf']} at frames {kf_frames}, map points {rows[-1]['n_mp']}, "
          f"ATE over the tracked frames {ate * 1e3:.3f} mm")


def cmd_compare(args):
    runs = []
    for path in (args.a, args.b):
        with open(path) as f:
            runs.append(json.load(f))
    a, b = runs
    n = min(len(a["frames"]), len(b["frames"]))
    for r in runs:
        lost = r["lost"]
        print(f"{r['package']}: {sum(1 for x in lost if not x)}/{len(lost)} tracked, first lost "
              f"{lost.index(True) if True in lost else None}, keyframes {r['frames'][-1]['n_kf']}")
        if r.get("system"):
            print(f"  ATE {r['ate_m']:.4f} m, last pose {r['last_pose_err_m']:.4f} m, loops closed "
                  f"{r['n_loops_closed']}, GBAs merged {r['n_gba_merged']}")
            for v in r["verifications"] or []:
                print(f"  {v}")
    first_state = next((i for i in range(n) if a["lost"][i] != b["lost"][i]), None)
    first_kf = next((i for i in range(n) if a["frames"][i]["n_kf"] != b["frames"][i]["n_kf"]), None)
    first_inl = next((i for i in range(n) if abs(a["frames"][i]["inliers"] - b["frames"][i]["inliers"])
                      > 0.1 * max(a["frames"][i]["inliers"], 1)), None)
    print(f"first frame with another lost flag: {first_state}; another keyframe count: "
          f"{first_kf}; inliers more than 10% apart: {first_inl}")
    if "centres" in a and "centres" in b:
        d = np.linalg.norm(np.asarray(a["centres"])[:n] - np.asarray(b["centres"])[:n], axis=1)
        print(f"keyframes at frames {a['keyframe_frames']} / {b['keyframe_frames']}; ATE "
              f"{a['ate_m'] * 1e3:.3f} / {b['ate_m'] * 1e3:.3f} mm; camera centres apart: max "
              f"{d.max() * 1e3:.3f} mm at frame {int(d.argmax())}, first above 1 mm at frame "
              f"{next((i for i in range(n) if d[i] > 1e-3), None)}")
    print(f"{'frame':>5} | {a['package']:>5} inl n_kf  err mm lost | {b['package']:>5} inl n_kf  err mm lost")
    for i in range(n):
        ra, rb = a["frames"][i], b["frames"][i]
        ea = a.get("final_centre_err_m", [r["centre_err_m"] for r in a["frames"]])[i]
        eb = b.get("final_centre_err_m", [r["centre_err_m"] for r in b["frames"]])[i]
        print(f"{i:>5} | {ra['inliers']:>9} {ra['n_kf']:>4} {ea * 1e3:>7.1f} "
              f"{int(a['lost'][i]):>4} | {rb['inliers']:>9} {rb['n_kf']:>4} "
              f"{eb * 1e3:>7.1f} {int(b['lost'][i]):>4}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", required=True, choices=["torch", "jax"])
    r.add_argument("--scene", default="circuit", choices=["circuit", "orbit", "longrun"],
                   help="longrun: tests/test_longrun.py's 520 frames (needs --system)")
    r.add_argument("--size", default="test", choices=["test", "full"],
                   help="longrun at the test's 320x240 or at the bench's 640x480")
    r.add_argument("--frames", type=int, default=160)
    r.add_argument("--mapping", action="store_true")
    r.add_argument("--pipelined", action="store_true")
    r.add_argument("--system", action="store_true", help="drive System.track_rgbd")
    r.add_argument("--loop", action="store_true",
                   help="with --system: the loop circuit, loop closing and global BA on")
    r.add_argument("--noise", type=float, default=0.0,
                   help="sigma of Gaussian noise added to the grey images (grey levels)")
    r.add_argument("--seed", type=int, default=0, help="seed of that noise")
    r.add_argument("--device", default="cpu")
    r.add_argument("--threads", type=int, default=2)
    r.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("a")
    c.add_argument("b")
    args = ap.parse_args()
    (cmd_run if args.cmd == "run" else cmd_compare)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
