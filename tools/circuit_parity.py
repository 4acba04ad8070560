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

Each run imports ONE package: `--package torch` the PyTorch port (on
`--device`, default cpu), `--package jax` the reference on the CPU.  Both
render the same frames with their own copy of the same numpy renderer.
`compare` prints the first frame at which the states differ, where the
inlier counts drift apart, and each run's first lost frame.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

H, W, C = 480, 640, 2
K4 = [520.9, 521.0, 320.0, 240.0]
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

    if args.mapping:
        tracker.kf_inserted_cb = kf_cb
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = time.perf_counter()
        state = tracker.process(torch.from_numpy(g).to(dev), torch.from_numpy(d).to(dev))
        rows.append(frame_row(i, int(state), tracker.last_n_inliers, int(tracker.map.n_kf),
                              int(tracker.map.n_mp), tracker.Tcw.cpu().numpy(), poses_gt,
                              time.perf_counter() - t))
    traj = tracker.absolute_trajectory()
    return rows, [bool(lost) for *_, lost in traj], [np.asarray(T) for _, _, T, _ in traj], poses_gt


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

    if args.mapping:
        tracker.kf_inserted_cb = kf_cb
    rows = []
    for i, (g, d) in enumerate(zip(grays, depths)):
        t = time.perf_counter()
        state = tracker.process(jnp.asarray(g), jnp.asarray(d))
        rows.append(frame_row(i, int(state), int(tracker.last_n_inliers),
                              int(tracker.map.n_kf), int(tracker.map.n_mp),
                              np.asarray(tracker.Tcw), poses_gt, time.perf_counter() - t))
    traj = tracker.absolute_trajectory()
    return rows, [bool(lost) for *_, lost in traj], [np.asarray(T) for _, _, T, _ in traj], poses_gt


def frame_row(i, state, n_inl, n_kf, n_mp, Tcw, poses_gt, seconds):
    # ground truth starts at poses_gt[0], the tracker at the identity
    gt_rel = np.asarray(poses_gt[i], np.float64) @ np.linalg.inv(np.asarray(poses_gt[0], np.float64))
    err = float(np.linalg.norm(centre(Tcw) - centre(gt_rel)))
    row = {"frame": i, "state": state, "inliers": int(n_inl), "n_kf": n_kf, "n_mp": n_mp,
           "centre_err_m": err, "seconds": seconds}
    print(json.dumps(row), flush=True)
    return row


def cmd_run(args):
    rows, lost, traj, poses_gt = (run_torch if args.package == "torch" else run_jax)(args)
    gt0_inv = np.linalg.inv(np.asarray(poses_gt[0], np.float64))
    final_err = [float(np.linalg.norm(centre(T) - centre(np.asarray(poses_gt[i], np.float64) @ gt0_inv)))
                 for i, T in enumerate(traj)]
    out = {"package": args.package, "scene": args.scene, "mapping": args.mapping,
           "pipelined": args.pipelined, "noise": args.noise, "seed": args.seed,
           "device": args.device if args.package == "torch" else "cpu",
           "frames": rows, "lost": lost, "final_centre_err_m": final_err}
    with open(args.out, "w") as f:
        json.dump(out, f)
    n_ok = sum(1 for x in lost if not x)
    first = lost.index(True) if True in lost else None
    print(f"{args.package} {args.scene} mapping={args.mapping} pipelined={args.pipelined}: "
          f"{n_ok}/{len(lost)} frames tracked, first lost frame {first}, "
          f"keyframes {rows[-1]['n_kf']}, map points {rows[-1]['n_mp']}")


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
    first_state = next((i for i in range(n) if a["lost"][i] != b["lost"][i]), None)
    first_kf = next((i for i in range(n) if a["frames"][i]["n_kf"] != b["frames"][i]["n_kf"]), None)
    first_inl = next((i for i in range(n) if abs(a["frames"][i]["inliers"] - b["frames"][i]["inliers"])
                      > 0.1 * max(a["frames"][i]["inliers"], 1)), None)
    print(f"first frame with another lost flag: {first_state}; another keyframe count: "
          f"{first_kf}; inliers more than 10% apart: {first_inl}")
    print(f"{'frame':>5} | {a['package']:>5} inl n_kf  err mm lost | {b['package']:>5} inl n_kf  err mm lost")
    for i in range(n):
        ra, rb = a["frames"][i], b["frames"][i]
        print(f"{i:>5} | {ra['inliers']:>9} {ra['n_kf']:>4} {a['final_centre_err_m'][i] * 1e3:>7.1f} "
              f"{int(a['lost'][i]):>4} | {rb['inliers']:>9} {rb['n_kf']:>4} "
              f"{b['final_centre_err_m'][i] * 1e3:>7.1f} {int(b['lost'][i]):>4}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run")
    r.add_argument("--package", required=True, choices=["torch", "jax"])
    r.add_argument("--scene", default="circuit", choices=["circuit", "orbit"])
    r.add_argument("--frames", type=int, default=160)
    r.add_argument("--mapping", action="store_true")
    r.add_argument("--pipelined", action="store_true")
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
