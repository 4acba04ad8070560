"""One frame of `tests/test_longrun.py`'s run, taken apart: where the port's
local-map tracking step leaves the reference's path.

    python3 tools/longrun_probe.py capture --device cuda --frame 14 --out card.pt
    python3 tools/longrun_probe.py capture --device cpu --frame 14 --out cpu.pt
    python3 tools/longrun_probe.py local-map card.pt cpu.pt

`capture` runs the port's `System(DUAL_RGBD)` (on graphs on the card) over the
long run's first frames at the test's 320x240 (`circuit_parity.py`'s
`--scene longrun --size test`: the vocabulary from camera 0 of every 8th
frame, loop closing on), prints each frame's state, inliers, keyframes and
camera-centre error, and saves the inputs that `tracking.track_local_map`
received on frame `--frame`, as CPU tensors.  It imports no jax, so it runs
on the card's machine.

`local-map` runs, on the CPU, the port's `track_local_map` body and the JAX
package's `track_local_map` on each saved input set, and prints their inliers
and positions; then, of the motion model's map matches (`frame_mp`), how many
carry a map position that reprojects more than 20 px from its keypoint under
the step's starting pose, and the port's result without them.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BAD_PX = 20.0


def _to(x, device):
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, tuple):
        vals = [_to(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def cmd_capture(args):
    import torch

    import circuit_parity as cp
    from multi_orb_slam_tpu_torch import system as system_mod
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.geometry import camera as cam_mod, se3
    from multi_orb_slam_tpu_torch.io import synthetic
    from multi_orb_slam_tpu_torch.ops import orb
    from multi_orb_slam_tpu_torch.placerec import database, vocabulary

    torch.set_num_threads(args.threads)
    dev = torch.device(args.device)
    T_rc1 = torch.eye(4)
    T_rc1[:3, :3] = se3.so3_exp(torch.tensor(cp.T_RC1_ROTVEC, dtype=torch.float32))
    T_rc1[:3, 3] = torch.tensor(cp.T_RC1_T)
    T_rc = torch.stack([torch.eye(4), T_rc1])
    (h, w), K4, bf, n_feat = cp.LONG_SIZES["test"]
    kw, _ = cp.longrun_cfg_kw("test")
    cfg = SlamConfig(**kw, orb=orb.ORBConfig(n_features=n_feat))
    calib = cam_mod.CameraParams(
        K=torch.tensor([K4] * cp.C, device=dev), dist=torch.zeros((cp.C, 5), device=dev),
        T_rc=T_rc.to(dev), bf=torch.tensor(bf, device=dev), width=w, height=h)
    # the frames this needs: the vocabulary's (every 8th) and the first ones
    world = synthetic.make_box_world(seed=11, n_points=5000, box=(7.0, 4.0, 7.0))
    poses = synthetic.circuit_trajectory(cp.LONG_FRAMES, radius=2.2, laps=2.2)
    lo, hi = cp.LONG_LOWTEX
    frames = {}
    for i in sorted(set(range(0, cp.LONG_FRAMES, 8)) | set(range(args.frame + 1))):
        g, d = synthetic.render_frames(world, K4, T_rc.numpy(), poses[i:i + 1], h, w)[0]
        frames[i] = ((100.0 + (g - 100.0) * 0.5).astype(np.float32) if lo <= i < hi else g, d)
    descs = [orb.extract_orb(torch.from_numpy(frames[i][0][0]).to(dev), cfg.orb)
             for i in range(0, cp.LONG_FRAMES, 8)]
    descs = np.concatenate([f.desc[f.valid].cpu().numpy() for f in descs])
    voc = vocabulary.build_vocabulary(descs, k=10, depth=4, iters=3, device=dev)
    slam = system_mod.System(sensor=system_mod.Sensor.DUAL_RGBD, calib=calib, cfg=cfg, device=dev)
    slam.loop_closer.voc = voc
    slam.loop_closer.db = database.make_empty_db(cfg.max_kf, voc.n_words, device=dev)
    saved = {}
    local_map = tracking.track_local_map

    def keep_inputs(*a, **k):
        if slam.tracker.frame_id == args.frame and not saved:
            saved.update(args=_to(a, "cpu"), kwargs=_to(k, "cpu"))
        return local_map(*a, **k)

    tracking.track_local_map = keep_inputs
    try:
        for i in range(args.frame + 1):
            g, d = (torch.from_numpy(x).to(dev) for x in frames[i])
            slam.track_rgbd(g[0], d[0], g[1], d[1], timestamp=i / 30.0)
            tr = slam.tracker
            gt = poses[i].astype(np.float64) @ np.linalg.inv(poses[0].astype(np.float64))
            err = np.linalg.norm(np.linalg.inv(tr.Tcw.cpu().numpy().astype(np.float64))[:3, 3]
                                 - np.linalg.inv(gt)[:3, 3])
            print(json.dumps({"frame": i, "state": int(tr.state), "inliers": int(tr.last_n_inliers),
                              "n_kf": int(tr.map.n_kf), "centre_err_mm": round(err * 1e3, 1)}))
    finally:
        tracking.track_local_map = local_map
    if not saved:
        raise SystemExit(f"frame {args.frame} did not reach track_local_map")
    torch.save(saved, args.out)
    print(f"track_local_map's inputs of frame {args.frame} on {dev} saved to {args.out}")


def cmd_local_map(args):
    import torch

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.extend.backend
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.extend.backend.clear_backends()
    from multi_orb_slam_tpu.config import SlamConfig as JCfg
    from multi_orb_slam_tpu.frontend import frame as j_frame, tracking as j_tr
    from multi_orb_slam_tpu.geometry import camera as j_cam
    from multi_orb_slam_tpu.mapping import map_state as j_ms
    from multi_orb_slam_tpu.ops import orb as j_orb, search as j_search
    from multi_orb_slam_tpu_torch import convert
    from multi_orb_slam_tpu_torch.frontend import tracking

    def to_jax(nt, cls):
        return cls(**{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                      for k, v in convert.to_numpy(nt).items()})

    body = tracking.track_local_map.__wrapped__
    for path in args.inputs:
        saved = torch.load(path, weights_only=False)
        state, Tcw, cur, frame_mp, pts, calib, cfg = saved["args"]
        port = body(*saved["args"], **saved["kwargs"])
        jcfg = JCfg(**{f: getattr(cfg, f) for f in JCfg._fields if f != "orb"},
                    orb=j_orb.ORBConfig(**cfg.orb._asdict()))
        ref = j_tr.track_local_map(
            to_jax(state, j_ms.MapState), jnp.asarray(Tcw.numpy()), to_jax(cur, j_frame.FrameData),
            jnp.asarray(frame_mp.numpy()), to_jax(pts, j_search.LocalPoints),
            to_jax(calib, j_cam.CameraParams), jcfg)
        # the motion model's matches whose map position reprojects far off
        C, F = frame_mp.shape
        fm = frame_mp.reshape(-1)
        ok = fm >= 0
        cam = torch.arange(C).repeat_interleave(F)
        T = calib.T_rc[cam] @ Tcw
        X = (T[:, :3, :3] @ state.mp_pos[fm.clamp(min=0).long()][..., None])[..., 0] + T[:, :3, 3]
        K = calib.K[cam]
        uv = torch.stack([K[:, 0] * X[:, 0] / X[:, 2] + K[:, 2],
                          K[:, 1] * X[:, 1] / X[:, 2] + K[:, 3]], -1)
        px = torch.linalg.norm(uv - cur.xy_und.reshape(-1, 2), dim=-1)
        bad = ok & ~(px <= BAD_PX)
        without = body(state, Tcw, cur, torch.where(bad, -1, fm).reshape(C, F), pts, calib, cfg)
        print(f"{path}: port {int(port[3])} inliers at t {np.round(port[1][:3, 3].numpy(), 4)}; "
              f"JAX {int(ref[3])} inliers at t {np.round(np.asarray(ref[1])[:3, 3], 4)}; "
              f"poses {float((port[1] - torch.from_numpy(np.array(ref[1]))).abs().max()):.2e} "
              f"apart")
        print(f"  motion-model map matches {int(ok.sum())}, of them {int(bad.sum())} reproject "
              f"> {BAD_PX:.0f} px (up to {float(px[bad].max()) if bool(bad.any()) else 0.0:.0f} "
              f"px; first frames {sorted(set(state.mp_first_frame[fm[bad].long()].tolist()))}); "
              f"the port without them: {int(without[3])} inliers")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("capture")
    c.add_argument("--device", default="cpu")
    c.add_argument("--frame", type=int, default=14)
    c.add_argument("--threads", type=int, default=4)
    c.add_argument("--out", required=True)
    m = sub.add_parser("local-map")
    m.add_argument("inputs", nargs="+")
    args = ap.parse_args()
    (cmd_capture if args.cmd == "capture" else cmd_local_map)(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
