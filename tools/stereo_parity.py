"""The stereo path of the PyTorch port against the JAX package on the CPU, on
one rendered scene: the stereo frames and the `System(STEREO)` trajectory.

    python3 tools/stereo_parity.py                          # tests/test_stereo.py's scene
    python3 tools/stereo_parity.py --bf 139.66 --points 16000 --box 12 --orbit 30 --seed 1

The scene is `tests/test_stereo.py`'s by default: 320x240, K = (260, 260,
160, 120), 512 features, bf = 20, `make_box_world(seed, points, box)`, the
first `--frames` poses of `orbit_trajectory(--orbit)`, the right camera
shifted by bf / fx along +x.  `--bf 139.66` gives KITTI's ratio of baseline
to focal length (386.1448 / 718.856).

The reference builds each stereo frame (`build_frame_stereo`, jitted) and
runs one `System` on them.  The port runs three ways: `track_stereo` on the
raw images ("own"); the same with the reference's `build_pyramid` in place
of its own ("reference pyramid"); and its tracker on the reference's own
frames ("reference frames").  For each, the script prints one JSON line:
per pair, the left keypoints shared with the reference and those with the
same match decision; the keyframes; the largest distance between the two
runs' camera centres; each run's ATE.  About 1 minute on 4 CPU cores.
"""

import argparse
import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.extend.backend  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.extend.backend.clear_backends()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from multi_orb_slam_tpu import system as j_system  # noqa: E402
from multi_orb_slam_tpu.frontend import frame as j_frame, tracking as j_tracking  # noqa: E402
from multi_orb_slam_tpu.geometry import camera as j_cam  # noqa: E402
from multi_orb_slam_tpu.io import synthetic  # noqa: E402
from multi_orb_slam_tpu.ops import orb as j_orb  # noqa: E402
from multi_orb_slam_tpu_torch import convert, system as t_system  # noqa: E402
from multi_orb_slam_tpu_torch.config import SlamConfig as TCfg  # noqa: E402
from multi_orb_slam_tpu_torch.frontend import frame as t_frame  # noqa: E402
from multi_orb_slam_tpu_torch.geometry import align as t_align, camera as t_cam  # noqa: E402
from multi_orb_slam_tpu_torch.ops import orb as t_orb  # noqa: E402

H, W = 240, 320


def reference_pyramid(img, cfg):
    """The reference's `build_pyramid` of each image of a [..., H, W] batch,
    in the port's layout."""
    jcfg = j_orb.ORBConfig(**cfg._asdict())
    flat = img.reshape(-1, *img.shape[-2:]).cpu().numpy()
    per_img = [j_orb.build_pyramid(jnp.asarray(im), jcfg) for im in flat]
    return [torch.from_numpy(np.stack([np.asarray(p[lvl]) for p in per_img]))
            .reshape(*img.shape[:-2], *per_img[0][lvl].shape)
            for lvl in range(cfg.n_levels)]


def pair_parity(fj, ft):
    """(left keypoints of the reference, shared, same match decision)."""
    def keyed(fr, host):
        xy, lv, ok = (host(v[0]) for v in (fr.xy, fr.level, fr.valid))
        return {(float(x), float(y), int(l)): i
                for i, ((x, y), l, v) in enumerate(zip(xy, lv, ok)) if v}

    kj, kt = keyed(fj, np.asarray), keyed(ft, lambda v: v.numpy())
    ij, it = (np.array(v) for v in zip(*[(kj[k], kt[k]) for k in kj if k in kt]))
    uj, ut = np.asarray(fj.uright[0])[ij], ft.uright[0].numpy()[it]
    return len(kj), len(ij), int(((uj >= 0) == (ut >= 0)).sum())


def centres(traj):
    return np.stack([np.linalg.inv(np.asarray(T))[:3, 3] for _, _, T, _ in traj])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bf", type=float, default=20.0)
    ap.add_argument("--points", type=int, default=3000)
    ap.add_argument("--box", type=float, default=6.0)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--orbit", type=int, default=None,
                    help="length of the orbit whose first --frames poses are used")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    calib_j = j_cam.CameraParams(K=jnp.asarray(K[None]), dist=jnp.zeros((1, 5)),
                                 T_rc=jnp.eye(4)[None], bf=jnp.asarray(args.bf),
                                 width=W, height=H)
    cfg_j = j_tracking.SlamConfig(n_cams=1, max_feat=512, max_kf=32, max_mp=8192,
                                  local_cap=1024, new_mp_per_cam=128, width=W, height=H,
                                  th_depth=6.0, orb=j_orb.ORBConfig(n_features=512))
    calib_t = convert.to_torch(calib_j, t_cam.CameraParams, "cpu")
    cfg_t = TCfg(**{**cfg_j._asdict(), "orb": t_orb.ORBConfig(**cfg_j.orb._asdict())})

    world = synthetic.make_box_world(seed=args.seed, n_points=args.points,
                                     box=(args.box, 4.0, args.box))
    poses = synthetic.orbit_trajectory(args.orbit or args.frames)[:args.frames]
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -args.bf / K[0]
    lefts = [synthetic.render_rgbd(world, K, P, H, W)[0].astype(np.float32) for P in poses]
    rights = [synthetic.render_rgbd(world, K, T_lr @ P, H, W)[0].astype(np.float32)
              for P in poses]
    gt0 = np.linalg.inv(poses[0])
    gt = np.stack([np.linalg.inv(P @ gt0)[:3, 3] for P in poses])

    def ate(c):
        return float(t_align.ate_rmse(torch.from_numpy(c), torch.from_numpy(gt)))

    frames_j = [j_frame.build_frame_stereo(jnp.asarray(a), jnp.asarray(b), calib_j, cfg_j.orb)
                for a, b in zip(lefts, rights)]
    sys_j = j_system.System(sensor=j_system.Sensor.STEREO, calib=calib_j, cfg=cfg_j,
                            enable_loop_closing=False)
    for i, fr in enumerate(frames_j):
        sys_j.tracker.process_frame(fr, i / 30.0)
    c_j = centres(sys_j.tracker.absolute_trajectory())
    print(json.dumps({"scene": vars(args), "reference": {
        "keyframes": int(sys_j.map.n_kf), "ate_m": ate(c_j)}}))

    own_pyramid = t_orb.build_pyramid
    for name in ("own", "reference pyramid", "reference frames"):
        t_orb.build_pyramid = reference_pyramid if name == "reference pyramid" else own_pyramid
        sys_t = t_system.System(sensor=t_system.Sensor.STEREO, calib=calib_t, cfg=cfg_t,
                                enable_loop_closing=False, device="cpu")
        pairs = []
        for i in range(args.frames):
            if name == "reference frames":
                sys_t.tracker.process_frame(
                    convert.to_torch(frames_j[i], t_frame.FrameData, "cpu"), i / 30.0)
                continue
            sys_t.track_stereo(lefts[i], rights[i], timestamp=i / 30.0)
            ft = t_frame.build_frame_stereo(torch.from_numpy(lefts[i]),
                                            torch.from_numpy(rights[i]), calib_t, cfg_t.orb)
            pairs.append(pair_parity(frames_j[i], ft))
        c_t = centres(sys_t.tracker.absolute_trajectory())
        part = np.linalg.norm(c_t - c_j, axis=1)
        print(json.dumps({"port": name, "pairs": pairs, "keyframes": int(sys_t.map.n_kf),
                          "lost": sum(bool(lost) for *_, lost in
                                      sys_t.tracker.absolute_trajectory()),
                          "max_part_mm": float(part.max() * 1e3),
                          "part_mm": [round(float(p) * 1e3, 2) for p in part],
                          "ate_m": ate(c_t)}))
    t_orb.build_pyramid = own_pyramid


if __name__ == "__main__":
    main()
