"""Distributed global BA: seconds per outer iteration at a world size.

Counterpart of `examples/bench_dist_ba.py`, over `torch.distributed`:

    python -m multi_orb_slam_tpu_torch.drivers.bench_dist_ba --devices 1
    torchrun --nproc-per-node N -m multi_orb_slam_tpu_torch.drivers.bench_dist_ba

Under torchrun the world is torchrun's; otherwise `--devices` ranks are
started on this host (`multihost.spawn_local`).  Each rank builds the same
synthetic problem (the reference script's, `RandomState(0)`), keeps its
shard, and runs the sharded step once to warm up and three times timed.
Rank 0 prints one JSON line.  NCCL needs a card a rank: on a one-card
machine a world above 1 runs on gloo (`--backend gloo`), whose collectives
stage CUDA tensors through the host, so its time is no scaling measurement.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from .. import resolve_device
from ..parallel import dryrun, multihost
from ._common import add_device_arg

BENCH_K = (500.0, 500.0, 320.0, 240.0)
BENCH_BF = 40.0


def make_problem(n_kf: int = 128, n_points: int = 16384, slots: int = 512, T_rc=None,
                 half: float = 4.0, centre=(0.0, 0.0, 6.0), pose_noise: float = 0.0,
                 point_noise: float = 0.0) -> dict:
    """The reference script's synthetic BA problem (`examples/bench_dist_ba.py`),
    drawn in its order from `RandomState(0)` (K 500/500/320/240, bf 40 on
    every camera): keyframe k at x translation 0.05 k (the first fixed),
    points uniform in a cube of half side `half` about `centre`, and per
    keyframe and camera `slots` distinct random points, each observed where it
    lies 0.3 m or more in front of the camera, with 0.5 px noise on u and v.
    `T_rc` [C, 4, 4] gives the rig (default: one camera).  With `pose_noise` /
    `point_noise` (drawn after the rest) the free poses (se(3) draws of that
    scale) and the points start off the truth.

    Returns the `flatten_problem` inputs (`kf_Tcw`, `kf_valid`, `kf_free`,
    `kf_mp`, `obs_uvr`, `obs_is2`, `mp_pos`, `mp_valid`), the calibration
    (`T_rc`, `K_intr`, `bf`) and the truth (`poses_gt`, `pts_gt`), as numpy."""
    from ..geometry import se3

    rng = np.random.RandomState(0)
    T_rc = np.eye(4, dtype=np.float32)[None] if T_rc is None else np.asarray(T_rc, np.float32)
    C = T_rc.shape[0]
    kf_Tcw = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    kf_Tcw[:, 0, 3] = 0.05 * np.arange(n_kf)
    kf_free = np.ones(n_kf, bool)
    kf_free[0] = False
    pts = rng.uniform(-half, half, (n_points, 3)).astype(np.float32)
    pts += np.asarray(centre, np.float32)
    Kintr = np.tile(np.asarray(BENCH_K, np.float32), (C, 1))
    bf32 = np.float32(BENCH_BF)
    kf_mp = np.full((n_kf, C, slots), -1, np.int32)
    uvr = np.zeros((n_kf, C, slots, 3), np.float32)
    for k in range(n_kf):
        for c in range(C):
            T = T_rc[c] @ kf_Tcw[k]
            sel = rng.choice(n_points, slots, replace=False)
            Xc = (pts @ T[:3, :3].T + T[:3, 3])[sel]
            j = np.nonzero(Xc[:, 2] >= 0.3)[0]
            u = Kintr[c, 0] * Xc[j, 0] / Xc[j, 2] + Kintr[c, 2]
            v = Kintr[c, 1] * Xc[j, 1] / Xc[j, 2] + Kintr[c, 3]
            noise = (rng.randn(len(j), 2) * 0.5).astype(np.float32)
            kf_mp[k, c, j] = sel[j]
            uvr[k, c, j] = np.stack([u + noise[:, 0], v + noise[:, 1], u - bf32 / Xc[j, 2]], -1)
    poses_gt, pts_gt = kf_Tcw.copy(), pts.copy()
    if pose_noise:
        xi = torch.from_numpy((rng.randn(n_kf, 6) * pose_noise).astype(np.float32))
        moved = (se3.exp(xi) @ torch.from_numpy(kf_Tcw)).numpy()
        kf_Tcw = np.where(kf_free[:, None, None], moved, kf_Tcw)
    if point_noise:
        pts = pts + (rng.randn(n_points, 3) * point_noise).astype(np.float32)
    return dict(kf_Tcw=kf_Tcw, kf_valid=np.ones(n_kf, bool), kf_free=kf_free, kf_mp=kf_mp,
                obs_uvr=uvr, obs_is2=np.ones((n_kf, C, slots), np.float32), mp_pos=pts,
                mp_valid=np.ones(n_points, bool), T_rc=T_rc, K_intr=Kintr, bf=bf32,
                poses_gt=poses_gt, pts_gt=pts_gt)


def bench_rank(mesh: multihost.Mesh, n_kf: int, n_points: int, slots: int, outer: int) -> dict:
    """One rank of the benchmark: build the problem, run the sharded step."""
    M = (n_points // mesh.world_size) * mesh.world_size
    prob = make_problem(n_kf, M, slots)
    res = dryrun.run_ba(mesh, prob, n_outer=outer, cg_iters=40, reps=3)
    return {"metric": "dist_gba_s_per_outer_iter", "value": res["s_per_outer_iter"],
            "unit": "s", "devices": mesh.world_size, "platform": mesh.device.type,
            "backend": res["backend"], "kfs": n_kf, "points": M,
            "cost_first": float(res["costs"][0]), "cost_last": float(res["costs"][-1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1,
                    help="world size when not under torchrun (ranks on this host)")
    ap.add_argument("--backend", default=None,
                    help="process-group backend (default: nccl on CUDA, gloo on the CPU)")
    ap.add_argument("--kfs", type=int, default=128)
    ap.add_argument("--points", type=int, default=16384)
    ap.add_argument("--obs-per-kf", type=int, default=512)
    ap.add_argument("--outer", type=int, default=6)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    shape = (args.kfs, args.points, args.obs_per_kf, args.outer)
    if "WORLD_SIZE" in os.environ:
        out = bench_rank(multihost.init_and_mesh(device=args.device, backend=args.backend),
                         *shape)
        if int(os.environ.get("RANK", 0)) != 0:
            return 0
    else:
        dev = resolve_device(args.device)
        out = multihost.spawn_local(bench_rank, args.devices,
                                    args.backend or multihost.default_backend(dev), dev,
                                    *shape)[0]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
