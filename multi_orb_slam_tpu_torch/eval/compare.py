"""Two-trajectory ATE comparison with overlay plot.

Re-implements OtherFiles/evaluate_ate_camparison.py (sic): align two
estimated trajectories against one ground truth, print both ATE statistics,
and render a single overlay figure (counterpart of
`multi_orb_slam_tpu/eval/compare.py`; matplotlib is imported only to plot).

    python -m multi_orb_slam_tpu_torch.eval.compare gt.txt est1.txt est2.txt \
        [--plot out.png]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..geometry import align
from ..io import tum
from .ate import evaluate_ate


def aligned_xyz(gt_file: str, est_file: str, max_difference: float = 0.02):
    gt = tum.read_trajectory_tum(gt_file)
    est = tum.read_trajectory_tum(est_file)
    matches = tum.associate({t: [0] for t in gt}, {t: [0] for t in est},
                            max_difference=max_difference)
    gt_xyz = np.stack([gt[a][:3, 3] for a, _ in matches])
    est_xyz = np.stack([est[b][:3, 3] for _, b in matches])
    _, R, t = align.umeyama(torch.from_numpy(est_xyz), torch.from_numpy(gt_xyz),
                            with_scale=False)
    return gt_xyz, est_xyz @ R.numpy().T + t.numpy()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("gt")
    ap.add_argument("est1")
    ap.add_argument("est2")
    ap.add_argument("--plot", default="ate_comparison.png")
    args = ap.parse_args()

    for name, est in [("est1", args.est1), ("est2", args.est2)]:
        res = evaluate_ate(args.gt, est)
        print(f"{name}: rmse="
              f"{res['absolute_translational_error.rmse']:.4f} m over "
              f"{res['compared_pose_pairs']} pairs")

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    gt_xyz, a1 = aligned_xyz(args.gt, args.est1)
    _, a2 = aligned_xyz(args.gt, args.est2)
    ax.plot(gt_xyz[:, 0], gt_xyz[:, 2], "k-", label="ground truth")
    ax.plot(a1[:, 0], a1[:, 2], "b-", label="estimate 1")
    ax.plot(a2[:, 0], a2[:, 2], "r-", label="estimate 2")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend()
    fig.savefig(args.plot, dpi=120, bbox_inches="tight")
    print(f"plot saved to {args.plot}")


if __name__ == "__main__":
    main()
