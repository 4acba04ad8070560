"""KITTI stereo driver: the counterpart of the reference's
`examples/stereo_kitti.py` (ORB-SLAM2's Examples/Stereo/stereo_kitti.cc,
settings as in Examples/Stereo/KITTI00-02.yaml).

    python -m multi_orb_slam_tpu_torch.drivers.stereo_kitti settings.yaml \\
        kitti_sequence_dir [--out trajectory_kitti.txt] [--max-frames N] \\
        [--device cpu]

Expects the KITTI layout: `image_0/` (left), `image_1/` (right), `times.txt`
(10 fps assumed where it is missing).  Images are decoded with `io/png.py`.
Prints the median and mean tracking time around `track_stereo` and saves
the trajectory in KITTI's 3x4 row-major format (reference
SaveTrajectoryKITTI, src/System.cc:450-503).  Runs on the CUDA device unless
given `--device cpu`.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from .. import system as system_mod
from ..io import png
from ._common import add_device_arg, print_map_summary, print_track_times


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m multi_orb_slam_tpu_torch.drivers.stereo_kitti",
        description="Track a KITTI-layout stereo sequence.")
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("--out", default="CameraTrajectory_kitti.txt")
    ap.add_argument("--max-frames", type=int, default=0)
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """What `main` does; returns (exit code, the System), so that a caller
    can inspect the map after the run."""
    args = parse_args(argv)
    left_dir = os.path.join(args.sequence, "image_0")
    right_dir = os.path.join(args.sequence, "image_1")
    times_path = os.path.join(args.sequence, "times.txt")
    names = sorted(os.listdir(left_dir))
    if os.path.exists(times_path):
        with open(times_path) as f:
            times = [float(x) for x in f if x.strip()]
    else:
        times = [i / 10.0 for i in range(len(names))]
    if args.max_frames:
        names = names[:args.max_frames]

    slam = system_mod.System(settings_path=args.settings, sensor=system_mod.Sensor.STEREO,
                             device=args.device)
    print(f"Start processing KITTI sequence ({len(names)} stereo pairs) ...")
    track_times, frame_times = [], []
    for i, name in enumerate(names):
        t_read = time.perf_counter()
        try:
            im_l = png.read_gray(os.path.join(left_dir, name)).astype(np.float32)
            im_r = png.read_gray(os.path.join(right_dir, name)).astype(np.float32)
        except (OSError, png.PNGError) as e:
            print(f"Failed to load pair {name}: {e}")
            return 1, slam
        t0 = time.perf_counter()
        slam.track_stereo(im_l, im_r, timestamp=times[i])
        track_times.append(time.perf_counter() - t0)
        frame_times.append(time.perf_counter() - t_read)

    slam.shutdown()
    print_track_times(track_times, frame_times)
    print_map_summary(slam)
    slam.save_trajectory_kitti(args.out)
    print(f"trajectory saved to {args.out}")
    return 0, slam


if __name__ == "__main__":
    sys.exit(main())
