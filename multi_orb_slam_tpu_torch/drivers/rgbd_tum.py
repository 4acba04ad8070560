"""TUM RGB-D driver: the counterpart of the reference's `examples/rgbd_tum.py`
(reference Examples/RGB-D/rgbd_tum.cc, the fork's one built example).

    python -m multi_orb_slam_tpu_torch.drivers.rgbd_tum settings.yaml seq_dir \\
        assoc1.txt [--assoc2 assoc2.txt --seq2 seq2_dir --calibration calib.txt] \\
        [--out trajectory.txt --kf-out kf.txt] [--no-realtime] \\
        [--native-loader] [--pipelined] [--device cpu]

- reads the association files (`t_rgb rgb_path t_depth depth_path` per line,
  one per camera) and decodes the images with `io/png.py`, or, for a single
  camera with `--native-loader`, with the port's native prefetching loader
  (`io/native_loader.py`)
- feeds the frames at the dataset's rate unless `--no-realtime`, and prints
  the median and mean tracking time around `track_rgbd` (rgbd_tum.cc:160-169)
- saves the TUM trajectory and the keyframe trajectory at the end
  (rgbd_tum.cc:183-186)

`--pipelined` runs `System(pipelined=True)`: the tracker's status scalars are
read one frame late, so a frame does not wait for its own host reads.  The
system runs on the CUDA device unless given `--device cpu`.  No vocabulary
argument: the loop stage trains its vocabulary online.
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


def load_assoc_pairs(path):
    """Association file: `t_rgb rgb_path t_depth depth_path` per line."""
    pairs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            pairs.append((float(v[0]), v[1], float(v[2]), v[3]))
    return pairs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m multi_orb_slam_tpu_torch.drivers.rgbd_tum",
        description="Track a TUM-layout RGB-D sequence (one or two cameras).")
    ap.add_argument("settings")
    ap.add_argument("sequence")
    ap.add_argument("assoc1")
    ap.add_argument("--assoc2")
    ap.add_argument("--seq2")
    ap.add_argument("--calibration")
    ap.add_argument("--out", default="CameraTrajectory.txt")
    ap.add_argument("--kf-out", default="KeyFrameTrajectory.txt")
    ap.add_argument("--no-realtime", action="store_true",
                    help="don't sleep to match dataset timestamps")
    ap.add_argument("--native-loader", action="store_true",
                    help="prefetch + decode frames with the native loader (one camera)")
    ap.add_argument("--pipelined", action="store_true",
                    help="read the tracker's status one frame late")
    add_device_arg(ap)
    return ap.parse_args(argv)


def _finish(slam, args, track_times, frame_times=None):
    slam.shutdown()
    print_track_times(track_times, frame_times)
    print_map_summary(slam)
    slam.save_trajectory_tum(args.out)
    slam.save_keyframe_trajectory_tum(args.kf_out)
    print(f"trajectory saved to {args.out}")
    return 0, slam


def main(argv=None) -> int:
    return run(argv)[0]


def run(argv=None):
    """What `main` does; returns (exit code, the System), so that a caller
    can inspect the map after the run."""
    args = parse_args(argv)
    dual = args.assoc2 is not None
    sensor = system_mod.Sensor.DUAL_RGBD if dual else system_mod.Sensor.RGBD
    slam = system_mod.System(
        settings_path=args.settings, calibration_path=args.calibration,
        sensor=sensor, pipelined=args.pipelined, device=args.device)
    inv_depth_factor = 1.0 / slam.depth_map_factor
    pairs1 = load_assoc_pairs(args.assoc1)

    native = None
    if args.native_loader and not dual:
        from ..io import native_loader
        if native_loader.native_available():
            items = [(os.path.join(args.sequence, p1), os.path.join(args.sequence, p3))
                     for _, p1, _, p3 in pairs1]
            native = native_loader.AsyncRGBDLoader(
                items, slam.cfg.height, slam.cfg.width, depth_factor=slam.depth_map_factor)
            print("using native async loader")
        else:
            print(f"native loader unavailable ({native_loader.build_error()}); "
                  f"reading with io/png.py")

    if native is not None:
        track_times = []
        try:
            for i, (gray, depth) in enumerate(native):
                t0 = time.perf_counter()
                slam.track_rgbd(gray, depth, timestamp=pairs1[i][0])
                track_times.append(time.perf_counter() - t0)
        finally:
            native.close()
        return _finish(slam, args, track_times)

    pairs2 = load_assoc_pairs(args.assoc2) if dual else None
    n = min(len(pairs1), len(pairs2)) if dual else len(pairs1)
    print(f"Start processing sequence ({n} images, "
          f"{'dual' if dual else 'single'} camera) ...")

    def read(root, rgb_rel, d_rel):
        gray = png.read_gray(os.path.join(root, rgb_rel)).astype(np.float32)
        depth = png.read_png(os.path.join(root, d_rel)).astype(np.float32)
        return gray, depth * inv_depth_factor

    track_times, frame_times = [], []
    for i in range(n):
        t_rgb, rgb_rel, _, d_rel = pairs1[i]
        t_read = time.perf_counter()
        try:
            im1, d1 = read(args.sequence, rgb_rel, d_rel)
            im2 = d2 = None
            if dual:
                _, rgb2, _, dd2 = pairs2[i]
                im2, d2 = read(args.seq2 or args.sequence, rgb2, dd2)
        except (OSError, png.PNGError) as e:
            print(f"Failed to load image at {args.sequence}/{rgb_rel}: {e}")
            return 1, slam
        t0 = time.perf_counter()
        slam.track_rgbd(im1, d1, im2, d2, timestamp=t_rgb)
        dt = time.perf_counter() - t0
        track_times.append(dt)
        frame_times.append(time.perf_counter() - t_read)
        if not args.no_realtime and i + 1 < n:
            gap = pairs1[i + 1][0] - t_rgb
            if dt < gap:
                time.sleep(gap - dt)
    return _finish(slam, args, track_times, frame_times)


if __name__ == "__main__":
    sys.exit(main())
