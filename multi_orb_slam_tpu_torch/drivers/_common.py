"""What the drivers share: the `--device` option and the timing summary."""

from __future__ import annotations

import numpy as np


def add_device_arg(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the CUDA device; "
                         "'cpu' runs on the CPU)")


def print_track_times(track_times, frame_times=None) -> None:
    """The reference example's summary (rgbd_tum.cc:160-169), in seconds;
    with `frame_times`, also the median time of a whole frame: reading and
    decoding its images, then tracking it."""
    tt = np.sort(np.asarray(track_times, np.float64))
    print("-------")
    print(f"median tracking time: {tt[len(tt) // 2]:.4f}")
    print(f"mean tracking time: {np.mean(tt):.4f}")
    if frame_times:
        ft = np.sort(np.asarray(frame_times, np.float64))
        print(f"median frame time (read + track): {ft[len(ft) // 2]:.4f}")


def print_map_summary(slam) -> None:
    """Frames tracked, keyframes and map points against their capacities."""
    traj = slam.tracker.absolute_trajectory()
    n_ok = sum(1 for *_, lost in traj if not lost)
    st, cfg = slam.map, slam.cfg
    print(f"frames tracked {n_ok}/{len(traj)}, keyframes {int(st.n_kf)} of {cfg.max_kf}, "
          f"map points {int(st.n_mp)} of {cfg.max_mp}")
