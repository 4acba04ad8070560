"""Live RGB-D ingestion: stream frames into the tracker over a socket or
stdin.  The counterpart of the reference's `examples/live_rgbd.py` (the
live-capture row of the reference: its ROS nodes push synchronised RGB +
depth pairs into TrackRGBD, Examples/ROS/ORB_SLAM2/src/ros_rgbd.cc:76-86).

The transport is a length-prefixed binary protocol that any producer (a
camera daemon, a rosbag bridge, netcat) can speak:

    header:  magic  b"MOSL"
             uint32 n_cams, height, width
    frame:   uint64 timestamp_ns
             per camera: float32[H*W] gray, float32[H*W] depth_meters
    trailer: uint64 0xFFFFFFFFFFFFFFFF ends the stream

All integers and floats are little-endian.

    python -m multi_orb_slam_tpu_torch.drivers.live_rgbd settings.yaml \\
        [--calibration C] [--listen PORT | --stdin] [--out traj.txt] [--device cpu]
    python -m multi_orb_slam_tpu_torch.drivers.live_rgbd --selftest [--device cpu]

`--selftest` streams a rendered 20-frame sequence through a local socket
from a producer thread, end to end, with a default calibration that matches
the producer.  `serve` reads from any binary file object, so a test can hand
it a `BytesIO`.  Runs on the CUDA device unless given `--device cpu`.
"""

from __future__ import annotations

import argparse
import socket
import struct
import sys
import threading

import numpy as np

from ._common import add_device_arg

MAGIC = b"MOSL"
END_TS = 0xFFFFFFFFFFFFFFFF
SELFTEST_FRAMES = 20
SELFTEST_H, SELFTEST_W = 240, 320


def _read_exact(f, n):
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError("stream closed mid-frame")
        buf += chunk
    return buf


def read_header(stream):
    """(n_cams, height, width) from the stream's header."""
    magic = _read_exact(stream, 4)
    if magic != MAGIC:
        raise ValueError(f"bad stream magic {magic!r}")
    return struct.unpack("<III", _read_exact(stream, 12))


def serve(stream, slam, n_cams, h, w):
    """Track frames from a binary stream until the end marker; returns the
    number of frames tracked."""
    frame_bytes = h * w * 4
    n = 0
    while True:
        ts = struct.unpack("<Q", _read_exact(stream, 8))[0]
        if ts == END_TS:
            break
        grays, depths = [], []
        for _ in range(n_cams):
            for out in (grays, depths):
                out.append(np.frombuffer(bytearray(_read_exact(stream, frame_bytes)),
                                         "<f4").reshape(h, w))
        if n_cams == 2:
            slam.track_rgbd(grays[0], depths[0], grays[1], depths[1], timestamp=ts * 1e-9)
        else:
            slam.track_rgbd(grays[0], depths[0], timestamp=ts * 1e-9)
        n += 1
    return n


def write_stream(f, grays, depths, timestamps):
    """Write a whole stream: grays, depths [N, C, H, W] float32 (depth in
    metres), timestamps [N] seconds."""
    n_cams, h, w = np.asarray(grays[0]).shape
    f.write(MAGIC + struct.pack("<III", n_cams, h, w))
    for g, d, t in zip(grays, depths, timestamps):
        f.write(struct.pack("<Q", int(round(t * 1e9))))
        for c in range(n_cams):
            f.write(np.ascontiguousarray(g[c], "<f4").tobytes())
            f.write(np.ascontiguousarray(d[c], "<f4").tobytes())
    f.write(struct.pack("<Q", END_TS))
    f.flush()


def selftest_sequence(n_frames=SELFTEST_FRAMES):
    """The self-test's rendered single-camera sequence."""
    from ..io import synthetic

    return synthetic.make_sequence(n_frames=n_frames, height=SELFTEST_H, width=SELFTEST_W,
                                   n_points=2500)


def selftest_system(h, w, device=None):
    """A `System` with the default calibration of the self-test's producer."""
    import torch

    from .. import system as system_mod
    from ..config import SlamConfig
    from ..geometry import camera as cam_mod
    from ..ops import orb

    cfg = SlamConfig(n_cams=1, max_feat=512, width=w, height=h,
                     orb=orb.ORBConfig(n_features=512))
    calib = cam_mod.CameraParams(
        K=torch.tensor([[520.9, 521.0, w / 2.0, h / 2.0]]), dist=torch.zeros((1, 5)),
        T_rc=torch.eye(4)[None], bf=torch.tensor(40.0), width=w, height=h)
    return system_mod.System(calib=calib, cfg=cfg, sensor=system_mod.Sensor.RGBD,
                             device=device)


def serve_stream(stream, args):
    """Read the header, build the System (from the settings, or the
    self-test's defaults), track the stream, save the trajectory."""
    from .. import system as system_mod

    n_cams, h, w = read_header(stream)
    if args.settings:
        sensor = system_mod.Sensor.DUAL_RGBD if n_cams == 2 else system_mod.Sensor.RGBD
        slam = system_mod.System(settings_path=args.settings,
                                 calibration_path=args.calibration, sensor=sensor,
                                 device=args.device)
    else:
        slam = selftest_system(h, w, args.device)
    n = serve(stream, slam, n_cams, h, w)
    slam.shutdown()
    slam.save_trajectory_tum(args.out)
    return n


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m multi_orb_slam_tpu_torch.drivers.live_rgbd",
        description="Track RGB-D frames streamed over a socket or stdin.")
    ap.add_argument("settings", nargs="?")
    ap.add_argument("--calibration")
    ap.add_argument("--listen", type=int, default=0)
    ap.add_argument("--stdin", action="store_true")
    ap.add_argument("--out", default="LiveTrajectory.txt")
    ap.add_argument("--selftest", action="store_true")
    add_device_arg(ap)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.selftest:
        seq = selftest_sequence()
        srv = socket.socket()
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        srv.settimeout(120)
        port = srv.getsockname()[1]
        errors = []

        def produce():
            try:
                with socket.create_connection(("127.0.0.1", port), timeout=60) as sock:
                    with sock.makefile("wb") as f:
                        write_stream(f, seq.grays, seq.depths, seq.timestamps)
            except OSError as e:
                errors.append(e)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        conn, _ = srv.accept()
        with conn, conn.makefile("rb") as stream:
            n = serve_stream(stream, args)
        producer.join()
        srv.close()
        if errors:
            raise errors[0]
        print(f"selftest: tracked {n} streamed frames")
        return 0

    if args.stdin:
        n = serve_stream(sys.stdin.buffer, args)
    elif args.listen:
        srv = socket.socket()
        srv.bind(("0.0.0.0", args.listen))
        srv.listen(1)
        print(f"listening on :{args.listen}")
        conn, addr = srv.accept()
        print(f"producer connected from {addr}")
        with conn, conn.makefile("rb") as stream:
            n = serve_stream(stream, args)
        srv.close()
    else:
        print("need --listen PORT, --stdin, or --selftest")
        return 1
    print(f"tracked {n} streamed frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
