"""Command-line drivers of the port: the counterparts of the reference's
`examples/rgbd_tum.py`, `examples/stereo_kitti.py` and `examples/live_rgbd.py`.

Each exposes `main(argv=None)` and runs as a module, e.g.
`python -m multi_orb_slam_tpu_torch.drivers.rgbd_tum ...`.  Every driver
runs on the CUDA device unless given `--device cpu`, and decodes images
with `io/png.py` (no OpenCV).
"""
