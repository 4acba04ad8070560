"""The port's drivers and image I/O, on the CPU.

- `io/png.py` against OpenCV both ways: every row filter at 8 and 16 bits
  written by the port and read by `cv2.imread`, images written by
  `cv2.imwrite` read by the port, RGB and RGBA turned to grey as
  `cv2.IMREAD_GRAYSCALE` does.
- `drivers/rgbd_tum.main` on `tests/test_drivers.py`'s generated datasets
  (single camera, single camera `--pipelined`), with that file's
  assertions plus ATE against the rendered poses (the dual rig, against the
  JAX `System`, is in `test_torch_drivers_reference.py`).
- `drivers/stereo_kitti.main`, `drivers/live_rgbd.serve` on a `BytesIO`
  stream, the native loader (skipped only where it does not build), and
  one subprocess run of the `rgbd_tum` module for the command-line form.

The datasets are written with `io/png.py` (lossless, so the same arrays as
`cv2.imwrite` would store).  Every driver runs with `--device cpu`.
"""

import io
import os
import subprocess
import sys

import cv2
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.io import synthetic
from multi_orb_slam_tpu_torch.drivers import live_rgbd, rgbd_tum, stereo_kitti
from multi_orb_slam_tpu_torch.geometry import align
from multi_orb_slam_tpu_torch.io import native_loader, png, tum

from test_drivers import write_settings

torch.set_num_threads(2)
K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# io/png.py against OpenCV
# ---------------------------------------------------------------------------


def _image(depth, seed=0, h=37, w=53):
    """A smooth image with noise (so every filter has work to do)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    top = 255 if depth == 8 else 65535
    base = (np.sin(xx / 5.0) + np.cos(yy / 7.0) + 2.0) / 4.0 * top
    img = np.clip(base + rng.randn(h, w) * top * 0.03, 0, top)
    return img.astype(np.uint8 if depth == 8 else np.uint16)


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("filter_type", ["none", "sub", "up", "average", "paeth", "mixed"])
def test_png_written_by_port_read_by_cv2(tmp_path, depth, filter_type):
    img = _image(depth)
    ft = {"none": png.NONE, "sub": png.SUB, "up": png.UP, "average": png.AVERAGE,
          "paeth": png.PAETH, "mixed": [4, 3, 0, 1, 2, 3, 3, 4, 1]}[filter_type]
    path = str(tmp_path / "x.png")
    png.write_png(path, img, ft)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    np.testing.assert_array_equal(png.read_gray(path), cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("depth", [8, 16])
def test_png_written_by_cv2_read_by_port(tmp_path, depth):
    for seed, (h, w) in enumerate(((240, 320), (31, 1241 // 8), (1, 5))):
        img = _image(depth, seed, h, w)
        path = str(tmp_path / f"{seed}.png")
        cv2.imwrite(path, img)
        np.testing.assert_array_equal(png.read_png(path), img)
        np.testing.assert_array_equal(png.read_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("channels", [3, 4])
def test_png_colour_to_gray_as_cv2(tmp_path, channels):
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (40, 64, channels)).astype(np.uint8)
    path = str(tmp_path / "c.png")
    cv2.imwrite(path, img)
    want = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(png.read_gray(path), want)
    # cvtColor's rounded weights are not what imread does for a colour PNG
    r, g, b = (img[..., i].astype(np.int64) for i in (2, 1, 0))
    rounded = (r * 4899 + g * 9617 + b * 1868 + 8192) >> 14
    print(f"{channels} channels: cvtColor's rounded grey differs from imread's on "
          f"{int((rounded != want).sum())} of {want.size} pixels")
    # the stored samples come back in the file's R, G, B(, A) order
    order = [2, 1, 0] + ([3] if channels == 4 else [])
    np.testing.assert_array_equal(png.read_png(path), img[..., order])


def test_png_refuses_what_it_does_not_read(tmp_path):
    """A damaged file raises `PNGError` (cv2 cannot read it either); a valid
    image that cv2 reads and `io/png.py` does not raises `UnsupportedImage`."""
    path = str(tmp_path / "bad.png")
    with open(path, "wb") as f:
        f.write(b"not a png")
    with pytest.raises(png.PNGError):
        png.read_png(path)
    assert cv2.imread(path) is None
    png.write_png(path, _image(8))
    data = bytearray(open(path, "rb").read())
    data[60] ^= 0xFF                       # inside the IDAT chunk: its CRC fails
    open(path, "wb").write(bytes(data))
    with pytest.raises(png.PNGError):
        png.read_png(path)
    png.write_png(path, _image(8))
    whole = open(path, "rb").read()
    open(path, "wb").write(whole[:len(whole) - 20])      # cut inside the IDAT chunk
    with pytest.raises(png.PNGError):
        png.read_png(path)
    assert cv2.imread(path) is None
    with pytest.raises(ValueError):
        png.write_png(path, np.zeros((4, 4), np.float32))
    cv2.imwrite(path, np.zeros((4, 4, 3), np.uint16))
    with pytest.raises(png.UnsupportedImage):
        png.read_gray(path)
    jpg = str(tmp_path / "image.jpg")
    cv2.imwrite(jpg, _image(8))
    assert cv2.imread(jpg, cv2.IMREAD_GRAYSCALE) is not None
    with pytest.raises(png.UnsupportedImage):
        png.read_gray(jpg)


def test_load_tum_sequence_decodes_with_png(tmp_path):
    """`io/tum.load_tum_sequence` on a TUM layout written by cv2: the frames
    associated by timestamp, grey and depth (metres) as cv2 reads them; an
    unreadable frame is skipped."""
    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    rgb, dep = [], []
    for i in range(3):
        t = i / 30.0
        cv2.imwrite(str(root / f"rgb/{t:.6f}.png"), _image(8, i, 24, 32))
        cv2.imwrite(str(root / f"depth/{t:.6f}.png"), _image(16, i, 24, 32))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.004:.6f} depth/{t:.6f}.png")
    (root / "rgb/0.066667.png").write_bytes(b"broken")
    (root / "rgb.txt").write_text("# rgb\n" + "\n".join(rgb) + "\n")
    (root / "depth.txt").write_text("\n".join(dep) + "\n")
    frames = list(tum.load_tum_sequence(str(root), depth_factor=5000.0))
    assert [round(t, 6) for t, _, _ in frames] == [0.0, 0.033333]
    for i, (_, g, d) in enumerate(frames):
        t = i / 30.0
        np.testing.assert_array_equal(g, cv2.imread(str(root / f"rgb/{t:.6f}.png"),
                                                    cv2.IMREAD_GRAYSCALE).astype(np.float32))
        want = cv2.imread(str(root / f"depth/{t:.6f}.png"), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(d, want.astype(np.float32) / 5000.0)


def test_load_tum_sequence_raises_on_an_unsupported_image(tmp_path):
    """A frame that cv2 would read and `io/png.py` does not (a JPEG) stops
    the sequence with `UnsupportedImage`, where a damaged one is skipped."""
    root = tmp_path / "seq"
    (root / "rgb").mkdir(parents=True)
    (root / "depth").mkdir()
    for i, ext in enumerate(("png", "jpg")):
        cv2.imwrite(str(root / f"rgb/{i}.{ext}"), _image(8, i, 24, 32))
        cv2.imwrite(str(root / f"depth/{i}.png"), _image(16, i, 24, 32))
    (root / "rgb.txt").write_text("0.0 rgb/0.png\n0.1 rgb/1.jpg\n")
    (root / "depth.txt").write_text("0.0 depth/0.png\n0.1 depth/1.png\n")
    frames = tum.load_tum_sequence(str(root), depth_factor=5000.0)
    assert next(frames)[0] == 0.0
    with pytest.raises(png.UnsupportedImage, match="JPEG"):
        next(frames)


# ---------------------------------------------------------------------------
# datasets (tests/test_drivers.py's, written with io/png.py)
# ---------------------------------------------------------------------------


def write_tum_dataset(root, n_frames=8, h=240, w=320):
    world = synthetic.make_box_world(seed=0, n_points=2500)
    poses = synthetic.orbit_trajectory(n_frames)
    os.makedirs(f"{root}/rgb", exist_ok=True)
    os.makedirs(f"{root}/depth", exist_ok=True)
    assoc = []
    for i in range(n_frames):
        g, d = synthetic.render_rgbd(world, K, poses[i], h, w)
        t = i / 30.0
        rgb_rel, dep_rel = f"rgb/{t:.6f}.png", f"depth/{t:.6f}.png"
        png.write_png(f"{root}/{rgb_rel}", g.astype(np.uint8))
        png.write_png(f"{root}/{dep_rel}", (d * 5000.0).astype(np.uint16))
        assoc.append(f"{t:.6f} {rgb_rel} {t:.6f} {dep_rel}")
    with open(f"{root}/assoc.txt", "w") as f:
        f.write("\n".join(assoc) + "\n")
    return poses


def write_dual_dataset(root, calib_path, n_frames=6):
    """The dual rig of `TestDualRgbdDriver`: camera 2 yawed 0.5 rad."""
    from multi_orb_slam_tpu_torch.geometry import se3

    world = synthetic.make_box_world(seed=0, n_points=4000)
    Ry = se3.so3_exp(torch.tensor([0.0, 0.5, 0.0])).numpy()
    T_c12 = np.eye(4, dtype=np.float32)
    T_c12[:3, :3] = Ry
    T_c12[:3, 3] = [0.16, 0.004, -0.07]
    T_rc = [np.eye(4, dtype=np.float32), np.linalg.inv(T_c12).astype(np.float32)]
    poses = synthetic.orbit_trajectory(n_frames)
    for suffix, Trc in (("1", T_rc[0]), ("2", T_rc[1])):
        os.makedirs(f"{root}/rgb{suffix}", exist_ok=True)
        os.makedirs(f"{root}/depth{suffix}", exist_ok=True)
        assoc = []
        for i in range(n_frames):
            g, d = synthetic.render_rgbd(world, K, Trc @ poses[i], 240, 320)
            t = i / 30.0
            rgb_rel, dep_rel = f"rgb{suffix}/{t:.6f}.png", f"depth{suffix}/{t:.6f}.png"
            png.write_png(f"{root}/{rgb_rel}", g.astype(np.uint8))
            png.write_png(f"{root}/{dep_rel}", (d * 5000.0).astype(np.uint16))
            assoc.append(f"{t:.6f} {rgb_rel} {t:.6f} {dep_rel}")
        with open(f"{root}/assoc{suffix}.txt", "w") as f:
            f.write("\n".join(assoc) + "\n")
    with open(calib_path, "w") as f:
        for row in T_c12[:3, :3]:
            f.write(" ".join(str(v) for v in row) + "\n")
        f.write(" ".join(str(v) for v in T_c12[:3, 3]) + "\n")
    return poses


def centres_of(traj: dict) -> np.ndarray:
    return np.stack([Twc[:3, 3] for _, Twc in sorted(traj.items())]).astype(np.float64)


def ate_against(traj: dict, poses) -> float:
    """ATE of a TUM trajectory file's centres against rendered Tcw poses."""
    gt = np.stack([np.linalg.inv(T)[:3, 3] for T in poses]).astype(np.float64)
    return float(align.ate_rmse(torch.from_numpy(centres_of(traj)), torch.from_numpy(gt)))


@pytest.fixture(scope="module")
def tum_dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("tum")
    poses = write_tum_dataset(str(root / "seq"))
    settings = str(root / "settings.yaml")
    write_settings(settings)
    return str(root / "seq"), settings, poses


def _run_rgbd(tmp_path, seq, settings, *extra):
    out, kf_out = str(tmp_path / "traj.txt"), str(tmp_path / "kf.txt")
    rc = rgbd_tum.main([settings, seq, f"{seq}/assoc.txt", "--out", out, "--kf-out", kf_out,
                        "--no-realtime", "--device", "cpu", *extra])
    return rc, tum.read_trajectory_tum(out), tum.read_trajectory_tum(kf_out)


@pytest.mark.parametrize("pipelined", [False, True])
def test_rgbd_tum_driver(tmp_path, capsys, tum_dataset, pipelined):
    seq, settings, poses = tum_dataset
    rc, traj, kfs = _run_rgbd(tmp_path, seq, settings, *(["--pipelined"] if pipelined else []))
    stdout = capsys.readouterr().out
    assert rc == 0
    assert "median tracking time" in stdout and "frames tracked 8/8" in stdout
    assert len(traj) == 8
    assert len(kfs) >= 1
    assert ate_against(traj, poses) < 0.02


def test_stereo_kitti_driver(tmp_path, capsys):
    root = str(tmp_path / "kitti")
    os.makedirs(f"{root}/image_0")
    os.makedirs(f"{root}/image_1")
    world = synthetic.make_box_world(seed=0, n_points=3000)
    T_lr = np.eye(4, dtype=np.float32)
    T_lr[0, 3] = -20.0 / 260.0
    poses = synthetic.orbit_trajectory(6)
    for i in range(6):
        gl, _ = synthetic.render_rgbd(world, K, poses[i], 240, 320)
        gr, _ = synthetic.render_rgbd(world, K, T_lr @ poses[i], 240, 320)
        png.write_png(f"{root}/image_0/{i:06d}.png", gl.astype(np.uint8))
        png.write_png(f"{root}/image_1/{i:06d}.png", gr.astype(np.uint8))
    with open(f"{root}/times.txt", "w") as f:
        f.write("\n".join(f"{i / 10.0:.6f}" for i in range(6)) + "\n")
    settings = str(tmp_path / "settings.yaml")
    write_settings(settings)
    out = str(tmp_path / "kitti_traj.txt")
    assert stereo_kitti.main([settings, root, "--out", out, "--device", "cpu"]) == 0
    assert "frames tracked 6/6" in capsys.readouterr().out
    lines = open(out).read().strip().splitlines()
    assert len(lines) == 6
    assert len(lines[0].split()) == 12  # 3x4 row-major
    assert stereo_kitti.main([settings, root, "--out", out, "--max-frames", "3",
                              "--device", "cpu"]) == 0
    assert len(open(out).read().strip().splitlines()) == 3


def test_live_rgbd_serve_on_a_byte_stream(tmp_path):
    """The first 8 frames of the self-test's stream, from a `BytesIO`."""
    seq, n = live_rgbd.selftest_sequence(), 8
    buf = io.BytesIO()
    live_rgbd.write_stream(buf, seq.grays[:n], seq.depths[:n], seq.timestamps[:n])
    buf.seek(0)
    assert live_rgbd.read_header(buf) == (1, 240, 320)
    slam = live_rgbd.selftest_system(240, 320, device="cpu")
    assert live_rgbd.serve(buf, slam, 1, 240, 320) == n
    assert buf.read() == b""          # the end marker was the last thing read
    slam.save_trajectory_tum(str(tmp_path / "live.txt"))
    traj = tum.read_trajectory_tum(str(tmp_path / "live.txt"))
    assert sorted(traj) == pytest.approx(list(seq.timestamps[:n]), abs=1e-6)  # %.6f in the file
    assert ate_against(traj, seq.poses_gt[:n]) < 0.02
    with pytest.raises(ValueError):
        live_rgbd.read_header(io.BytesIO(b"XXXX" + bytes(12)))
    with pytest.raises(EOFError):
        live_rgbd.serve(io.BytesIO(bytes(8 + 100)), slam, 1, 240, 320)


def test_native_loader_and_driver(tmp_path, capsys, tum_dataset):
    if not native_loader.native_available():
        pytest.skip(f"the native loader does not build here: {native_loader.build_error()}")
    seq, settings, poses = tum_dataset
    pairs = rgbd_tum.load_assoc_pairs(f"{seq}/assoc.txt")
    items = [(f"{seq}/{r}", f"{seq}/{d}") for _, r, _, d in pairs]
    loader = native_loader.AsyncRGBDLoader(items, 240, 320, depth_factor=5000.0)
    try:
        for (gray, depth), (r, d) in zip(loader, items):
            np.testing.assert_array_equal(gray, png.read_gray(r).astype(np.float32))
            np.testing.assert_allclose(
                depth, png.read_png(d).astype(np.float32) * np.float32(1 / 5000.0),
                rtol=1e-6, atol=0)
    finally:
        loader.close()
    rc, traj, _ = _run_rgbd(tmp_path, seq, settings, "--native-loader", "--pipelined")
    assert rc == 0
    assert "native async loader" in capsys.readouterr().out
    assert len(traj) == 8
    assert ate_against(traj, poses) < 0.02


def test_rgbd_tum_command_line(tmp_path, tum_dataset):
    seq, settings, _ = tum_dataset
    out = str(tmp_path / "traj.txt")
    r = subprocess.run(
        [sys.executable, "-m", "multi_orb_slam_tpu_torch.drivers.rgbd_tum", settings, seq,
         f"{seq}/assoc.txt", "--out", out, "--kf-out", str(tmp_path / "kf.txt"),
         "--no-realtime", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "median tracking time" in r.stdout
    assert len(tum.read_trajectory_tum(out)) == 8
