"""The port's dual-rig driver against the JAX `System`.

`drivers/rgbd_tum.main` with two association files and the 4x3
`calibration.txt` (the reference's flagship invocation, `tests/test_drivers.py`'s
`TestDualRgbdDriver` dataset, 6 frames at 320x240), then the same decoded
frames through the reference's `System`: the same frame count and keyframes,
camera centres within 5 mm.  Its own file because the reference `System`'s
first run compiles for ~30 s on the CPU.
"""

import numpy as np
import torch

from multi_orb_slam_tpu_torch.drivers import rgbd_tum
from multi_orb_slam_tpu_torch.io import png, tum

from test_drivers import write_settings
from test_torch_drivers import ate_against, centres_of, write_dual_dataset

torch.set_num_threads(2)


def test_rgbd_tum_dual_driver_against_reference(tmp_path):
    """The reference's flagship invocation (two association files and the
    4x3 calibration.txt) through the port's driver, and the same decoded
    frames through the JAX `System`: the same frame count and keyframes,
    camera centres within 5 mm."""
    from multi_orb_slam_tpu import system as j_system

    root = str(tmp_path / "seq")
    calib_path = str(tmp_path / "calibration.txt")
    poses = write_dual_dataset(root, calib_path)
    settings = str(tmp_path / "settings.yaml")
    write_settings(settings)
    out, kf_out = str(tmp_path / "traj.txt"), str(tmp_path / "kf.txt")
    rc = rgbd_tum.main([settings, root, f"{root}/assoc1.txt", "--assoc2", f"{root}/assoc2.txt",
                        "--calibration", calib_path, "--out", out, "--kf-out", kf_out,
                        "--no-realtime", "--device", "cpu"])
    assert rc == 0
    traj = tum.read_trajectory_tum(out)
    assert len(traj) == 6
    assert ate_against(traj, poses) < 0.02

    ref = j_system.System(settings_path=settings, calibration_path=calib_path,
                          sensor=j_system.Sensor.DUAL_RGBD)
    pairs = [rgbd_tum.load_assoc_pairs(f"{root}/assoc{c}.txt") for c in (1, 2)]
    for (t, r1, _, d1), (_, r2, _, d2) in zip(*pairs):
        ims = [png.read_gray(f"{root}/{r}").astype(np.float32) for r in (r1, r2)]
        deps = [png.read_png(f"{root}/{d}").astype(np.float32) / 5000.0 for d in (d1, d2)]
        ref.track_rgbd(ims[0], deps[0], ims[1], deps[1], timestamp=t)
    ref.save_trajectory_tum(str(tmp_path / "ref.txt"))
    ref.save_keyframe_trajectory_tum(str(tmp_path / "ref_kf.txt"))
    ref_traj = tum.read_trajectory_tum(str(tmp_path / "ref.txt"))
    assert sorted(ref_traj) == sorted(traj)
    assert sorted(tum.read_trajectory_tum(str(tmp_path / "ref_kf.txt"))) == \
        sorted(tum.read_trajectory_tum(kf_out))
    part = np.linalg.norm(centres_of(ref_traj) - centres_of(traj), axis=1).max()
    print(f"dual driver against the JAX System: centres within {part * 1e3:.3f} mm")
    assert part < 0.005
