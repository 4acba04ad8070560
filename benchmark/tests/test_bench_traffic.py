"""Each traffic mix repeats from its seed, and another seed gives another
room; the TUM files decode to what was written."""

import os

import numpy as np
import pytest
import torch

from harness import files, settings, tumfiles, traffic

MIXES = {"orbit-track": "dual-astra", "png-orbit": "tum3-kinect"}


def build(mix, seed):
    rig = settings.Rig(files.config(MIXES[mix]))
    return traffic.build(files.traffic(mix), rig, seed, torch.device("cpu"), frames=3)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mix_repeats_from_its_seed(mix):
    seed = 2 ** 31 + 12345
    a, b, c = build(mix, seed), build(mix, seed), build(mix, seed + 1)
    try:
        np.testing.assert_array_equal(a.poses_gt, b.poses_gt)
        np.testing.assert_array_equal(a.world.points, b.world.points)
        assert not np.array_equal(a.world.points, c.world.points)
        if a.greys is not None:
            np.testing.assert_array_equal(a.greys, b.greys)
            np.testing.assert_array_equal(a.depths, b.depths)
            assert a.greys.shape[1] == 2 and (a.depths > 0).mean() > 0.05
        else:
            for x, y in zip(a.stored, b.stored):
                np.testing.assert_array_equal(x, y)
            assert a.pass_order == [0, 1, 2, 1]
    finally:
        for s in (a, b, c):
            traffic.remove(s)


def test_tum_files_decode_to_what_was_written(tmp_path):
    from multi_orb_slam_tpu_torch.io import png

    rng = np.random.default_rng(0)
    greys = rng.uniform(0, 255, (2, 48, 64)).astype(np.float32)
    depths = rng.uniform(0.3, 6.0, (2, 48, 64)).astype(np.float32)
    assoc = tumfiles.write_sequence(str(tmp_path), greys, depths, 5000.0, [0, 1, 0])
    lines = open(assoc).read().split("\n")
    assert lines[2].split()[1] == "rgb/0.000000.png"
    for i in range(2):
        g8, d16 = tumfiles.quantise(greys[i], depths[i], 5000.0)
        name = f"{i / 30.0:.6f}.png"
        np.testing.assert_array_equal(png.read_png(os.path.join(tmp_path, "rgb", name)), g8)
        np.testing.assert_array_equal(png.read_png(os.path.join(tmp_path, "depth", name)), d16)
