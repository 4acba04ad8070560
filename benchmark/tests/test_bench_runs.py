"""Whole runs of each cell on the CPU at a few frames (the look for a card
skipped): the result line's keys, `correct` on the sound program, and
`correct` false with the timed path broken underneath, once for each fault
a cell can have:

- a step that returns its state unchanged: `Tracker.process` does nothing
  after a system's first frame (the pose and the tracker's frame stay);
- an answer altered where it is produced: `build_frame` flips one
  descriptor bit of every feature; the returned pose pushed 100 mm
  further along x each frame (still a rigid pose);
- half of the batch left out (the dual rig): camera 2's images replaced by
  camera 1's in `System.track_rgbd`.

No cell runs across chips, so none can leave out an exchange between them.
The TF32 control runs only on the card (`test_bench_card.py`).  At six
frames the orbit's black frames would leave it lost for good (its
vocabulary holds one frame), so here it is fed none.
"""

import io
import json
import contextlib
from unittest import mock

import numpy as np
import pytest
import torch

import run
from multi_orb_slam_tpu_torch import system as system_mod
from multi_orb_slam_tpu_torch.frontend import frame as frame_mod, tracking

SIZES = {"dual-astra.orbit-track": dict(frames=6, warm_frames=6, window_frames=5, rpe_span=2),
         "tum3-kinect.png-orbit": dict(frames=6, window_frames=5, rpe_span=2)}
DUAL = ("dual-astra.orbit-track",)


def small_workload(name):
    cell = WORKLOAD(name)
    cell["drive"]["blank_frames"] = 0
    return cell


WORKLOAD = run.files.workload


def run_cell(cell, trace=0):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), mock.patch.object(run.files, "workload", small_workload):
        rc = run.main(["--workload", cell, "--seed", str(2 ** 31 + 77), "--seconds", "1",
                       "--trace", str(trace)], test={"device": "cpu", **SIZES[cell]})
    assert rc == 0
    return json.loads(out.getvalue().strip().split("\n")[-1])


def frozen(monkeypatch):
    process = tracking.Tracker.process

    def process_once(self, grays, depths, timestamp=None):
        if self.frame_id == 0:
            return process(self, grays, depths, timestamp)
        return self.state

    monkeypatch.setattr(tracking.Tracker, "process", process_once)


def altered(monkeypatch):
    build = frame_mod.build_frame

    def build_altered(*args, **kwargs):
        fr = build(*args, **kwargs)
        return fr._replace(desc=torch.bitwise_xor(fr.desc, 1))

    monkeypatch.setattr(frame_mod, "build_frame", build_altered)


def drifted(monkeypatch):
    track = system_mod.System.track_rgbd
    calls = []

    def track_drifted(self, *args, **kwargs):
        pose = np.array(track(self, *args, **kwargs), np.float64)
        calls.append(1)
        pose[0, 3] += 0.1 * len(calls)
        return pose

    monkeypatch.setattr(system_mod.System, "track_rgbd", track_drifted)


def half_batch(monkeypatch):
    track = system_mod.System.track_rgbd

    def track_first_camera(self, im1, depth1, im2=None, depth2=None, timestamp=None):
        return track(self, im1, depth1, im1, depth1, timestamp)

    monkeypatch.setattr(system_mod.System, "track_rgbd", track_first_camera)


FAULTS = ([(c, f) for c in SIZES for f in (frozen, altered, drifted)]
          + [(c, half_batch) for c in DUAL])


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_sound_run_is_correct_and_its_line_has_the_keys(cell):
    r = run_cell(cell, trace=1 if cell == "tum3-kinect.png-orbit" else 0)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"], r["checks"]
    assert r["attempted"] == SIZES[cell]["window_frames"]
    assert set(r["checks"]) == set(run.files.workload(cell)["limits"])
    if cell == "tum3-kinect.png-orbit":
        assert {"decode_ms.mean", "tracking_ms.p50"} <= set(r["metrics"])
    else:
        assert set(r["metrics"]) == {"frames_per_s", "setup_s"}


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_cell(cell)
    assert not r["correct"], r["checks"]
