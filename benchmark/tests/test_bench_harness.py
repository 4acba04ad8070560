"""The harness finds cells and metrics by their files alone, reads the
traced timeline as it should, and holds its numbers to their limits."""

import json
import shutil
import types

import numpy as np
import torch

from harness import checks, files, trace


def test_cell_and_metric_added_as_files_are_found(tmp_path, monkeypatch):
    bench = tmp_path / "benchmark"
    shutil.copytree(files.BENCH_DIR, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = json.loads((files.ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "dual-astra.slow-orbit", "config": "dual-astra",
                              "traffic": "slow-orbit", "chips": 1, "why": "a new cell"})
    spec["per_layer"].append({"name": "frames.count", "unit": "frames", "better": "higher",
                              "source": "host_clock", "layer": "facade",
                              "moves": "frames_per_s", "workloads": ["dual-astra.slow-orbit"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    mix = json.loads((bench / "traffic" / "orbit-track.json").read_text())
    mix["orbit"]["yaw_range"] = 0.4
    (bench / "traffic" / "slow-orbit.json").write_text(json.dumps(mix))
    cell = json.loads((bench / "workloads" / "dual-astra.orbit-track.json").read_text())
    cell["traffic"] = "slow-orbit"
    (bench / "workloads" / "dual-astra.slow-orbit.json").write_text(json.dumps(cell))
    (bench / "metrics" / "frames.count.py").write_text(
        "def read(run):\n    return float(len(run['records']))\n")
    monkeypatch.setattr(files, "BENCH_DIR", bench)
    monkeypatch.setattr(files, "ROOT", tmp_path)
    assert files.workload("dual-astra.slow-orbit")["traffic"] == "slow-orbit"
    assert files.traffic("slow-orbit")["orbit"]["yaw_range"] == 0.4
    names = [m["name"] for m in files.per_layer_for("dual-astra.slow-orbit")]
    assert "frames.count" in names and "mapping_ms.p50" not in names
    assert files.metric_reader("frames.count")({"records": [1, 2, 3]}) == 3.0
    assert [m["name"] for m in files.end_to_end_for("dual-astra.slow-orbit")] == [
        "frames_per_s", "setup_s"]


def event(name, start, end, cuda=False, annotation=False):
    dt = torch.autograd.DeviceType
    return types.SimpleNamespace(name=lambda: name, start_ns=lambda: start, end_ns=lambda: end,
                                 device_type=lambda: dt.CUDA if cuda else dt.CPU,
                                 is_user_annotation=lambda: annotation)


def test_trace_reduction_counts_busy_idle_and_kernels():
    ev = [event(trace.FRAME_RANGE, 0, 1000, annotation=True),
          event(trace.FRAME_RANGE, 1000, 2000, annotation=True),
          event(trace.FRAME_RANGE, 0, 1000, cuda=True, annotation=True),
          event("aten::copy_", 100, 450), event("cudaStreamSynchronize", 1400, 1900),
          event("fast_score_kernel(float*)", 200, 400, cuda=True),
          event("fast_score_kernel(float*)", 300, 500, cuda=True),
          event("gemm", 1500, 1800, cuda=True), event("gemm", 2500, 2600, cuda=True)]
    r = trace.reduce(ev)
    assert r["window_s"] == 2000e-9
    assert abs(r["busy_s"] - 600e-9) < 1e-15
    assert r["kernels"] == {"fast_score_kernel(float*)": (2, 400e-9), "gemm": (1, 300e-9)}
    idle = dict(r["idle_gaps"])
    assert abs(sum(idle.values()) - 1400e-9) < 1e-15
    assert abs(idle["cudaStreamSynchronize"] - 200e-9) < 1e-15     # gap 1800-2000
    assert abs(idle["aten::copy_"] - 200e-9) < 1e-15               # gap 0-200
    assert abs(idle["host Python between operations"] - 1000e-9) < 1e-15


def test_pose_numbers_hold_the_returned_poses_to_the_ground_truth():
    from reference import poses as ref_poses

    n, span = 12, 3
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 3] = 0.01 * np.arange(n)                     # 10 mm a frame along x
    recs = [{"sys": 0, "fid": i, "frame": i, "ok": True, "pose": gt[i].copy()} for i in range(n)]
    r = checks.pose_numbers(recs, gt, span)
    assert r["rpe_1s_pairs"] == n - span and r["rpe_1s_mm"] < 1e-9 and r["pose_ate_mm"] < 1e-9
    frozen = [dict(x, pose=gt[0].copy()) for x in recs]    # the pose never moves
    assert abs(checks.pose_numbers(frozen, gt, span)["rpe_1s_mm"] - 30.0) < 1e-6
    skew = np.eye(4)                                        # a rotation that is no rotation
    skew[0, 1] = 0.01
    _, dr = ref_poses.relative_errors(np.stack([np.eye(4), skew])[None], np.tile(np.eye(4), (1, 2, 1, 1)))
    assert abs(dr[0] - 0.01 / np.sqrt(2)) < 1e-4
    c = np.cos(0.002)
    R = np.array([[c, -np.sin(0.002), 0], [np.sin(0.002), c, 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = R
    _, dr = ref_poses.relative_errors(np.stack([np.eye(4), T])[None], np.tile(np.eye(4), (1, 2, 1, 1)))
    assert abs(dr[0] - 0.002) < 1e-9


def test_a_number_over_or_without_its_limit_fails():
    ok, c = checks.compare({"a": 1.0, "b": 0.0}, {"a": 2.0, "b": 0.0})
    assert ok and c["a"] == {"value": 1.0, "limit": 2.0}
    assert not checks.compare({"a": 3.0}, {"a": 2.0})[0]
    assert not checks.compare({}, {"a": 2.0})[0]
    assert not checks.compare({"a": float("nan")}, {"a": 2.0})[0]


def test_roofline_share_from_the_configuration_shapes():
    share = files.metric_reader("fast_score_roofline")
    shapes = {"n_cams": 2, "height": 480, "width": 640, "n_levels": 8, "scale_factor": 1.2,
              "n_features": 1024}
    # chip_smoke.py's fast_score phase: 27.27 MB at [16, 480, 640] -> a bound of 0.00814 ms
    kernels = {"void fast_score_kernel<16>(float const*, float*)": (6, 6 * 0.0279e-3),
               "fast_score_kernel(float const*, float*)": (4, 4 * 0.0279e-3), "gemm": (9, 1.0)}
    run = {"shapes": shapes, "trace": {"kernels": kernels}}
    assert abs(share(run) - 100 * 0.00814 / 0.0279) < 0.1
    assert share({"shapes": shapes, "trace": {"kernels": {"gemm": (9, 1.0)}}}) is None
    assert np.isfinite(files.metric_reader("gather_patches_roofline")(
        {"shapes": shapes, "trace": {"kernels": {"gather_patches_kernel(float*)": (4, 4e-5)}}}))
