"""Per-stage breakdown of the PyTorch port's mapping stage on one NVIDIA GPU.

    python3 tools/torch_mapping_profile.py [--scene orbit|circuit] [--out DIR]

Drives the bench's scene through the port's `Tracker` (pipelined, depth 3)
with the mapping callback set as `bench.py` sets it, twice:

1. timing pass: each mapping callback (`run_mapping_stage`, a replay of
   the stage's CUDA graph, and `covis_kf_count`) between two
   `torch.cuda.synchronize()` calls on the host clock, and each whole frame
   likewise; no profiler;
2. profile pass: each mapping callback under one `torch.profiler` profile,
   with the stage run eagerly (the body of the graphed
   `local_mapping._mapping_stage_fused` on the window's bucket: what its
   graph holds, launched one operation at a time).  The
   stage names its parts with `record_function` ("mapping/<stage>"); the
   tool reads those ranges from the trace: the host
   time of each range (the time to launch its work; the profiler inflates
   it, so the column says "profiled"), and the device operations (kernels
   and copies) launched inside it with their summed device time, each
   operation assigned to the range that encloses the host call that
   launched it.

Prints one table row per stage (calls, profiled host ms per keyframe, device
ops per keyframe, device ms per keyframe), the unprofiled ms per mapping
callback, the local-BA windows and LM iterations, the frame times with and
without a keyframe, and the card's name and power limit; with `--out DIR` it
writes the same as JSON into DIR.  Needs a CUDA device.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the rig, the scenes, their sizes, the range reader)

PREFIX = "mapping/"


def run(frames, calib, cfg, profiled):
    from multi_orb_slam_tpu_torch.frontend import tracking
    from multi_orb_slam_tpu_torch.mapping import local_mapping
    from multi_orb_slam_tpu_torch.optim import local_ba

    tracker = tracking.Tracker(calib, cfg, pipelined=True, pipeline_depth=3)
    pending = [None]
    kf_frames, cb_ms = [], []
    rows = collections.defaultdict(
        lambda: {"calls": 0, "host_ms": 0.0, "device_ops": 0, "device_ms": 0.0})
    ops = [0, 0]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def mapping(kf_slot):
        hint = int(pending[0]) if pending[0] is not None else None
        if profiled:
            def scalar(v):
                return torch.full((), v, dtype=torch.int32, device=calib.K.device)

            m = local_mapping._mapping_stage_fused.__wrapped__(
                tracker.map, scalar(kf_slot), scalar(tracker.frame_id), calib, cfg,
                *local_mapping._window(tracker.map, kf_slot, cfg, hint))
        else:
            m = local_mapping.run_mapping_stage(tracker.map, kf_slot, tracker.frame_id,
                                                calib, cfg, covis_hint=hint)
        with torch.profiler.record_function(PREFIX + "covis_kf_count"):
            pending[0] = local_mapping.covis_kf_count(m, kf_slot)
        torch.cuda.synchronize()
        return m

    def kf_cb(kf_slot):
        kf_frames.append(len(times))
        torch.cuda.synchronize()
        if not profiled:
            t = time.perf_counter()
            m = mapping(kf_slot)
            cb_ms.append((time.perf_counter() - t) * 1e3)
            return m
        with torch.profiler.profile(activities=acts) as prof:
            m = mapping(kf_slot)
        n_in, n_all = chip_smoke.read_ranges(prof, PREFIX, rows)
        ops[0] += n_in
        ops[1] += n_all
        return m

    tracker.kf_inserted_cb = kf_cb
    ba0, win0 = local_ba.STATS.read(), local_mapping.BA_WINDOWS.read()
    times = []
    for g, d in frames:
        torch.cuda.synchronize()
        t = time.perf_counter()
        tracker.process(g, d)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    traj = tracker.absolute_trajectory()
    windows = {k: v - win0.get(k, 0) for k, v in local_mapping.BA_WINDOWS.read().items()
               if v - win0.get(k, 0)}
    ba = local_ba.STATS.read()
    return {
        "frame_ms": times, "kf_frames": kf_frames, "callback_ms": cb_ms, "windows": windows,
        "solves": ba.get("solves", 0) - ba0.get("solves", 0),
        "iterations": ba.get("iterations", 0) - ba0.get("iterations", 0),
        "tracked": sum(1 for *_, lost in traj if not lost),
        "keyframes": int(tracker.map.n_kf), "map_points": int(tracker.map.n_mp),
        "rows": dict(rows), "device_ops_in_ranges": ops[0], "device_ops_profiled": ops[1],
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default="orbit", choices=["orbit", "circuit"])
    ap.add_argument("--out", default=None, help="directory for the JSON copy")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mapping_profile: no CUDA device", file=sys.stderr)
        return 1
    from multi_orb_slam_tpu_torch.config import SlamConfig
    from multi_orb_slam_tpu_torch.ops import _build, orb

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"nvidia-smi: {smi}")
    _build.load()
    cfg = SlamConfig(n_cams=chip_smoke.C, width=chip_smoke.W, height=chip_smoke.H,
                     orb=orb.ORBConfig(n_features=1024))
    calib = chip_smoke.bench_rig(dev)
    frames, _ = chip_smoke.render_scene(args.scene, calib, dev)

    res = run(frames, calib, cfg, profiled=False)
    prof = run(frames, calib, cfg, profiled=True)

    cb = np.asarray(res["callback_ms"]) if res["callback_ms"] else np.zeros(1)
    print(f"{args.scene}: {res['tracked']}/{len(frames)} frames tracked, "
          f"{len(res['kf_frames'])} mapping stages, {res['keyframes']} keyframes, "
          f"{res['map_points']} map points; local-BA windows {res['windows']}, "
          f"{res['iterations']} LM iterations in {res['solves']} solves")
    print(f"mapping callback, unprofiled: median {np.median(cb):.2f} ms, max {cb.max():.2f} ms, "
          f"mean {cb.mean():.2f} ms")
    print(f"device ops inside a stage range: {prof['device_ops_in_ranges']} of "
          f"{prof['device_ops_profiled']} profiled")
    print(f"{'stage':<18}{'calls':>6}{'prof ms/KF':>12}{'dev ops/KF':>12}{'dev ms/KF':>11}")
    stages = {}
    n_kf_prof = max(len(prof["kf_frames"]), 1)
    for name, row in prof.pop("rows").items():
        stages[name] = {"calls": row["calls"], "profiled_host_ms_per_kf": row["host_ms"] / n_kf_prof,
                        "device_ops_per_kf": row["device_ops"] / n_kf_prof,
                        "device_ms_per_kf": row["device_ms"] / n_kf_prof}
        s = stages[name]
        print(f"{name:<18}{s['calls']:>6}{s['profiled_host_ms_per_kf']:>12.2f}"
              f"{s['device_ops_per_kf']:>12.0f}{s['device_ms_per_kf']:>11.2f}")
    tot = {k: sum(s[k] for s in stages.values()) for k in
           ("profiled_host_ms_per_kf", "device_ops_per_kf", "device_ms_per_kf")}
    print(f"{'all':<18}{'':>6}{tot['profiled_host_ms_per_kf']:>12.2f}"
          f"{tot['device_ops_per_kf']:>12.0f}{tot['device_ms_per_kf']:>11.2f}")
    for key in ("rows", "device_ops_in_ranges", "device_ops_profiled"):
        res.pop(key)     # the unprofiled pass has none
    ms = np.asarray(res["frame_ms"])
    is_kf = np.zeros(len(ms), bool)
    is_kf[res["kf_frames"]] = True
    steady = ms[8:][~is_kf[8:]]
    print(f"frame ms (synchronised): median without a mapping stage {np.median(steady):.2f}, "
          f"median with one {np.median(ms[is_kf]) if is_kf.any() else float('nan'):.2f}, "
          f"all frames {np.median(ms):.2f}, total {ms.sum() / 1e3:.2f} s")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, f"torch_mapping_profile_{args.scene}.json")
        with open(path, "w") as f:
            json.dump({"card": smi, "scene": args.scene, "stages": stages,
                       "device_ops_in_ranges": prof["device_ops_in_ranges"],
                       "device_ops_profiled": prof["device_ops_profiled"], **res}, f, indent=1)
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
