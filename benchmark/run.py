"""The benchmark of multi_orb_slam_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell (`workloads/<cell>.json`) names a configuration (`configs/`), a
traffic mix (`traffic/`), how the system is driven and the limits of the
numbers that decide `correct`.  The run renders the cell's scene from the
seed on the card, builds the system as a user does (from the
configuration's settings files), warms it up through every CUDA graph the
window will replay, feeds frames closed loop for `--seconds`, takes the
window's outputs to the host, frees the program's state and holds the
outputs against the plain references of `reference/`.

The last line of standard output is one JSON object: `correct`,
`attempted` (frames fed in the window), `failed` (frames whose tracking
state after the call is not OK), `metrics` (with `--trace 0` the cell's
end-to-end metrics, frames_per_s and setup_s; with `--trace 1`
its per-layer metrics, each read by `metrics/<name>.py`), `device`, with
`--trace 1` a `breakdown`, and last `checks`: each number compared beside
its limit.  The line before it is a JSON object of what the run saw
(`{"info": ...}`).  The checks are also the last lines of standard error.

`--control tf32`, which a check never passes, runs the program with TF32
matmuls: the configuration states float32 with TF32 off, so this is the
control that the limits must fail.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import checks, drive, files, settings, trace as trace_mod, traffic  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "multi_orb_slam_tpu"}
RPE_SPAN_S = 1.0            # the returned poses are held to the ground truth over 1 s
SLOW_SHARE = 0.06           # the info line's slow frames: the slowest 6% of the window
DECODE_SAMPLE = 24          # decoded TUM frames kept for the decode check
DECODE_SAMPLE_RANGE = 300   # drawn from the window's first frames


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",), default=None)
    return ap.parse_args(argv)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def smi() -> dict:
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True).stdout
        return dict(zip(q.split(","), [v.strip() for v in out.splitlines()[0].split(",")]))
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return {"error": str(e)}


def orb_settings(cfg: dict) -> dict:
    y = settings.read_yaml(cfg["dir"] / cfg["settings"])
    return {"n_levels": int(y["ORBextractor.nLevels"]),
            "scale_factor": y["ORBextractor.scaleFactor"],
            "fast_min": y["ORBextractor.minThFAST"], "n_features": int(y["ORBextractor.nFeatures"]),
            "fps": float(y["Camera.fps"])}


def graph_entries():
    from multi_orb_slam_tpu_torch.utils import graphs

    return graphs.all_entries()


def captured_graphs() -> int:
    return sum(1 for _, e in graph_entries() if e.graph is not None)


def one_run(cell: dict, cfg: dict, rig, args, device, test: dict) -> dict:
    """Set-up, window and checks; the pieces of the result."""
    seed = args.seed
    t_traffic = files.traffic(cell["traffic"])
    sc = traffic.build(t_traffic, rig, seed, device, frames=test.get("frames"))
    try:
        drv = drive.Driver(cell, cfg, sc, device, bool(args.trace))
        sched = drv.warm(test.get("warm_frames"))
        n_graphs = captured_graphs()
        capture_s = sum((e.warmup_ms or 0) + (e.capture_ms or 0)
                        for _, e in graph_entries()) / 1e3
        prof = cell.get("profile", {})
        stretch = (trace_mod.Stretch(prof.get("start", 20), prof.get("warm", 3), prof.get("frames", 10))
                   if args.trace and device.type == "cuda" else None)
        keep = None
        if sc.assoc is not None:
            rng = np.random.default_rng(seed)
            keep = set(int(i) for i in rng.choice(DECODE_SAMPLE_RANGE, DECODE_SAMPLE, replace=False))
        if device.type == "cuda":
            torch.cuda.synchronize()
        gc_times = GcTimes()
        recs, window_s = drv.window(sched, args.seconds, stretch, keep, test.get("window_frames"))
        gc_times.stop()
        setup_s = drv.t_first - T_START
        found = forbidden_modules()
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
        captured_in_window = captured_graphs() - n_graphs
        out = checks.collect(drv, recs, len(sc.pass_order))
        traced = (trace_mod.reduce(stretch.events)
                  if stretch is not None and stretch.events else None)
        del drv, sched
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        orb = orb_settings(cfg)
        span = test.get("rpe_span", round(orb["fps"] * RPE_SPAN_S))
        values = checks.numbers(out, sc, orb, seed, cell.get("orb_keyframes", 6), span)
    finally:
        traffic.remove(sc)
    return {"recs": recs, "window_s": window_s, "setup_s": setup_s, "forbidden": found,
            "peak": peak, "captured_in_window": captured_in_window, "capture_s": capture_s,
            "values": values, "trace": traced, "gc": gc_times.spans}


class GcTimes:
    """The host-clock spans of the window's Python garbage collections of
    generations 1 and 2 (to name the slow frames)."""

    def __init__(self):
        self.spans, self._start = [], None
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if info["generation"] >= 1:
            if phase == "start":
                self._start = time.perf_counter()
            elif self._start is not None:
                self.spans.append((self._start, time.perf_counter(), info["generation"]))
                self._start = None

    def stop(self):
        gc.callbacks.remove(self)


def slow_frames(recs: list, gc_spans: list) -> dict:
    """The window's slowest frames: how many, what ran in them, how far
    apart they fall."""
    if len(recs) < 20:
        return {}
    ms = np.asarray([x["ms"] for x in recs])
    cut = np.quantile(ms, 1.0 - SLOW_SHARE)
    idx = [i for i in range(len(recs)) if ms[i] > cut]
    gc_end = np.asarray([b for _, b, _ in gc_spans])
    gc_start = np.asarray([a for a, _, _ in gc_spans])

    def has_gc(r):
        t0 = r["t_end"] - r["ms"] / 1e3
        return bool(np.any((gc_start < r["t_end"]) & (gc_end > t0)))

    slow = [recs[i] for i in idx]
    rest = [x for i, x in enumerate(recs) if ms[i] <= cut]
    return {"over_ms": float(cut), "n": len(idx),
            "slow_ms_p50": float(np.median(ms[idx])), "rest_ms_p50": float(np.median(ms[ms <= cut])),
            "with_keyframe": sum(1 for x in slow if x["keyframes"]),
            "with_relocalization": sum(1 for x in slow if x["relocalized"]),
            "with_gc": sum(1 for x in slow if has_gc(x)),
            "rest_with_gc": sum(1 for x in rest if has_gc(x)),
            "gap_p50": float(np.median(np.diff(idx))) if len(idx) > 1 else None,
            "first": idx[:24], "input_frames": [x["frame"] for x in slow[:24]]}


def info_line(name, seed, r, args) -> dict:
    recs = r["recs"]
    ms = np.asarray([x["ms"] for x in recs]) if recs else np.zeros(1)
    return {"info": {
        "workload": name, "seed": seed, "control": args.control,
        "graphs_captured_in_window": r["captured_in_window"],
        "frames": len(recs), "systems": len({x["sys"] for x in recs}),
        "keyframes": sum(x["keyframes"] for x in recs),
        "loops_closed": sum(x["loops"] for x in recs),
        "gba_merged": sum(x["gba_merged"] for x in recs),
        "relocalized": sum(x["relocalized"] for x in recs),
        "frame_ms": {f"p{q}": float(np.percentile(ms, q)) for q in (50, 90, 95, 99, 100)},
        "slow_frames": slow_frames(recs, r["gc"]),
        "gc_collections": {"gen1": sum(1 for *_, g in r["gc"] if g == 1),
                           "gen2": sum(1 for *_, g in r["gc"] if g == 2)},
        "window_s": r["window_s"], "setup_s": r["setup_s"],
        "graph_capture_s": r["capture_s"], "numbers": r["values"], "nvidia_smi": smi()}}


def main(argv=None, test: dict | None = None) -> int:
    """One run.  `test` is for the benchmark's own tests alone: {"device",
    "frames", "warm_frames", "window_frames", "rpe_span"}; with a
    "device" it skips the look for a card."""
    args = parse(argv)
    test = test or {}
    spec = files.benchmark_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if "device" in test:
        device = torch.device(test["device"])
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
                  f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    cell = files.workload(args.workload)
    cfg = files.config(cell["config"])
    rig = settings.Rig(cfg)
    import multi_orb_slam_tpu_torch  # noqa: F401  (sets TF32 off, process-wide)

    if args.control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    r = one_run(cell, cfg, rig, args, device, test)
    if r["forbidden"]:
        print(f"the run imported {r['forbidden']}: the benchmark runs without JAX and "
              f"without the JAX package", file=sys.stderr)
        return 3
    print(json.dumps(info_line(args.workload, args.seed, r, args)), flush=True)
    result = result_line(args, spec, cell, shapes(cfg, rig), r, device)
    if result is None:
        return 4
    print(json.dumps(result), flush=True)
    return 0


def result_line(args, spec, cell, kernel_shapes, r, device):
    recs = r["recs"]
    if not recs:
        print("no frame ran in the window", file=sys.stderr)
        return None
    correct, compared = checks.compare(r["values"], cell["limits"])
    metrics = {}
    if not args.trace:
        values = {"frames_per_s": len(recs) / r["window_s"], "setup_s": r["setup_s"]}
        for m in files.end_to_end_for(args.workload, spec):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        run = {"records": recs, "graph_capture_s": r["capture_s"], "trace": r["trace"],
               "shapes": kernel_shapes}
        for m in files.per_layer_for(args.workload, spec):
            v = files.metric_reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(r["peak"])}
    result = {"correct": bool(correct), "attempted": len(recs),
              "failed": sum(1 for x in recs if not x["ok"]), "metrics": metrics, "device": dev}
    if args.trace and r["trace"] is not None:
        dev["busy_s"] = r["trace"]["busy_s"]
        dev["window_s"] = r["trace"]["window_s"]
        result["breakdown"] = {"device_ops": r["trace"]["device_ops"],
                               "idle_gaps": r["trace"]["idle_gaps"]}
    result["checks"] = compared
    for name, c in compared.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    return result


def shapes(cfg: dict, rig) -> dict:
    """The shapes the configuration fixes for the kernels' work per frame."""
    return {"n_cams": rig.n_cams, "height": rig.height, "width": rig.width, **orb_settings(cfg)}


if __name__ == "__main__":
    sys.exit(main())
