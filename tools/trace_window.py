"""One benchmark run with the port's tracer on for the whole run, and what
its spans say about the window's frames.

    python3 tools/trace_window.py --workload <cell> --seed <n> --seconds <s> [--out F.json]

Runs `benchmark/run.py` in this process exactly as the benchmark does
(`--trace 0`), with `utils.metrics.enable()` in force from before the
system is built, so that its `frames_per_s` is the tracer's on cost against
a run without.  The store is emptied as the window starts, so it holds the
window's frames alone; the `span.*` readers of `benchmark/metrics/` are
read over them.  Then it splits the frames in two at `--split-ms`
(default: halfway between the 10th and 90th percentiles of the frames' host
ms) and prints, for every span name under a frame, its median host ms (and
device ms where it has events) in the slow and in the fast frames, largest
difference first.  `--out` writes one row a frame: its start on the wall
clock, its host and device ms and the host ms of each span name under it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "benchmark"))
sys.path.insert(1, str(ROOT))

import run as bench_run  # noqa: E402  (starts the benchmark's set-up clock)
from harness import drive, files  # noqa: E402

from multi_orb_slam_tpu_torch.utils import metrics  # noqa: E402

FRAME = "system/track_rgbd"
SPAN_METRICS = ("span.host_waits.per_frame", "span.host_wait_ms.per_frame",
                "span.tracker_host_ms.p50", "span.tracker_device_ms.p50",
                "span.graph_io_ms.per_frame")


def frame_rows(spans) -> list:
    """One row a frame: its start on the wall clock (s), host and device ms
    of the frame, and {span name: [host ms summed, device ms summed or
    None]} over its descendants."""
    wall = time.time_ns() - time.perf_counter_ns()
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    roots = [s for s in spans if s.name == FRAME]
    rows = []
    for r in roots:
        names = collections.defaultdict(lambda: [0.0, None])
        todo = list(children.get(r.seq, ()))
        while todo:
            s = todo.pop()
            acc = names[s.name]
            acc[0] += s.host_ms
            d = s.device_ms()
            if d is not None:
                acc[1] = (acc[1] or 0.0) + d
            todo.extend(children.get(s.seq, ()))
        rows.append({"frame": r.frame, "system": r.system, "wall_s": (r.t0 + wall) / 1e9,
                     "host_ms": r.host_ms,
                     "device_ms": r.device_ms(), "spans": dict(names)})
    return rows


def compare(rows: list, split_ms: float | None) -> dict:
    ms = np.asarray([r["host_ms"] for r in rows])
    if split_ms is None:
        split_ms = float((np.percentile(ms, 10) + np.percentile(ms, 90)) / 2)
    slow = [r for r in rows if r["host_ms"] > split_ms]
    fast = [r for r in rows if r["host_ms"] <= split_ms]
    names = sorted({n for r in rows for n in r["spans"]})

    def med(group, n, i):
        v = [r["spans"].get(n, [0.0, None])[i] for r in group]
        v = [x for x in v if x is not None]
        return float(np.median(v)) if v else None

    table = []
    for n in names:
        hs, hf = med(slow, n, 0), med(fast, n, 0)
        table.append({"span": n, "slow_host_ms": hs, "fast_host_ms": hf,
                      "slow_device_ms": med(slow, n, 1), "fast_device_ms": med(fast, n, 1),
                      "host_diff_ms": (hs or 0.0) - (hf or 0.0)})
    table.sort(key=lambda t: -abs(t["host_diff_ms"]))
    dev = [r["device_ms"] for r in rows if r["device_ms"] is not None]
    return {"split_ms": split_ms, "frames": len(rows), "slow": len(slow), "fast": len(fast),
            "frame_host_ms": {"slow": float(np.median([r["host_ms"] for r in slow])) if slow else None,
                              "fast": float(np.median([r["host_ms"] for r in fast])) if fast else None},
            "frame_device_ms_p50": float(np.median(dev)) if dev else None,
            "spans": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    ap.add_argument("--split-ms", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    window = drive.Driver.window

    def window_alone(self, *a, **k):
        metrics.clear()
        return window(self, *a, **k)

    drive.Driver.window = window_alone
    metrics.enable()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench_run.main(["--workload", args.workload, "--seed", str(args.seed),
                             "--seconds", str(args.seconds), "--trace", "0"])
    metrics.enable(False)
    lines = out.getvalue().strip().splitlines()
    print(lines[-1] if lines else "", flush=True)
    if rc != 0:
        return rc
    result = json.loads(lines[-1])
    rows = frame_rows(metrics.spans())
    summary = compare(rows, args.split_ms)
    summary.update(workload=args.workload, seed=args.seed, dropped=metrics.GLOBAL.dropped,
                   frames_per_s=result["metrics"]["frames_per_s"]["value"],
                   window={n: files.metric_reader(n)(None) for n in SPAN_METRICS})
    print(json.dumps({"trace_window": {k: v for k, v in summary.items() if k != "spans"}}))
    for t in summary["spans"][:25]:
        print(json.dumps(t))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
