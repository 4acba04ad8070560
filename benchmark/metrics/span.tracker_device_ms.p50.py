"""The device's work in the tracker a frame: device ms (between their two
events) of the innermost spans under `track/process` that carry events,
summed, leaving out the `system/keyframe` subtrees (the mapping and loop
stages); median over the traced stretch's frames (layer: tracker; moves
frames_per_s).

The innermost such spans are the `graph/replay`s of the frame's CUDA
graphs and the stages that run eagerly with no replay inside.  The time the
device sits idle between them, waiting for the host to enqueue the next,
is left out, so the profiler's cost on the host does not reach this
number; `track/process`'s own events would hold it.  Where the device had
drained before a replay, its start event still holds the graph launch's
latency on the host.

Not listed in `BENCHMARK.json`: under the profiler a frame's replays'
events lie about twice its kernels' time apart (the slow launch and the
idle gaps the profiler leaves between a graph's kernels included), so in
a `--trace 1` run this reads the profiler.
`tools/trace_window.py` reads it over a whole window traced with
`metrics.enable()` alone."""

import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location("bench_program_spans",
                                               Path(__file__).with_name("program_spans.py"))
spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(spans)


def _keyframe(s):
    return s.name == "system/keyframe"


def _frame(root, children):
    proc = [s for s in children.get(root.seq, ()) if s.name == "track/process"]
    ms = [spans.device_leaves_ms(p, children, _keyframe) for p in proc]
    ms = [m if m is not None else p.device_ms() for m, p in zip(ms, proc)]
    return None if not ms or any(m is None for m in ms) else sum(ms)


def read(run):
    v = [x for x in spans.per_frame(_frame) or () if x is not None]
    return float(np.median(v)) if v else None
