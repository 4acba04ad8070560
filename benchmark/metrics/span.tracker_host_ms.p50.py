"""The host's own work in the tracker a frame: host ms of `track/process`
less its top-most `wait/*`, `graph/load`, `graph/clone` and
`system/keyframe` descendants, so Python and kernel or graph launches
alone; median over the traced stretch's frames (layer: tracker; moves
frames_per_s).  Disjoint from `span.host_wait_ms.per_frame` and
`span.graph_io_ms.per_frame` by definition.

Not listed in `BENCHMARK.json`: in a `--trace 1` run the store holds the
profiled stretch alone, where the profiler's own cost on the host swamps
the host's times (a frame's enqueue reads ~30 times its untraced value).
`tools/trace_window.py` reads it over a whole window traced with
`metrics.enable()` alone."""

import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location("bench_program_spans",
                                               Path(__file__).with_name("program_spans.py"))
spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(spans)


CUT = spans.GRAPH_IO + ("system/keyframe",)


def _cut(s):
    return spans.is_wait(s) or s.name in CUT


def _frame(root, children):
    proc = [s for s in children.get(root.seq, ()) if s.name == "track/process"]
    return sum(spans.host_ms_less(p, children, _cut) for p in proc) if proc else None


def read(run):
    v = [x for x in spans.per_frame(_frame) or () if x is not None]
    return float(np.median(v)) if v else None
