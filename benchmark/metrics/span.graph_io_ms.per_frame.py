"""Host ms a frame spends copying into and out of the CUDA graphs: the
top-most `graph/load` (`copy_into` of the inputs) and `graph/clone` (the
outputs' copies) spans under each `system/track_rgbd`, less any wait inside
them; mean over the traced stretch's frames (layer: jit boundaries; moves
frames_per_s).

Not listed in `BENCHMARK.json`: in a `--trace 1` run the store holds the
profiled stretch alone, where the profiler's own cost on the host swamps
the host's times (a frame's enqueue reads ~30 times its untraced value).
`tools/trace_window.py` reads it over a whole window traced with
`metrics.enable()` alone."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("bench_program_spans",
                                               Path(__file__).with_name("program_spans.py"))
spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(spans)


def _frame(root, children):
    io = spans.topmost(root, children, lambda s: s.name in spans.GRAPH_IO)
    return sum(spans.host_ms_less(s, children, spans.is_wait) for s in io)


def read(run):
    v = spans.per_frame(_frame)
    return float(sum(v)) / len(v) if v else None
