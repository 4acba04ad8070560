"""Host ms a frame spends waiting on the device: the host time of the
top-most `wait/*` spans under each `system/track_rgbd`, mean over the
traced stretch's frames (layer: facade; moves frames_per_s).

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


def read(run):
    v = spans.per_frame(lambda r, ch: sum(s.host_ms for s in spans.topmost(r, ch, spans.is_wait)))
    return float(sum(v)) / len(v) if v else None
