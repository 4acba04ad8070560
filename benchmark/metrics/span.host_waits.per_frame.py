"""The host's waits on the device a frame: `wait/*` spans of the program
per `system/track_rgbd`, mean over the traced stretch's frames (layer:
facade; moves frames_per_s).  Every site on the frame path where the host
waits for the device is a `wait/<site>` span: the pageable uploads, the
pose read back, the stepwise route's inlier counts, the keyframe stages'
reads; a wait on an event only where the event had not completed."""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("bench_program_spans",
                                               Path(__file__).with_name("program_spans.py"))
spans = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(spans)


def read(run):
    v = spans.per_frame(lambda r, ch: sum(1 for s in spans.descendants(r, ch) if spans.is_wait(s)))
    return float(sum(v)) / len(v) if v else None
