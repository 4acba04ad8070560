"""The program's own spans, as the tracer of multi_orb_slam_tpu_torch
(`utils/metrics.py`) holds them once a traced run's window is over; the
readers of the `span.*` metrics beside this file share it.

The tracer records only while `metrics.enable()` is in force or a
`torch.profiler` records, and the harness never enables it: in a traced run
the store holds the frames of the profiled stretch alone (each whole, since
the profiler steps between frames).  `tools/trace_window.py` runs the
readers over a whole window with the tracer enabled instead.  A frame is a `system/track_rgbd` span with its
descendants.  A program without the tracer, or a store without a frame,
gives None.
"""

from __future__ import annotations

import collections

FRAME = "system/track_rgbd"
WAIT = "wait/"
GRAPH_IO = ("graph/load", "graph/clone")


def frames():
    """[(root span, {seq: [child spans]})] of every frame in the store, or
    None."""
    try:
        from multi_orb_slam_tpu_torch.utils import metrics
    except ImportError:
        return None
    read = getattr(metrics, "spans", None)
    if not callable(read):
        return None
    spans = read()
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    roots = [s for s in spans if s.name == FRAME]
    return [(r, children) for r in roots] or None


def descendants(span, children) -> list:
    out, todo = [], list(children.get(span.seq, ()))
    while todo:
        s = todo.pop()
        out.append(s)
        todo.extend(children.get(s.seq, ()))
    return out


def topmost(span, children, hit) -> list:
    """The descendants of `span` for which `hit(s)` holds and that have no
    such ancestor below `span`."""
    out, todo = [], list(children.get(span.seq, ()))
    while todo:
        s = todo.pop()
        if hit(s):
            out.append(s)
        else:
            todo.extend(children.get(s.seq, ()))
    return out


def device_leaves_ms(span, children, skip):
    """Device ms summed over the innermost descendants of `span` that carry
    device events (those with no such descendant of their own), leaving out
    the subtrees of the descendants that `skip`; None where none carries
    events."""
    total, found = 0.0, False
    for c in children.get(span.seq, ()):
        if skip(c):
            continue
        ms = device_leaves_ms(c, children, skip)
        if ms is None:
            ms = c.device_ms()
        if ms is not None:
            total, found = total + ms, True
    return total if found else None


def is_wait(s) -> bool:
    return s.name.startswith(WAIT)


def host_ms_less(span, children, hit) -> float:
    """Host ms of `span` less that of its top-most descendants that `hit`."""
    return span.host_ms - sum(s.host_ms for s in topmost(span, children, hit))


def per_frame(fn):
    """fn(root, children) for each frame, as a list; None without frames."""
    fr = frames()
    return None if fr is None else [fn(r, ch) for r, ch in fr]
