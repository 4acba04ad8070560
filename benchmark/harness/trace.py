"""The traced run's device timeline: a short steady stretch of frames under
`torch.profiler`, reduced to what the per-layer metrics and the result's
`device` and `breakdown` read.

The profiler is made in set-up and waits for the stretch; it misses
launches while it starts, so the stretch's first frames go to its warm-up
and only the frames after them are read.  A traced run's window lasts
until the stretch is read, past `--seconds` where it must.  The traced
window runs from the start of the first read frame to the end of the last
(each frame is a `bench.frame` range).  Device time is the union of the
device's kernels, copies and sets inside it; the host's ranges mirrored on the
device's timeline are left out.  An idle gap is named by the innermost host
event that covers its middle, or as Python where none does.
"""

from __future__ import annotations

import bisect
import collections

import torch

FRAME_RANGE = "bench.frame"
LABELLED_GAPS = 500     # the longest idle gaps, each named by the host event over it
LOOK_BACK = 5000        # host events started before a gap's middle searched for one over it


class Stretch:
    """Profile window frames [start + warm, start + warm + frames), after
    `warm` frames of the profiler's own warm-up: made in set-up, stepped by
    `after()` after each window frame; `events` once the stretch is read."""

    def __init__(self, start: int, warm: int, frames: int):
        self.total = start + warm + frames
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        steps = torch.profiler.schedule(wait=start, warmup=warm, active=frames, repeat=1)
        self.prof = torch.profiler.profile(activities=acts, schedule=steps)
        self.prof.__enter__()
        self.n = 0
        self.events = None

    @property
    def done(self) -> bool:
        return self.events is not None

    def after(self) -> None:
        if self.done:
            return
        self.n += 1
        if self.n == self.total:
            torch.cuda.synchronize()
        self.prof.step()
        if self.n == self.total:
            self.events = list(self.prof.profiler.kineto_results.events())
            self.prof.__exit__(None, None, None)

    def close(self) -> None:
        """Stop a stretch the run ended before (nothing is read)."""
        if not self.done:
            self.prof.__exit__(None, None, None)
            self.events = []


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events) -> dict | None:
    """busy_s, window_s, (launches, device s) of every device operation by
    its name, the top device operations and the longest idle time by what
    the host was doing."""
    cpu = torch.autograd.DeviceType.CPU
    frames = [e for e in events if e.device_type() == cpu and e.name() == FRAME_RANGE]
    if not frames:
        return None
    t0 = min(e.start_ns() for e in frames)
    t1 = max(e.end_ns() for e in frames)
    dev = [e for e in events if e.device_type() != cpu and not e.is_user_annotation()
           and e.end_ns() > t0 and e.start_ns() < t1]
    host = [e for e in events if e.device_type() == cpu and e.name() != FRAME_RANGE
            and not e.name().startswith("ProfilerStep")]
    busy = _merge([(max(e.start_ns(), t0), min(e.end_ns(), t1)) for e in dev])
    busy_ns = sum(b - a for a, b in busy)
    by_op = collections.Counter()
    launches = collections.Counter()
    for e in dev:
        by_op[e.name()] += (e.end_ns() - e.start_ns()) / 1e9
        launches[e.name()] += 1
    gaps = []
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    idle = collections.Counter()
    host.sort(key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in host]
    gaps.sort(key=lambda ab: ab[0] - ab[1])
    for a, b in gaps[:LABELLED_GAPS]:
        mid = (a + b) // 2
        i = bisect.bisect_right(starts, mid)
        cover = [e for e in host[max(0, i - LOOK_BACK):i] if e.end_ns() >= mid]
        label = (min(cover, key=lambda e: e.end_ns() - e.start_ns()).name() if cover
                 else "host Python between operations")
        idle[label] += (b - a) / 1e9
    rest = sum(b - a for a, b in gaps[LABELLED_GAPS:])
    if rest:
        idle[f"gaps shorter than the {LABELLED_GAPS} longest"] += rest / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": (t1 - t0) / 1e9,
            "kernels": {n: (launches[n], s) for n, s in by_op.items()},
            "device_ops": [[n, s] for n, s in by_op.most_common(10)],
            "idle_gaps": [[n, s] for n, s in idle.most_common(10)]}
