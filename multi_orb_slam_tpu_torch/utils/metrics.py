"""Lightweight per-stage timing and counters.

The reference instruments itself with ad-hoc `std::chrono` spans printed to
stdout (pose-opt time Optimizer.cc:613-615, local-BA time :1348-1351,
per-frame track time Tracking.cc:294-299, the example program's median and
mean rgbd_tum.cc:160-169).  This module is the structured equivalent: named
timer spans with summary statistics, usable as context managers, plus
counters.  The port's own copy of `multi_orb_slam_tpu/utils/metrics.py`
(numpy only).  A span closes on the host clock and adds no synchronisation:
around work queued on the card it reads the time to queue it, unless the
work itself ends in a host read.  For kernel-level profiles use
`torch.profiler` around a sequence of frames.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class Metrics:
    def __init__(self):
        self.spans = defaultdict(list)
        self.counters = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name].append(time.perf_counter() - t0)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def summary(self) -> dict:
        out = {}
        for name, vals in self.spans.items():
            v = np.asarray(vals)
            out[name] = {
                "n": len(v),
                "median_ms": float(np.median(v) * 1e3),
                "mean_ms": float(np.mean(v) * 1e3),
                "p90_ms": float(np.percentile(v, 90) * 1e3),
                "total_s": float(v.sum()),
            }
        for name, c in self.counters.items():
            out[name] = c
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            if isinstance(s, dict):
                lines.append(
                    f"{name:32s} n={s['n']:5d} median={s['median_ms']:8.2f}ms "
                    f"mean={s['mean_ms']:8.2f}ms p90={s['p90_ms']:8.2f}ms")
            else:
                lines.append(f"{name:32s} {s}")
        return "\n".join(lines)

    def reset(self):
        self.spans.clear()
        self.counters.clear()


GLOBAL = Metrics()
