"""The port's tracer: named spans at the layer boundaries, and counters.

The reference instruments itself with ad-hoc `std::chrono` spans printed to
stdout (pose-opt time Optimizer.cc:613-615, local-BA time :1348-1351,
per-frame track time Tracking.cc:294-299, the example program's median and
mean rgbd_tum.cc:160-169).  Here every layer boundary opens a `span(name)`;
names are `<layer>/<stage>` (`system/track_rgbd`, `track/step`,
`graph/replay`, `wait/pose_readback`, `mapping/solve`, `io/decode`, ...).
Every point where the host waits for the device is a `wait/<site>` span:
`host(site, t)` reads a tensor back inside one, `upload(x, device)` copies
host memory onto the card inside `wait/upload`, and `wait(site)` marks any
other wait (a `nonzero`, a synchronise, an event).

A span records its name, its parent span, the system it belongs to and that
system's frame id (inherited from the enclosing span), its host start and
end on `time.perf_counter_ns`, and, where it is given a CUDA `device`, a
pair of timing events recorded on the current stream.  A span's device ms
is the time between its two events; it is read only when someone asks
(`Span.device_ms`), never while the span runs, and the read does not wait:
an event the device has not reached yet reads as None.

Tracing is off by default.  Off, `span` checks a module flag and the
profiler's enabled bit and returns one shared no-op context: no
`record_function`, no event, no allocation.  It is on while `enable()` is
in force or while a `torch.profiler` records (its wait and warm-up steps do
not count).  While a profiler records, every span also opens a
`record_function` range under its own name, so the spans sit in the
profiler's timeline beside the kernels.  Inside a CUDA graph's warm-up or
capture (`graphs` bodies called inline, or a stream that captures) a span
is a no-op: an event recorded into a capture would be part of the graph,
and a replay runs no host code.

Spans go to one process-global store (`GLOBAL`), a ring of `CAPACITY`
spans: the oldest is dropped (and counted) when it is full, and its events
go back to a pool.  `Metrics` is the view of one owner (a `System` has one):
its spans, filtered by its id, and its own host counters.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict

import numpy as np
import torch

CAPACITY = 1 << 16

_on = False
_profiling = torch._C._autograd._profiler_enabled
_local = threading.local()      # this thread's stack of open spans
_owners = itertools.count(1)


def enable(on: bool = True) -> None:
    """Record spans from now on (or stop, with `on=False`), profiler or not."""
    global _on
    _on = bool(on)


@contextlib.contextmanager
def tracing(on: bool = True):
    """A block with tracing switched on (or off); the setting it found is
    restored after it."""
    before = _on
    enable(on)
    try:
        yield
    finally:
        enable(before)


class _Null:
    """The span of tracing off: does nothing, shared by every call."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


_graph_local = None            # `graphs._local`, looked up on first use (graphs imports this)


def _in_graph_body() -> bool:
    """Whether the host is inside a CUDA graph's warm-up or capture."""
    global _graph_local
    if _graph_local is None:
        from .graphs import _local as _graph_local
    return (getattr(_graph_local, "inline", 0) > 0
            or (torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()))


def span(name: str, device=None, system=None, frame=None):
    """A context that records one span named `name`.  With a CUDA `device`
    the span carries a pair of timing events on the current stream (give it
    only to spans that enqueue device work).  `system` and `frame` are
    inherited from the enclosing span unless given."""
    if not (_on or _profiling()):
        return _NULL
    if _in_graph_body():
        return _NULL
    return _Open(name, device, system, frame)


def wait(name: str, event=None):
    """The span `wait/<name>` of a point where the host waits for the
    device.  Around a wait on `event` it records only where the host will
    really wait (the event has not completed)."""
    if not (_on or _profiling()) or (event is not None and event.query()):
        return _NULL
    return span("wait/" + name)


def host(name: str, t: torch.Tensor) -> np.ndarray:
    """`t` read back to the host, as a numpy array, inside `wait(name)`."""
    with wait(name):
        return t.cpu().numpy()


def upload(x, device, dtype=None) -> torch.Tensor:
    """`x` (a numpy array, a list or a tensor) as a tensor on `device`.  From
    host memory onto the card it is a copy from pageable memory that the
    host waits for, inside `wait("upload")`."""
    if torch.device(device).type == "cuda" and not (isinstance(x, torch.Tensor) and x.is_cuda):
        with wait("upload"):
            return torch.as_tensor(x, dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


class Span:
    """One recorded span; `t1` is None while it is open."""

    __slots__ = ("seq", "name", "parent", "system", "frame", "t0", "t1", "events", "_dev_ms")

    def __init__(self, seq, name, parent, system, frame):
        self.seq, self.name, self.parent = seq, name, parent
        self.system, self.frame = system, frame
        self.t0 = self.t1 = None
        self.events = None
        self._dev_ms = None

    @property
    def host_ms(self) -> float | None:
        return None if self.t1 is None else (self.t1 - self.t0) / 1e6

    def device_ms(self) -> float | None:
        """Device ms between the span's two events; None for a span without
        events, or one whose end the device has not reached.  Reading does
        not wait; once read, the events go back to the pool."""
        if self._dev_ms is None and self.events is not None and self.t1 is not None:
            start, end = self.events
            if not end.query():
                return None
            self._dev_ms = start.elapsed_time(end)
            GLOBAL._release(self)
        return self._dev_ms


class _Open:
    """The context of a span that records."""

    __slots__ = ("s", "rf", "device")

    def __init__(self, name, device, system, frame):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        top = stack[-1] if stack else None
        self.s = GLOBAL._new(name, top.seq if top is not None else None,
                             system if system is not None else (top.system if top else None),
                             frame if frame is not None else (top.frame if top else None))
        self.device = device is not None and torch.device(device).type == "cuda"
        self.rf = None

    def __enter__(self):
        s = self.s
        _local.stack.append(s)
        if _profiling():
            self.rf = torch.autograd.profiler.record_function(s.name)
            self.rf.__enter__()
        if self.device:
            s.events = GLOBAL._take_events()
            s.events[0].record()
        s.t0 = time.perf_counter_ns()
        return s

    def __exit__(self, *exc):
        s = self.s
        if s.events is not None:
            s.events[1].record()
        s.t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _local.stack
        if stack and stack[-1] is s:
            stack.pop()
        return False


class Store:
    """A ring of the last `capacity` spans of the process, and a pool of
    timing events for them."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._n = 0               # spans made since import: the next one's seq
        self.clear()

    def clear(self) -> None:
        """Forget every span (the events too); seqs go on counting."""
        self._ring = [None] * self.capacity
        self._first = self._n
        self._pool = []

    @property
    def dropped(self) -> int:
        """Spans dropped from the ring, oldest first, since the last clear."""
        return max(0, self._n - self._first - self.capacity)

    def _new(self, name, parent, system, frame) -> Span:
        with self._lock:
            seq = self._n
            self._n += 1
            i = seq % self.capacity
            old = self._ring[i]
            s = self._ring[i] = Span(seq, name, parent, system, frame)
        if old is not None:
            self._release(old)
        return s

    def _take_events(self):
        if self._pool:
            return self._pool.pop()
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def _release(self, s: Span) -> None:
        if s.events is not None:
            self._pool.append(s.events)
            s.events = None

    def spans(self, system=None) -> list:
        """The closed spans in the ring, oldest first (of one system's id
        where given)."""
        n, cap = self._n, self.capacity
        out = [self._ring[q % cap] for q in range(max(self._first, n - cap), n)]
        return [s for s in out if s is not None and s.t1 is not None
                and (system is None or s.system == system)]


GLOBAL = Store()


def spans(system=None) -> list:
    """The closed spans of the process-global store, oldest first."""
    return GLOBAL.spans(system)


def clear() -> None:
    GLOBAL.clear()


def _summary(spans_: list) -> dict:
    """{name: n, host median / mean / p90 ms and total s, and the device's
    median / mean / p90 ms where the spans carry events}."""
    by = defaultdict(list)
    for s in spans_:
        by[s.name].append(s)
    out = {}
    for name, ss in by.items():
        v = np.asarray([s.host_ms for s in ss])
        row = {"n": len(v), "median_ms": float(np.median(v)), "mean_ms": float(np.mean(v)),
               "p90_ms": float(np.percentile(v, 90)), "total_s": float(v.sum() / 1e3)}
        d = [x for x in (s.device_ms() for s in ss) if x is not None]
        if d:
            d = np.asarray(d)
            row.update(device_median_ms=float(np.median(d)), device_mean_ms=float(np.mean(d)),
                       device_p90_ms=float(np.percentile(d, 90)))
        out[name] = row
    return out


class Metrics:
    """One owner's view of the tracer: its spans in the global store (by its
    id) and its own host counters."""

    def __init__(self):
        self.id = next(_owners)
        self.counters = defaultdict(int)
        self._since = 0

    def span(self, name: str, device=None, frame=None):
        return span(name, device, system=self.id, frame=frame)

    def count(self, name: str, n: int = 1):
        self.counters[name] += n

    def spans(self) -> list:
        return [s for s in GLOBAL.spans(self.id) if s.seq >= self._since]

    def summary(self) -> dict:
        out = _summary(self.spans())
        out.update(self.counters)
        return out

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            if isinstance(s, dict):
                line = (f"{name:32s} n={s['n']:5d} median={s['median_ms']:8.2f}ms "
                        f"mean={s['mean_ms']:8.2f}ms p90={s['p90_ms']:8.2f}ms")
                if "device_median_ms" in s:
                    line += (f" device median={s['device_median_ms']:8.2f}ms "
                             f"mean={s['device_mean_ms']:8.2f}ms p90={s['device_p90_ms']:8.2f}ms")
                lines.append(line)
            else:
                lines.append(f"{name:32s} {s}")
        return "\n".join(lines)

    def reset(self):
        """Forget this owner's spans so far and its counters."""
        self._since = GLOBAL._n
        self.counters.clear()
