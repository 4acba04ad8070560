"""CUDA graphs: the port's counterpart of `jax.jit`.

`graphed(static_argnames=...)` is `partial(jax.jit, static_argnames=...)`
for a function that reads nothing back to the host.  On the card the
decorated function is one CUDA graph replay a call, captured once for each
input signature (the function, the device, the static arguments, and the
structure, shape and dtype of every tensor of the others); on the CPU it
calls its body.  Each signature has one `Entry`:

- fixed input buffers, filled by `copy_into` on every call; a Python
  `int`, `float` or `bool` argument that is not static is traced, as JAX
  traces it: a 0-dim device buffer filled with `fill_`, never baked into
  the graph;
- a warm-up of the body on a side stream, then one capture (`capture`);
- the kernel launches the capture recorded, added to `kernels.LAUNCHES` on
  every replay (a replay calls no wrapper); the warm-up's and the capture's
  own launches, and what they added to any `DeviceCounters`, are taken back;
- its own memory pool: replays of different entries may come in any order
  (the tracker's fallback and insertion run on some frames only);
- outputs handed back as the caller's own copies (`clone`): the next replay
  overwrites the graph's memory.

A decorated function called inside another one's body (a warm-up or a
capture) calls its body, as a jit inside a traced function is inlined.
`eager()` makes every decorated function call its body on the card too:
for holding a replay against the eager call.  A capture that fails raises;
nothing falls back to eager launches.

The fused tracking step (`frontend/fused_graph.FusedStep`) keeps buffers of
its own, since its outputs are the next frame's inputs, and captures
through `capture` as well.

`DeviceCounters` are the counters a captured function keeps: an `add_` on a
tensor of the device, so a replay counts as the eager call did, and
counting reads nothing back.  `read()` takes one host read a device.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from . import metrics

# scalars traced as 0-dim device tensors, and their dtypes
_SCALARS = {bool: torch.bool, int: torch.int64, float: torch.float32}


def _scalar(x):
    """The type (bool, int or float) of a scalar argument that is traced: a
    Python or numpy scalar; None for anything else."""
    for t, kinds in ((bool, (bool, np.bool_)), (int, (int, np.integer)),
                     (float, (float, np.floating))):
        if isinstance(x, kinds):
            return t
    return None


def tensors(x):
    """The tensors of a tensor, a NamedTuple or a tuple, in order (fields
    that are no tensor, such as None or an image size, skipped)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, tuple):
        return [t for f in x for t in tensors(f)]
    return []


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.shape == b.shape
                      and a.stride() == b.stride() and a.dtype == b.dtype)


def copy_into(buf, value) -> None:
    """buf.copy_(value) field by field, skipping fields that are the buffer."""
    for b, v in zip(tensors(buf), tensors(value), strict=True):
        if not _same(b, v):
            b.copy_(v)


def clone(x):
    """A copy of each tensor of a (Named)tuple nest; other leaves (None, an
    image size) as they are."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if not isinstance(x, tuple):
        return x
    out = [clone(f) for f in x]
    return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)


def filled(values, dtype: torch.dtype, device) -> torch.Tensor:
    """A 1-D tensor of host values, each filled in on the device (no copy
    from pageable host memory, which would make the stream wait)."""
    out = torch.empty(len(values), dtype=dtype, device=device)
    for i, v in enumerate(values):
        out[i].fill_(v)
    return out


@contextlib.contextmanager
def no_host_sync(device: torch.device):
    """On a CUDA device, `torch.cuda.set_sync_debug_mode("error")` for the
    block (the mode it found is restored): an operation that makes the host
    wait on the device raises."""
    if device.type != "cuda":
        yield
        return
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


# this thread's depth of `eager()` blocks and of bodies being warmed up or
# captured
_local = threading.local()


@contextlib.contextmanager
def _depth(name: str):
    setattr(_local, name, getattr(_local, name, 0) + 1)
    try:
        yield
    finally:
        setattr(_local, name, getattr(_local, name) - 1)


def eager():
    """A block in which every `graphed` function calls its body, on the
    card too (to hold a replay against the eager call)."""
    return _depth("eager")


def _calls_body(device: torch.device) -> bool:
    """Whether a graphed function calls its body here: off the card, under
    `eager()`, or inside another graph's body."""
    return (device.type != "cuda" or getattr(_local, "eager", 0) > 0
            or getattr(_local, "inline", 0) > 0 or torch.cuda.is_current_stream_capturing())


class Captured(NamedTuple):
    graph: torch.cuda.CUDAGraph
    out: object              # what the captured body returned (the graph's memory)
    launches: dict           # kernel launches in the graph, by kernel
    warmup_ms: float
    capture_ms: float


def capture(device: torch.device, warmup, body) -> Captured:
    """Call `warmup()` on a side stream (library handles, constant tables,
    counters), then capture `body()` into a CUDA graph with a memory pool
    of its own.  Neither call's kernel launches nor what they added to a
    `DeviceCounters` stay counted; decorated functions inside both call
    their bodies."""
    from ..ops import _build, kernels

    with metrics.span("graph/capture"):
        _build.load()
        launches0 = dict(kernels.LAUNCHES)
        cur = torch.cuda.current_stream(device)
        with metrics.wait("capture"):
            torch.cuda.synchronize(device)
        saved = [c.save(device) for c in _COUNTERS]
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        t0 = time.perf_counter()
        with _depth("inline"), torch.cuda.stream(side):
            warmup()
        cur.wait_stream(side)
        with metrics.wait("capture"):
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        launches1 = dict(kernels.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        with _depth("inline"), torch.cuda.graph(graph):
            out = body()
        with metrics.wait("capture"):
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
    launches = {k: v - launches1[k] for k, v in kernels.LAUNCHES.items()}
    kernels.LAUNCHES.update(launches0)
    for c, s in zip(_COUNTERS, saved):
        c.restore(device, s)
    return Captured(graph, out, launches, (t1 - t0) * 1e3, (t2 - t1) * 1e3)


def _spec(x, top: bool):
    """What a signature holds of a non-static argument: shape, dtype and
    device of a tensor, the type of a traced scalar (top level only), the
    type and fields of a tuple, and any other leaf by value (an image size
    in a NamedTuple, None)."""
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if top and _scalar(x) is not None:
        return _scalar(x)
    if isinstance(x, tuple):
        return (type(x),) + tuple(_spec(f, False) for f in x)
    hash(x)
    return ("value", x)


def _buffer(x, top: bool, device):
    """A fixed buffer of the argument's structure: tensors cloned, a traced
    scalar a 0-dim device tensor, other leaves as they are."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if top and _scalar(x) is not None:
        return torch.zeros((), dtype=_SCALARS[_scalar(x)], device=device)
    if isinstance(x, tuple):
        out = [_buffer(f, False, device) for f in x]
        return type(x)(*out) if hasattr(x, "_fields") else type(x)(out)
    return x


def _device_of(arguments: dict, static) -> torch.device | None:
    """The device of the first tensor of the non-static arguments."""
    return next((t.device for k, v in arguments.items() if k not in static
                 for t in tensors(v)), None)


class Entry:
    """One signature of a graphed function: its input buffers, its CUDA
    graph (captured on the first `run` on the card) and what the capture
    counted.  Off the card `run` calls the body on the buffers."""

    def __init__(self, fn, bind, device: torch.device, arguments: dict, static):
        self.fn, self.name, self.device = fn, fn.__qualname__, device
        self.span_name = f"graph/{self.name}"
        self._bind, self.static = bind, static
        self.inputs = {k: v if k in static else _buffer(v, True, device)
                       for k, v in arguments.items()}
        self._traced = {k for k, v in arguments.items()
                        if k not in static and _scalar(v) is not None}
        self.graph = None
        self.out = None
        self.graph_launches = {}
        self.warmup_ms = self.capture_ms = None
        self.n_calls = 0          # calls run through the entry: on the card, replays

    def load(self, arguments: dict) -> None:
        """Fill the buffers: a traced scalar by `fill_`, tensors by
        `copy_into`."""
        for k, v in arguments.items():
            if k in self._traced:
                self.inputs[k].fill_(_scalar(v)(v))
            elif k not in self.static:
                copy_into(self.inputs[k], v)

    def body(self):
        """The function called eagerly on the buffers."""
        with _depth("inline"):
            return self.fn(**self.inputs)

    def capture(self) -> None:
        """Warm up and capture the body on the buffers as they are (the
        host waits here, once)."""
        cap = capture(self.device, self.body, self.body)
        self.graph, self.out, self.graph_launches = cap.graph, cap.out, cap.launches
        self.warmup_ms, self.capture_ms = cap.warmup_ms, cap.capture_ms

    def run(self, *args, **kwargs):
        """The function's call on this signature: fill the buffers, replay
        (capturing first), and return a copy of the outputs."""
        return self._run(self._bind(args, kwargs))

    def _run(self, arguments: dict):
        with metrics.span(self.span_name):
            with metrics.span("graph/load"):
                self.load(arguments)
            self.n_calls += 1
            if self.device.type != "cuda":
                return clone(self.body())
            if self.graph is None:
                self.capture()
            with no_host_sync(self.device):
                with metrics.span("graph/replay", self.device):
                    self.graph.replay()
                with metrics.span("graph/clone"):
                    out = clone(self.out)
        from ..ops import kernels

        kernels.add_launches(self.graph_launches)
        return out


# every graphed function, in the order of definition
GRAPHED: list = []


def graphed(static_argnames=()):
    """Decorator: the function as one CUDA graph replay a call on the card
    (see the module's docstring), its body on the CPU.  The decorated
    function's `entry(*args, **kwargs)` is the `Entry` of a call's
    signature (made on first use, on any device), `entries` all of them,
    and `__wrapped__` the body."""
    static = frozenset(static_argnames)

    def wrap(fn):
        sig = inspect.signature(fn)
        unknown = static - set(sig.parameters)
        if unknown:
            raise TypeError(f"{fn.__qualname__}: no argument {sorted(unknown)}")
        entries = {}

        def bind(args, kwargs):
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            return bound.arguments

        def entry_of(arguments: dict) -> Entry:
            device = _device_of(arguments, static)
            if device is None:
                raise TypeError(f"{fn.__qualname__}: no tensor argument")
            key = (device,) + tuple((k, v) if k in static else (k, _spec(v, True))
                                    for k, v in arguments.items())
            entry = entries.get(key)
            if entry is None:
                entry = entries[key] = Entry(fn, bind, device, arguments, static)
            return entry

        @functools.wraps(fn)
        def call(*args, **kwargs):
            arguments = bind(args, kwargs)
            device = _device_of(arguments, static)
            if device is None or _calls_body(device):
                return fn(*args, **kwargs)
            return entry_of(arguments)._run(arguments)

        call.entry = lambda *args, **kwargs: entry_of(bind(args, kwargs))
        call.entries = entries
        GRAPHED.append(call)
        return call

    return wrap


def all_entries():
    """(function name, Entry) of every signature captured or made so far."""
    return [(e.name, e) for fn in GRAPHED for e in fn.entries.values()]


# every DeviceCounters of the process: a capture takes back what its
# warm-up and its capture added to them
_COUNTERS: list = []


class DeviceCounters:
    """Named int64 counters, one 0-dim tensor a (key, device), added to in
    place on the device that counts.

    A counter is created at its first `add` on a device; a function that is
    captured into a CUDA graph creates its counters in its eager warm-up,
    and `capture` takes them back to their values from before it (`save` /
    `restore`), so that only replays count.  `read()` is {key: int}
    summed over devices: one host read a device, a value and not a
    reference (a snapshot to subtract from a later `read()`)."""

    def __init__(self):
        self._t = {}      # device -> {key: tensor}
        _COUNTERS.append(self)

    @staticmethod
    def _device(device) -> torch.device:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def counter(self, key, device) -> torch.Tensor:
        device = self._device(device)
        per = self._t.setdefault(device, {})
        if key not in per:
            per[key] = torch.zeros((), dtype=torch.int64, device=device)
        return per[key]

    def add(self, key, value, device=None) -> None:
        """Add `value` (a Python int, or a tensor on the counting device)."""
        if isinstance(value, torch.Tensor):
            self.counter(key, value.device).add_(value.to(torch.int64))
        else:
            self.counter(key, device).add_(int(value))

    def save(self, device) -> dict:
        return {k: t.clone() for k, t in self._t.get(self._device(device), {}).items()}

    def restore(self, device, saved: dict) -> None:
        """Counters back to `save`'s copies; a counter created since goes
        back to 0."""
        for k, t in self._t.get(self._device(device), {}).items():
            if k in saved:
                t.copy_(saved[k])
            else:
                t.zero_()

    def read(self) -> dict:
        out = {}
        for per in self._t.values():
            keys = list(per)
            if not keys:
                continue
            for k, v in zip(keys, torch.stack([per[k] for k in keys]).tolist()):
                out[k] = out.get(k, 0) + v
        return out
