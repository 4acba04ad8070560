"""What the port's captured steps share: nests of tensors, copies into
fixed buffers, the host-sync check, and counters that live on the device.

Two steps run as CUDA graphs on the card: the fused tracking step
(`frontend/fused_graph.FusedStep`) and the mapping stage
(`mapping/mapping_graph.MappingStep`).  Both keep their inputs in fixed
buffers, fill them field by field, replay, and hand out what they made.

`DeviceCounters` are the counters a captured step keeps: an `add_` on a
tensor of the device, so a replay counts as the eager call did, and
counting reads nothing back.  `read()` takes one host read a device.
"""

from __future__ import annotations

import contextlib

import torch


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
    """A copy of a tensor, or of each tensor of a (Named)tuple nest of
    tensors and Nones."""
    if x is None or isinstance(x, torch.Tensor):
        return None if x is None else x.clone()
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


class DeviceCounters:
    """Named int64 counters, one 0-dim tensor a (key, device), added to in
    place on the device that counts.

    A counter is created at its first `add` on a device; a step that is
    captured into a CUDA graph creates its counters in its eager warm-up,
    and takes them back to their values from before it (`save` /
    `restore`), so that only replays count.  `read()` is {key: int}
    summed over devices: one host read a device, a value and not a
    reference (a snapshot to subtract from a later `read()`)."""

    def __init__(self):
        self._t = {}      # device -> {key: tensor}

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
