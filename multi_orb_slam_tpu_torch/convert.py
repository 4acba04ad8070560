"""State carried between the JAX reference package and this port.

`CameraParams`, `FrameData`, `MapState`, `LocalPoints`, `PoseObs` and
`Features` have the same fields, in the same order, in both packages.
`to_torch` turns a reference tuple (of jax or numpy arrays) into the port's
tuple of tensors on a device; `to_numpy` turns a port tuple into a dict of
numpy arrays that the reference's constructors take
(`map_state.MapState(**to_numpy(state))`).

Descriptors are uint32 words in the reference and int32 words here: the
conversion reinterprets the bits with `np.ndarray.view`, so it is
bit-identical both ways.  torch's uint32 lacks many CUDA ops.  This module
imports no jax: reference arrays are read through `np.asarray`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# fields holding descriptor words (uint32 in the reference, int32 here)
DESC_FIELDS = frozenset({"desc", "kf_desc", "mp_desc", "mp_descbuf"})


def _field_to_torch(v, device):
    if v is None or isinstance(v, (int, float)):
        return v
    a = np.asarray(v)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def to_torch(nt: NamedTuple, cls: type, device=None):
    """Reference NamedTuple -> the port's `cls` with tensors on `device`."""
    return cls(*[_field_to_torch(getattr(nt, f), device) for f in cls._fields])


def to_numpy(nt: NamedTuple) -> dict:
    """Port NamedTuple -> {field: numpy array}; descriptor words as uint32."""
    out = {}
    for f in nt._fields:
        v = getattr(nt, f)
        if isinstance(v, torch.Tensor):
            a = v.detach().cpu().numpy()
            if f in DESC_FIELDS:
                a = a.view(np.uint32)
            out[f] = a
        else:
            out[f] = v
    return out
