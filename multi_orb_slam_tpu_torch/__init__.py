"""Multi-camera ORB SLAM tracking and mapping in PyTorch, with hand-written Hopper kernels.

The PyTorch + CUDA counterpart of `multi_orb_slam_tpu` (the JAX reference
package, which stays the numerical spec).  Sub-packages and modules carry the
same names as the reference's, so each counterpart is easy to find:

- `ops/orb.py`: ORB pyramid extraction; FAST scoring and the per-keypoint
  patch gather run as CUDA kernels (`ops/kernels.py`, `csrc/*.cu`)
- `ops/search.py`: the projection searches; their gated best/second Hamming
  inner loop is the `window_match` CUDA kernel
- `optim/pose_opt.py`: motion-only bundle adjustment
- `frontend/tracking.py`: the per-frame tracking state machine (`Tracker`)
- `mapping/`: the map store (`map_state.py`) and the mapping stage run at
  every keyframe (`local_mapping.run_mapping_stage`: map-point culling,
  `triangulation.py`, `fusion.py`, local BA, keyframe culling)
- `optim/local_ba.py`: windowed bundle adjustment with an explicit Schur
  complement; its observation re-layout is the `point_sums` CUDA kernel

Public functions keep the reference's layouts: `[C, F, ...]` feature arrays,
`[K, C, F]` keyframe arrays, 4x4 world->camera `Tcw`.  Descriptors are held
as int32 words (bit-identical to the reference's uint32, see `convert.py`).

Numerics policy: SLAM geometry is unforgiving of reduced-precision matmuls
(the reference forces float32 matmuls because bf16 passes gave NaN poses).
Importing this package therefore sets
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, process-wide, so every float32
matmul and convolution on the card runs in full float32.
"""

__version__ = "0.1.0"

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> "_torch.device":
    """The device an entry point that creates state runs on: the CUDA
    device unless the caller names another (`device="cpu"`, as the CPU tests
    do).  With `device=None` and no CUDA device this raises; nothing falls
    back to the CPU unasked."""
    if device is None:
        if not _torch.cuda.is_available():
            raise RuntimeError(
                "multi_orb_slam_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return _torch.device(device)
