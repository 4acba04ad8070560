"""Frame construction: multi-camera ORB extraction + depth association.

Counterpart of `multi_orb_slam_tpu/frontend/frame.py`: `build_frame` (ORB
extraction of every rig camera in one batched call, per-camera keypoint
undistortion, depth lookup and the RGB-D virtual right coordinate) and
`build_frame_stereo` (depth from left / right ORB matching).
Cameras are a leading axis `[C, F, ...]`.  Both are `graphs.graphed`, as
the reference jits them: one CUDA graph replay a call on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..ops import orb, stereo
from ..utils import graphs


class FrameData(NamedTuple):
    """One rig frame: all arrays are [C, F, ...] with validity masks."""

    xy: torch.Tensor        # [C, F, 2] raw (distorted) pixel coords
    xy_und: torch.Tensor    # [C, F, 2] undistorted pixel coords
    level: torch.Tensor     # [C, F] int32
    angle: torch.Tensor     # [C, F] float32
    response: torch.Tensor  # [C, F]
    desc: torch.Tensor      # [C, F, 8] int32
    valid: torch.Tensor     # [C, F] bool
    depth: torch.Tensor     # [C, F] float32 (<=0 invalid)
    uright: torch.Tensor    # [C, F] float32 virtual right u (-1 invalid)


def sample_depth(depth_img: torch.Tensor, xy: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel depth lookup at (raw) keypoint locations.

    depth_img [..., H, W], xy [..., F, 2], valid [..., F] -> [..., F].
    `torch.round` rounds half to even, as `jnp.round` does.
    """
    h, w = depth_img.shape[-2:]
    x = torch.clamp(torch.round(xy[..., 0]).long(), 0, w - 1)
    y = torch.clamp(torch.round(xy[..., 1]).long(), 0, h - 1)
    flat = depth_img.reshape(depth_img.shape[:-2] + (h * w,))
    d = torch.gather(flat, -1, y * w + x)
    return torch.where(valid, d, torch.zeros_like(d))


@graphs.graphed(static_argnames=("orb_cfg",))
def build_frame(grays: torch.Tensor, depths: torch.Tensor,
                calib: cam_mod.CameraParams,
                orb_cfg: orb.ORBConfig = orb.ORBConfig()) -> FrameData:
    """grays, depths [C, H, W] float32 (depth in meters, <= 0 = none)."""
    feats = orb.extract_orb(grays, orb_cfg)
    xy_und = cam_mod.undistort_pixels(calib.K[:, None, :], calib.dist[:, None, :], feats.xy)
    depth = sample_depth(depths, feats.xy, feats.valid)
    bf = calib.bf.to(grays.device, torch.float32)
    uright = cam_mod.virtual_right_u(bf.reshape(-1, 1) if bf.dim() else bf,
                                     xy_und[..., 0], depth)
    return FrameData(
        xy=feats.xy, xy_und=xy_und, level=feats.level, angle=feats.angle,
        response=feats.response, desc=feats.desc, valid=feats.valid,
        depth=depth, uright=uright,
    )


@graphs.graphed(static_argnames=("orb_cfg",))
def build_frame_stereo(gray_left: torch.Tensor, gray_right: torch.Tensor,
                       calib: cam_mod.CameraParams,
                       orb_cfg: orb.ORBConfig = orb.ORBConfig()) -> FrameData:
    """Stereo frame (the KITTI path): gray_left, gray_right [H, W] float32 ->
    a single-camera FrameData whose depth / uright come from stereo disparity
    (reference Frame.cc:76-146, 782-956).

    Both images are extracted in one `extract_orb` call on a [2, H, W] batch
    (one `fast_score` and one `gather_patches` launch a frame); the reference
    extracts them one after the other.  Then the stereo match, the SAD
    subpixel refinement on the level-0 images and the undistortion of the
    left features.
    """
    feats = orb.extract_orb(torch.stack([gray_left, gray_right]), orb_cfg)
    featsL = orb.Features(*(t[0] for t in feats))
    featsR = orb.Features(*(t[1] for t in feats))
    depth, uright = stereo.stereo_match_depth(featsL, featsR, calib.bf, orb_cfg.scale_factor)
    depth, uright = stereo.subpixel_refine(gray_left, gray_right, featsL.xy[:, 0],
                                           featsL.xy[:, 1], uright, calib.bf)
    xy_und = cam_mod.undistort_pixels(calib.K[0], calib.dist[0], featsL.xy)
    return FrameData(
        xy=featsL.xy[None], xy_und=xy_und[None], level=featsL.level[None],
        angle=featsL.angle[None], response=featsL.response[None],
        desc=featsL.desc[None], valid=featsL.valid[None],
        depth=depth[None], uright=uright[None],
    )
