"""Static SLAM configuration shared across stages.

Counterpart of `multi_orb_slam_tpu/config.py`: the same fields and defaults,
so one configuration drives both packages.  Capacities (max_kf, max_mp,
max_feat) are the fixed-shape substitute for a dynamically growing pointer
graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .ops import orb
from .ops.orb import ORBConfig  # noqa: F401  (re-exported)


class SlamConfig(NamedTuple):
    """Static configuration (hashable, immutable)."""

    n_cams: int = 1
    max_feat: int = 1024
    max_kf: int = 192
    max_mp: int = 24576
    local_cap: int = 2048       # local-point batch for per-frame search
    ba_local_cap: int = 2048    # marginalized-point capacity in local BA.
                                # Sized to the measured local-window point
                                # count of the flagship dual-cam config
                                # (12-KF windows hold ~1-2k points; the
                                # whole bench map peaks ~2.5k) — every
                                # [LC, P, ...] solver intermediate scales
                                # linearly with it.  Dense outdoor scenes
                                # (KITTI stereo) should raise it.
    ba_free_kfs: int = 12       # local-BA window: optimized keyframes.  The
                                # reference frees the FULL covisible set
                                # (Optimizer.cc:936-1014, unbounded); a
                                # fixed-shape window is the XLA tradeoff —
                                # size it to the expected covisible-set size
                                # of the deployment (12 covers the measured
                                # sets of the benchmark sequences)
    ba_fixed_kfs: int = 12      # local-BA window: fixed observer keyframes
    ba_adaptive: bool = True    # size the local-BA window to the covisible
                                # set per keyframe (reference semantics:
                                # the FULL covisible neighborhood is freed,
                                # Optimizer.cc:936-1014) by bucketing
                                # (n_free, n_fixed) over compiled variants
                                # (12/16/24/32); costs one host sync per KF
                                # insertion — the mapping dispatch is
                                # already async from the tracker, so the
                                # sync is off the frame path
    new_mp_per_cam: int = 192   # close points created per camera per KF
    width: int = 640
    height: int = 480
    scale_factor: float = 1.2
    n_levels: int = 8
    th_depth: float = 3.1       # close/far split in meters (bf*ThDepth/fx)
    min_frames_kf: int = 3      # The reference's value is 0
                                # (Tracking.cc:102-108) but its effective
                                # cadence is throttled by the mapping-idle
                                # condition (Tracking.cc:1488-1508: a
                                # need-driven KF is deferred or dropped
                                # while LocalMapping is busy).  Our mapping
                                # stage occupies the device ~3-4 frame
                                # times, so a 3-frame floor is the
                                # deterministic equivalent; without it a
                                # chronically-firing bNeedToInsertClose
                                # inserts (and promptly culls) a keyframe
                                # every 1-2 frames.
    kf_close_tracked: int = -1  # bNeedToInsertClose thresholds
    kf_close_untracked: int = -1  # (Tracking.cc:1464-1477: <100 tracked
                                # close & >70 untracked close).  The
                                # reference values assume its 1000+500
                                # feature budget; -1 auto-scales them by
                                # total features / 1500.
    max_frames_kf: int = 30     # reference: fps
    min_inliers_track: int = 30 # TrackLocalMap accept gate (Tracking.cc:1396)
    kf_weak_abs: int = -1       # absolute weak-tracking KF trigger: insert
                                # (after min_frames_kf) once inliers fall
                                # below this, regardless of the reference-KF
                                # ratio.  -1 = 2*min_inliers_track.  Guards a
                                # failure mode the reference cannot hit: its
                                # weak-ratio base is the ref KF's map-derived
                                # TrackedMapPoints (hundreds), ours is
                                # inliers-at-insertion — after one weak
                                # insertion (e.g. 46 inliers) the ratio
                                # trigger (0.6*46=28) lands BELOW the LOST
                                # gate (30) and tracking dies before any
                                # keyframe can fire (observed on the
                                # outward-facing circuit at wall closest
                                # approach).
    min_matches_motion: int = 20
    kf_ref_ratio: float = 0.60  # NeedNewKeyFrame weak-tracking ratio.  The
                                # reference compares current inliers to the
                                # reference KF's TrackedMapPoints with a
                                # 0.75 ratio (Tracking.cc:1474) — BOTH
                                # measured post-redetection.  Our reference
                                # quantity is inliers-at-insertion (see
                                # tracking.py), which exceeds the
                                # reference's by the per-cell top-K
                                # redetection overlap (~0.78: a 1-frame-old
                                # KF refinds ~78% of its points), so the
                                # faithful effective ratio is
                                # 0.75 * 0.78 ~= 0.6.  At 0.75 against the
                                # inflated base the cadence nearly doubles
                                # (13 KFs / 52 bench frames vs the
                                # reference's ~1 per 10-15).
    tri_rotation_check: bool = False
                                # rotation-histogram consistency on the
                                # triangulation epipolar search, as the
                                # reference applies in SearchForTriangulation
                                # (src/ORBmatcher.cc:1380-1388,1540-1565).
                                # Default OFF: our triangulation match is
                                # already mutual-best + epipolar + two-view
                                # chi2 gated, and the measured false-match
                                # rate without the histogram is at reference
                                # level while the histogram's true-match
                                # thinning measurably degrades map density
                                # (reloc recovery 0.23 m vs 0.20 bound on the
                                # blackout test) — see
                                # tools/measure_triangulation_matches.py.
    orb: orb.ORBConfig = orb.ORBConfig()


def inv_sigma2_of_level(level: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    return 1.0 / torch.pow(cfg.scale_factor, 2.0 * level.to(torch.float32))
