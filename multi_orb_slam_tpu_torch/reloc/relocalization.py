"""Relocalization: recover tracking after loss.

Counterpart of `multi_orb_slam_tpu/reloc/relocalization.py` (which replaces
`Tracking::Relocalization`, src/Tracking.cc:1967-2158): camera-0 BoW
candidates from the keyframe database, brute-force descriptor matching
against each candidate's map points, PnP RANSAC for a prior-free pose,
motion-only BA refinement, and a projection-search top-up when inliers are
thin (the reference's 50-inlier acceptance).

The brute-force match goes through the `window_match` kernel with every
gate open (an infinite radius, an open level range, no stereo gate), as
`search.match_frame_kf_brute` does: its distances and first-minimum index
are those of a dense Hamming matrix with `masked_argmin2`, in one launch.
The top-up search is a second launch.  Each candidate costs up to four host
reads (matches, PnP inliers, the two pose-BA inlier counts): the control
flow is decided on the host, as in the reference.  `STATS` counts them.

Between those reads a candidate is a short chain of `graphs.graphed`
functions, each one CUDA graph replay a call on the card, with the
candidate's slot traced (every candidate replays the same entries):
`match_stage` (the dense match, its ratio count and the 2D-3D
correspondences), the draw of the minimal sets (eager, on the candidate's
generator) and `pnp.pnp_solve`, `pose_ba_inputs` and `pose_opt.optimize_pose`,
`top_up_stage` (the projection search and the second BA's observations) and
`optimize_pose` again.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig, inv_sigma2_of_level
from ..frontend import frame as frame_mod
from ..geometry import camera as cam_mod
from ..mapping import map_state as ms
from ..ops import hamming, kernels, search
from ..optim import pose_opt
from ..placerec import database as db_mod, vocabulary as vocab_mod
from ..utils import graphs, metrics
from . import pnp

MIN_BOW_MATCHES = 15     # Tracking.cc:2030
MIN_ACCEPT_INLIERS = 50  # Tracking.cc:2144

# calls, candidates tried, host reads (one per scored query, up to four per
# candidate) and successes since import
STATS = {"calls": 0, "candidates": 0, "host_reads": 0, "found": 0}


def _read(x: torch.Tensor) -> int:
    STATS["host_reads"] += 1
    return int(metrics.host("reloc_read", x))


def _stage(name: str, device):
    """The tracer's span of one stage, `reloc/<name>`, with device events.
    Every stage but the top-up search ends in its host read, so a span's
    host time is the stage's wall time."""
    return metrics.span(f"reloc/{name}", device)


def match_kf_cam0(kf_desc: torch.Tensor, kf_has_mp: torch.Tensor,
                  frame_desc: torch.Tensor, frame_valid: torch.Tensor):
    """Best and second-best frame feature per keyframe feature of camera 0,
    over every valid frame feature: (best_idx, best_d, second_d), each [Fk];
    distance 2^20 where there is no candidate."""
    Fk, F = kf_desc.shape[0], frame_desc.shape[0]
    dev = kf_desc.device
    rad = torch.where(kf_has_mp, float("inf"), -1.0).to(torch.float32)
    bi, bd, b2, _ = kernels.window_match(
        torch.zeros((1, Fk, 2), dtype=torch.float32, device=dev),
        rad[None].contiguous(),
        torch.full((1, Fk), -1, dtype=torch.int32, device=dev),
        torch.full((1, Fk), 1 << 30, dtype=torch.int32, device=dev),
        torch.full((1, Fk), -1e9, dtype=torch.float32, device=dev),
        kf_desc[None].contiguous(),
        torch.zeros((1, F, 2), dtype=torch.float32, device=dev),
        torch.full((1, F), -1.0, dtype=torch.float32, device=dev),
        torch.zeros((1, F), dtype=torch.int32, device=dev),
        frame_valid[None].contiguous(), frame_desc[None].contiguous())
    return bi[0], bd[0], b2[0]


@graphs.graphed()
def match_stage(kf_desc: torch.Tensor, kf_mp: torch.Tensor, kf_feat_valid: torch.Tensor,
                mp_valid: torch.Tensor, mp_pos: torch.Tensor, frame_desc0: torch.Tensor,
                frame_valid0: torch.Tensor, kf):
    """Camera-0 matching of the frame against keyframe `kf`'s map-point
    features (Lowe's ratio 0.75 at TH_LOW) and the 2D-3D correspondences on
    the frame's features: (n_matches, mp_of_feat [F] int32, matched [F],
    Xw [F, 3]).  `kf` is a slot (an int, traced on the card)."""
    M, F = mp_pos.shape[0], frame_valid0.shape[0]
    r = ms.slot_index(kf, kf_mp.device)
    kf_mp0 = kf_mp.index_select(0, r)[0, 0]
    has = (kf_mp0 >= 0) & kf_feat_valid.index_select(0, r)[0, 0]
    bi, bd, b2 = match_kf_cam0(kf_desc.index_select(0, r)[0, 0], has, frame_desc0, frame_valid0)
    ok = (bd <= hamming.TH_LOW) & (bd.to(torch.float32) <= 0.75 * b2.to(torch.float32))
    feat_q = search.resolve_feature_conflicts(bi, bd, ok, F)
    mp_of_feat = torch.where(feat_q >= 0, kf_mp0[feat_q.clamp(0, F - 1).long()], -1)
    g = mp_of_feat.clamp(0, M - 1).long()
    return ok.sum(), mp_of_feat, (mp_of_feat >= 0) & mp_valid[g], mp_pos[g]


def _pose_obs(frame_mp: torch.Tensor, mp_pos: torch.Tensor, fr: frame_mod.FrameData,
              cfg: SlamConfig) -> pose_opt.PoseObs:
    """Motion-only BA's observations of the frame's features that
    `frame_mp` [C, F] ties to map points."""
    C, F = frame_mp.shape
    pw = mp_pos[frame_mp.clamp(0, cfg.max_mp - 1).long()]
    cam_idx = torch.arange(C, dtype=torch.int32, device=frame_mp.device)[:, None].expand(C, F)
    uvr = torch.cat([fr.xy_und, fr.uright[..., None]], dim=-1)
    return pose_opt.PoseObs(
        pw=pw.reshape(C * F, 3), uvr=uvr.reshape(C * F, 3), cam_idx=cam_idx.reshape(C * F),
        inv_sigma2=inv_sigma2_of_level(fr.level, cfg).reshape(C * F),
        mask=(frame_mp >= 0).reshape(C * F))


@graphs.graphed(static_argnames=("cfg",))
def pose_ba_inputs(matched: torch.Tensor, inl: torch.Tensor, mp_of_feat: torch.Tensor,
                   mp_pos: torch.Tensor, fr: frame_mod.FrameData, cfg: SlamConfig):
    """The first pose BA's (frame_mp [C, F], PoseObs): camera 0's PnP
    inliers, the other cameras empty."""
    C, F = fr.valid.shape
    row0 = torch.where(matched & inl, mp_of_feat, -1)
    frame_mp = torch.cat([row0[None], torch.full((C - 1, F), -1, dtype=row0.dtype,
                                                 device=row0.device)])
    return frame_mp, _pose_obs(frame_mp, mp_pos, fr, cfg)


@graphs.graphed(static_argnames=("cfg",))
def top_up_stage(state: ms.MapState, kf, frame_mp: torch.Tensor, inlier: torch.Tensor,
                 Tcw: torch.Tensor, fr: frame_mod.FrameData, calib: cam_mod.CameraParams,
                 cfg: SlamConfig):
    """The projection-search top-up around the recovered pose
    (Tracking.cc:2090-2130: SearchByProjection with th=10) over keyframe
    `kf`'s points, and the second pose BA's (merged [C, F], PoseObs)."""
    M = cfg.max_mp
    C, F = frame_mp.shape
    frame_mp = torch.where(inlier.reshape(C, F), frame_mp, -1)
    own = state.kf_mp.index_select(0, ms.slot_index(kf, frame_mp.device))[0].reshape(-1)
    local_mask = ms.scatter_max_bool(M, torch.where(own >= 0, own, M - 1), own >= 0)
    local_mask = local_mask & state.mp_valid
    pts = search.gather_local_points(state, local_mask, cfg.local_cap)
    add_mp, _ = search.search_points_in_frame(
        pts, fr.xy_und, fr.uright, fr.level, fr.desc, fr.valid,
        frame_mp >= 0, Tcw, calib.T_rc, calib.K, calib.bf,
        cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels,
        th_radius=10.0, nn_ratio=1.0, use_view_cos=False,
    )
    merged = torch.where(frame_mp >= 0, frame_mp, add_mp)
    return merged, _pose_obs(merged, state.mp_pos, fr, cfg)


def relocalize(
    state: ms.MapState,
    fr: frame_mod.FrameData,
    voc: vocab_mod.Vocabulary,
    db: db_mod.KeyFrameDB,
    calib: cam_mod.CameraParams,
    cfg: SlamConfig,
):
    """Try to relocalize the frame. Returns (ok, Tcw, frame_mp, n_inliers)."""
    dev = fr.valid.device
    STATS["calls"] += 1
    with _stage("candidates", dev):
        candidates = db_mod.detect_relocalization_candidates(
            db, voc, state, fr.desc[0], fr.valid[0])
        STATS["host_reads"] += 1
    for kf in candidates:
        STATS["candidates"] += 1
        # camera-0 matching against the candidate's map-point features
        with _stage("dense_match", dev):
            n_matches, mp_of_feat, matched, Xw = match_stage(
                state.kf_desc, state.kf_mp, state.kf_feat_valid, state.mp_valid, state.mp_pos,
                fr.desc[0], fr.valid[0], int(kf))
            n_matches = _read(n_matches)
        if n_matches < MIN_BOW_MATCHES:
            continue
        with _stage("pnp", dev):
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(kf))
            Tcw0, inl, n_inl = pnp.pnp_ransac(gen, fr.xy_und[0], Xw, matched, calib.K[0])
            n_inl = _read(n_inl)
        if n_inl < 10:
            continue
        # motion-only BA on the PnP inliers
        with _stage("pose_ba_1", dev):
            frame_mp, obs = pose_ba_inputs(matched, inl, mp_of_feat, state.mp_pos, fr, cfg)
            Tcw, inlier, n = pose_opt.optimize_pose(Tcw0, obs, calib.T_rc, calib.K, calib.bf)
            n = _read(n)
        if n < 10:
            continue
        with _stage("top_up_search", dev):
            merged, obs = top_up_stage(state, int(kf), frame_mp, inlier, Tcw, fr, calib, cfg)
        with _stage("pose_ba_2", dev):
            Tcw, inlier, n = pose_opt.optimize_pose(Tcw, obs, calib.T_rc, calib.K, calib.bf)
            n = _read(n)
        if n >= MIN_ACCEPT_INLIERS:
            C, F = merged.shape
            frame_mp = torch.where(inlier.reshape(C, F), merged, -1)
            STATS["found"] += 1
            return True, Tcw, frame_mp, n
    return False, None, None, 0
