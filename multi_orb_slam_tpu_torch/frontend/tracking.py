"""Tracking: the per-frame state machine.

Counterpart of `multi_orb_slam_tpu/frontend/tracking.py`:

- RGB-D initialization (first keyframe at identity, points from depth)
- motion-model tracking: project the last frame's points, match, pose BA
- reference-keyframe fallback via brute-force descriptor matching
- local-map tracking: cached covisibility-local points, projection search,
  second pose BA
- keyframe decision + insertion with new close map points

The reference runs one frame as one fused device dispatch whose two
`lax.cond`s (reference-KF fallback, keyframe insertion) stay on the device.
Here both are host `if`s in `track_frame_fused`, each after one scalar
read from the device; everything else stays on the device.  The `Tracker`
keeps the reference's pipelined bookkeeping (status scalars resolved
`pipeline_depth` frames later), so keyframe callbacks and the local-point
cache refresh happen on the same frames as in the reference.

State updates are functional, as in the reference: a stage clones the map
arrays it writes and returns a new `MapState`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig, inv_sigma2_of_level
from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapping import map_state as ms
from ..ops import hamming, search
from ..optim import pose_opt
from . import frame as frame_mod


def _neg1(t: torch.Tensor) -> torch.Tensor:
    return torch.full_like(t, -1)


def _scatter_max_bool(M: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """zeros(M, bool).at[idx].max(val)."""
    out = torch.zeros(M, dtype=torch.int32, device=idx.device)
    out.scatter_reduce_(0, idx.long(), val.to(torch.int32), "amax", include_self=True)
    return out > 0


def unproject_features(fr: frame_mod.FrameData, Tcw: torch.Tensor,
                       calib: cam_mod.CameraParams):
    """World positions [C, F, 3] of all frame features, and which have depth."""
    C = fr.xy.shape[0]
    pw_list, ok_list = [], []
    for c in range(C):
        Twc = se3.inverse(calib.T_rc[c] @ Tcw)
        xc = cam_mod.backproject(calib.K[c], fr.xy_und[c], fr.depth[c])
        pw_list.append(se3.transform_points(Twc, xc))
        ok_list.append(fr.valid[c] & (fr.depth[c] > 0))
    return torch.stack(pw_list), torch.stack(ok_list)


def _pose_obs_from_matches(fr: frame_mod.FrameData, pw: torch.Tensor,
                           matched: torch.Tensor, cfg: SlamConfig) -> pose_opt.PoseObs:
    """Flatten [C, F] matches into a PoseObs batch."""
    C, F = matched.shape
    cam_idx = torch.arange(C, dtype=torch.int32, device=matched.device)[:, None].expand(C, F)
    uvr = torch.cat([fr.xy_und, fr.uright[..., None]], dim=-1)
    return pose_opt.PoseObs(
        pw=pw.reshape(C * F, 3),
        uvr=uvr.reshape(C * F, 3),
        cam_idx=cam_idx.reshape(C * F),
        inv_sigma2=inv_sigma2_of_level(fr.level, cfg).reshape(C * F),
        mask=matched.reshape(C * F),
    )


# ---------------------------------------------------------------------------
# Initialization and keyframe insertion
# ---------------------------------------------------------------------------


def initialize_map(state: ms.MapState, fr: frame_mod.FrameData,
                   calib: cam_mod.CameraParams, cfg: SlamConfig, frame_id: int):
    """First KF at identity + map points from depth in all cameras."""
    Tcw = torch.eye(4, dtype=torch.float32, device=fr.xy.device)
    state, frame_mp = insert_keyframe_impl(
        state, fr, Tcw, _neg1(fr.level), calib, cfg, frame_id, unlimited_new=True)
    return state, Tcw, frame_mp


def insert_keyframe_impl(state: ms.MapState, fr: frame_mod.FrameData,
                         Tcw: torch.Tensor, frame_mp: torch.Tensor,
                         calib: cam_mod.CameraParams, cfg: SlamConfig,
                         frame_id: int, unlimited_new: bool = False):
    """Write the frame as a keyframe; create new close-depth map points
    (nearest first, `new_mp_per_cam` per camera unless `unlimited_new`).

    Returns (new_state, kf_mp [C, F]).
    """
    C, F = fr.valid.shape
    M = cfg.max_mp
    dev = fr.valid.device
    k = torch.argmin(state.kf_valid.to(torch.int32)).reshape(1)  # first free slot
    frame_mp = ms.resolve_mp_ids(state, frame_mp)

    close = (fr.depth > 0) & fr.valid & (frame_mp < 0)
    if not unlimited_new:
        close = close & (fr.depth < cfg.th_depth)
        score = torch.where(close, -fr.depth, torch.full_like(fr.depth, float("-inf")))
        _, sel = hamming.top_k(score, cfg.new_mp_per_cam)       # [C, cap]
        close = torch.zeros_like(close).scatter_(1, sel, torch.gather(close, 1, sel))

    pw_all, _ = unproject_features(fr, Tcw, calib)
    want = close.reshape(-1)
    slots = ms.allocate_mp_slots(state.mp_valid, want)
    created = slots >= 0
    n_failed = (want & ~created).sum(dtype=torch.int32)
    new_mp_grid = torch.where(created, slots, _neg1(slots)).reshape(C, F)
    kf_mp_new = ms.dedupe_obs_rows(torch.where(frame_mp >= 0, frame_mp, new_mp_grid))

    centers = torch.stack([se3.camera_center(calib.T_rc[c] @ Tcw) for c in range(C)])
    cam_of_flat = torch.arange(C, device=dev)[:, None].expand(C, F).reshape(-1)
    pw_flat = pw_all.reshape(-1, 3)
    po = pw_flat - centers[cam_of_flat]
    dist = torch.linalg.norm(po, dim=-1)
    normal = po / torch.clamp(dist[:, None], min=1e-9)
    min_d, max_d = ms.scale_range_from_obs(dist, fr.level.reshape(-1),
                                           cfg.scale_factor, cfg.n_levels)
    tgt = torch.where(created, slots, torch.full_like(slots, M - 1)).long()
    put = created

    def set_rows(arr, val):
        """arr.at[tgt].set(where(put, val, arr[tgt])) on a copy."""
        out = arr.clone()
        old = arr[tgt]
        p = put.reshape((-1,) + (1,) * (old.dim() - 1))
        out.index_put_((tgt,), torch.where(p, val.to(arr.dtype), old))
        return out

    desc_flat = fr.desc.reshape(-1, 8)
    mp_pos = set_rows(state.mp_pos, pw_flat)
    mp_valid = set_rows(state.mp_valid, torch.ones_like(put))
    mp_desc = set_rows(state.mp_desc, desc_flat)
    mp_normal = set_rows(state.mp_normal, normal)
    mp_min = set_rows(state.mp_min_dist, min_d)
    mp_max = set_rows(state.mp_max_dist, max_d)
    mp_first_kf = set_rows(state.mp_first_kf, k.to(torch.int32).expand(tgt.shape))
    mp_first_frame = set_rows(state.mp_first_frame,
                              torch.full(tgt.shape, frame_id, dtype=torch.int32, device=dev))
    ones = torch.ones(tgt.shape, dtype=torch.int32, device=dev)
    mp_descbuf_n = set_rows(state.mp_descbuf_n, ones)
    mp_visible = set_rows(state.mp_visible, ones)
    mp_found = set_rows(state.mp_found, ones)
    mp_descbuf = state.mp_descbuf.clone()
    zero = torch.zeros_like(tgt)
    mp_descbuf.index_put_((tgt, zero), torch.where(
        put[:, None], desc_flat, state.mp_descbuf[tgt, zero]))

    # push observation descriptors of re-observed points into their buffers;
    # a point seen by several cameras takes the last camera's descriptor
    obs_flat = kf_mp_new.reshape(-1)
    has_obs = (obs_flat >= 0) & ~created
    ot = torch.where(has_obs, obs_flat, torch.full_like(obs_flat, M - 1)).long()
    pos = torch.arange(ot.shape[0], device=dev)
    last = torch.full((M,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, ot, torch.where(has_obs, pos, _neg1(pos)), "amax",
                         include_self=True)
    writer = has_obs & (last[ot] == pos)
    slot_in_buf = (mp_descbuf_n[ot] % ms.DESC_BUF).long()
    wt = torch.where(writer, ot, torch.full_like(ot, M - 1))
    ws = torch.where(writer, slot_in_buf, torch.zeros_like(slot_in_buf))
    mp_descbuf.index_put_((wt, ws), torch.where(
        writer[:, None], desc_flat, mp_descbuf[wt, ws]))
    mp_descbuf_n.index_add_(0, ot, has_obs.to(torch.int32))
    mp_desc = torch.where(mp_valid[:, None],
                          ms.update_mp_descriptor(mp_descbuf, mp_descbuf_n), mp_desc)

    def set_kf(arr, val):
        out = arr.clone()
        out.index_put_((k,), val[None].to(arr.dtype))
        return out

    new_state = state._replace(
        kf_Tcw=set_kf(state.kf_Tcw, Tcw),
        kf_valid=set_kf(state.kf_valid, torch.tensor(True, device=dev)),
        kf_frame_id=set_kf(state.kf_frame_id, torch.tensor(frame_id, device=dev)),
        kf_xy_und=set_kf(state.kf_xy_und, fr.xy_und),
        kf_uright=set_kf(state.kf_uright, fr.uright),
        kf_depth=set_kf(state.kf_depth, fr.depth),
        kf_level=set_kf(state.kf_level, fr.level),
        kf_angle=set_kf(state.kf_angle, fr.angle),
        kf_desc=set_kf(state.kf_desc, fr.desc),
        kf_feat_valid=set_kf(state.kf_feat_valid, fr.valid),
        kf_mp=set_kf(state.kf_mp, kf_mp_new),
        mp_pos=mp_pos, mp_valid=mp_valid, mp_desc=mp_desc,
        mp_descbuf=mp_descbuf, mp_descbuf_n=mp_descbuf_n, mp_normal=mp_normal,
        mp_min_dist=mp_min, mp_max_dist=mp_max, mp_first_kf=mp_first_kf,
        mp_first_frame=mp_first_frame, mp_visible=mp_visible, mp_found=mp_found,
        n_kf=state.n_kf + 1,
        n_mp=state.n_mp + created.sum(dtype=torch.int32),
        next_kf_id=state.next_kf_id + 1,
        n_alloc_failed=state.n_alloc_failed + n_failed,
    )
    return new_state, kf_mp_new


# ---------------------------------------------------------------------------
# Per-frame tracking stages
# ---------------------------------------------------------------------------


def track_motion_model(state: ms.MapState, prev: frame_mod.FrameData,
                       prev_Tcw: torch.Tensor, prev_mp: torch.Tensor,
                       velocity: torch.Tensor, cur: frame_mod.FrameData,
                       calib: cam_mod.CameraParams, cfg: SlamConfig):
    """Search the previous frame's points from the velocity-predicted pose,
    then pose-optimize from the previous pose.

    Returns (Tcw, frame_mp, n_matches, n_inliers, n_map_inliers).
    """
    Tcw_pred = velocity @ prev_Tcw
    prev_mp = ms.resolve_mp_ids(state, prev_mp)
    prev_pw, prev_ok = unproject_features(prev, prev_Tcw, calib)
    match_src, match_pw, match_mp = search.search_prev_frame(
        prev_pw, prev_ok, prev.desc, prev.level, prev.angle, prev_mp,
        cur.xy_und, cur.uright, cur.level, cur.angle, cur.desc, cur.valid,
        Tcw_pred, calib.T_rc, calib.K, calib.bf,
        cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels, th_radius=7.0)
    matched = match_src >= 0
    n_matches = matched.sum(dtype=torch.int32)
    obs = _pose_obs_from_matches(cur, match_pw, matched, cfg)
    Tcw, inlier, n_inl = pose_opt.optimize_pose(prev_Tcw, obs, calib.T_rc, calib.K, calib.bf)
    frame_mp = torch.where(matched & inlier.reshape(matched.shape), match_mp, _neg1(match_mp))
    n_map_inl = (frame_mp >= 0).sum(dtype=torch.int32)
    return Tcw, frame_mp, n_matches, n_inl, n_map_inl


def track_reference_kf(state: ms.MapState, ref_kf: torch.Tensor,
                       prev_Tcw: torch.Tensor, cur: frame_mod.FrameData,
                       calib: cam_mod.CameraParams, cfg: SlamConfig):
    """Fallback: match the reference keyframe's map points by brute force.

    Returns (Tcw, frame_mp, n_matches, n_inliers).
    """
    r = ref_kf.long()
    frame_mp = search.match_frame_kf_brute(
        state.kf_desc[r], state.kf_feat_valid[r], state.kf_mp[r], state.kf_angle[r],
        cur.desc, cur.valid, cur.angle, th=hamming.TH_LOW, nn_ratio=0.7)
    matched = frame_mp >= 0
    n_matches = matched.sum(dtype=torch.int32)
    g = frame_mp.clamp(0, cfg.max_mp - 1).long()
    obs = _pose_obs_from_matches(cur, state.mp_pos[g], matched & state.mp_valid[g], cfg)
    Tcw, inlier, n_inl = pose_opt.optimize_pose(prev_Tcw, obs, calib.T_rc, calib.K, calib.bf)
    frame_mp = torch.where(matched & inlier.reshape(matched.shape), frame_mp, _neg1(frame_mp))
    return Tcw, frame_mp, n_matches, n_inl


def build_local_points_cache(state: ms.MapState, anchor_slot, cfg: SlamConfig
                             ) -> search.LocalPoints:
    """Local-map point batch anchored on a keyframe (normally the newest):
    the points of every keyframe sharing observations with the anchor,
    ranked by that keyframe's shared-observation count, as a superset of
    4 x local_cap that `track_local_map` re-ranks per frame."""
    M = cfg.max_mp
    K = state.kf_mp.shape[0]
    dev = state.kf_mp.device
    anchor = torch.as_tensor(anchor_slot, device=dev).long()
    amp = state.kf_mp[anchor].reshape(-1)
    in_anchor = _scatter_max_bool(M, torch.where(amp >= 0, amp, torch.full_like(amp, M - 1)),
                                  amp >= 0)
    kf_obs = state.kf_mp.reshape(K, -1)
    seen = in_anchor[kf_obs.clamp(0, M - 1).long()]
    kf_w = ((kf_obs >= 0) & state.kf_valid[:, None] & seen).to(torch.int32).sum(-1)
    _, local_kfs = hamming.top_k(kf_w, min(80, K))
    local_ok = kf_w[local_kfs] > 0
    lk = torch.where(local_ok, local_kfs, torch.zeros_like(local_kfs))
    obs_of_local = state.kf_mp[lk].reshape(local_ok.shape[0], -1)
    obs_valid = (obs_of_local >= 0) & local_ok[:, None]
    tgt = torch.where(obs_valid, obs_of_local, torch.full_like(obs_of_local, M - 1)).reshape(-1)
    local_mask = _scatter_max_bool(M, tgt, obs_valid.reshape(-1)) & state.mp_valid
    w_row = kf_w[lk].to(torch.float32)
    rel = torch.zeros(M, dtype=torch.float32, device=dev)
    rel.scatter_reduce_(0, tgt.long(), torch.where(
        obs_valid, w_row[:, None], torch.tensor(float("-inf"), device=dev)).reshape(-1),
        "amax", include_self=True)
    cap = min(4 * cfg.local_cap, cfg.max_mp)
    return search.gather_local_points(state, local_mask, cap, priority=rel)


def track_local_map(state: ms.MapState, Tcw: torch.Tensor, cur: frame_mod.FrameData,
                    frame_mp: torch.Tensor, pts: search.LocalPoints,
                    calib: cam_mod.CameraParams, cfg: SlamConfig):
    """Re-validate the cached local points, search them, pose-optimize.

    Returns (state, Tcw, final_mp, n_inliers, n_close_tracked,
    n_close_untracked).
    """
    M = cfg.max_mp
    fmp = frame_mp.reshape(-1)
    in_frame = _scatter_max_bool(M, torch.where(fmp >= 0, fmp, torch.full_like(fmp, M - 1)),
                                 fmp >= 0)
    gi = pts.idx.clamp(0, M - 1).long()
    ok = pts.valid & state.mp_valid[gi] & ~in_frame[gi]
    if pts.idx.shape[0] > cfg.local_cap:
        key = torch.where(ok, pts.rel, torch.full_like(pts.rel, float("-inf")))
        _, sel = hamming.top_k(key, cfg.local_cap)
        ok_s = ok[sel]
        pts = search.LocalPoints(
            idx=torch.where(ok_s, pts.idx[sel], _neg1(pts.idx[sel])),
            pos=state.mp_pos[gi[sel]], desc=pts.desc[sel], normal=pts.normal[sel],
            min_dist=pts.min_dist[sel], max_dist=pts.max_dist[sel], valid=ok_s)
    else:
        pts = pts._replace(valid=ok, pos=state.mp_pos[gi])
    new_mp, visible = search.search_points_in_frame(
        pts, cur.xy_und, cur.uright, cur.level, cur.desc, cur.valid, frame_mp >= 0,
        Tcw, calib.T_rc, calib.K, calib.bf,
        cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels,
        th_radius=4.0, nn_ratio=0.8)
    merged = torch.where(frame_mp >= 0, frame_mp, new_mp)
    matched = merged >= 0
    g = merged.clamp(0, M - 1).long()
    obs = _pose_obs_from_matches(cur, state.mp_pos[g], matched & state.mp_valid[g], cfg)
    Tcw_out, inlier, n_inl = pose_opt.optimize_pose(Tcw, obs, calib.T_rc, calib.K, calib.bf)
    final_mp = torch.where(matched & inlier.reshape(matched.shape), merged, _neg1(merged))

    # visibility / found bookkeeping (IncreaseVisible / IncreaseFound)
    seen = pts.valid & visible
    mp_visible = state.mp_visible.clone()
    mp_visible.index_add_(0, torch.where(seen, pts.idx, torch.full_like(pts.idx, M - 1)).long(),
                          seen.to(torch.int32))
    fm = final_mp.reshape(-1)
    mp_found = state.mp_found.clone()
    mp_found.index_add_(0, torch.where(fm >= 0, fm, torch.full_like(fm, M - 1)).long(),
                        (fm >= 0).to(torch.int32))
    state = state._replace(mp_visible=mp_visible, mp_found=mp_found)

    close = (cur.depth > 0) & (cur.depth < cfg.th_depth) & cur.valid
    n_ct = (close & (final_mp >= 0)).sum(dtype=torch.int32)
    n_cu = (close & (final_mp < 0)).sum(dtype=torch.int32)
    return state, Tcw_out, final_mp, n_inl, n_ct, n_cu


def close_point_thresholds(cfg: SlamConfig, total_feat: int):
    """bNeedToInsertClose thresholds (100 tracked / 70 untracked for the
    reference's 1500 features), scaled to ours when the config says -1."""
    scale = total_feat / 1500.0
    tct = cfg.kf_close_tracked if cfg.kf_close_tracked > 0 else int(round(100 * scale))
    tcu = cfg.kf_close_untracked if cfg.kf_close_untracked > 0 else int(round(70 * scale))
    return tct, tcu


def _newest_kf(state: ms.MapState) -> torch.Tensor:
    fid = torch.where(state.kf_valid, state.kf_frame_id, _neg1(state.kf_frame_id))
    return torch.argmax(fid).to(torch.int32)


def track_frame_fused(state: ms.MapState, prev: frame_mod.FrameData,
                      prev_Tcw: torch.Tensor, prev_mp: torch.Tensor,
                      velocity: torch.Tensor, tstate: torch.Tensor,
                      local_pts: search.LocalPoints, cur: frame_mod.FrameData,
                      calib: cam_mod.CameraParams, cfg: SlamConfig, frame_id: int):
    """One whole tracking frame: motion model, reference-KF fallback,
    local map, NeedNewKeyFrame and keyframe insertion.

    tstate: [3] int32 (last_kf_frame, ref_kf_tracked, only_tracking flag).
    The fallback and the insertion are host `if`s on scalars read back
    from the device (one read each).

    Returns (new_state, Tcw, frame_mp, velocity_new, tstate_new,
    scalars [8] int32: [ok, n_inl, inserted, kf_slot, n_kf,
    n_close_tracked, n_close_untracked, n_matches], ref_slot, ref_pose,
    ref_frame_id).
    """
    dev = prev_Tcw.device
    i32 = torch.int32
    last_kf_frame, ref_kf_tracked = tstate[0], tstate[1]
    only_tracking = tstate[2] > 0

    Tcw2, fmp2, n_match2, n_inl2, n_map_inl1 = track_motion_model(
        state, prev, prev_Tcw, prev_mp, velocity, cur, calib, cfg)
    n_inl1_h, n_map_inl1_h = torch.stack([n_inl2, n_map_inl1]).tolist()
    if n_inl1_h < cfg.min_matches_motion or n_map_inl1_h < 10:
        Tcw2, fmp2, n_match2, n_inl2 = track_reference_kf(
            state, _newest_kf(state), prev_Tcw, cur, calib, cfg)
    pre_ok = n_inl2 >= cfg.min_matches_motion

    state3, Tcw3, fmp3, n_inl3, n_ct, n_cu = track_local_map(
        state, Tcw2, cur, fmp2, local_pts, calib, cfg)
    ok = pre_ok & (n_inl3 >= cfg.min_inliers_track)

    since_kf = frame_id - last_kf_frame
    C, F = cur.desc.shape[0], cur.desc.shape[1]
    tct, tcu = close_point_thresholds(cfg, C * F)
    need_close = (n_ct < tct) & (n_cu > tcu)
    weak_abs = cfg.kf_weak_abs if cfg.kf_weak_abs > 0 else 2 * cfg.min_inliers_track
    weak = (n_inl3 < cfg.kf_ref_ratio * torch.clamp(ref_kf_tracked, min=1).to(torch.float32)
            ) | (n_inl3 < weak_abs)
    capacity = state3.n_kf < cfg.max_kf - 1
    need_kf = (ok & ~only_tracking & capacity & (n_inl3 > 15)
               & ((since_kf >= cfg.max_frames_kf)
                  | ((since_kf >= cfg.min_frames_kf) & (weak | need_close))))
    if bool(need_kf):
        state4, fmp4 = insert_keyframe_impl(state3, cur, Tcw3, fmp3, calib, cfg,
                                            frame_id, unlimited_new=False)
        kf_slot = _newest_kf(state4)
        inserted = torch.tensor(1, dtype=i32, device=dev)
    else:
        state4, fmp4 = state3, fmp3
        kf_slot = torch.tensor(-1, dtype=i32, device=dev)
        inserted = torch.tensor(0, dtype=i32, device=dev)

    Tcw_out = torch.where(ok, Tcw3, prev_Tcw)
    vel_out = torch.where(ok, Tcw3 @ se3.inverse(prev_Tcw),
                          torch.eye(4, dtype=Tcw3.dtype, device=dev))
    fid = torch.tensor(frame_id, dtype=i32, device=dev)
    tstate_new = torch.stack([
        torch.where(inserted > 0, fid, last_kf_frame),
        torch.where(inserted > 0, n_inl3, ref_kf_tracked),
        tstate[2],
    ])
    scalars = torch.stack([ok.to(i32), n_inl3, inserted, kf_slot,
                           state4.n_kf, n_ct, n_cu, n_match2]).to(i32)
    ref_slot_out = _newest_kf(state4)
    ref_pose_out = state4.kf_Tcw[ref_slot_out.long()]
    ref_fid_out = state4.kf_frame_id[ref_slot_out.long()]
    return (state4, Tcw_out, fmp4, vel_out, tstate_new, scalars,
            ref_slot_out, ref_pose_out, ref_fid_out)


class TrackState:
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class Tracker:
    """Host orchestration of the tracking stages.

    With `pipelined=True` each OK frame runs `track_frame_fused` and its
    status scalars are resolved `pipeline_depth` frames later, exactly as in
    the reference; `fuse_extraction` keeps the reference's ordering of
    extraction and resolution (resolve first, then extract) -- in eager
    PyTorch extraction and tracking are the same launches either way.
    """

    def __init__(self, calib: cam_mod.CameraParams, cfg: SlamConfig,
                 pipelined: bool = False, pipeline_depth: int = 1,
                 fuse_extraction: bool = False, device=None):
        self.device = torch.device(device) if device is not None else calib.K.device
        self.calib = calib
        self.cfg = cfg
        self.kf_inserted_cb = None
        self.reloc_cb = None   # fn(FrameData) -> (ok, Tcw, frame_mp, n_inl)
        self.reloc_ready_fn = lambda: True
        self.only_tracking = False
        self.pipelined = pipelined
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.fuse_extraction = fuse_extraction
        self.reset()

    def reset(self):
        """Clear the map and all per-frame state."""
        cfg, dev = self.cfg, self.device
        self.map = ms.make_empty(cfg.max_kf, cfg.n_cams, cfg.max_feat, cfg.max_mp, dev)
        self.state = TrackState.NOT_INITIALIZED
        self.Tcw = torch.eye(4, dtype=torch.float32, device=dev)
        self.velocity = torch.eye(4, dtype=torch.float32, device=dev)
        self.prev_frame = None
        self.prev_mp = None
        self.prev_Tcw = None
        self.frame_id = 0
        self.last_kf_frame = -999
        self.last_kf_slot = 0
        self.ref_kf_tracked = 0
        self._pending = []
        self._tstate_dev = None
        self._tstate_dirty = True
        self._local_pts = None
        self.last_n_inliers = 0
        # (frame_id, timestamp, ref_kf_slot, (Tcw, ref_pose, ref_fid), lost)
        self.trajectory = []

    def invalidate_local_cache(self):
        """Drop the per-KF local point batch; rebuilt lazily next frame."""
        self._local_pts = None

    def _ensure_local_pts(self):
        if self._local_pts is None:
            self._local_pts = build_local_points_cache(self.map, self.last_kf_slot, self.cfg)
        return self._local_pts

    def process(self, grays, depths, timestamp: float | None = None):
        """Track one rig frame: grays, depths [C, H, W] (numpy or tensors)."""
        grays = torch.as_tensor(grays, dtype=torch.float32, device=self.device)
        depths = torch.as_tensor(depths, dtype=torch.float32, device=self.device)
        if (self.pipelined and self.fuse_extraction
                and self.state == TrackState.OK):
            self._drain_pending(keep=self.pipeline_depth - 1)
        fr = frame_mod.build_frame(grays, depths, self.calib, self.cfg.orb)
        return self.process_frame(fr, timestamp)

    def _push_pending(self, scalars):
        self._pending.append({
            "scalars": scalars,
            "frame_id": self.frame_id,
            "traj_idx": len(self.trajectory) - 1,
        })

    def _resolve_pending(self):
        self._drain_pending(keep=0)

    def _drain_pending(self, keep: int = 0):
        while len(self._pending) > keep:
            self._resolve_oldest()

    def _resolve_oldest(self):
        if not self._pending:
            return
        pending = self._pending.pop(0)
        ok, n_inl, inserted, kf_slot, _n_kf, _nct, _ncu, _nm = pending["scalars"].tolist()
        fid = pending["frame_id"]
        traj_idx = pending["traj_idx"]
        self.last_n_inliers = n_inl
        if not ok:
            self.state = TrackState.LOST
            e = self.trajectory[traj_idx]
            self.trajectory[traj_idx] = e[:4] + (True,)
        if inserted:
            self.last_kf_frame = fid
            self.last_kf_slot = kf_slot
            # weak-tracking reference count: inliers at insertion
            self.ref_kf_tracked = n_inl
            if self.kf_inserted_cb is not None:
                new_map = self.kf_inserted_cb(kf_slot)
                if new_map is not None:
                    self.map = new_map
            self.invalidate_local_cache()

    def _process_ok_fused(self, fr: frame_mod.FrameData):
        if self._tstate_dirty or self._tstate_dev is None:
            self._tstate_dev = torch.tensor(
                [self.last_kf_frame, self.ref_kf_tracked, 0], dtype=torch.int32,
                device=self.device)
            self._tstate_dirty = False
        tstate = self._tstate_dev.clone()
        tstate[2] = 1 if self.only_tracking else 0
        (self.map, self.Tcw, frame_mp, self.velocity, self._tstate_dev, scalars,
         ref_slot, ref_pose, ref_fid) = track_frame_fused(
            self.map, self.prev_frame, self.prev_Tcw, self.prev_mp, self.velocity,
            tstate, self._ensure_local_pts(), fr, self.calib, self.cfg, self.frame_id)
        self.prev_frame, self.prev_mp, self.prev_Tcw = fr, frame_mp, self.Tcw
        self._record(ref_slot, ref_pose, ref_fid)
        self._push_pending(scalars)
        self.frame_id += 1
        return self.state

    def process_frame(self, fr: frame_mod.FrameData, timestamp: float | None = None):
        cfg = self.cfg
        if self.pipelined and self.state == TrackState.OK:
            self._drain_pending(keep=self.pipeline_depth - 1)
        if self.state != TrackState.OK:
            self._resolve_pending()
        self._ts = timestamp if timestamp is not None else self.frame_id / 30.0
        if self.state == TrackState.NOT_INITIALIZED:
            n_depth = int(((fr.depth > 0) & fr.valid).sum())
            if n_depth >= min(500, cfg.orb.n_features // 2):
                self.map, self.Tcw, frame_mp = initialize_map(
                    self.map, fr, self.calib, cfg, self.frame_id)
                self.state = TrackState.OK
                self.prev_frame, self.prev_mp = fr, frame_mp
                self.prev_Tcw = self.Tcw
                self.last_kf_frame = self.frame_id
                self.last_kf_slot = 0
                self.ref_kf_tracked = int((frame_mp >= 0).sum())
                self._tstate_dirty = True
            self._record()
            self.frame_id += 1
            return self.state

        if self.state == TrackState.LOST:
            relocalized = False
            if self.reloc_cb is not None:
                ok, Tcw, frame_mp, n = self.reloc_cb(fr)
                if ok:
                    relocalized = True
                    self.state = TrackState.OK
                    self.Tcw = Tcw
                    self.velocity = torch.eye(4, dtype=torch.float32, device=self.device)
                    self.prev_frame, self.prev_mp = fr, frame_mp
                    self.prev_Tcw = Tcw
                    self.last_n_inliers = n
            if not relocalized:
                can_reloc = self.reloc_cb is not None and self.reloc_ready_fn()
                if int(self.map.n_kf) <= 5 and not self.only_tracking and not can_reloc:
                    self.reset()
                    return self.process_frame(fr, timestamp)
            self._record()
            self.frame_id += 1
            return self.state

        if self.pipelined:
            return self._process_ok_fused(fr)

        # --- motion-model tracking (or ref-KF fallback) ---
        Tcw, frame_mp, n_match, n_inl, n_map_inl = track_motion_model(
            self.map, self.prev_frame, self.prev_Tcw, self.prev_mp,
            self.velocity, fr, self.calib, cfg)
        n_inl, n_map_inl = torch.stack([n_inl, n_map_inl]).tolist()
        if n_inl < cfg.min_matches_motion or n_map_inl < 10:
            Tcw, frame_mp, n_match, n_inl = track_reference_kf(
                self.map, torch.tensor(self.last_kf_slot, device=self.device),
                self.prev_Tcw, fr, self.calib, cfg)
            n_inl = int(n_inl)
        if n_inl < cfg.min_matches_motion:
            self.state = TrackState.LOST
            self._record()
            self.frame_id += 1
            return self.state

        # --- local map tracking ---
        (self.map, Tcw, frame_mp, n_inl, n_close_tracked,
         n_close_untracked) = track_local_map(
            self.map, Tcw, fr, frame_mp, self._ensure_local_pts(), self.calib, cfg)
        n_inl, n_close_tracked, n_close_untracked = torch.stack(
            [n_inl, n_close_tracked, n_close_untracked]).tolist()
        if n_inl < cfg.min_inliers_track:
            self.state = TrackState.LOST
            self._record()
            self.frame_id += 1
            return self.state

        self.state = TrackState.OK
        self.velocity = Tcw @ se3.inverse(self.prev_Tcw)
        self.Tcw = Tcw
        self.last_n_inliers = n_inl

        # --- keyframe decision (NeedNewKeyFrame) ---
        since_kf = self.frame_id - self.last_kf_frame
        tct, tcu = close_point_thresholds(cfg, cfg.n_cams * fr.desc.shape[1])
        need_close = n_close_tracked < tct and n_close_untracked > tcu
        weak_abs = cfg.kf_weak_abs if cfg.kf_weak_abs > 0 else 2 * cfg.min_inliers_track
        weak_tracking = (n_inl < cfg.kf_ref_ratio * max(self.ref_kf_tracked, 1)
                         or n_inl < weak_abs)
        need_kf = (not self.only_tracking and n_inl > 15
                   and (since_kf >= cfg.max_frames_kf
                        or (since_kf >= cfg.min_frames_kf
                            and (weak_tracking or need_close))))
        if need_kf and int(self.map.n_kf) < cfg.max_kf - 1:
            self.map, kf_mp = insert_keyframe_impl(
                self.map, fr, Tcw, frame_mp, self.calib, cfg, self.frame_id)
            self.last_kf_frame = self.frame_id
            self.last_kf_slot = int(_newest_kf(self.map))
            self._tstate_dirty = True
            frame_mp = kf_mp
            self.ref_kf_tracked = n_inl
            if self.kf_inserted_cb is not None:
                new_map = self.kf_inserted_cb(self.last_kf_slot)
                if new_map is not None:
                    self.map = new_map
            self.invalidate_local_cache()

        self.prev_frame, self.prev_mp, self.prev_Tcw = fr, frame_mp, Tcw
        self._record()
        self.frame_id += 1
        return self.state

    def _record(self, ref_slot=None, ref_pose=None, ref_fid=None):
        if ref_pose is None:
            ref_slot = self.last_kf_slot
            ref_pose = self.map.kf_Tcw[self.last_kf_slot]
            ref_fid = self.map.kf_frame_id[self.last_kf_slot]
        self.trajectory.append((
            self.frame_id, self._ts, ref_slot,
            (self.Tcw, ref_pose, ref_fid),
            self.state != TrackState.OK,
        ))

    def absolute_trajectory(self):
        """(frame_id, timestamp, Tcw [4, 4] numpy, lost) per frame, with
        keyframe-pose corrections applied through the stored relative poses;
        a frame whose reference keyframe slot was recycled keeps its
        recorded absolute pose."""
        self._resolve_pending()
        kf_Tcw = self.map.kf_Tcw.cpu().numpy()
        kf_fid = self.map.kf_frame_id.cpu().numpy()
        kf_valid = self.map.kf_valid.cpu().numpy()
        out = []
        for fid, ts, ref, rec, lost in self.trajectory:
            Tcw_rec = rec[0].cpu().numpy()
            ref_pose_rec = rec[1].cpu().numpy()
            r = int(ref)
            fresh = bool(kf_valid[r]) and int(kf_fid[r]) == int(rec[2])
            if fresh:
                Tcr = Tcw_rec @ np.linalg.inv(ref_pose_rec)
                out.append((fid, ts, Tcr @ kf_Tcw[r], lost))
            else:
                out.append((fid, ts, Tcw_rec, lost))
        return out
