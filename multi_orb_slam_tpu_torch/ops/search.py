"""Data-association searches: projection searches and keyframe matching.

Counterpart of `multi_orb_slam_tpu/ops/search.py`.  The gated best/second
Hamming inner loop of all three searches runs through the `window_match`
kernel (`ops/kernels.py`), one launch per search for every rig camera.
Per-query validity is folded into the query radius (a negative radius
admits no feature) and already-taken features into the feature mask, so
the kernel sees the searches' exact candidate sets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import camera as cam_mod
from ..geometry import se3
from ..mapping import map_state as ms
from . import hamming, kernels

BIG = hamming.BIG
_NO_QUERY_RADIUS = -1.0   # |du| < -1 is never true: the query has no candidate
_UR_FLOOR = -1e8          # ur below this disables the kernel's stereo gate


class LocalPoints(NamedTuple):
    """Compacted local map points gathered for a frame search (capacity L)."""

    idx: torch.Tensor       # [L] map-point slot ids (-1 pad)
    pos: torch.Tensor       # [L, 3]
    desc: torch.Tensor      # [L, 8]
    normal: torch.Tensor    # [L, 3]
    min_dist: torch.Tensor  # [L]
    max_dist: torch.Tensor  # [L]
    valid: torch.Tensor     # [L] bool
    rel: torch.Tensor | None = None  # [L] relevance (higher first; -inf pad)


def gather_local_points(state: ms.MapState, mask: torch.Tensor, cap: int,
                        priority: torch.Tensor | None = None) -> LocalPoints:
    """Compact up to `cap` masked map points into a dense batch, ranked by
    `priority` (higher first) or else by slot order."""
    dev = mask.device
    if priority is not None:
        key = torch.where(mask, priority.to(torch.float32),
                          torch.full_like(priority, float("-inf"), dtype=torch.float32))
        kv, order = hamming.top_k(key, cap)
        sel_valid = mask[order]
        idx = torch.where(sel_valid, order, torch.full_like(order, -1))
        rel = torch.where(sel_valid, kv, torch.full_like(kv, float("-inf")))
    else:
        score = mask.to(torch.int32)
        _, order = hamming.top_k(
            score * (1 << 20) - torch.arange(score.shape[0], dtype=torch.int32, device=dev), cap)
        sel_valid = mask[order]
        idx = torch.where(sel_valid, order, torch.full_like(order, -1))
        rel = torch.where(sel_valid, -torch.arange(cap, dtype=torch.float32, device=dev),
                          torch.full((cap,), float("-inf"), device=dev))
    g = order.clamp(min=0)
    return LocalPoints(
        idx=idx.to(torch.int32), pos=state.mp_pos[g], desc=state.mp_desc[g],
        normal=state.mp_normal[g], min_dist=state.mp_min_dist[g],
        max_dist=state.mp_max_dist[g], valid=sel_valid, rel=rel,
    )


def resolve_feature_conflicts(best_feat: torch.Tensor, best_dist: torch.Tensor,
                              q_ok: torch.Tensor, n_feat: int) -> torch.Tensor:
    """Per-feature winner among the queries that chose it: the lowest
    distance, then the lowest query index.  Returns feat_q [n_feat] int32
    (winning query index or -1)."""
    dev = best_feat.device
    best_feat = best_feat.to(torch.int32)
    sf_all = torch.where(q_ok, best_feat, torch.full_like(best_feat, n_feat))
    key = sf_all * 512 + torch.clamp(best_dist.to(torch.int32), 0, 511)
    order = torch.sort(key, stable=True)[1]
    sf = sf_all[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), sf[1:] != sf[:-1]])
    win = first & (sf < n_feat)
    feat_q = torch.full((n_feat,), -1, dtype=torch.int32, device=dev)
    tgt = torch.where(win, sf, torch.full_like(sf, n_feat - 1)).long()
    src = torch.where(win, order.to(torch.int32), torch.full_like(sf, -1))
    feat_q.scatter_reduce_(0, tgt, src, "amax", include_self=True)
    return feat_q


def _frame_window_args(frame_xy_und, frame_uright, frame_level, frame_valid):
    return (frame_xy_und.contiguous(), frame_uright.contiguous(),
            frame_level.to(torch.int32).contiguous(), frame_valid.contiguous())


def search_points_in_frame(
    pts: LocalPoints,
    frame_xy_und: torch.Tensor,    # [C, F, 2]
    frame_uright: torch.Tensor,    # [C, F]
    frame_level: torch.Tensor,     # [C, F]
    frame_desc: torch.Tensor,      # [C, F, 8]
    frame_valid: torch.Tensor,     # [C, F]
    frame_taken: torch.Tensor,     # [C, F] bool: slots already matched
    Tcw: torch.Tensor,             # [4, 4] rig pose
    T_rc: torch.Tensor,            # [C, 4, 4]
    K: torch.Tensor,               # [C, 4]
    bf: torch.Tensor,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th_radius: float = 4.0,
    nn_ratio: float = 0.9,
    th_hamming: int = hamming.TH_HIGH,
    level_slack: int = 1,
    use_view_cos: bool = True,
):
    """Project map points into all rig cameras and match to frame features
    (SearchByProjection(Frame&, MapPoints) / SearchLocalPoints).

    Returns (match_mp [C, F] map-point slot per frame feature or -1,
    visible [L] frustum-visible mask).
    """
    C, F = frame_valid.shape
    dev = frame_valid.device
    sf = torch.tensor([scale_factor ** lvl for lvl in range(n_levels)],
                      dtype=torch.float32, device=dev)
    uvs, rads, lvls, urs, masks = [], [], [], [], []
    for c in range(C):
        Tcam = T_rc[c] @ Tcw
        mask, uv, invz, dist, view_cos = cam_mod.frustum_check(
            K[c], Tcam, pts.pos, width, height,
            0.8 * pts.min_dist, 1.2 * pts.max_dist, pts.normal,
            view_cos_limit=0.5 if use_view_cos else -2.0,
        )
        mask = mask & pts.valid
        lvl = ms.predict_scale(dist, pts.max_dist, scale_factor, n_levels)
        r_view = torch.where(view_cos > 0.998, 2.5, 4.0)
        radius = th_radius / 4.0 * r_view * sf[lvl.long()]
        uvs.append(uv)
        rads.append(torch.where(mask, radius, torch.full_like(radius, _NO_QUERY_RADIUS)))
        lvls.append(lvl)
        urs.append(torch.clamp(uv[:, 0] - bf * invz, min=_UR_FLOOR))
        masks.append(mask)
    lvl = torch.stack(lvls)
    f_xy, f_ur, f_lv, f_ok = _frame_window_args(frame_xy_und, frame_uright,
                                                frame_level, frame_valid)
    bi, bd, b2, b2i = kernels.window_match(
        torch.stack(uvs).contiguous(), torch.stack(rads).contiguous(),
        (lvl - level_slack).contiguous(), (lvl + level_slack).contiguous(),
        torch.stack(urs).contiguous(), pts.desc[None].contiguous(),
        f_xy, f_ur, f_lv, (f_ok & ~frame_taken).contiguous(),
        frame_desc.contiguous())
    # the ratio test applies only when the two best share a level
    blvl = torch.gather(f_lv, 1, bi.long())
    same_lvl = torch.gather(f_lv, 1, b2i.long()) == blvl
    ratio_ok = ~same_lvl | (bd.to(torch.float32) <= nn_ratio * b2.to(torch.float32))
    ok = (bd <= th_hamming) & ratio_ok & (bd < BIG)
    L = pts.pos.shape[0]
    match_mp = []
    for c in range(C):
        feat_q = resolve_feature_conflicts(bi[c], bd[c], ok[c], F)
        mp = pts.idx[feat_q.clamp(0, L - 1).long()]
        match_mp.append(torch.where(feat_q >= 0, mp, torch.full_like(mp, -1)))
    visible = torch.stack(masks).any(dim=0)
    return torch.stack(match_mp), visible


def search_prev_frame(
    prev_pw: torch.Tensor,        # [C, F, 3] world points of prev features
    prev_pw_valid: torch.Tensor,  # [C, F]
    prev_desc: torch.Tensor,      # [C, F, 8]
    prev_level: torch.Tensor,     # [C, F]
    prev_angle: torch.Tensor,     # [C, F]
    prev_mp: torch.Tensor,        # [C, F] map-point ids of prev matches
    frame_xy_und: torch.Tensor,   # [C, F, 2]
    frame_uright: torch.Tensor,   # [C, F]
    frame_level: torch.Tensor,    # [C, F]
    frame_angle: torch.Tensor,    # [C, F]
    frame_desc: torch.Tensor,     # [C, F, 8]
    frame_valid: torch.Tensor,    # [C, F]
    Tcw: torch.Tensor,
    T_rc: torch.Tensor,
    K: torch.Tensor,
    bf: torch.Tensor,
    width: int,
    height: int,
    scale_factor: float,
    n_levels: int,
    th_radius: float = 7.0,
    check_rotation: bool = True,
):
    """Frame-to-frame projection search for motion-model tracking; every
    previous-frame 3D point is projected into EVERY current camera.

    Returns (match_src [C, F] flattened prev index (c*F+f) per current
    feature or -1, match_pw [C, F, 3], match_mp [C, F]).
    """
    C, F = frame_valid.shape
    dev = frame_valid.device
    sf = torch.tensor([scale_factor ** lvl for lvl in range(n_levels)],
                      dtype=torch.float32, device=dev)
    Q = C * F
    pw = prev_pw.reshape(Q, 3)
    q_valid = prev_pw_valid.reshape(Q)
    q_desc = prev_desc.reshape(1, Q, 8).contiguous()
    q_level = prev_level.reshape(Q).to(torch.int32)
    q_angle = prev_angle.reshape(Q)
    radius = th_radius * sf[q_level.long()]
    uvs, rads, urs = [], [], []
    for c in range(C):
        Tcam = T_rc[c] @ Tcw
        Xc = se3.transform_points(Tcam, pw)
        z_ok = Xc[:, 2] > 0.1
        uv = cam_mod.project(K[c], Xc)
        inb = cam_mod.in_image(uv, width, height)
        invz = 1.0 / torch.clamp(Xc[:, 2], min=1e-6)
        uvs.append(uv)
        rads.append(torch.where(q_valid & z_ok & inb, radius,
                                torch.full_like(radius, _NO_QUERY_RADIUS)))
        urs.append(torch.clamp(uv[:, 0] - bf * invz, min=_UR_FLOOR))
    f_xy, f_ur, f_lv, f_ok = _frame_window_args(frame_xy_und, frame_uright,
                                                frame_level, frame_valid)
    lmin = (q_level - 1)[None].expand(C, Q).contiguous()
    lmax = (q_level + 1)[None].expand(C, Q).contiguous()
    bi, bd, _, _ = kernels.window_match(
        torch.stack(uvs).contiguous(), torch.stack(rads).contiguous(), lmin, lmax,
        torch.stack(urs).contiguous(), q_desc, f_xy, f_ur, f_lv, f_ok,
        frame_desc.contiguous())
    match_src = []
    for c in range(C):
        ok = bd[c] <= hamming.TH_HIGH
        if check_rotation:
            delta = q_angle - frame_angle[c][bi[c].long()]
            ok = hamming.rotation_histogram_filter(delta, ok)
        match_src.append(resolve_feature_conflicts(bi[c], bd[c], ok, F))
    match_src = torch.stack(match_src)
    has = match_src >= 0
    src = match_src.clamp(0, Q - 1).long()
    match_pw = torch.where(has[..., None], pw[src], torch.zeros_like(pw[src]))
    prev_mp_flat = prev_mp.reshape(Q)
    match_mp = torch.where(has, prev_mp_flat[src], torch.full_like(match_src, -1))
    return match_src, match_pw, match_mp


def match_frame_kf_brute(
    kf_desc: torch.Tensor,     # [C, F, 8]
    kf_feat_valid: torch.Tensor,
    kf_mp: torch.Tensor,       # [C, F]
    kf_angle: torch.Tensor,
    frame_desc: torch.Tensor,  # [C, F, 8]
    frame_valid: torch.Tensor,
    frame_angle: torch.Tensor,
    th: int = hamming.TH_LOW,
    nn_ratio: float = 0.7,
    check_rotation: bool = True,
):
    """Reference-keyframe matching by brute force (SearchByBoW replacement):
    best/second per keyframe feature over every valid frame feature of the
    same camera, ratio + rotation checks.  No window, level or stereo gate:
    an infinite radius, an open level range and a disabled stereo gate.

    Returns match_mp [C, F]: map-point id for each frame feature.
    """
    C, F = frame_valid.shape
    Fk = kf_desc.shape[1]
    dev = frame_valid.device
    q_ok = kf_feat_valid & (kf_mp >= 0)
    rad = torch.where(q_ok, torch.full(q_ok.shape, float("inf"), device=dev),
                      torch.full(q_ok.shape, _NO_QUERY_RADIUS, device=dev))
    zeros_q = torch.zeros((C, Fk, 2), dtype=torch.float32, device=dev)
    bi, bd, b2, _ = kernels.window_match(
        zeros_q, rad.contiguous(),
        torch.full((C, Fk), -1, dtype=torch.int32, device=dev),
        torch.full((C, Fk), 1 << 30, dtype=torch.int32, device=dev),
        torch.full((C, Fk), -1e9, dtype=torch.float32, device=dev),
        kf_desc.contiguous(),
        torch.zeros((C, F, 2), dtype=torch.float32, device=dev),
        torch.full((C, F), -1.0, dtype=torch.float32, device=dev),
        torch.zeros((C, F), dtype=torch.int32, device=dev),
        frame_valid.contiguous(), frame_desc.contiguous())
    out = []
    for c in range(C):
        ok = (bd[c] <= th) & (bd[c].to(torch.float32) <= nn_ratio * b2[c].to(torch.float32))
        if check_rotation:
            delta = kf_angle[c] - frame_angle[c][bi[c].long()]
            ok = hamming.rotation_histogram_filter(delta, ok)
        feat_q = resolve_feature_conflicts(bi[c], bd[c], ok, F)
        mp = kf_mp[c][feat_q.clamp(0, Fk - 1).long()]
        out.append(torch.where(feat_q >= 0, mp, torch.full_like(mp, -1)))
    return torch.stack(out)
