"""Map-point fusion between covisible keyframes.

Counterpart of `multi_orb_slam_tpu/mapping/fusion.py` (SearchInNeighbors +
ORBmatcher::Fuse): project map points into a target keyframe's cameras;
where a projected point lands on a feature that already observes another
point, merge the two (the one with more observations survives); where it
lands on a free feature, add the observation.  All cameras are searched at
once, through `search.search_points_in_frame` and so through the
`window_match` kernel, with the 60-degree viewing-angle gate
(`use_view_cos=True`) and no ratio test.

Deferred merges: a fuse group (the 5 + 1 targets of `fuse_neighbors`)
accumulates loser -> winner redirections in ONE [M] replacement table; each
step rewrites only its target keyframe row and redirects its lookups
through the table, and the full-store remap and per-row dedupe run once at
the end of the group.  The sequential merge semantics are kept: losers are
invalidated immediately, later steps see earlier merges through the table,
and the weighted observation counter that decides merge direction is
carried through the group (a merge rolls the loser's count into the winner
at once).

Where the reference leaves a scatter's winner open (two conflicts in one
step that name the same loser with different winners), the conflict that
comes last in feature order wins (`map_state.scatter_set_last`).

`fuse_into_kf`, `fuse_into_kfs` and `fuse_neighbors` are `graphs.graphed`
with the reference jit's static arguments (`cfg`; `cfg` and `n_neighbors`):
on the card one CUDA graph replay a call, the target slot traced.  Inside
the mapping stage's graph they run inline.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig
from ..geometry import camera as cam_mod
from ..ops import hamming, search
from ..utils import graphs
from . import map_state as ms


def _redirect(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """where(ids >= 0, table[ids], -1)"""
    M = table.shape[0]
    return torch.where(ids >= 0, table[ids.clamp(0, M - 1).long()],
                       torch.full_like(ids, -1))


def _match_into_kf(state: ms.MapState, pts: search.LocalPoints, kt: torch.Tensor,
                   cfg: SlamConfig, calib: cam_mod.CameraParams) -> torch.Tensor:
    """Fuse search of `pts` in keyframe `kt` (1-element index): [C, F] raw
    map-point id per feature or -1.  TH_LOW only, no ratio test."""
    row = lambda x: x.index_select(0, kt)[0]        # noqa: E731
    fv = row(state.kf_feat_valid)
    match_raw, _ = search.search_points_in_frame(
        pts, row(state.kf_xy_und), row(state.kf_uright), row(state.kf_level),
        row(state.kf_desc), fv, torch.zeros_like(fv),
        row(state.kf_Tcw), calib.T_rc, calib.K, calib.bf,
        cfg.width, cfg.height, cfg.scale_factor, cfg.n_levels,
        th_radius=3.0, nn_ratio=1.0, th_hamming=50, use_view_cos=True)
    return match_raw


def _fuse_step(state: ms.MapState, pts: search.LocalPoints, kf_t,
               replace_tot: torch.Tensor, obs_cnt: torch.Tensor,
               cfg: SlamConfig, calib: cam_mod.CameraParams,
               match_raw: torch.Tensor | None = None):
    """One fusion target: match, add observations, record merges.

    `replace_tot` [M] maps raw id -> live id (path-compressed); `obs_cnt`
    [M] int32 is the weighted observation count at LIVE ids, maintained
    incrementally across the group.  Touches only the target row of
    `kf_mp`; merge effects on the rest of the store are deferred to
    `_finalize_merges`.  Returns (state, replace_tot, obs_cnt, n_merged).
    """
    M = cfg.max_mp
    dev = state.mp_pos.device
    i32 = torch.int32
    kt = ms.slot_index(kf_t, dev)
    if match_raw is None:
        # points that lost an earlier merge in this group are dead: skip
        g = pts.idx.clamp(0, M - 1).long()
        pts = pts._replace(valid=pts.valid & state.mp_valid[g])
        match_raw = _match_into_kf(state, pts, kt, cfg, calib)
    # redirect both sides through the accumulated merges so conflicts are
    # detected between LIVE landmark ids
    match_mp = _redirect(match_raw, replace_tot)
    cur_raw = state.kf_mp.index_select(0, kt)[0]           # [C, F]
    cur_mp = _redirect(cur_raw, replace_tot)
    new_obs = (match_mp >= 0) & (cur_mp < 0)
    conflict = (match_mp >= 0) & (cur_mp >= 0) & (match_mp != cur_mp)

    # add observations on free features; dedupe THIS row only (in the
    # redirected id space, preferring features already on the final id)
    row = torch.where(new_obs, match_mp, cur_raw)
    row_red = _redirect(row, replace_tot)
    row_dd = ms.dedupe_obs_rows(row_red, prefer_keep=(row_red == row))
    row = torch.where(row_dd < 0, torch.full_like(row, -1), row)
    kf_mp = state.kf_mp.clone()
    kf_mp[kt] = row[None]

    # incremental count update for this row: features that gained an
    # observation (+w), features the dedupe dropped (-w); stereo weighs 2
    w_feat = torch.where(state.kf_uright.index_select(0, kt)[0] >= 0, 2, 1).to(i32)
    added = (row >= 0) & (cur_raw < 0)
    removed = (cur_raw >= 0) & (row < 0)
    zero = torch.zeros_like(w_feat)
    obs_cnt = obs_cnt.clone()
    obs_cnt.index_add_(0, torch.where(added, row, M - 1).reshape(-1).long(),
                       torch.where(added, w_feat, zero).reshape(-1))
    obs_cnt.index_add_(0, torch.where(removed, cur_mp, M - 1).reshape(-1).long(),
                       -torch.where(removed, w_feat, zero).reshape(-1))

    # merge conflicting pairs: loser -> winner by a STRICT total order
    # (observation count, then lower slot id), so both orientations of a
    # pair agree and no merge cycle can form
    ids = torch.arange(M, dtype=i32, device=dev)
    a = torch.where(conflict, match_mp, 0).long()
    b = torch.where(conflict, cur_mp, 0).long()
    key = obs_cnt * M + (M - ids)
    a_wins = key[a] > key[b]
    winner = torch.where(a_wins, a, b).to(i32)
    loser = torch.where(a_wins, b, a)
    cfl = conflict.reshape(-1)
    lfl = torch.where(conflict, loser, M - 1).reshape(-1)
    replace = ms.scatter_set_last(
        ids, lfl, torch.where(cfl, winner.reshape(-1), ids[lfl]))
    # path compression: chains (c->b->a) end because edges strictly
    # increase the order key; 4 halvings cover depth 16
    for _ in range(4):
        replace = replace[replace.long()]

    # losers die now (later steps in the group skip them); their found /
    # visible / observation counters roll into the final winner
    is_loser = replace != ids
    wfin = torch.where(cfl, replace[lfl].long(), M - 1)

    def roll(cnt):
        out = cnt.clone()
        out.index_add_(0, wfin, torch.where(cfl, cnt[lfl], 0).to(cnt.dtype))
        return out

    n_merged = is_loser.sum(dtype=i32)
    state = state._replace(
        kf_mp=kf_mp, mp_valid=state.mp_valid & ~is_loser,
        mp_found=roll(state.mp_found), mp_visible=roll(state.mp_visible),
        n_mp=state.n_mp - n_merged)
    # compose into the group table (replace maps live -> live, so the
    # result stays path-compressed)
    return state, replace[replace_tot.long()], roll(obs_cnt), n_merged


def _finalize_merges(state: ms.MapState, replace_tot: torch.Tensor) -> ms.MapState:
    """Apply a fuse group's accumulated merges to the whole store.

    Remap every observation to its live landmark, then erase observations
    the remap made redundant: a (keyframe, camera) row keeps at most ONE
    feature per landmark, preferring the feature that already observed the
    winner over a remapped loser.

    The dedupe is one pass over the whole store.  (The reference narrows it
    to the rows the remap changed, to spare its device a full-store sort;
    with every row writer keeping the store dedupe-clean the two give the
    same rows, and one path is kept here.)
    """
    M = state.mp_pos.shape[0]
    dev = state.mp_pos.device
    raw = state.kf_mp
    red = torch.where(raw >= 0, replace_tot[raw.clamp(0, M - 1).long()], raw)
    kf_mp = ms.dedupe_obs_rows(red, prefer_keep=(red == raw))
    # forward pointers so stale frame matches can be redirected
    is_loser = replace_tot != torch.arange(M, dtype=torch.int32, device=dev)
    mp_replaced = torch.where(is_loser, replace_tot, state.mp_replaced)
    return state._replace(kf_mp=kf_mp, mp_replaced=mp_replaced)


def _group_start(state: ms.MapState):
    M = state.mp_pos.shape[0]
    return (torch.arange(M, dtype=torch.int32, device=state.mp_pos.device),
            ms.mp_weighted_obs(state))


@graphs.graphed(static_argnames=("cfg",))
def fuse_into_kf(state: ms.MapState, src_mask: torch.Tensor, kf_t,
                 cfg: SlamConfig, calib: cam_mod.CameraParams):
    """Project masked points [M] into keyframe kf_t; add observations /
    merge.  Returns (state, n_merged)."""
    pts = search.gather_local_points(state, src_mask & state.mp_valid, cfg.local_cap)
    rep0, cnt0 = _group_start(state)
    state, rep, _, n_merged = _fuse_step(state, pts, kf_t, rep0, cnt0, cfg, calib)
    return _finalize_merges(state, rep), n_merged


@graphs.graphed(static_argnames=("cfg",))
def fuse_into_kfs(state: ms.MapState, src_mask: torch.Tensor, kf_slots: torch.Tensor,
                  cfg: SlamConfig, calib: cam_mod.CameraParams):
    """Fuse masked points [M] into a batch of keyframes `kf_slots` [Kc]
    (pad with K-1, the reserved dummy slot whose features are never valid).

    Later targets see earlier merges through the deferred replacement
    table, and the full-store remap + dedupe runs once, not per target."""
    pts = search.gather_local_points(state, src_mask & state.mp_valid, cfg.local_cap)
    rep, cnt = _group_start(state)
    total = torch.zeros((), dtype=torch.int32, device=state.mp_pos.device)
    for i in range(kf_slots.shape[0]):
        state, rep, cnt, n = _fuse_step(state, pts, kf_slots[i], rep, cnt, cfg, calib)
        total = total + n
    return _finalize_merges(state, rep), total


@graphs.graphed(static_argnames=("cfg", "n_neighbors"))
def fuse_neighbors(state: ms.MapState, kf_slot, calib: cam_mod.CameraParams,
                   cfg: SlamConfig, n_neighbors: int = 5):
    """Two-direction fusion with the top covisible neighbours: this
    keyframe's points into each neighbour, then the neighbours' points into
    this keyframe.  Both directions share one deferred replacement table,
    finalized once.  Empty ranks map to the reserved no-op dummy slot K-1.
    Returns (state, n_merged)."""
    M = cfg.max_mp
    K, C, F = state.kf_mp.shape
    dev = state.mp_pos.device
    ks = ms.slot_index(kf_slot, dev)
    W = ms.covisibility(state)
    w, nbrs = hamming.top_k(W.index_select(0, ks)[0], n_neighbors)
    ok = w > 0
    slots = torch.where(ok, nbrs, K - 1)
    rep, cnt = _group_start(state)

    # direction 1.  The MATCHING does not depend on the merge bookkeeping
    # (projection uses keyframe poses and point positions, neither of which
    # a fuse step changes), so every neighbour is searched against the
    # state as it stands; only the merge bookkeeping is sequential (a match
    # against a merged-away loser redirects to its winner in _fuse_step).
    own = state.kf_mp.index_select(0, ks)[0].reshape(-1)
    own_mask = ms.scatter_max_bool(
        M, torch.where(own >= 0, own, M - 1), own >= 0)
    pts_own = search.gather_local_points(state, own_mask & state.mp_valid, cfg.local_cap)
    match_all = [_match_into_kf(state, pts_own, slots[i].reshape(1), cfg, calib)
                 for i in range(n_neighbors)]
    total = torch.zeros((), dtype=torch.int32, device=dev)
    for i in range(n_neighbors):
        state, rep, cnt, n = _fuse_step(state, pts_own, slots[i], rep, cnt, cfg,
                                        calib, match_raw=match_all[i])
        total = total + n

    # direction 2: neighbours' points into this keyframe (redirect the mask
    # through the table so winners of direction-1 merges are projected)
    rows = state.kf_mp[slots]                       # [Kc, C, F], raw ids
    rows = torch.where(rows >= 0, rep[rows.clamp(0, M - 1).long()], rows)
    rows = rows.reshape(n_neighbors, -1)
    rows_ok = (rows >= 0) & ok[:, None]
    neigh_mask = ms.scatter_max_bool(
        M, torch.where(rows_ok, rows, M - 1), rows_ok)
    pts_n = search.gather_local_points(state, neigh_mask & state.mp_valid, cfg.local_cap)
    state, rep, cnt, n2 = _fuse_step(state, pts_n, ks, rep, cnt, cfg, calib)
    return _finalize_merges(state, rep), total + n2
