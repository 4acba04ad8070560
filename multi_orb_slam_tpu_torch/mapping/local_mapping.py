"""Local mapping stage: local-BA windowing, map write-back and culling.

Counterpart of `multi_orb_slam_tpu/mapping/local_mapping.py`: a
deterministic stage invoked after keyframe insertion (the `Tracker`'s
`kf_inserted_cb`).  This module owns

- local BA problem extraction (the covisible-keyframe window: covisible
  keyframes free, observing keyframes fixed, their points marginalized)
- write-back of optimized poses / points and erasure of outlier
  observations
- map-point culling and keyframe culling
- `run_mapping_stage`, the whole pass; triangulation of new points and
  neighbour fusion live in `triangulation.py` / `fusion.py`.

With every stage on, `run_mapping_stage` is `_mapping_stage_fused`, the
reference's one jitted program a keyframe: the host reads nothing.  Its two
`lax.cond`s (local BA once the map holds more than 2 keyframes, capacity
relief once the point store is over 90% full) compute both branches and
select (`tracking.select`), and local BA's LM loop runs on the device
(`optim/local_ba.py`).  `_mapping_stage_fused` is `graphs.graphed` with the
window bucket static: on the card one CUDA graph, captured once per
(configuration, window bucket) and replayed once a keyframe; on the CPU
the body itself.
Without `covis_hint` (and with `ba_adaptive`) the window's covisible count
is read back first; a stage switched off takes the stepwise path, whose
host `if`s read `n_kf`, as the reference's does.  Each function of that
path is graphed as the reference jits it (`cull_map_points`,
`triangulation.triangulate_new_points`, `fusion.fuse_neighbors`,
`build_local_problem`, `solve_ba_jit`, `apply_ba_result`, `cull_keyframes`,
`tracking.update_point_geometry`): one replay each on the card, the slots
and the frame id traced; inside `_mapping_stage_fused` they run inline.

Repeated scatter indices only meet on a dump slot (K-1, M-1, or a column
past the end), where every write carries the same value, so each
`index_put_` here is deterministic; counts go through integer
`index_add_` / `scatter_reduce_`, which do not depend on order.
"""

from __future__ import annotations

import torch

from ..config import SlamConfig, inv_sigma2_of_level
from ..frontend.tracking import _device_scalar, select, update_point_geometry
from ..geometry import camera as cam_mod
from ..ops import hamming
from ..optim import local_ba
from ..utils import graphs, metrics
from . import fusion, triangulation
from . import map_state as ms

# device counters over all mapping stages of this process (diagnostics):
# stages run ("stages"), and local-BA windows taken, keyed by their number
# of free keyframes
STATS = graphs.DeviceCounters()
BA_WINDOWS = graphs.DeviceCounters()


def _stage(name: str, state: ms.MapState):
    """The tracer's span of one stage, `mapping/<name>`, with device events
    on `state`'s device (inside a graph's capture it records nothing: a
    replay of `_mapping_stage_fused` is one `graph/replay`)."""
    return metrics.span(f"mapping/{name}", state.mp_pos.device)


def _shared_obs(state: ms.MapState, mask: torch.Tensor) -> torch.Tensor:
    """[K] int32: per valid keyframe, observations of points in `mask` [M]."""
    K = state.kf_mp.shape[0]
    M = state.mp_pos.shape[0]
    kfobs = state.kf_mp.reshape(K, -1)
    kfobs_ok = (kfobs >= 0) & state.kf_valid[:, None]
    return (mask[kfobs.clamp(0, M - 1).long()] & kfobs_ok).sum(dim=-1, dtype=torch.int32)


def _row_mask(state: ms.MapState, ks: torch.Tensor) -> torch.Tensor:
    """[M] bool: points observed by keyframe `ks` (1-element index)."""
    M = state.mp_pos.shape[0]
    obs = state.kf_mp.index_select(0, ks).reshape(-1)
    return ms.scatter_max_bool(M, torch.where(obs >= 0, obs, M - 1), obs >= 0)


@graphs.graphed(static_argnames=("cfg", "n_free", "n_fixed"))
def build_local_problem(state: ms.MapState, center_kf, cfg: SlamConfig,
                        n_free: int = 12, n_fixed: int = 12) -> local_ba.BAProblem:
    """Extract the covisibility window around `center_kf` as a BAProblem."""
    K, C, F = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    P = cfg.ba_local_cap
    dev = state.mp_pos.device
    i32 = torch.int32
    ck = ms.slot_index(center_kf, dev)

    share = _shared_obs(state, _row_mask(state, ck))
    share.index_fill_(0, ck, 1 << 24)  # center always first
    w_free, free_kfs = hamming.top_k(share, n_free)
    free_ok = (w_free > 0) & state.kf_valid[free_kfs]

    # local points = points observed by the free window
    fk = torch.where(free_ok, free_kfs, 0)
    obs_free = state.kf_mp[fk].reshape(n_free, -1)
    obs_free_ok = (obs_free >= 0) & free_ok[:, None]
    local_mask = ms.scatter_max_bool(
        M, torch.where(obs_free_ok, obs_free, M - 1), obs_free_ok) & state.mp_valid

    # fixed keyframes: observe local points but are not free
    sees_local = _shared_obs(state, local_mask)
    is_free = ms.scatter_max_bool(K, torch.where(free_ok, free_kfs, K - 1), free_ok)
    sees_local = torch.where(is_free | ~state.kf_valid, -1, sees_local)
    w_fix, fixed_kfs = hamming.top_k(sees_local, n_fixed)
    fixed_ok = w_fix > 0

    # compact local points, in slot order
    _, order = hamming.top_k(
        local_mask.to(i32) * (1 << 20) - torch.arange(M, dtype=i32, device=dev), P)
    sel_ok = local_mask[order]
    mp_slot = torch.where(sel_ok, order, -1).to(i32)
    lookup = torch.full((M,), -1, dtype=i32, device=dev)
    lookup[torch.where(sel_ok, order, M - 1)] = torch.where(
        sel_ok, torch.arange(P, dtype=i32, device=dev), -1)

    L = n_free + n_fixed
    kf_slots = torch.cat([free_kfs, fixed_kfs])
    kf_ok = torch.cat([free_ok, fixed_ok])
    kf_free = torch.cat([free_ok, torch.zeros(n_fixed, dtype=torch.bool, device=dev)])
    # gauge anchor: slot 0, the first keyframe ever created, stays fixed
    kf_free = kf_free & ~((kf_slots == 0) & kf_ok)
    # if nothing anchors the gauge (no fixed keyframe, slot 0 absent), fix
    # the oldest
    has_anchor = torch.any(kf_ok & ~kf_free)
    fid = torch.where(kf_ok, state.kf_frame_id[kf_slots], 1 << 30)
    oldest = hamming.first_argmin(fid)
    kf_free = kf_free & ~(~has_anchor & (torch.arange(L, device=dev) == oldest))

    ks = torch.where(kf_ok, kf_slots, 0)
    obs_mp_raw = state.kf_mp[ks]  # [L, C, F]
    obs_mp = torch.where(
        (obs_mp_raw >= 0) & kf_ok[:, None, None] & state.kf_feat_valid[ks],
        lookup[obs_mp_raw.clamp(0, M - 1).long()], -1)
    # dedupe: at most ONE observation of a point per (keyframe, camera)
    # row (fusion merges can leave two features on the same winner); the
    # solver's inverse index map needs it
    flat = obs_mp.reshape(L * C, F)
    sv, order = torch.sort(flat, dim=1, stable=True)
    dup_sorted = torch.cat([
        torch.zeros((flat.shape[0], 1), dtype=torch.bool, device=dev),
        (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    obs_mp = torch.where(dup.reshape(obs_mp.shape), -1, obs_mp)
    obs_uvr = torch.cat([state.kf_xy_und[ks], state.kf_uright[ks][..., None]], dim=-1)
    return local_ba.BAProblem(
        kf_slot=torch.where(kf_ok, kf_slots, -1).to(i32),
        kf_Tcw=state.kf_Tcw[ks],
        kf_free=kf_free,
        kf_valid=kf_ok,
        mp_slot=mp_slot,
        mp_pos=state.mp_pos[mp_slot.clamp(0, M - 1).long()],
        mp_valid=sel_ok,
        obs_mp=obs_mp,
        obs_uvr=obs_uvr,
        obs_inv_sigma2=inv_sigma2_of_level(state.kf_level[ks], cfg),
    )


@graphs.graphed(static_argnames=("cfg",))
def apply_ba_result(state: ms.MapState, prob: local_ba.BAProblem,
                    kf_Tcw_new: torch.Tensor, mp_pos_new: torch.Tensor,
                    obs_inlier: torch.Tensor, cfg: SlamConfig) -> ms.MapState:
    """Write optimized poses / points back; erase outlier observations."""
    K = state.kf_mp.shape[0]
    M = state.mp_pos.shape[0]

    # poses (free keyframes only; dummy writes to reserved slot K-1)
    put = prob.kf_valid & prob.kf_free
    tgt_kf = torch.where(put, prob.kf_slot, K - 1).long()
    kf_Tcw = state.kf_Tcw.clone()
    kf_Tcw[tgt_kf] = torch.where(put[:, None, None], kf_Tcw_new, state.kf_Tcw[tgt_kf])

    # points
    tgt_mp = torch.where(prob.mp_valid, prob.mp_slot, M - 1).long()
    mp_pos = state.mp_pos.clone()
    mp_pos[tgt_mp] = torch.where(prob.mp_valid[:, None], mp_pos_new, state.mp_pos[tgt_mp])

    # erase outlier observations
    tgt_rows = torch.where(prob.kf_valid, prob.kf_slot, K - 1).long()
    erase = (prob.obs_mp >= 0) & ~obs_inlier & prob.kf_valid[:, None, None]
    kf_mp = state.kf_mp.clone()
    kf_mp[tgt_rows] = torch.where(erase, -1, state.kf_mp[tgt_rows])

    # point geometry refresh is deferred to the end of the mapping stage
    return state._replace(kf_Tcw=kf_Tcw, mp_pos=mp_pos, kf_mp=kf_mp)


@graphs.graphed(static_argnames=("phases",))
def solve_ba_jit(prob: local_ba.BAProblem, T_rc: torch.Tensor, K: torch.Tensor,
                 bf: torch.Tensor, phases: tuple = ((5, True), (10, False))):
    """`local_ba.solve_ba` with its LM schedule static: (kf_Tcw, mp_pos,
    obs_inlier)."""
    return local_ba.solve_ba(prob, T_rc, K, bf, phases=phases)


def run_local_ba(state: ms.MapState, center_kf, calib: cam_mod.CameraParams,
                 cfg: SlamConfig, n_free: int = 12, n_fixed: int = 12,
                 phases: tuple = ((5, True), (8, False))) -> ms.MapState:
    """Full local BA pass around a keyframe (build -> solve -> apply)."""
    with _stage("build_problem", state):
        prob = build_local_problem(state, center_kf, cfg, n_free, n_fixed)
    with _stage("solve", state):
        kf_Tcw, mp_pos, inlier = solve_ba_jit(prob, calib.T_rc, calib.K, calib.bf, phases)
    with _stage("apply", state):
        return apply_ba_result(state, prob, kf_Tcw, mp_pos, inlier, cfg)


# adaptive-window buckets: the smallest window covering the covisible set
# wins; the largest is the cap.  Each bucket carries its own LM schedule
# (huber_iters, plain_iters): the cost of an iteration grows with the
# window, and under real-time keyframe pressure the big-window solves are
# the ones a live system interrupts, so the deterministic budget scales
# down with window size.
_BA_WINDOW_BUCKETS = (12, 16, 24, 32)
_BA_BUCKET_PHASES = {
    12: ((5, True), (8, False)),
    16: ((4, True), (6, False)),
    24: ((2, True), (4, False)),
    32: ((2, True), (3, False)),
}


def _window(state: ms.MapState, kf_slot, cfg: SlamConfig, covis_hint):
    """(n_free, n_fixed, phases) of the local-BA window: with
    `ba_adaptive`, the smallest bucket above the covisible count and its
    LM schedule (the count is read back here when no hint is given)."""
    if not cfg.ba_adaptive:
        return cfg.ba_free_kfs, cfg.ba_fixed_kfs, ((5, True), (8, False))
    n_cov = (covis_hint if covis_hint is not None
             else int(metrics.host("covis_count", covis_kf_count(state, kf_slot))))
    for nf in _BA_WINDOW_BUCKETS:
        if nf >= n_cov + 1:
            break
    n = min(nf, cfg.max_kf // 2)
    return n, n, _BA_BUCKET_PHASES[nf]


def run_mapping_stage(state: ms.MapState, kf_slot, frame_id,
                      calib: cam_mod.CameraParams, cfg: SlamConfig,
                      do_triangulate: bool = True, do_fuse: bool = True,
                      do_ba: bool = True, do_cull: bool = True,
                      covis_hint: int | None = None) -> ms.MapState:
    """The full mapping pass after a keyframe insertion: map-point culling
    -> new-point triangulation -> neighbour fusion -> local BA (once the
    map has more than 2 keyframes) -> keyframe culling -> point geometry.

    With every stage on (the default), the pass is `_mapping_stage_fused`
    (a CUDA graph replay on the card) and also evicts the weakest
    non-recent points when the point store is over 90% full; the map it
    returns is the caller's own (a copy of the graph's outputs).  A pass with a stage switched off runs stage by stage and
    does not relieve capacity (as in the reference).

    `covis_hint`: a caller-provided covisible-keyframe count for adaptive
    window sizing.  Pass the PREVIOUS keyframe's count (`covis_kf_count`,
    read one keyframe later); with `ba_adaptive` and no hint, the count is
    computed here and read back at once.
    """
    n_free, n_fixed, phases = _window(state, kf_slot, cfg, covis_hint)
    if do_triangulate and do_fuse and do_ba and do_cull:
        dev = state.mp_pos.device
        return _mapping_stage_fused(
            state, _device_scalar(kf_slot, torch.int32, dev).reshape(()),
            _device_scalar(frame_id, torch.int32, dev).reshape(()), calib, cfg,
            n_free, n_fixed, phases)
    STATS.add("stages", 1, state.mp_pos.device)
    if do_cull:
        with _stage("cull_points", state):
            state = cull_map_points(state, frame_id, cfg)
    if do_triangulate:
        with _stage("triangulate", state):
            state, _ = triangulation.triangulate_new_points(state, kf_slot, calib, cfg)
    if do_fuse:
        with _stage("fuse", state):
            state, _ = fusion.fuse_neighbors(state, kf_slot, calib, cfg)
    if do_ba and int(metrics.host("n_kf", state.n_kf)) > 2:
        BA_WINDOWS.add(n_free, 1, state.mp_pos.device)
        state = run_local_ba(state, kf_slot, calib, cfg,
                             n_free=n_free, n_fixed=n_fixed, phases=phases)
    if do_cull:
        with _stage("cull_keyframes", state):
            state = cull_keyframes(state, kf_slot, cfg)
    with _stage("geometry", state):
        return update_point_geometry(state, cfg)


@graphs.graphed(static_argnames=("cfg", "n_free", "n_fixed", "phases"))
def _mapping_stage_fused(state: ms.MapState, kf_slot: torch.Tensor, frame_id: torch.Tensor,
                         calib: cam_mod.CameraParams, cfg: SlamConfig, n_free: int,
                         n_fixed: int, phases: tuple) -> ms.MapState:
    """The mapping pass with every stage on, reading nothing back:
    `kf_slot` and `frame_id` are 0-dim device tensors, the window and its
    schedule static.  Local BA (skipped in the reference until the map
    holds more than 2 keyframes) and capacity relief (over 90% of the
    point store in use) are computed on every keyframe and selected."""
    M = state.mp_pos.shape[0]
    STATS.add("stages", 1, state.mp_pos.device)
    with _stage("cull_points", state):
        state = cull_map_points(state, frame_id, cfg)
    with _stage("triangulate", state):
        state, _ = triangulation.triangulate_new_points(state, kf_slot, calib, cfg)
    with _stage("fuse", state):
        state, _ = fusion.fuse_neighbors(state, kf_slot, calib, cfg)
    do_ba = state.n_kf > 2
    BA_WINDOWS.add(n_free, do_ba)
    with _stage("build_problem", state):
        prob = build_local_problem(state, kf_slot, cfg, n_free, n_fixed)
    with _stage("solve", state):
        sol = local_ba.solve_ba(prob, calib.T_rc, calib.K, calib.bf, phases=phases, run=do_ba)
    with _stage("apply", state):
        state = select(do_ba, apply_ba_result(state, prob, *sol, cfg), state)
    with _stage("cull_keyframes", state):
        state = cull_keyframes(state, kf_slot, cfg)
    with _stage("relieve_capacity", state):
        # neither local BA nor keyframe culling changes n_mp
        state = select(state.n_mp > int(0.90 * M),
                       ms.relieve_capacity(state, target_free=max(M // 10, 64)), state)
    with _stage("geometry", state):
        return update_point_geometry(state, cfg)


def covis_kf_count(state: ms.MapState, kf_slot) -> torch.Tensor:
    """Number of valid keyframes sharing >= 15 observations with kf_slot."""
    ks = ms.slot_index(kf_slot, state.mp_pos.device)
    share = _shared_obs(state, _row_mask(state, ks))
    share.index_fill_(0, ks, 0)
    return (share >= 15).sum(dtype=torch.int32)


@graphs.graphed(static_argnames=("cfg",))
def cull_map_points(state: ms.MapState, current_frame_id, cfg: SlamConfig) -> ms.MapState:
    """Remove low-quality recent points, with age measured in keyframes
    inserted since creation: found/visible ratio < 0.25, or >= 2 keyframes
    old with <= 3 weighted observations; points older than 3 keyframes
    graduate and are kept.  (`current_frame_id` is unused, as in the
    reference.)"""
    M = state.mp_pos.shape[0]
    ratio = state.mp_found.to(torch.float32) / torch.clamp(
        state.mp_visible.to(torch.float32), min=1.0)
    # keyframes inserted since the point's creation
    age_kf = ((state.kf_frame_id[None, :] > state.mp_first_frame[:, None])
              & state.kf_valid[None, :]).sum(dim=-1)
    wobs = ms.mp_weighted_obs(state)
    bad = (ratio < 0.25) | ((age_kf >= 2) & (wobs <= 3))
    # grace period: only points still in their probation window get culled
    kill = state.mp_valid & bad & (age_kf <= 3)
    # drop observations of killed points
    killed_of = kill[state.kf_mp.clamp(0, M - 1).long()] & (state.kf_mp >= 0)
    return state._replace(
        mp_valid=state.mp_valid & ~kill,
        kf_mp=torch.where(killed_of, -1, state.kf_mp),
        n_mp=state.n_mp - kill.sum(dtype=torch.int32))


@graphs.graphed(static_argnames=("cfg", "max_victims"))
def cull_keyframes(state: ms.MapState, center_kf, cfg: SlamConfig,
                   max_victims: int = 6) -> ms.MapState:
    """Discard redundant local keyframes (multi-victim, octave-aware).

    For each covisibility neighbour of `center_kf`, a CLOSE map point
    (0 < depth < th_depth) is redundant if >= 3 OTHER keyframes observe it
    at the same-or-finer pyramid octave (level_other <= level_here + 1);
    the keyframe is erased when > 90% of its close points are redundant.
    The serial semantics (each erasure immediately shrinks later
    candidates' support) are a loop over the top-`max_victims` candidates
    ordered by redundancy ratio: a per-point level histogram is built once,
    and each accepted victim subtracts its own observations from it before
    the next is judged, so mutually redundant keyframes cannot cull each
    other.  The verdicts stay on the device.  Never culls slot 0 (the map
    origin) or the center keyframe itself.
    """
    K, C, F = state.kf_mp.shape
    M = state.mp_pos.shape[0]
    L = cfg.n_levels
    dev = state.mp_pos.device
    i32 = torch.int32
    ck = ms.slot_index(center_kf, dev)
    has = (state.kf_mp >= 0) & state.kf_feat_valid & state.kf_valid[:, None, None]
    close = (state.kf_depth > 0) & (state.kf_depth < cfg.th_depth)
    lvl = state.kf_level.clamp(0, L - 1)
    mp = state.kf_mp.clamp(0, M - 1).long()                  # [K, C, F]
    # per-point observation count at each pyramid level, over ALL keyframes
    lin = mp * L + lvl                                       # [K, C, F]
    lvl_cnt = torch.zeros(M * L + 1, dtype=i32, device=dev)
    lvl_cnt.index_add_(0, torch.where(has, lin, M * L).reshape(-1),
                       has.reshape(-1).to(i32))

    # per-(keyframe, camera) point -> observation level (127 = none): lets
    # a candidate subtract its OWN observations of a point over BOTH
    # cameras (a dual-camera self-observation is no independent supporter)
    lvl_of = torch.full((K, C, M + 1), 127, dtype=i32, device=dev)
    lvl_of.scatter_reduce_(2, torch.where(has, mp, M), torch.where(has, lvl, 127),
                           "amin", include_self=True)
    lvl_of = lvl_of[:, :, :M]
    levels = torch.arange(L, device=dev)

    def kf_ratio(lvl_cnt, s):
        """Redundant-close-point ratio of keyframe slots s [S] under lvl_cnt."""
        S = s.shape[0]
        m_s, lvl_s = mp[s], lvl[s]                           # [S, C, F]
        cnt = lvl_cnt[:-1].reshape(M, L)[m_s]                # [S, C, F, L]
        sup_mask = levels <= (lvl_s + 1)[..., None]
        # self-observations of the same point (any camera) at qualifying
        # level, to subtract from the histogram total
        own = torch.gather(lvl_of[s], 2, m_s.reshape(S, 1, C * F).expand(S, C, C * F))
        self_sup = (own <= (lvl_s + 1).reshape(S, 1, C * F)).sum(dim=1, dtype=i32)
        sup = torch.where(sup_mask, cnt, 0).sum(dim=-1, dtype=i32) - self_sup.reshape(S, C, F)
        ok = has[s] & close[s]
        red = ok & (sup >= 3)
        n_pts = ok.sum(dim=(1, 2)).to(torch.float32)
        n_red = red.sum(dim=(1, 2)).to(torch.float32)
        return n_red / torch.clamp(n_pts, min=1.0)

    W = ms.covisibility(state)
    slots = torch.arange(K, device=dev)
    neighbor = W.index_select(0, ck)[0] >= 15.0
    cand = state.kf_valid & neighbor & (slots != 0) & (slots != ck)
    ratio0 = kf_ratio(lvl_cnt, slots)
    order_score = torch.where(cand, ratio0, -1.0)
    _, victims = hamming.top_k(order_score, max_victims)
    vic_ok = order_score[victims] > 0.0  # only plausible candidates

    kf_valid = state.kf_valid.clone()
    n_culled = torch.zeros((), dtype=i32, device=dev)
    erased = torch.zeros(K, dtype=torch.bool, device=dev)
    for i in range(max_victims):
        s = victims[i:i + 1]
        do = vic_ok[i] & (kf_ratio(lvl_cnt, s)[0] > 0.9) & kf_valid[s][0]
        # subtract this keyframe's observations from the level histogram so
        # the next candidate no longer counts it as a supporter
        sub = has[s][0] & do
        lvl_cnt.index_add_(0, torch.where(sub, lin[s][0], M * L).reshape(-1),
                           -sub.reshape(-1).to(i32))
        kf_valid[s] = kf_valid[s] & ~do
        erased[s] = erased[s] | do
        n_culled = n_culled + do.to(i32)
    # erase the victims' observation rows
    kf_mp = torch.where(erased[:, None, None], -1, state.kf_mp)
    return state._replace(kf_valid=kf_valid, kf_mp=kf_mp, n_kf=state.n_kf - n_culled)
