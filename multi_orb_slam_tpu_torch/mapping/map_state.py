"""The map as fixed-capacity structure-of-arrays state.

Counterpart of `multi_orb_slam_tpu/mapping/map_state.py`: keyframe feature
stores `[K, C, F, ...]`, the keyframe/map-point observation array
`kf_mp[K, C, F]`, map-point records `[M, ...]`, and scalar counters.  The
last map-point slot (M-1) is a scatter dummy that is never allocated.

Scatters map as `.at[].set` -> `index_put_`, `.at[].max` ->
`scatter_reduce_(..., "amax", include_self=True)`, `.at[].add` ->
`index_add_`.  Where duplicates of one index are written (the dummy slot),
every duplicate writes the same value, as in the reference; where they
may write different values, `scatter_set_last` fixes the winner.
"""

from __future__ import annotations

import functools

from typing import NamedTuple

import torch

from .. import resolve_device
from ..ops import hamming

DESC_BUF = 4  # rolling descriptor buffer per map point


class MapState(NamedTuple):
    # --- keyframes ---
    kf_Tcw: torch.Tensor        # [K, 4, 4] rig pose (world -> rig body = cam0)
    kf_valid: torch.Tensor      # [K] bool
    kf_frame_id: torch.Tensor   # [K] int32 source frame id (monotonic)
    kf_xy_und: torch.Tensor     # [K, C, F, 2]
    kf_uright: torch.Tensor     # [K, C, F]
    kf_depth: torch.Tensor      # [K, C, F]
    kf_level: torch.Tensor      # [K, C, F] int32
    kf_angle: torch.Tensor      # [K, C, F]
    kf_desc: torch.Tensor       # [K, C, F, 8] int32
    kf_feat_valid: torch.Tensor # [K, C, F] bool
    kf_mp: torch.Tensor         # [K, C, F] int32 map-point id or -1
    # --- map points ---
    mp_pos: torch.Tensor        # [M, 3]
    mp_valid: torch.Tensor      # [M] bool
    mp_desc: torch.Tensor       # [M, 8] int32 distinctive descriptor
    mp_descbuf: torch.Tensor    # [M, DESC_BUF, 8] int32 recent obs descriptors
    mp_descbuf_n: torch.Tensor  # [M] int32 (monotone insert counter)
    mp_normal: torch.Tensor     # [M, 3] mean viewing direction
    mp_min_dist: torch.Tensor   # [M]
    mp_max_dist: torch.Tensor   # [M]
    mp_first_kf: torch.Tensor   # [M] int32 kf slot that created it
    mp_first_frame: torch.Tensor# [M] int32 frame id at creation
    mp_visible: torch.Tensor    # [M] int32 (IncreaseVisible)
    mp_found: torch.Tensor      # [M] int32 (IncreaseFound)
    mp_replaced: torch.Tensor   # [M] int32 forward pointer after a merge, -1
    # --- counters ---
    n_kf: torch.Tensor          # [] int32 number of valid keyframes
    n_mp: torch.Tensor          # [] int32 number of valid map points
    next_kf_id: torch.Tensor    # [] int32 monotonic keyframe id counter
    n_alloc_failed: torch.Tensor  # [] int32 map-point requests refused (full)


def make_empty(max_kf: int, n_cams: int, max_feat: int, max_mp: int,
               device=None) -> MapState:
    """An empty map on `device`: the CUDA device when None (raises where
    there is none), `"cpu"` where the caller asks for it."""
    device = resolve_device(device)
    K, C, F, M = max_kf, n_cams, max_feat, max_mp
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    return MapState(
        kf_Tcw=torch.eye(4, dtype=f32, device=device).repeat(K, 1, 1),
        kf_valid=full((K,), False, torch.bool),
        kf_frame_id=full((K,), -1, i32),
        kf_xy_und=full((K, C, F, 2), 0.0, f32),
        kf_uright=full((K, C, F), -1.0, f32),
        kf_depth=full((K, C, F), 0.0, f32),
        kf_level=full((K, C, F), 0, i32),
        kf_angle=full((K, C, F), 0.0, f32),
        kf_desc=full((K, C, F, 8), 0, i32),
        kf_feat_valid=full((K, C, F), False, torch.bool),
        kf_mp=full((K, C, F), -1, i32),
        mp_pos=full((M, 3), 0.0, f32),
        mp_valid=full((M,), False, torch.bool),
        mp_desc=full((M, 8), 0, i32),
        mp_descbuf=full((M, DESC_BUF, 8), 0, i32),
        mp_descbuf_n=full((M,), 0, i32),
        mp_normal=full((M, 3), 0.0, f32),
        mp_min_dist=full((M,), 0.0, f32),
        mp_max_dist=full((M,), 0.0, f32),
        mp_first_kf=full((M,), -1, i32),
        mp_first_frame=full((M,), -1, i32),
        mp_visible=full((M,), 0, i32),
        mp_found=full((M,), 0, i32),
        mp_replaced=full((M,), -1, i32),
        n_kf=full((), 0, i32),
        n_mp=full((), 0, i32),
        next_kf_id=full((), 0, i32),
        n_alloc_failed=full((), 0, i32),
    )


def scatter_max_bool(M: int, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """zeros(M, bool).at[idx].max(val): true where any true value lands."""
    out = torch.zeros(M, dtype=torch.int32, device=idx.device)
    out.scatter_reduce_(0, idx.reshape(-1).long(), val.reshape(-1).to(torch.int32),
                        "amax", include_self=True)
    return out > 0


def slot_index(k, device) -> torch.Tensor:
    """A keyframe slot (Python int, 0-dim or 1-element tensor) as a
    1-element int64 index tensor: rows are read with `index_select` and
    written with `x[idx] = ...`, so a slot that lives on the device is
    never read back to the host, and an int is filled in on the device
    (no copy from the host).  Inside the mapping stage the slot is always
    a device tensor."""
    if isinstance(k, torch.Tensor):
        return k.to(device).reshape(1).long()
    return torch.full((1,), int(k), dtype=torch.int64, device=device)


def scatter_set_last(dst: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """1-D `dst.at[idx].set(val)` in which, where an index repeats, the
    update that comes LAST in `idx` wins.

    The reference leaves the winner of a repeated index open; taken in
    order, as its scatter runs on the CPU, the last one stays.  This makes
    that rule explicit and the same on every device and launch."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((dst.shape[0],), -1, dtype=pos.dtype, device=idx.device)
    last.scatter_reduce_(0, idx.long(), pos, "amax", include_self=True)
    return torch.where(last >= 0, val[last.clamp(min=0)], dst)


# ---------------------------------------------------------------------------
# Incidence / covisibility
# ---------------------------------------------------------------------------


def resolve_mp_ids(state: MapState, ids: torch.Tensor) -> torch.Tensor:
    """Follow fusion forward-pointers and drop dead ids."""
    M = state.mp_pos.shape[0]
    neg = torch.full_like(ids, -1)
    fwd = state.mp_replaced[ids.clamp(0, M - 1).long()]
    ids2 = torch.where((ids >= 0) & (fwd >= 0), fwd, ids)
    alive = state.mp_valid[ids2.clamp(0, M - 1).long()]
    return torch.where((ids2 >= 0) & alive, ids2, neg)


def observation_matrix(state: MapState, cam0_only: bool = False) -> torch.Tensor:
    """KF x MP incidence as float [K, M]: 1 where kf k observes point m."""
    M = state.mp_pos.shape[0]
    kf_mp = state.kf_mp[:, :1] if cam0_only else state.kf_mp
    K = kf_mp.shape[0]
    flat = kf_mp.reshape(K, -1)
    valid = flat >= 0
    idx = torch.where(valid, flat, torch.zeros_like(flat)).long()
    O = torch.zeros((K, M), dtype=torch.float32, device=flat.device)
    O.scatter_reduce_(1, idx, valid.to(torch.float32), "amax", include_self=True)
    return O * state.kf_valid[:, None] * state.mp_valid[None, :]


def covisibility(state: MapState, cam0_only: bool = False) -> torch.Tensor:
    """[K, K] shared-observation counts (diag zeroed)."""
    O = observation_matrix(state, cam0_only)
    W = O @ O.T
    return W - torch.diag(torch.diag(W))


def mp_observation_count(state: MapState) -> torch.Tensor:
    """[M] number of keyframe features observing each point."""
    K = state.kf_mp.shape[0]
    M = state.mp_pos.shape[0]
    flat = state.kf_mp.reshape(K, -1)
    valid = (flat >= 0) & state.kf_valid[:, None]
    idx = torch.where(valid, flat, torch.full_like(flat, M - 1)).long()
    cnt = torch.zeros(M, dtype=torch.int32, device=flat.device)
    cnt.index_add_(0, idx.reshape(-1), valid.to(torch.int32).reshape(-1))
    return cnt * state.mp_valid


def mp_weighted_obs(state: MapState) -> torch.Tensor:
    """[M] observation weight: stereo obs count 2, mono 1 (MapPoint::nObs)."""
    K = state.kf_mp.shape[0]
    M = state.mp_pos.shape[0]
    flat = state.kf_mp.reshape(K, -1)
    ur = state.kf_uright.reshape(K, -1)
    valid = (flat >= 0) & state.kf_valid[:, None]
    w = torch.where(ur >= 0, 2, 1).to(torch.int32) * valid.to(torch.int32)
    idx = torch.where(valid, flat, torch.full_like(flat, M - 1)).long()
    cnt = torch.zeros(M, dtype=torch.int32, device=flat.device)
    cnt.index_add_(0, idx.reshape(-1), w.reshape(-1))
    return cnt * state.mp_valid


# ---------------------------------------------------------------------------
# Slot allocation
# ---------------------------------------------------------------------------


def allocate_mp_slots(mp_valid: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """[N] int32 free map-point slots for the wanted requests (-1 if out of
    capacity or not wanted), in slot order.  Slot M-1 is never allocated."""
    M = mp_valid.shape[0]
    dev = mp_valid.device
    occupied = mp_valid.clone()
    occupied[M - 1].fill_(True)   # a fill: no copy from the host
    free = ~occupied
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1
    slot_of_rank = torch.full((M,), -1, dtype=torch.int32, device=dev)
    tgt = torch.where(free, free_rank, torch.full_like(free_rank, M - 1)).long()
    src = torch.where(free, torch.arange(M, dtype=torch.int32, device=dev),
                      torch.full((M,), -1, dtype=torch.int32, device=dev))
    slot_of_rank.index_put_((tgt,), src)
    n_free = free.sum(dtype=torch.int32)
    req_rank = torch.cumsum(want.to(torch.int32), 0) - 1
    ok = want & (req_rank < n_free)
    got = slot_of_rank[req_rank.clamp(0, M - 1).long()]
    return torch.where(ok, got, torch.full_like(got, -1))


# ---------------------------------------------------------------------------
# Map point maintenance
# ---------------------------------------------------------------------------


def update_mp_descriptor(descbuf: torch.Tensor, descbuf_n: torch.Tensor) -> torch.Tensor:
    """Distinctive descriptor per point: min total Hamming to buffer peers."""
    B = descbuf.shape[1]
    x = torch.bitwise_xor(descbuf[:, :, None, :], descbuf[:, None, :, :])
    d = hamming.popcount32(x).sum(dim=-1, dtype=torch.int32)     # [M, B, B]
    slots = torch.arange(B, device=descbuf.device)
    slot_used = slots[None, :] < torch.clamp(descbuf_n[:, None], max=B)
    d = torch.where(slot_used[:, None, :], d, torch.zeros_like(d))
    tot = d.sum(dim=-1, dtype=torch.int32)                       # [M, B]
    tot = torch.where(slot_used, tot, torch.full_like(tot, 1 << 24))
    best = torch.argmin(tot, dim=-1)
    return torch.gather(descbuf, 1, best[:, None, None].expand(-1, 1, 8))[:, 0]


def scale_range_from_obs(dist: torch.Tensor, level: torch.Tensor,
                         scale_factor: float, n_levels: int):
    """(min_dist, max_dist) scale-invariance bounds of an observation."""
    lf = torch.pow(scale_factor, level.to(torch.float32))
    max_d = dist * lf
    min_d = max_d / (scale_factor ** (n_levels - 1))
    return min_d, max_d


@functools.lru_cache(maxsize=None)
def _log_scale(scale_factor: float) -> float:
    """log of the float32 scale factor, taken in float32 (once per value)."""
    return float(torch.log(torch.tensor(scale_factor, dtype=torch.float32)))


def predict_scale(dist: torch.Tensor, max_dist: torch.Tensor,
                  scale_factor: float, n_levels: int) -> torch.Tensor:
    """MapPoint::PredictScale."""
    ratio = torch.clamp(max_dist, min=1e-6) / torch.clamp(dist, min=1e-6)
    lvl = torch.ceil(torch.log(ratio) / _log_scale(scale_factor)).to(torch.int32)
    return torch.clamp(lvl, 0, n_levels - 1)


def relieve_capacity(state: MapState, target_free: int) -> MapState:
    """Evict the weakest map points until >= target_free slots are free.

    Eviction priority is the tracking quality ratio found/visible (lowest
    first, then the lowest slot); points observed by the 12 newest
    keyframes are protected so the active local map is never thinned.
    """
    M = state.mp_pos.shape[0]
    K = state.kf_mp.shape[0]
    dev = state.mp_pos.device
    n_recent = min(12, K)
    fid = torch.where(state.kf_valid, state.kf_frame_id, torch.full_like(state.kf_frame_id, -1))
    _, recent = hamming.top_k(fid, n_recent)
    obs = state.kf_mp[recent].reshape(n_recent, -1)
    ok = (obs >= 0) & state.kf_valid[recent][:, None]
    protected = scatter_max_bool(M, torch.where(ok, obs, torch.full_like(obs, M - 1)), ok)

    ratio = state.mp_found.to(torch.float32) / torch.clamp(
        state.mp_visible.to(torch.float32), min=1.0)
    evictable = state.mp_valid & ~protected
    n_free = (~state.mp_valid).sum(dtype=torch.int32)
    n_needed = torch.clamp(target_free - n_free, min=0)
    prio = torch.where(evictable, -ratio, torch.full_like(ratio, float("-inf")))
    _, order = hamming.top_k(prio, min(target_free, M))
    rank_ok = torch.arange(order.shape[0], device=dev) < n_needed
    hit = rank_ok & evictable[order]
    kill = scatter_max_bool(M, torch.where(hit, order, torch.full_like(order, M - 1)), hit)
    kill[M - 1].fill_(False)   # a fill: no copy from the host
    mp_valid = state.mp_valid & ~kill
    killed_of = kill[state.kf_mp.clamp(0, M - 1).long()] & (state.kf_mp >= 0)
    kf_mp = torch.where(killed_of, torch.full_like(state.kf_mp, -1), state.kf_mp)
    return state._replace(mp_valid=mp_valid, kf_mp=kf_mp,
                          n_mp=state.n_mp - kill.sum(dtype=torch.int32))


def kf_tracked_points(state: MapState, kf_slot, min_obs) -> torch.Tensor:
    """Number of `kf_slot` map points with >= min_obs weighted observations
    (KeyFrame::TrackedMapPoints)."""
    M = state.mp_pos.shape[0]
    w = mp_weighted_obs(state)
    k = torch.as_tensor(kf_slot, device=state.kf_mp.device).long()
    obs = state.kf_mp[k].reshape(-1)
    ok = (obs >= 0) & state.kf_feat_valid[k].reshape(-1)
    g = obs.clamp(0, M - 1).long()
    good = ok & state.mp_valid[g] & (w[g] >= min_obs)
    return good.sum(dtype=torch.int32)


def dedupe_obs_rows(rows: torch.Tensor,
                    prefer_keep: torch.Tensor | None = None) -> torch.Tensor:
    """Keep at most one occurrence of each point id per [..., F] row
    (MapPoint::Replace erases the redundant observation); among duplicates
    the entry with prefer_keep=True wins, then the lowest index."""
    F = rows.shape[-1]
    flat = rows.reshape(-1, F)
    if prefer_keep is None:
        pk = torch.ones_like(flat)
    else:
        pk = prefer_keep.reshape(-1, F).to(torch.int32)
    key = flat * 2 + (1 - pk)
    order = torch.sort(key, dim=1, stable=True)[1]
    sv = torch.gather(flat, 1, order)
    dup_sorted = torch.cat([
        torch.zeros((flat.shape[0], 1), dtype=torch.bool, device=flat.device),
        (sv[:, 1:] == sv[:, :-1]) & (sv[:, 1:] >= 0)], dim=1)
    dup = torch.zeros_like(dup_sorted).scatter_(1, order, dup_sorted)
    return torch.where(dup.reshape(rows.shape), torch.full_like(rows, -1), rows)
