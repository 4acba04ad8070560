"""Distributed global bundle adjustment over a process group.

Counterpart of `multi_orb_slam_tpu/parallel/dist_ba.py`.  Map points and
their observations are sharded over the ranks; each rank builds its local
point system and its part of the camera system, and the reduced Schur camera
system is summed over the ranks with `all_reduce` (the reference's `psum`).
Inside the CG loop the only traffic is one [K, 6] sum per matvec.

Layout (as the reference's):
- `mp_pos` is split along the point axis into equal blocks, one a rank;
  `flatten_problem` groups the observations so that each lies on the rank
  that owns its point.  Observations index points by GLOBAL index (turned
  into the local one inside the step) and poses by global index.
- `kf_Tcw` is replicated; every rank computes the pose update from the same
  summed systems, so the poses are the same bits on every rank.

The math is the reference's `local_step` (matrix-free Schur complement,
block-Jacobi PCG, LM outer loop): the single-process global BA's solver,
`optim/global_ba.schur_lm`, run on the rank's observation rows with each sum
over the ranks an `all_reduce`.  A rank's own sums onto its points and onto
the poses add its rows in one fixed order (`optim/segments.py`: the rows
sorted by point and by pose once a step; pads left out), so a rank gives
the same bits on every call.  The step reads nothing back to the host:
fixed trip counts, accept / reject by `torch.where` on the summed costs,
which every rank holds alike.  Three sums of the reference travel as one
here (the camera system, its gradient and the right-hand side's coupling
term), and so do the two costs: the same sums, fewer collectives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..optim import residuals
from ..optim.global_ba import point_information as global_point_information
from ..optim.global_ba import schur_lm
from .multihost import Mesh, all_reduce_sum, rank_block


class FlatBA(NamedTuple):
    """Flat, shardable BA problem: N observations grouped by the point block
    that owns them, M points, K poses.  `obs_mp` indexes the GLOBAL point
    axis (-1 on a pad); `obs_kf` the replicated pose axis."""

    obs_kf: object      # [N] int32
    obs_cam: object     # [N] int32
    obs_mp: object      # [N] int32 global point index (-1 pad)
    obs_uvr: object     # [N, 3] float32
    obs_is2: object     # [N] float32
    kf_Tcw: object      # [K, 4, 4] float32
    kf_free: object     # [K] bool
    mp_pos: object      # [M, 3] float32
    mp_valid: object    # [M] bool


def flatten_problem(kf_Tcw, kf_valid, kf_free, kf_mp, obs_uvr_grid, obs_is2_grid,
                    mp_pos, mp_valid, n_shards: int) -> FlatBA:
    """Host side: flatten the [K, C, F] observations and group them by the
    point block that owns their map point; each block is padded to the same
    length, a multiple of 128 (pads: `obs_mp = -1`, `obs_is2 = 1`).  Returns
    numpy arrays, the same as the reference's."""
    kf_mp = np.asarray(kf_mp)
    K, C, F = kf_mp.shape
    M = np.asarray(mp_pos).shape[0]
    if M % n_shards:
        raise ValueError(f"point capacity {M} does not divide into {n_shards} shards")
    blk = M // n_shards
    obs_kf = np.repeat(np.arange(K, dtype=np.int32), C * F)
    obs_cam = np.tile(np.repeat(np.arange(C, dtype=np.int32), F), K)
    obs_mp = kf_mp.reshape(-1)
    uvr = np.asarray(obs_uvr_grid).reshape(-1, 3)
    is2 = np.asarray(obs_is2_grid).reshape(-1)
    ok = (obs_mp >= 0) & np.asarray(kf_valid)[obs_kf] & np.asarray(mp_valid)[
        np.clip(obs_mp, 0, M - 1)]

    shard_of = np.where(ok, obs_mp // blk, -1)
    counts = [(shard_of == d).sum() for d in range(n_shards)]
    cap = int(max(max(counts), 1))
    cap = ((cap + 127) // 128) * 128
    N = cap * n_shards
    f_kf = np.zeros(N, np.int32)
    f_cam = np.zeros(N, np.int32)
    f_mp = np.full(N, -1, np.int32)
    f_uvr = np.zeros((N, 3), np.float32)
    f_is2 = np.ones(N, np.float32)
    for d in range(n_shards):
        sel = np.nonzero(shard_of == d)[0]
        base, n = d * cap, len(sel)
        f_kf[base:base + n] = obs_kf[sel]
        f_cam[base:base + n] = obs_cam[sel]
        f_mp[base:base + n] = obs_mp[sel]
        f_uvr[base:base + n] = uvr[sel]
        f_is2[base:base + n] = is2[sel]
    return FlatBA(
        obs_kf=f_kf, obs_cam=f_cam, obs_mp=f_mp, obs_uvr=f_uvr, obs_is2=f_is2,
        kf_Tcw=np.asarray(kf_Tcw, np.float32), kf_free=np.asarray(kf_free, bool),
        mp_pos=np.asarray(mp_pos, np.float32), mp_valid=np.asarray(mp_valid, bool))


def shard_problem(flat: FlatBA, mesh: Mesh) -> FlatBA:
    """This rank's part of a whole problem (numpy or tensors), on its device:
    observation block `[r * N/n, (r + 1) * N/n)`, point block
    `[r * M/n, (r + 1) * M/n)`, the poses whole."""
    def whole(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
        return t.to(mesh.device)

    return FlatBA(
        obs_kf=rank_block(flat.obs_kf, mesh), obs_cam=rank_block(flat.obs_cam, mesh),
        obs_mp=rank_block(flat.obs_mp, mesh), obs_uvr=rank_block(flat.obs_uvr, mesh),
        obs_is2=rank_block(flat.obs_is2, mesh), kf_Tcw=whole(flat.kf_Tcw),
        kf_free=whole(flat.kf_free), mp_pos=rank_block(flat.mp_pos, mesh),
        mp_valid=rank_block(flat.mp_valid, mesh))


def gather_points(pos_local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole [M, 3] point array on every rank: each rank writes its block
    into zeros and the blocks are summed (exact, since x + 0 = x)."""
    Ml = pos_local.shape[0]
    full = torch.zeros((Ml * mesh.world_size,) + pos_local.shape[1:],
                       dtype=pos_local.dtype, device=pos_local.device)
    full[mesh.rank * Ml:(mesh.rank + 1) * Ml] = pos_local
    return all_reduce_sum(full, mesh)


def _rank_rows(flat: FlatBA, rank: int, T_rc, K_intr, bf):
    """This rank's observation rows: (obs_kf, local point index, which rows
    count, `residual_state(Tcw, pos_local, want_jac)` for `schur_lm`)."""
    Ml = flat.mp_pos.shape[0]
    # global -> local point index
    mp_local = flat.obs_mp.long() - rank * Ml
    mp_idx = mp_local.clamp(0, Ml - 1)
    obs_ok = ((flat.obs_mp >= 0) & (mp_local >= 0) & (mp_local < Ml)
              & flat.mp_valid[mp_idx])
    obs_kf = flat.obs_kf.long()
    cam = flat.obs_cam.long()
    T_rc_o, K_o = T_rc[cam], K_intr[cam]

    def residual_state(Tcw_all, pos_local, want_jac):
        return residuals.reproj_residual(
            Tcw_all[obs_kf], pos_local[mp_idx], T_rc_o, K_o, bf, flat.obs_uvr,
            want_jac=want_jac)

    return obs_kf, mp_idx, obs_ok, residual_state


def make_dist_ba_step(mesh: Mesh, n_outer: int = 8, cg_iters: int = 40):
    """The distributed BA step for this rank of the mesh.

    Returns `run(flat_local, T_rc, K_intr, bf) -> (kf_Tcw [K, 4, 4], same on
    every rank; pos_local [M/n, 3], this rank's points; costs [n_outer], the
    robust cost before each outer iteration)`, where `flat_local` is
    `shard_problem`'s.  Every rank must call it with its own part of the same
    problem."""

    def run(flat: FlatBA, T_rc, K_intr, bf):
        obs_kf, mp_idx, obs_ok, residual_state = _rank_rows(flat, mesh.rank, T_rc, K_intr, bf)
        return schur_lm(flat.kf_Tcw, flat.mp_pos, flat.kf_free, flat.mp_valid, obs_kf,
                        mp_idx, obs_ok, flat.obs_is2, residual_state, n_outer, cg_iters,
                        reduce=lambda t: all_reduce_sum(t, mesh))

    return run


def point_information(flat: FlatBA, T_rc, K_intr, bf, kf_Tcw, mp_pos) -> torch.Tensor:
    """[M, 3, 3] H_pp of a whole problem (`shard_problem`'s at world 1) at the
    poses and points given: the blocks the step forms for its Schur
    complement (`global_ba.point_information`)."""
    _, mp_idx, obs_ok, residual_state = _rank_rows(flat, 0, T_rc, K_intr, bf)
    return global_point_information(mp_pos, mp_idx, obs_ok, flat.obs_is2, residual_state,
                                    kf_Tcw)
