"""Sim3 RANSAC between two keyframes, batched hypotheses, and the guided
Sim3 search.

Counterpart of `multi_orb_slam_tpu/loop/sim3_solver.py` (which replaces
`Sim3Solver`, src/Sim3Solver.cc, and `ORBmatcher::SearchBySim3`): every
hypothesis is generated and scored in one batch, with weighted Umeyama for
the closed form and a camera-aware reprojection inlier check in both
directions.

The RANSAC is split where the random numbers enter: `sample_triplets` (the
relocalizer's sampler) draws the [H, 3] minimal sets from a
`torch.Generator`, `solve_sim3` takes them.  The reference draws them from a
JAX key; the two generators give other numbers from the same seed, so a
comparison hands both solvers the same triplets.

`search_by_sim3` runs its two directions as ONE `window_match` launch with a
"camera" per direction.

Both are `graphs.graphed`, as the reference jits them (`solve_sim3_ransac`
with its draws, `search_by_sim3` with `static_argnums=(5, 6, 7, 8)`): one
CUDA graph replay a call on the card.  The draws stay outside the graph; the
two keyframe slots of `search_by_sim3` are traced, so every candidate
replays one entry.  The closed form is `align.umeyama_quat`, which needs no
SVD (`torch.linalg.svd` reads its convergence flags back to the host, which
a capture refuses).
"""

from __future__ import annotations

import torch

from ..geometry import align, camera as cam_mod, se3, sim3
from ..mapping import map_state as ms
from ..ops import hamming, kernels, orb
from ..reloc.pnp import sample_triplets
from ..utils import graphs

N_HYP = 128


@graphs.graphed(static_argnames=("fix_scale", "sigma2_px"))
def solve_sim3(
    tri: torch.Tensor,      # [H, 3] minimal sets (indices into N)
    pts_a: torch.Tensor,    # [N, 3] matched points in frame-a rig coords
    pts_b: torch.Tensor,    # [N, 3] same landmarks in frame-b rig coords
    cam_a: torch.Tensor,    # [N] camera id of the observation in a
    cam_b: torch.Tensor,    # [N] camera id in b
    valid: torch.Tensor,    # [N]
    T_rc: torch.Tensor,     # [C, 4, 4]
    K: torch.Tensor,        # [C, 4]
    fix_scale: bool = True,
    sigma2_px: float = 10.0,
):
    """Returns (g_ab [8] Sim3 mapping b->a, inlier_mask [N], n_inliers
    int32 tensor).  Inlier: both-direction reprojection error below
    9.210 * sigma2_px in the observing camera, in front of it."""
    N = pts_a.shape[0]
    s, R, t = align.umeyama_quat(pts_b[tri], pts_a[tri], with_scale=not fix_scale)
    g = sim3.pack(s, R, t)  # [H, 8] b -> a
    ca, cb = cam_a.long(), cam_b.long()

    def project_into(X, cams):
        Trc = T_rc[cams]
        Xc = (Trc[..., :3, :3] @ X[..., None])[..., 0] + Trc[..., :3, 3]
        return cam_mod.project(K[cams], Xc), Xc[..., 2] > 0.05

    uv_a, _ = project_into(pts_a, ca)
    uv_b, _ = project_into(pts_b, cb)
    th2 = 9.210 * sigma2_px

    def score(g_ab):
        """g_ab [..., 8] -> (n_inliers [...], inliers [..., N])."""
        lead = g_ab.shape[:-1]
        rep = g_ab[..., None, :].expand(lead + (N, 8))
        uv_ab, oka = project_into(sim3.apply(rep, pts_b.expand(lead + (N, 3))), ca)
        uv_ba, okb = project_into(
            sim3.apply(sim3.inverse(rep), pts_a.expand(lead + (N, 3))), cb)
        e_ab = torch.sum((uv_ab - uv_a) ** 2, -1)
        e_ba = torch.sum((uv_ba - uv_b) ** 2, -1)
        inl = valid & (e_ab < th2) & (e_ba < th2) & oka & okb
        return inl.sum(dim=-1, dtype=torch.int32), inl

    n_inl, inls = score(g)
    # first maximum, as `jnp.argmax`; rows taken with `index_select` (indexing
    # with a 0-dim tensor would read it back to the host)
    best = hamming.first_argmin(-n_inl, dim=0).reshape(1)
    g_best, inl_best, n_best = (x.index_select(0, best)[0] for x in (g, inls, n_inl))
    # refine on all inliers (closed form again)
    s2, R2, t2 = align.umeyama_quat(pts_b, pts_a, weights=inl_best.to(pts_a.dtype),
                               with_scale=not fix_scale)
    g_ref = sim3.pack(s2, R2, t2)
    n2, inl2 = score(g_ref)
    better = n2 >= n_best
    return (torch.where(better, g_ref, g_best), torch.where(better, inl2, inl_best),
            torch.maximum(n2, n_best))


def solve_sim3_ransac(generator: torch.Generator, pts_a: torch.Tensor, pts_b: torch.Tensor,
                      cam_a: torch.Tensor, cam_b: torch.Tensor, valid: torch.Tensor,
                      T_rc: torch.Tensor, K: torch.Tensor, n_hyp: int = N_HYP,
                      fix_scale: bool = True, sigma2_px: float = 10.0):
    """The reference's entry point with a `torch.Generator` in place of its
    key: `n_hyp` minimal sets drawn (`sample_triplets`), then `solve_sim3`."""
    tri = sample_triplets(valid, n_hyp, generator)
    return solve_sim3(tri, pts_a, pts_b, cam_a, cam_b, valid, T_rc, K, fix_scale, sigma2_px)


@graphs.graphed(static_argnames=("max_mp", "scale_factor", "n_levels", "th"))
def search_by_sim3(
    state: ms.MapState,
    kf_a: int,
    kf_b: int,
    g_ab: torch.Tensor,      # [8] Sim3 mapping b-rig -> a-rig
    K0: torch.Tensor,        # [4] camera-0 intrinsics
    max_mp: int,
    scale_factor: float,
    n_levels: int,
    th: float = 7.5,
) -> torch.Tensor:
    """Match-producing guided search between two keyframes under a Sim3
    (`ORBmatcher::SearchBySim3`): project each keyframe's landmarks into
    the other through g_ab, gate by a scale-predicted window and pyramid
    level, take the best Hamming match between landmark descriptors, and
    keep mutually agreeing pairs.

    One `window_match` launch, C = 2: row 0 holds b's landmarks as queries
    against a's camera-0 features (with the descriptors of a's landmarks),
    row 1 the reverse.  An invalid landmark gets a negative radius, an
    invalid feature a false mask; the stereo gate is off.  TH_HIGH and the
    mutual check follow the kernel.

    Returns match_ab [F] int32: for each camera-0 feature of kf_a with a
    landmark, the matched feature index of kf_b, or -1.
    """
    F = state.kf_mp.shape[2]
    M = max_mp
    dev = state.mp_pos.device
    f32, i32 = torch.float32, torch.int32
    sf = orb.scale_table(scale_factor, n_levels, dev)
    ra, rb = ms.slot_index(kf_a, dev), ms.slot_index(kf_b, dev)

    def row(a, r):
        # a keyframe's row; `index_select`, as the slot may live on the device
        return a.index_select(0, r)[0]

    mpa = row(state.kf_mp, ra)[0]
    mpb = row(state.kf_mp, rb)[0]
    ga = mpa.clamp(0, M - 1).long()
    gb = mpb.clamp(0, M - 1).long()
    va = (mpa >= 0) & row(state.kf_feat_valid, ra)[0] & state.mp_valid[ga]
    vb = (mpb >= 0) & row(state.kf_feat_valid, rb)[0] & state.mp_valid[gb]

    Xa = se3.transform_points(row(state.kf_Tcw, ra), state.mp_pos[ga])   # a landmarks, a-rig
    Xb = se3.transform_points(row(state.kf_Tcw, rb), state.mp_pos[gb])   # b landmarks, b-rig
    Xb_in_a = sim3.apply(g_ab, Xb)
    Xa_in_b = sim3.apply(sim3.inverse(g_ab), Xa)

    def query(X, max_dist, v):
        """(uv, radius, lowest level, highest level) of projected landmarks."""
        z = torch.clamp(X[:, 2], min=1e-6)
        uv = torch.stack([K0[0] * X[:, 0] / z + K0[2], K0[1] * X[:, 1] / z + K0[3]], -1)
        lvl = ms.predict_scale(torch.linalg.norm(X, dim=-1), max_dist, scale_factor, n_levels)
        rad = torch.where(v & (X[:, 2] > 0.05), th * sf[lvl.long()], -1.0)
        return uv, rad, lvl - 1, lvl

    # row 0: b's landmarks into a (b -> a); row 1: a's landmarks into b
    q0 = query(Xb_in_a, state.mp_max_dist[gb], vb)
    q1 = query(Xa_in_b, state.mp_max_dist[ga], va)
    q_uv, q_rad, q_lmin, q_lmax = (torch.stack([x0, x1]).contiguous()
                                   for x0, x1 in zip(q0, q1))
    desc_a, desc_b = state.mp_desc[ga], state.mp_desc[gb]
    bi, bd, _, _ = kernels.window_match(
        q_uv, q_rad, q_lmin.to(i32), q_lmax.to(i32),
        torch.full((2, F), -1e9, dtype=f32, device=dev),
        torch.stack([desc_b, desc_a]).contiguous(),
        torch.stack([row(state.kf_xy_und, ra)[0], row(state.kf_xy_und, rb)[0]]).contiguous(),
        torch.full((2, F), -1.0, dtype=f32, device=dev),
        torch.stack([row(state.kf_level, ra)[0], row(state.kf_level, rb)[0]]).contiguous(),
        torch.stack([va, vb]).contiguous(),
        torch.stack([desc_a, desc_b]).contiguous())
    best_a_of_b, best_b_of_a = bi[0].long(), bi[1].long()
    ok_ba = bd[0] <= hamming.TH_HIGH
    ok_ab = bd[1] <= hamming.TH_HIGH
    # mutual agreement (reference: vnMatch1[i1]==i2 && vnMatch2[i2]==i1)
    ja = torch.arange(F, device=dev)
    agree = ok_ab & ok_ba[best_b_of_a] & (best_a_of_b[best_b_of_a] == ja)
    return torch.where(agree, best_b_of_a.to(i32), -1)
