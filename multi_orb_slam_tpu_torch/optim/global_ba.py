"""Global bundle adjustment, matrix-free Schur complement + preconditioned CG.

Counterpart of `multi_orb_slam_tpu/optim/global_ba.py` (which replaces
`Optimizer::GlobalBundleAdjustemnt`): every keyframe free but the first, every
point marginalized.  The reduced camera system

    S dx = (H_cc - W H_pp^-1 W^T) dx

is applied matrix-free: each matvec gathers pose blocks to the observations,
sums U_n^T x onto the points, applies H_pp^-1, and sums back onto the poses;
block-Jacobi preconditioned CG solves it (60 iterations).

Every sum of a solve adds its rows in one fixed order (`optim/segments.py`,
the reference's `.at[].add`): onto the points by a stable sort of the rows'
point index, built once a solve before the LM loop, and a segment sum in
ascending row order; onto the poses, whose rows are the [K, C, F] grid, as
a sum over each keyframe's block.  No sum adds with atomics, so one input
gives the same bits on every call, on the card as on the CPU (card and CPU
agree to a tolerance: they add in other orders).

`dispatch_global_ba` only enqueues work on the device: it reads nothing back
to the host.  To that end the 3x3 point inverses are closed form, the 6x6
preconditioner is `torch.linalg.inv_ex` (no error check), the annealed
gate's quantile is a sort and a written-out linear interpolation, and the
loops have fixed trip counts with accept / reject as `torch.where`.

`run_global_ba_arrays` is `graphs.graphed` (`cfg` and `n_outer` static, as
the reference's `run_global_ba_jit`): `dispatch_global_ba` enqueues it as
one CUDA graph replay on the current stream, and its outputs are the
caller's own copies, which the next replay does not overwrite.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SlamConfig, inv_sigma2_of_level
from ..geometry import se3
from ..utils import graphs
from . import residuals
from .pose_opt import CHI2_MONO, CHI2_STEREO
from .segments import Segments

CG_ITERS = 60


def _damp_blocks(H, lam):
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    tr = torch.sum(d, dim=-1, keepdim=True)
    dd = lam * d + 1e-6 * tr + 1e-9
    return H + torch.diag_embed(dd)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices by the adjugate (no error check)."""
    c0 = torch.cross(A[..., 1, :], A[..., 2, :], dim=-1)
    c1 = torch.cross(A[..., 2, :], A[..., 0, :], dim=-1)
    c2 = torch.cross(A[..., 0, :], A[..., 1, :], dim=-1)
    det = torch.sum(A[..., 0, :] * c0, dim=-1)
    return torch.stack([c0, c1, c2], dim=-1) / det[..., None, None]


# float32 square roots of the float32 gates, as the reference takes them
_DELTA_MONO = float(np.sqrt(np.float32(CHI2_MONO)))
_DELTA_STEREO = float(np.sqrt(np.float32(CHI2_STEREO)))


def _robust_rows(e, is_st, posd, obs_ok, obs_is2):
    """Per observation row: (active, row weights [N, 3], chi2, Huber delta,
    the rows' information weights Wr [N, 3] with the Huber weight in)."""
    dtype = e.dtype
    act = obs_ok & posd
    row = residuals.row_weights(is_st, dtype)
    chi2 = torch.sum(e * e * row, -1) * obs_is2
    delta = torch.where(is_st, _DELTA_STEREO, _DELTA_MONO)
    r = torch.sqrt(torch.clamp(chi2, min=1e-12))
    hw = torch.where(r > delta, delta / r, 1.0)
    Wr = row * (obs_is2 * hw * act.to(dtype))[:, None]
    return act, row, chi2, delta, Wr


def _point_blocks(to_mp: Segments, Jp, Wr):
    """H_pp [M, 3, 3]: each point's sum of J_p^T W J_p over its rows."""
    JTpW = Jp * Wr[:, :, None]
    return to_mp.sum(residuals.outer_rows(JTpW, Jp)), JTpW


def point_information(mp_pos, mp_idx, obs_ok, obs_is2, residual_state, kf_Tcw):
    """The undamped 3x3 blocks H_pp that `schur_lm` forms for its Schur
    complement, at the poses `kf_Tcw` and points `mp_pos` given (with the
    Huber weights of those residuals): each point's information, whose
    smallest eigenvalue says how well the observations fix it."""
    e, _, Jp, is_st, posd = residual_state(kf_Tcw, mp_pos, True)
    Wr = _robust_rows(e, is_st, posd, obs_ok, obs_is2)[-1]
    return _point_blocks(Segments.of_index(mp_idx, mp_pos.shape[0], obs_ok), Jp, Wr)[0]


def schur_lm(kf_Tcw, mp_pos, kf_free, mp_valid, obs_kf, mp_idx, obs_ok, obs_is2,
             residual_state, n_outer, cg_iters, reduce=lambda t: t, to_kf=None):
    """The LM outer loop over the matrix-free Schur complement, on N flat
    observation rows: Huber weights, the point system (local: a point's
    observations are all in this call), the camera system and right-hand
    side, block-Jacobi PCG for the pose update, back-substitution of the
    points, accept / reject on the robust cost.

    `obs_kf` [N] indexes the K poses, `mp_idx` [N] the points `mp_pos`
    holds; `residual_state(Tcw, pos, want_jac)` returns the rows' (e [N, 3],
    Jc, Jp, is_st [N], posd [N]).  Sums onto the points go through a
    `Segments` of `mp_idx` over the rows in `obs_ok` (rows outside it add
    zeros), built here once; sums onto the poses through `to_kf`, or else a
    `Segments` of `obs_kf` built the same way.  `reduce` sums a tensor over
    the processes that hold the other points (the distributed BA's
    `all_reduce`; the identity for one process): the camera system with its
    gradient and coupling term in one call, one call per matvec, the two
    costs in one.
    Returns (Tcw, pos, costs [n_outer], the cost before each iteration)."""
    K, M = kf_Tcw.shape[0], mp_pos.shape[0]
    dev, dtype = mp_pos.device, mp_pos.dtype
    free_f = kf_free.to(dtype)
    free_o = free_f[obs_kf][:, None, None]
    pad_pts = torch.where(mp_valid, 0.0, 1.0)[:, None, None] * torch.eye(3, dtype=dtype, device=dev)
    pad_kfs = torch.where(kf_free, 0.0, 1.0)[:, None, None] * torch.eye(6, dtype=dtype, device=dev)
    # the rows' fixed order of summation, the same for every iteration
    to_mp = Segments.of_index(mp_idx, M, obs_ok)
    if to_kf is None:
        to_kf = Segments.of_index(obs_kf, K, obs_ok)

    def rho(c2, delta):
        r = torch.sqrt(torch.clamp(c2, min=1e-12))
        return torch.where(r > delta, delta * (2 * r - delta), c2)

    Tcw_all, pos_all = kf_Tcw, mp_pos
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    costs = []
    for _ in range(n_outer):
        e, Jc, Jp, is_st, posd = residual_state(Tcw_all, pos_all, True)
        act, row, chi2, delta, Wr = _robust_rows(e, is_st, posd, obs_ok, obs_is2)

        Jc_eff = Jc * free_o
        JTcW = Jc_eff * Wr[:, :, None]
        Hpp, JTpW = _point_blocks(to_mp, Jp, Wr)
        bp = to_mp.sum(residuals.jte_rows(JTpW, e))
        # per-observation camera-point coupling block U_n [6, 3]
        U = residuals.outer_rows(JTcW, Jp)
        Hpp_inv = inv3(_damp_blocks(Hpp, lam) + pad_pts)
        zb = residuals.bmv(Hpp_inv, bp)

        # Hcc, bc and W Hpp^-1 bp, summed over the processes in one call
        sysc = reduce(to_kf.sum(torch.cat([
            residuals.outer_rows(JTcW, Jc_eff).reshape(-1, 36),
            residuals.jte_rows(JTcW, e),
            residuals.bmv(U, zb[mp_idx])], dim=1)))
        Hcc_d = _damp_blocks(sysc[:, :36].reshape(K, 6, 6), lam)
        rhs = (sysc[:, 36:42] - sysc[:, 42:]) * free_f[:, None]

        def S_matvec(x):  # x [K, 6]
            y = to_mp.sum(residuals.bmtv(U, x[obs_kf]))     # sum U^T x -> [M, 3]
            z = residuals.bmv(Hpp_inv, y)
            WHWx = reduce(to_kf.sum(residuals.bmv(U, z[mp_idx])))   # sum U z -> [K, 6]
            return (residuals.bmv(Hcc_d, x) - WHWx) * free_f[:, None]

        # block-Jacobi preconditioner from the damped Hcc
        Pinv = torch.linalg.inv_ex(Hcc_d + pad_kfs)[0]

        def precond(v):
            return residuals.bmv(Pinv, v) * free_f[:, None]

        # PCG for S dx = -rhs
        x = torch.zeros((K, 6), dtype=dtype, device=dev)
        rr = -rhs
        p = precond(rr)
        rz = torch.sum(rr * p)
        for _ in range(cg_iters):
            Sp = S_matvec(p)
            pSp = torch.sum(p * Sp)
            alpha = rz / torch.where(torch.abs(pSp) < 1e-20, 1e-20, pSp)
            x = x + alpha * p
            rr = rr - alpha * Sp
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = rz_new / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
            p = z + beta * p
            rz = rz_new
        dxc = x * free_f[:, None]

        # back-substitute points: dp = -Hpp_inv (bp + W^T dxc)
        WTdx = to_mp.sum(residuals.bmtv(U, dxc[obs_kf]))
        dp = -residuals.bmv(Hpp_inv, bp + WTdx) * mp_valid[:, None]

        Tcw_new = se3.exp(dxc) @ Tcw_all
        pos_new = pos_all + dp
        e2, _, _, _, posd2 = residual_state(Tcw_new, pos_new, False)
        chi2n = torch.sum(e2 * e2 * row, -1) * obs_is2
        tot = reduce(torch.stack([
            torch.sum(torch.where(obs_ok & posd2, rho(chi2n, delta), 0.0)),
            torch.sum(torch.where(act, rho(chi2, delta), 0.0))]))
        tot_new, tot_old = tot[0], tot[1]
        accept = tot_new < tot_old
        Tcw_all = torch.where(accept, Tcw_new, Tcw_all)
        pos_all = torch.where(accept, pos_new, pos_all)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
        costs.append(tot_old)
    return Tcw_all, pos_all, torch.stack(costs)


def _flat_problem(kf_valid, kf_mp, obs_uvr, mp_valid, T_rc, K_intr, bf):
    """The [K, C, F] observations as N flat rows: (obs_kf [N], mp_idx [N],
    obs_ok [N], residual_state(Tcw, pos, want_jac) as `schur_lm` takes it)."""
    K, C, F = kf_mp.shape
    M = mp_valid.shape[0]
    N = K * C * F
    dev = kf_mp.device
    obs_kf = torch.arange(K, device=dev)[:, None, None].expand(K, C, F).reshape(N)
    obs_mp = kf_mp.reshape(N)
    uvr = obs_uvr.reshape(K, C, F, 3)
    mp_idx = obs_mp.clamp(0, M - 1).long()
    obs_ok = (obs_mp >= 0) & kf_valid[obs_kf] & mp_valid[mp_idx]

    def residual_state(Tcw_all, pos_all, want_jac):
        # pose and extrinsic enter as [K,1,1] / [1,C,1] broadcasts over
        # the [K, C, F] layout
        e, Jc, Jp, is_st, posd = residuals.reproj_residual(
            Tcw_all[:, None, None], pos_all[mp_idx].reshape(K, C, F, 3),
            T_rc[None, :, None], K_intr[None, :, None], bf, uvr, want_jac=want_jac)
        if want_jac:
            Jc, Jp = Jc.reshape(N, 3, 6), Jp.reshape(N, 3, 3)
        return e.reshape(N, 3), Jc, Jp, is_st.reshape(N), posd.reshape(N)

    return obs_kf, mp_idx, obs_ok, residual_state


def make_global_ba(cfg: SlamConfig):
    """The global BA function for a configuration: `step(kf_Tcw, kf_valid,
    kf_free, kf_mp, obs_uvr, obs_is2, mp_pos, mp_valid, T_rc, K_intr, bf,
    n_outer, cg_iters)` -> (Tcw, pos)."""

    def step(kf_Tcw, kf_valid, kf_free, kf_mp, obs_uvr, obs_is2,
             mp_pos, mp_valid, T_rc, K_intr, bf, n_outer, cg_iters):
        obs_kf, mp_idx, obs_ok, residual_state = _flat_problem(
            kf_valid, kf_mp, obs_uvr, mp_valid, T_rc, K_intr, bf)
        K, C, F = kf_mp.shape
        Tcw, pos, _ = schur_lm(kf_Tcw, mp_pos, kf_free, mp_valid, obs_kf, mp_idx, obs_ok,
                               obs_is2.reshape(-1), residual_state, n_outer, cg_iters,
                               to_kf=Segments.blocks(K, C * F))
        return Tcw, pos

    return step


def map_point_information(state_arrays, calib_arrays, kf_Tcw, mp_pos) -> torch.Tensor:
    """[M, 3, 3] H_pp of the global BA's problem on `global_ba_arrays`'
    (state_arrays, calib_arrays), every valid observation Huber-weighted, at
    the poses and points given: how well the observations fix each point
    (`point_information`), the metric to hold two solutions' points in."""
    (_, kf_valid, kf_mp, obs_uvr, obs_is2, _, mp_valid) = state_arrays
    _, mp_idx, obs_ok, residual_state = _flat_problem(kf_valid, kf_mp, obs_uvr, mp_valid,
                                                      *calib_arrays)
    return point_information(mp_pos, mp_idx, obs_ok, obs_is2.reshape(-1), residual_state,
                             kf_Tcw)


def sorted_quantile(c: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """`jnp.quantile(c, q)` (linear interpolation) of a 1-D tensor for a
    0-dim tensor q, with no host read: sort, then the two neighbours of
    position q * (n - 1) weighted as the reference weighs them.  NaN if any
    entry is NaN."""
    n = c.shape[0]
    srt = torch.sort(c).values
    pos = q * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    w_high = pos - low
    w_low = 1.0 - w_high
    # index_select with a 1-element index: indexing with a 0-dim tensor
    # would read it back to the host
    lo = srt.index_select(0, low.clamp(0, n - 1).long().reshape(1))[0]
    hi = srt.index_select(0, high.clamp(0, n - 1).long().reshape(1))[0]
    out = lo * w_low + hi * w_high
    return torch.where(torch.isnan(c).any(), float("nan"), out)


def _chi2_gate(kf_Tcw, kf_mp, obs_uvr, obs_is2, mp_pos, T_rc, K_intr, bf,
               scale=1.0, keep_frac=None):
    K, C, F = kf_mp.shape
    M = mp_pos.shape[0]
    N = K * C * F
    mp_idx = kf_mp.reshape(N).clamp(0, M - 1).long()
    e, _, _, is_st, posd = residuals.reproj_residual(
        kf_Tcw[:, None, None], mp_pos[mp_idx].reshape(K, C, F, 3),
        T_rc[None, :, None], K_intr[None, :, None], bf,
        obs_uvr.reshape(K, C, F, 3), want_jac=False)
    e, is_st, posd = e.reshape(N, 3), is_st.reshape(N), posd.reshape(N)
    row = residuals.row_weights(is_st, e.dtype)
    chi2 = torch.sum(e * e * row, -1) * obs_is2.reshape(N)
    th = torch.where(is_st, CHI2_STEREO, CHI2_MONO) * scale
    if keep_frac is not None:
        # never drop more than (1 - keep_frac) of the valid observations:
        # early stages must not mistake a large initial perturbation for
        # outliers (the threshold floors at the keep_frac quantile)
        valid = kf_mp.reshape(N) >= 0
        c = torch.where(valid, chi2, -1.0)
        q = 1.0 - (1.0 - keep_frac) * torch.mean(valid.to(chi2.dtype))
        th = torch.maximum(th, sorted_quantile(c, q))
    return ((chi2 <= th) & posd).reshape(K, C, F)


@graphs.graphed(static_argnames=("cfg", "n_outer"))
def run_global_ba_arrays(state_arrays, calib_arrays, kf_free, cfg: SlamConfig,
                         n_outer: int = 10):
    """The annealed global BA on plain arrays: before each of three stages
    the observations are re-gated at the CURRENT state with a loosening ->
    strict chi2 scale (64, 8, 1; the first two floored at the 98% and 97%
    quantiles), then `n_outer // 3`, `n_outer // 3` and the rest of the
    outer LM iterations run."""
    (kf_Tcw, kf_valid, kf_mp, obs_uvr, obs_is2, mp_pos, mp_valid) = state_arrays
    (T_rc, K_intr, bf) = calib_arrays
    fn = make_global_ba(cfg)
    Tcw, pos = kf_Tcw, mp_pos
    stages = [(64.0, 0.98, max(n_outer // 3, 1)),
              (8.0, 0.97, max(n_outer // 3, 1)),
              (1.0, None, max(n_outer - 2 * (n_outer // 3), 1))]
    for scale, keep_frac, iters in stages:
        gate = _chi2_gate(Tcw, kf_mp, obs_uvr, obs_is2, pos,
                          T_rc, K_intr, bf, scale=scale, keep_frac=keep_frac)
        Tcw, pos = fn(Tcw, kf_valid, kf_free, torch.where(gate, kf_mp, -1),
                      obs_uvr, obs_is2, pos, mp_valid, T_rc, K_intr, bf,
                      iters, CG_ITERS)
    return Tcw, pos


def run_global_ba_jit(state_arrays, calib_arrays, free_spec, cfg: SlamConfig,
                      n_outer: int = 10):
    """The reference's name and signature for `run_global_ba_arrays`
    (`free_spec` is the [K] free-keyframe mask)."""
    return run_global_ba_arrays(state_arrays, calib_arrays, free_spec, cfg, n_outer)


def global_ba_arrays(state, calib, cfg: SlamConfig):
    """`run_global_ba_arrays`' (state_arrays, calib_arrays, kf_free) of a
    map: every valid keyframe free but slot 0, invalid feature slots masked
    out of the problem."""
    K = state.kf_valid.shape[0]
    kf_free = state.kf_valid & (torch.arange(K, device=state.kf_valid.device) != 0)
    obs_uvr = torch.cat([state.kf_xy_und, state.kf_uright[..., None]], dim=-1)
    obs_is2 = inv_sigma2_of_level(state.kf_level, cfg)
    kf_mp = torch.where(state.kf_feat_valid, state.kf_mp, -1)
    return ((state.kf_Tcw, state.kf_valid, kf_mp, obs_uvr, obs_is2, state.mp_pos,
             state.mp_valid), (calib.T_rc, calib.K, calib.bf), kf_free)


def dispatch_global_ba(state, calib, cfg: SlamConfig, n_outer: int = 10):
    """Enqueue full-map BA on the device; return (kf_Tcw, mp_pos), which
    the device fills in later.  No host read: the caller keeps working
    against the old map and folds these in later
    (`LoopCloser.merge_pending_gba`), the counterpart of the reference's
    GBA thread (src/LoopClosing.cc:812)."""
    return run_global_ba_arrays(*global_ba_arrays(state, calib, cfg), cfg, n_outer)


def run_global_ba(state, calib, cfg: SlamConfig, n_outer: int = 10):
    """Full-map BA (the reference's GBA: first keyframe fixed).  Returns the
    updated MapState."""
    Tcw, pos = dispatch_global_ba(state, calib, cfg, n_outer)
    return state._replace(kf_Tcw=Tcw, mp_pos=pos)
