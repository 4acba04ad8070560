"""Local bundle adjustment with an explicit Schur complement.

Counterpart of `multi_orb_slam_tpu/optim/local_ba.py` (`BAProblem`,
`solve_ba`): covisible keyframes free, observer keyframes fixed, points
marginalized, dense-batched:

  H_cc (per-KF 6x6 blocks)      <- contraction of J_c^T W J_c over the KF row
  H_pp (per-point 3x3 blocks)   <- reduction of J_p^T W J_p over (L, C)
  W_cp [P, L, 6, 3]             <- reduction of J_c^T W J_p over C
  S = H_cc - sum_p W_cp Hpp^-1 W_cp^T    (one [6L, 3P] x [3P, 6L] product)
  solve dense S dx_c = rhs; back-substitute points.

Schedule: phased Levenberg-Marquardt, `phases = ((iters, huber), ...)`,
with a chi2 re-gate (5.991 mono / 7.815 stereo, positive depth) at each
phase boundary and a final gate that reports the outlier observations.

The one-time re-layout of the observations from feature-indexed [L, C, F]
to point-indexed [L, C, P] rows runs through the `point_sums` kernel
(`ops/kernels.py`): rows r = L*C, values V = [u, v, ur, inv_sigma2].

Control flow: the reference's one `lax.while_loop`, on the device.  The
schedule runs a fixed `n_total` trips (the sum of the phases' iterations:
each live trip advances the iteration `it` by at least 1, so no schedule
needs more).  `it`, the stagnation count `conv` and the damping `lam` are
device tensors; a trip is live while `it < n_total` and the final phase
has not stagnated (`conv < 2` or `it` before the last phase's start), as
the reference's loop condition reads.  A dead trip computes and merges
nothing (`torch.where` on `live`), so the result is the reference's at any
trip count.  The Huber flag, the phase-boundary re-gate and the jump to
the next boundary after an earlier phase stagnates are read from device
tables of the schedule; the re-gate and its cost re-evaluation (a
`lax.cond` in the reference) are computed on every trip that can still
reach a phase boundary, and selected.
The host reads nothing, so the solve can be captured into a CUDA graph
(`local_mapping._mapping_stage_fused`).  The dense solve is
`torch.linalg.solve_ex` (no error check, so no sync; a singular system
gives a non-finite step, which the cost test rejects).

`STATS` counts on the device: `solves` (solves run), `iterations` (live
trips) and `trips` (trips computed, live or dead, over every call).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..ops import kernels
from ..utils import graphs
from . import residuals
from .pose_opt import CHI2_MONO, CHI2_STEREO

# device counters over all solves of this process (read by diagnostics)
STATS = graphs.DeviceCounters()


class BAProblem(NamedTuple):
    """A windowed BA problem with static capacities L (KFs) and P (points).

    Observations stay in the [L, C, F] keyframe-feature layout.
    """

    kf_slot: torch.Tensor     # [L] map KF slot ids (-1 pad)
    kf_Tcw: torch.Tensor      # [L, 4, 4]
    kf_free: torch.Tensor     # [L] bool: pose is optimized
    kf_valid: torch.Tensor    # [L] bool
    mp_slot: torch.Tensor     # [P] map MP slot ids (-1 pad)
    mp_pos: torch.Tensor      # [P, 3]
    mp_valid: torch.Tensor    # [P] bool
    obs_mp: torch.Tensor      # [L, C, F] local point index or -1
    obs_uvr: torch.Tensor     # [L, C, F, 3]
    obs_inv_sigma2: torch.Tensor  # [L, C, F]


def relayout_observations(prob: BAProblem):
    """Feature-indexed [L, C, F] observations -> point-indexed [L, C, P].

    Returns (inv [L, C, P] int32 feature index or -1, obs_ok_f [L, C, F],
    uvr_g [L, C, P, 3] with the mono sentinel [0, 0, -1] at empty slots,
    obs_is2 [L, C, P] with 0 at empty slots).  Requires at most one
    observation of a point per (KF, camera) row (`build_local_problem`
    dedupes); should a row hold two, the higher feature index wins.
    """
    L, C, F = prob.obs_mp.shape
    P = prob.mp_pos.shape[0]
    dev, dtype = prob.mp_pos.device, prob.mp_pos.dtype
    obs_mp_f = prob.obs_mp
    obs_ok_f = ((obs_mp_f >= 0) & prob.kf_valid[:, None, None]
                & prob.mp_valid[obs_mp_f.clamp(0, P - 1).long()])
    pidx = torch.where(obs_ok_f, obs_mp_f, torch.full_like(obs_mp_f, P)).long()
    feat = torch.arange(F, dtype=torch.int32, device=dev).expand(L, C, F)
    inv = torch.full((L, C, P + 1), -1, dtype=torch.int32, device=dev)
    inv.scatter_reduce_(2, pidx, feat, "amax", include_self=True)
    inv = inv[:, :, :P].contiguous()
    V = torch.cat([prob.obs_uvr, prob.obs_inv_sigma2[..., None]], dim=-1)
    _, gathered = kernels.point_sums(
        V.reshape(L * C, F, 4).contiguous(), inv.reshape(L * C, P))
    gathered = gathered.reshape(L, C, P, 4)
    obs_valid = inv >= 0
    mono = torch.zeros(3, dtype=dtype, device=dev)
    mono[2].fill_(-1.0)
    uvr_g = torch.where(obs_valid[..., None], gathered[..., :3], mono)
    return inv, obs_ok_f, uvr_g, gathered[..., 3]


def _inv3(H: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det, det clamped)."""
    a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e_, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A = e_ * i - f * h
    B = c * h - b * i
    Cc = b * f - c * e_
    D = f * g - d * i
    E = a * i - c * g
    Ff = c * d - a * f
    G = d * h - e_ * g
    Hh = b * g - a * h
    I = a * e_ - b * d  # noqa: E741
    det = a * A + b * D + c * G
    det = torch.where(torch.abs(det) > 1e-20, det, torch.full_like(det, 1e-20))
    adj = torch.stack([
        torch.stack([A, B, Cc], -1),
        torch.stack([D, E, Ff], -1),
        torch.stack([G, Hh, I], -1),
    ], -2)
    return adj / det[..., None, None]


def solve_ba(
    prob: BAProblem,
    T_rc: torch.Tensor,    # [C, 4, 4]
    K: torch.Tensor,       # [C, 4]
    bf: torch.Tensor,
    phases: tuple = ((5, True), (10, False)),
    chi2_gate_between: bool = True,
    early_exit_rtol: float = 1e-3,
    run: torch.Tensor | None = None,
):
    """Run the phased LM schedule. Returns (kf_Tcw, mp_pos, obs_inlier).

    obs_inlier [L, C, F]: observations that survived the chi2 gates; the
    caller erases the rest from the map.  `run`, a device bool (default
    true): where false, no trip is live (the result is the start, gated)
    and the solve is not counted; the mapping stage computes its local BA
    on every keyframe and selects it.
    """
    L, C, F = prob.obs_mp.shape
    P = prob.mp_pos.shape[0]
    dtype, dev = prob.mp_pos.dtype, prob.mp_pos.device

    # float32 square roots of the float32 gates, as the reference takes them
    delta_m = float(np.sqrt(np.float32(CHI2_MONO)))
    delta_s = float(np.sqrt(np.float32(CHI2_STEREO)))

    inv, obs_ok_f, uvr_g, obs_is2 = relayout_observations(prob)
    obs_valid = inv >= 0                                   # [L, C, P]
    kf_free_f = prob.kf_free[:, None, None, None, None].to(dtype)
    Tcw_b = lambda T: T[:, None, None]                     # noqa: E731
    Trc_b, K_b = T_rc[None, :, None], K[None, :, None]

    def residual_state(kf_Tcw, mp_pos, want_jac=True):
        """Gather-free residual pass over the [L, C, P] layout: pose
        [L,1,1], extrinsics/intrinsics [1,C,1], points [1,1,P]."""
        return residuals.reproj_residual(
            Tcw_b(kf_Tcw), mp_pos[None, None, :], Trc_b, K_b, bf, uvr_g,
            want_jac=want_jac)

    def chi2_of(e, is_st):
        row = residuals.row_weights(is_st, dtype)
        return torch.sum(e * e * row, dim=-1) * obs_is2

    def huber_on(chi2, is_st, use_huber):
        """(r, delta, robust): the Huber kernel applies where `robust`; the
        flag `use_huber` is a device bool, so a plain phase keeps chi2 and
        a weight of exactly 1.0 (the same bits as no kernel at all)."""
        delta = torch.where(is_st, delta_s, delta_m)
        r = torch.sqrt(torch.clamp(chi2, min=1e-12))
        return r, delta, use_huber & (r > delta)

    def cost_eval(kf_Tcw, mp_pos, active, use_huber):
        """Residual-only robust cost + (chi2, posd): the trial-acceptance
        check, no Jacobians."""
        e, _, _, is_st, posd = residual_state(kf_Tcw, mp_pos, want_jac=False)
        act = active & obs_valid & posd
        chi2 = chi2_of(e, is_st)
        r, delta, robust = huber_on(chi2, is_st, use_huber)
        rho_c = torch.where(robust, delta * (2.0 * r - delta), chi2)
        total = torch.sum(torch.where(act, rho_c, torch.zeros_like(rho_c)))
        return total, chi2, posd

    def linearize(kf_Tcw, mp_pos, active, use_huber):
        """One residual pass -> undamped normal-equation blocks."""
        e, Jc, Jp, is_st, posd = residual_state(kf_Tcw, mp_pos)
        act = active & obs_valid & posd
        row = residuals.row_weights(is_st, dtype)           # [L, C, P, 3]
        w = obs_is2 * act.to(dtype)
        r, delta, robust = huber_on(chi2_of(e, is_st), is_st, use_huber)
        w = w * torch.where(robust, delta / r, torch.ones_like(r))
        Wr = row * w[..., None]                             # [L, C, P, 3]

        Jc_eff = Jc * kf_free_f
        JTc = Jc_eff * Wr[..., None]                        # weighted rows
        CP = C * P
        # H_cc: contraction over the flattened (row, col) axis of 18; the
        # true blocks are the sum of the three row-diagonal 6x6 blocks
        A18 = JTc.reshape(L, CP, 18)
        B18 = Jc_eff.reshape(L, CP, 18)
        H18 = (A18.transpose(1, 2) @ B18).reshape(L, 3, 6, 3, 6)
        Hcc = H18[:, 0, :, 0, :] + H18[:, 1, :, 1, :] + H18[:, 2, :, 2, :]
        bc = torch.einsum("lnri,lnr->li", JTc.reshape(L, CP, 3, 6),
                          e.reshape(L, CP, 3))

        # point blocks: plain reductions over (L, C); the residual-row
        # contraction (extent 3) is unrolled into broadcast products
        JTp = Jp * Wr[..., None]                            # [L, C, P, 3, 3]
        Hpp = torch.sum(residuals.outer_rows(JTp, Jp), dim=(0, 1))
        bp = torch.sum(residuals.jte_rows(JTp, e), dim=(0, 1))  # [P, 3]
        Wcp = torch.sum(residuals.outer_rows(JTc, Jp), dim=1)
        Wcp = Wcp.permute(1, 0, 2, 3)                       # [P, L, 6, 3]
        return Hcc, bc, Hpp, bp, Wcp

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    mp_invalid_eye = torch.where(prob.mp_valid, 0.0, 1.0).to(dtype)[:, None, None] * eye3
    free6 = torch.repeat_interleave(prob.kf_free, 6)
    free66 = free6[:, None] & free6[None, :]
    fixed_diag = torch.diag(torch.where(free6, 0.0, 1.0).to(dtype))
    li = torch.arange(L, device=dev)

    def solve_step(lin, lam):
        Hcc, bc, Hpp, bp, Wcp = lin

        # multiplicative LM damping: scales with each block, keeping the
        # float32 condition number bounded
        def damp(H, eye):
            d = torch.diagonal(H, dim1=-2, dim2=-1)
            tr = torch.sum(d, dim=-1, keepdim=True)
            dd = lam * d + 1e-6 * tr + 1e-9
            return H + dd[..., :, None] * eye

        Hcc_d = damp(Hcc, eye6)
        # invalid points get an identity block so the inverse is defined
        Hpp_inv = _inv3(damp(Hpp, eye3) + mp_invalid_eye)

        # Schur: S = blockdiag(Hcc) - sum_p W_p Hpp_p^-1 W_p^T, with
        # Hpp^-1 = R R^T by a closed-form 3x3 Cholesky (clamped), so the
        # point sum is one product of Y' = W R with itself
        l11 = torch.sqrt(torch.clamp(Hpp_inv[:, 0, 0], min=1e-20))
        l21 = Hpp_inv[:, 1, 0] / l11
        l31 = Hpp_inv[:, 2, 0] / l11
        l22 = torch.sqrt(torch.clamp(Hpp_inv[:, 1, 1] - l21 * l21, min=1e-20))
        l32 = (Hpp_inv[:, 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(torch.clamp(
            Hpp_inv[:, 2, 2] - l31 * l31 - l32 * l32, min=1e-20))
        c0 = (Wcp[..., 0] * l11[:, None, None]
              + Wcp[..., 1] * l21[:, None, None]
              + Wcp[..., 2] * l31[:, None, None])
        c1 = (Wcp[..., 1] * l22[:, None, None]
              + Wcp[..., 2] * l32[:, None, None])
        c2 = Wcp[..., 2] * l33[:, None, None]
        Yc = torch.stack([c0, c1, c2], dim=-1)              # [P, L, 6, 3]
        Yr = Yc.permute(0, 3, 1, 2).reshape(P * 3, L * 6)
        S = -(Yr.T @ Yr)                                    # [L6, L6]
        Wr_flat = Wcp.permute(0, 3, 1, 2).reshape(P * 3, L * 6)
        hb = torch.sum(Hpp_inv * bp[:, None, :], dim=-1)
        S = S.reshape(L, 6, L, 6)
        S[li, :, li, :] += Hcc_d
        S = S.reshape(L * 6, L * 6)
        # gauge: freeze non-free KFs by forcing identity rows
        S = torch.where(free66, S, torch.zeros_like(S)) + fixed_diag
        rhs = bc.reshape(L * 6) - Wr_flat.T @ hb.reshape(P * 3)
        rhs = torch.where(free6, rhs, torch.zeros_like(rhs))

        dxc = -torch.linalg.solve_ex(S, rhs)[0]
        dxc = torch.where(free6, dxc, torch.zeros_like(dxc)).reshape(L, 6)
        WTdx = (Wr_flat @ dxc.reshape(L * 6)).reshape(P, 3)
        dp = -torch.sum(Hpp_inv * (bp + WTdx)[:, None, :], dim=-1)
        dp = dp * prob.mp_valid[:, None]
        return dxc, dp

    # stereo flag / chi2 threshold per observation is state-independent
    th_const = torch.where(uvr_g[..., 2] >= 0, CHI2_STEREO, CHI2_MONO)

    huber_t, gate_t, next_b_t, n_total, last_start = _schedule(
        tuple((int(n), bool(h)) for n, h in phases), bool(chi2_gate_between), dev)
    i64 = torch.int64

    kf_cur, mp_cur = prob.kf_Tcw, prob.mp_pos
    active = obs_valid
    cost, chi2c, posdc = cost_eval(kf_cur, mp_cur, active, huber_t[0])
    lam_reset = torch.full((), 1e-4, dtype=dtype, device=dev)
    lam = lam_reset
    it = torch.zeros((), dtype=i64, device=dev)
    conv = torch.zeros((), dtype=i64, device=dev)
    run = torch.ones((), dtype=torch.bool, device=dev) if run is None else run
    n_live = torch.zeros((), dtype=i64, device=dev)
    # a live trip t has it >= t, so trips past the last gated iteration
    # cannot re-gate: the re-gate is computed on trips up to it only
    last_gate = last_start if chi2_gate_between and len(phases) > 1 else -1
    for trip in range(n_total):
        # the reference's loop condition: stagnation in the FINAL phase
        # ends the schedule (the jump out of an earlier phase is below)
        live = run & (it < n_total) & ((conv < 2) | (it < last_start))
        at = it.clamp(max=max(n_total - 1, 0)).reshape(1)
        use_huber = huber_t.index_select(0, at)[0]
        if trip <= last_gate:
            # phase boundary: re-gate actives from the carried chi2; LM
            # restarts its damping and the stagnation counter, and the
            # carried cost is re-evaluated under the new (mask, kernel)
            regate = live & gate_t.index_select(0, at)[0]
            active = torch.where(regate, obs_valid & (chi2c <= th_const) & posdc, active)
            lam = torch.where(regate, lam_reset, lam)
            conv = torch.where(regate, 0, conv)
            cost = torch.where(regate, cost_eval(kf_cur, mp_cur, active, use_huber)[0], cost)

        dxc, dp = solve_step(linearize(kf_cur, mp_cur, active, use_huber), lam)
        kf_new = se3.exp(dxc) @ kf_cur
        mp_new = mp_cur + dp
        cost_t, chi2_t, posd_t = cost_eval(kf_new, mp_new, active, use_huber)
        accept = live & (cost_t < cost)
        rel_dec = (cost - cost_t) / torch.clamp(cost, min=1e-12)
        kf_cur = torch.where(accept, kf_new, kf_cur)
        mp_cur = torch.where(accept, mp_new, mp_cur)
        cost = torch.where(accept, cost_t, cost)
        chi2c = torch.where(accept, chi2_t, chi2c)
        posdc = torch.where(accept, posd_t, posdc)
        lam_t = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e8)
        # two consecutive no-progress iterations end the phase; a REJECTED
        # step only counts once lambda has grown large
        no_prog = torch.where(accept, rel_dec < early_exit_rtol, lam_t >= 1e2)
        conv_t = torch.where(no_prog, conv + 1, 0)
        jump = (conv_t >= 2) & (it < last_start)
        it = torch.where(live, torch.where(jump, next_b_t.index_select(0, at)[0], it + 1), it)
        conv = torch.where(live, torch.where(jump, 0, conv_t), conv)
        lam = torch.where(live, lam_t, lam)
        n_live = n_live + live.to(i64)
    STATS.add("solves", run)
    STATS.add("iterations", n_live)
    STATS.add("trips", n_total, dev)

    # final inlier gate from the carried chi2 of the last ACCEPTED state,
    # mapped back to the caller's feature-indexed [L, C, F] layout
    active = obs_valid & (chi2c <= th_const) & posdc
    act_f = torch.gather(active, 2, prob.obs_mp.clamp(0, P - 1).long()) & obs_ok_f
    return kf_cur, mp_cur, act_f


@functools.lru_cache(maxsize=None)
def _schedule(phases: tuple, chi2_gate_between: bool, device: torch.device):
    """The LM schedule as device tables, built once per (phases, device)
    with fills: per iteration the Huber flag, the gate-before-iteration
    flag and the next phase boundary; with `n_total` and the last phase's
    first iteration (host ints, static per schedule)."""
    iters_list = [n for n, _ in phases]
    n_total = int(sum(iters_list))
    starts = np.cumsum([0] + iters_list[:-1])
    n = max(n_total, 1)
    huber, gate, next_b = [False] * n, [False] * n, [0] * n
    for ph, (it0, nit) in enumerate(zip(starts, iters_list)):
        for i in range(int(it0), int(it0) + nit):
            huber[i] = phases[ph][1]
            next_b[i] = int(it0) + nit
        if ph > 0 and chi2_gate_between:
            gate[int(it0)] = True
    last_start = int(starts[-1]) if len(starts) else 0
    return (graphs.filled(huber, torch.bool, device), graphs.filled(gate, torch.bool, device),
            graphs.filled(next_b, torch.int64, device), n_total, last_start)
