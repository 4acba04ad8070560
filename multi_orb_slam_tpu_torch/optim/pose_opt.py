"""Motion-only bundle adjustment (pose optimization), batched LM.

Counterpart of `multi_orb_slam_tpu/optim/pose_opt.py` (`optimize_pose`):
4 rounds x 10 Levenberg-Marquardt iterations, each round restarting from
the input pose; chi2 gates 5.991 (mono) / 7.815 (stereo) re-classify
inliers between rounds; Huber kernel for rounds 0-1 only.

Control flow stays on the device, with no host sync per iteration:

- the reference's `lax.while_loop` (exit after 10 iterations or two
  no-progress iterations) is a fixed 10-iteration loop that carries an
  `active` flag; an inactive iteration leaves the carry unchanged;
- the 6x6 solve is `torch.linalg.solve_ex`, which skips the error check
  (and its host sync);
- the reference's `settled` `lax.cond` (skip a round whose inlier set
  reached a fixed point) runs the round and selects its input with
  `torch.where` -- the skipped round would reproduce the same pose, so
  the result is identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from . import residuals

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObs(NamedTuple):
    """Flat observation set for one frame (fixed capacity N, masked)."""

    pw: torch.Tensor         # [N, 3] world points
    uvr: torch.Tensor        # [N, 3] (u, v, u_right); u_right < 0 => mono
    cam_idx: torch.Tensor    # [N] int32 camera of each observation
    inv_sigma2: torch.Tensor # [N] information scale (1/sigma^2 of the level)
    mask: torch.Tensor       # [N] bool valid observation


def optimize_pose(Tcw0: torch.Tensor, obs: PoseObs, T_rc: torch.Tensor,
                  K: torch.Tensor, bf: torch.Tensor, n_rounds: int = 4,
                  n_iters: int = 10):
    """Run the 4x10 motion-only BA schedule.

    Returns (Tcw [4,4], inlier_mask [N], n_inliers int32 tensor).
    """
    dev, f32 = Tcw0.device, Tcw0.dtype
    # float32 square roots of the float32 gates, as the reference takes them
    delta_mono = float(np.sqrt(np.float32(CHI2_MONO)))
    delta_stereo = float(np.sqrt(np.float32(CHI2_STEREO)))
    cam = obs.cam_idx.long()
    Trc, Ko = T_rc[cam], K[cam]
    bfo = torch.as_tensor(bf, dtype=f32, device=dev).expand(cam.shape)
    eye6 = 1e-9 * torch.eye(6, dtype=f32, device=dev)

    def residual(Tcw, want_jac):
        e, J, _, is_st, z_ok = residuals.reproj_residual(
            Tcw, obs.pw, Trc, Ko, bfo, obs.uvr, want_jac=want_jac)
        row = residuals.row_weights(is_st, e.dtype)
        chi2 = torch.sum(e * e * row, dim=-1) * obs.inv_sigma2
        return e, J, is_st, obs.mask & z_ok, row, chi2

    def linearize(Tcw, inlier, use_huber):
        e, J, is_st, valid, row, chi2 = residual(Tcw, True)
        act = inlier & valid
        delta = torch.where(is_st, delta_stereo, delta_mono)
        r = torch.sqrt(torch.clamp(chi2, min=1e-12))
        robust = use_huber & (r > delta)
        hw = torch.where(robust, delta / r, torch.ones_like(r))
        w = obs.inv_sigma2 * hw * act.to(e.dtype)
        Jw = J * (row * w[:, None])[..., None]          # [N, 3, 6]
        H = Jw.reshape(-1, 6).T @ J.reshape(-1, 6)
        g = torch.einsum("nri,nr->i", Jw, e)
        rho = torch.where(robust, delta * (2.0 * r - delta), chi2)
        total = torch.sum(torch.where(act, rho, torch.zeros_like(rho)))
        return H, g, total

    def lm_round(Tcw_init, inlier, use_huber):
        H, g, chi2 = linearize(Tcw_init, inlier, use_huber)
        Tcw = Tcw_init
        lam = torch.tensor(1e-3, dtype=f32, device=dev)
        no_prog = torch.tensor(0, dtype=torch.int32, device=dev)
        for _ in range(n_iters):
            active = no_prog < 2
            Hd = H + lam * torch.diag(torch.diag(H)) + eye6
            # solve_ex: no error check, so no host sync (a singular system
            # gives a non-finite step, which the chi2 test then rejects)
            dx = -torch.linalg.solve_ex(Hd, g)[0]
            Tcw_try = se3.exp(dx) @ Tcw
            H_t, g_t, chi2_t = linearize(Tcw_try, inlier, use_huber)
            accept = active & (chi2_t < chi2)
            rel_dec = (chi2 - chi2_t) / torch.clamp(chi2, min=1e-12)
            Tcw = torch.where(accept, Tcw_try, Tcw)
            H = torch.where(accept, H_t, H)
            g = torch.where(accept, g_t, g)
            chi2 = torch.where(accept, chi2_t, chi2)
            lam_new = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
            stall = torch.where(accept, rel_dec < 1e-3, lam_new >= 1e2)
            no_prog_new = torch.where(stall, no_prog + 1, torch.zeros_like(no_prog))
            lam = torch.where(active, lam_new, lam)
            no_prog = torch.where(active, no_prog_new, no_prog)
        return Tcw

    def reclassify(Tcw):
        _, _, is_st, valid, _, chi2 = residual(Tcw, False)
        th = torch.where(is_st, CHI2_STEREO, CHI2_MONO)
        return (chi2 <= th) & valid

    inlier = obs.mask
    Tcw = Tcw0
    settled = torch.tensor(False, device=dev)
    for it in range(n_rounds):
        use_huber = torch.tensor(it < 2, device=dev)
        if it == 2:
            settled = torch.tensor(False, device=dev)
        Tcw = torch.where(settled, Tcw, lm_round(Tcw0, inlier, use_huber))
        new_inlier = torch.where(settled, inlier, reclassify(Tcw))
        settled = settled | torch.all(new_inlier == inlier)
        inlier = new_inlier
    n_inliers = inlier.sum(dtype=torch.int32)
    return Tcw, inlier, n_inliers
