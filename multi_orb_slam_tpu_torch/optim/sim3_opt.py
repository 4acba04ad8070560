"""Sim3-pair optimization: gated LM refinement of a loop-closure transform.

Counterpart of `multi_orb_slam_tpu/optim/sim3_opt.py` (which replaces
`Optimizer::OptimizeSim3[_cam1]`): one Sim3 vertex g_ab relating two
keyframes, two families of reprojection edges

  e1_i = uv_a_i - proj( g_ab  (X_b_i) )     (b's landmark seen in a)
  e2_i = uv_b_i - proj( g_ab^-1 (X_a_i) )   (a's landmark seen in b)

with per-level information and Huber kernels, on the reference's schedule: 5
LM iterations, drop correspondences whose e1 OR e2 chi2 exceeds 10, then 10
more iterations without the kernel, and count the surviving inliers.

Fixed-capacity [N] edge arrays with masks, Jacobians by forward-mode autodiff
of the 7-dof tangent (`sim3.jacfwd_batched`) (scale frozen for stereo / RGB-D), the 7x7 normal
system solved with `torch.linalg.solve_ex` (no host synchronisation); the
iterations are a fixed loop whose accept / reject is a `torch.where`.
`optimize_sim3` is `graphs.graphed` (`fix_scale` and the two trip counts
static, as the reference jits it): one CUDA graph replay a call on the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import sim3
from ..utils import graphs

CHI2_TH = 10.0  # reference th2, Optimizer.cc:2149


class Sim3Obs(NamedTuple):
    """Fixed-capacity correspondence set between two keyframes.

    X_a / X_b are the SAME physical landmark's positions in each keyframe's
    rig (camera-0) coordinates; uv_a / uv_b the matched feature positions.
    `cam_a` / `cam_b` are the observing camera of each feature (None means
    all camera 0).
    """

    X_a: torch.Tensor          # [N, 3]
    X_b: torch.Tensor          # [N, 3]
    uv_a: torch.Tensor         # [N, 2]
    uv_b: torch.Tensor         # [N, 2]
    inv_sigma2_a: torch.Tensor # [N]
    inv_sigma2_b: torch.Tensor # [N]
    mask: torch.Tensor         # [N] bool
    cam_a: Optional[torch.Tensor] = None  # [N] int32 observing camera in a
    cam_b: Optional[torch.Tensor] = None  # [N] int32 observing camera in b


def _project(K, X):
    z = torch.clamp(X[..., 2], min=1e-6)
    u = K[..., 0] * X[..., 0] / z + K[..., 2]
    v = K[..., 1] * X[..., 1] / z + K[..., 3]
    return torch.stack([u, v], dim=-1), X[..., 2] > 1e-3


@graphs.graphed(static_argnames=("fix_scale", "n_iters_first", "n_iters_second"))
def optimize_sim3(
    g_ab0: torch.Tensor,   # [8] initial Sim3 (b -> a), e.g. from RANSAC
    obs: Sim3Obs,
    K0: torch.Tensor,      # [4] cam-0 intrinsics, or [C, 4] with T_rc given
    T_rc: Optional[torch.Tensor] = None,  # [C, 4, 4]: camera-aware edges
    fix_scale: bool = True,
    n_iters_first: int = 5,
    n_iters_second: int = 10,
):
    """Returns (g_ab [8], inlier_mask [N], n_inliers int32 tensor)."""
    dev, dtype = g_ab0.device, g_ab0.dtype
    delta = CHI2_TH ** 0.5
    multi = T_rc is not None and obs.cam_a is not None
    N = obs.mask.shape[0]
    if multi:
        ca, cb = obs.cam_a.long(), obs.cam_b.long()
        Trc_a, Trc_b, K_a, K_b = T_rc[ca], T_rc[cb], K0[ca], K0[cb]

    def proj_into(Trc, Kc, X):
        """Project rig-frame points into each observation's camera."""
        if not multi:
            return _project(K0, X)
        Xc = (Trc[:, :3, :3] @ X[..., None])[..., 0] + Trc[:, :3, 3]
        return _project(Kc, Xc)

    def residuals(xi, g_base):
        """xi [..., 7] -> e1, e2 [..., N, 2] and the in-front mask."""
        g = sim3.compose(sim3.exp(xi), g_base)[..., None, :]
        uv1, ok1 = proj_into(Trc_a if multi else None, K_a if multi else None,
                             sim3.apply(g, obs.X_b))
        uv2, ok2 = proj_into(Trc_b if multi else None, K_b if multi else None,
                             sim3.apply(sim3.inverse(g), obs.X_a))
        return obs.uv_a - uv1, obs.uv_b - uv2, ok1 & ok2

    def chi2_of(e1, e2):
        return (torch.sum(e1 * e1, -1) * obs.inv_sigma2_a,
                torch.sum(e2 * e2, -1) * obs.inv_sigma2_b)

    zero = torch.zeros(7, dtype=dtype, device=dev)
    eye7 = 1e-9 * torch.eye(7, dtype=dtype, device=dev)
    # freeze sigma: a unit row and column with no gradient coupling
    g_keep = sim3.free_scale_mask(True, dtype, dev)
    keep = g_keep[:, None] * g_keep[None, :]
    unit6 = torch.diag(1.0 - g_keep)

    def lm_phase(g_init, active, n_iters, use_huber):
        def linearize(g):
            e1, e2, okz = residuals(zero, g)
            J = sim3.jacfwd_batched(
                lambda x: torch.cat(residuals(x, g)[:2], dim=-2), zero)   # [2N, 2, 7]
            J1, J2 = J[:N], J[N:]
            c1, c2 = chi2_of(e1, e2)
            act = (active & okz).to(dtype)

            def hw(c):
                r = torch.sqrt(torch.clamp(c, min=1e-12))
                return torch.where(use_huber & (r > delta), delta / r, 1.0)

            def rho(c):
                r = torch.sqrt(torch.clamp(c, min=1e-12))
                return torch.where(use_huber & (r > delta), delta * (2.0 * r - delta), c)

            w1 = obs.inv_sigma2_a * hw(c1) * act
            w2 = obs.inv_sigma2_b * hw(c2) * act
            H = (torch.einsum("nri,n,nrj->ij", J1, w1, J1)
                 + torch.einsum("nri,n,nrj->ij", J2, w2, J2))
            g_vec = (torch.einsum("nri,n,nr->i", J1, w1, e1)
                     + torch.einsum("nri,n,nr->i", J2, w2, e2))
            total = torch.sum(torch.where(act > 0, rho(c1) + rho(c2), 0.0))
            return H, g_vec, total

        g_cur = g_init
        H, gv, chi2_cur = linearize(g_init)
        lam = torch.full((), 1e-3, dtype=dtype, device=dev)
        for _ in range(n_iters):
            Hd = H + lam * torch.diag(torch.diag(H)) + eye7
            if fix_scale:
                Hd, gv_s = Hd * keep + unit6, gv * g_keep
            else:
                gv_s = gv
            dx = -torch.linalg.solve_ex(Hd, gv_s)[0]
            g_try = sim3.compose(sim3.exp(dx), g_cur)
            H_t, gv_t, chi2_t = linearize(g_try)
            accept = chi2_t < chi2_cur
            g_cur = torch.where(accept, g_try, g_cur)
            H = torch.where(accept, H_t, H)
            gv = torch.where(accept, gv_t, gv)
            chi2_cur = torch.where(accept, chi2_t, chi2_cur)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        return g_cur

    def classify(g, active):
        e1, e2, okz = residuals(zero, g)
        c1, c2 = chi2_of(e1, e2)
        # the reference drops a correspondence when EITHER direction fails
        return active & okz & (c1 <= CHI2_TH) & (c2 <= CHI2_TH)

    true = torch.ones((), dtype=torch.bool, device=dev)
    g1 = lm_phase(g_ab0, obs.mask, n_iters_first, true)
    survivors = classify(g1, obs.mask)
    g2 = lm_phase(g1, survivors, n_iters_second, ~true)
    inliers = classify(g2, survivors)
    return g2, inliers, inliers.sum(dtype=torch.int32)
