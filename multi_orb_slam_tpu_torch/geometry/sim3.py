"""Sim(3) operations for loop closing and pose-graph optimization.

Counterpart of `multi_orb_slam_tpu/geometry/sim3.py` (which replaces g2o's
`Sim3` type used by `OptimizeEssentialGraph` / `OptimizeSim3`).  A Sim3
element is an (s, R, t) triple packed into a (..., 8) tensor:
[tx, ty, tz, qx, qy, qz, qw, s].  The group action is `x -> s * R @ x + t`.
Tangent vectors are (..., 7): [upsilon, omega, sigma] with sigma = log s.

Every function broadcasts over leading batch dimensions and is
differentiable in forward mode: the branches of `_W` and `log` use the
reference's safe denominators under `torch.where`, so the branch that is
chosen has a finite value and tangent.  `log` solves its 3x3 system in
closed form (no `torch.linalg` error check, so no host synchronisation on
the card).  `jacfwd_batched` is the Jacobian the optimizers take.
"""

from __future__ import annotations

import torch

from . import se3

_EPS = 1e-8


def pack(s, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    q = se3.to_quaternion(R)
    # a number is filled in on the device (no copy from the host)
    s = (s.to(t.device, t.dtype) if isinstance(s, torch.Tensor)
         else torch.full((), s, dtype=t.dtype, device=t.device))
    batch = torch.broadcast_shapes(s.shape, q.shape[:-1], t.shape[:-1])
    return torch.cat([t.expand(batch + (3,)), q.expand(batch + (4,)),
                      s.expand(batch)[..., None]], dim=-1)


def unpack(g: torch.Tensor):
    return g[..., 7], se3.from_quaternion(g[..., 3:7]), g[..., 0:3]


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    # qw = s = 1 by a comparison on the device: a number written into a
    # tensor would be a copy from the host
    return (torch.arange(8, device=device) >= 6).to(dtype)


def free_scale_mask(fix_scale: bool, dtype, device) -> torch.Tensor:
    """[7] tangent mask: 0 on sigma (log-scale) when the scale is fixed,
    else all ones."""
    return (torch.arange(7, device=device) < (6 if fix_scale else 7)).to(dtype)


def from_se3(T: torch.Tensor, s=None) -> torch.Tensor:
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return pack(s, T[..., :3, :3], T[..., :3, 3])


def to_se3(g: torch.Tensor) -> torch.Tensor:
    """SE3 from Sim3 by folding the scale into the translation: [R | t/s]
    (the reference's loop-closing pose recovery)."""
    s, R, t = unpack(g)
    return se3.from_rt(R, t / torch.clamp(s[..., None], min=_EPS))


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def apply(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Action on points: s*R@x + t.  Supports (..., 3) or (..., N, 3)."""
    s, R, t = unpack(g)
    if x.dim() == g.dim() + 1:  # (..., N, 3)
        return s[..., None, None] * (x @ R.transpose(-1, -2)) + t[..., None, :]
    return s[..., None] * _mv(R, x) + t


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Group product a*b acting as a(b(x))."""
    sa, Ra, ta = unpack(a)
    sb, Rb, tb = unpack(b)
    return pack(sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta)


def inverse(g: torch.Tensor) -> torch.Tensor:
    s, R, t = unpack(g)
    Rt = R.transpose(-1, -2)
    sinv = 1.0 / torch.clamp(s, min=_EPS)
    return pack(sinv, Rt, -sinv[..., None] * _mv(Rt, t))


def _W(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim(3) translation integral W with t = W @ upsilon.

    W = cI*I + cK*K + cK2*K^2 with the closed-form coefficients of
    Strasdat's Sim(3) exponential, series-expanded near theta=0 / sigma=0.
    """
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    s = torch.exp(sigma)
    K = se3.hat(omega)
    K2 = K @ K
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(K.shape)

    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-4
    small_th = theta < 1e-4
    safe_sig = torch.where(small_sig, 1.0, sigma)
    safe_sig2 = torch.where(small_sig, 1.0, sig2)
    safe_th2 = torch.where(small_th, 1.0, theta2)
    safe_th = torch.where(small_th, 1.0, theta)
    c = sig2 + theta2
    safe_c = torch.clamp(c, min=_EPS)

    # coeff of I: (s-1)/sigma, limit 1 + sigma/2 + sigma^2/6
    cI = torch.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0, (s - 1.0) / safe_sig)

    a = s * torch.sin(theta)
    b = s * torch.cos(theta)
    # coeff of K
    cK_gen = (a * sigma + (1.0 - b) * theta) / (safe_th * safe_c)
    cK_sig0 = (1.0 - torch.cos(theta)) / safe_th2
    cK_th0 = ((sigma - 1.0) * s + 1.0) / safe_sig2
    cK_both = 0.5 + sigma / 3.0
    cK = torch.where(small_th, torch.where(small_sig, cK_both, cK_th0),
                     torch.where(small_sig, cK_sig0, cK_gen))

    # coeff of K^2
    cK2_gen = (cI - ((b - 1.0) * sigma + a * theta) / safe_c) / safe_th2
    cK2_sig0 = (theta - torch.sin(theta)) / (safe_th2 * safe_th)
    cK2_th0 = (s * (0.5 * sig2 - sigma + 1.0) - 1.0) / (safe_sig2 * safe_sig)
    cK2_both = 1.0 / 6.0 + sigma / 8.0
    cK2 = torch.where(small_th, torch.where(small_sig, cK2_both, cK2_th0),
                      torch.where(small_sig, cK2_sig0, cK2_gen))

    return cI[..., None, None] * eye + cK[..., None, None] * K + cK2[..., None, None] * K2


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Tangent (..., 7) [upsilon, omega, sigma] -> Sim3 (..., 8)."""
    upsilon, omega, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    t = _mv(_W(omega, sigma), upsilon)
    return pack(torch.exp(sigma), se3.so3_exp(omega), t)


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for (..., 3, 3) A and (..., 3) b, by Cramer's rule:
    no pivoting and no error check (A is the well-conditioned W here)."""
    c0 = torch.cross(A[..., :, 1], A[..., :, 2], dim=-1)
    c1 = torch.cross(A[..., :, 2], A[..., :, 0], dim=-1)
    c2 = torch.cross(A[..., :, 0], A[..., :, 1], dim=-1)
    det = torch.sum(A[..., :, 0] * c0, dim=-1)
    x = torch.stack([torch.sum(b * c0, -1), torch.sum(b * c1, -1), torch.sum(b * c2, -1)], -1)
    return x / det[..., None]


def log(g: torch.Tensor) -> torch.Tensor:
    """Sim3 (..., 8) -> tangent (..., 7).  Solves t = W @ upsilon."""
    s, R, t = unpack(g)
    sigma = torch.log(torch.clamp(s, min=_EPS))
    omega = se3.so3_log(R)
    upsilon = solve3(_W(omega, sigma), t)
    return torch.cat([upsilon, omega, sigma[..., None]], dim=-1)


def jacfwd_batched(f, x0: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of `f` at x0 [..., D]: [..., R, D] for an
    output [..., R] (any trailing output shape).

    One `torch.func.jvp` over a batch of D copies of x0, copy d with the
    tangent e_d, instead of `torch.func.jacfwd` (a `vmap` of such jvps):
    there, a per-example 0-dim tensor combined with a Python scalar gets a
    float64 tangent in torch 2.13, which breaks the next float32 matmul.
    Here no example is 0-dim.  `f` must broadcast over the new leading
    dimension; every copy is an independent evaluation."""
    D = x0.shape[-1]
    X = x0.expand((D,) + x0.shape).contiguous()
    basis = torch.eye(D, dtype=x0.dtype, device=x0.device)
    T = basis.reshape((D,) + (1,) * (x0.dim() - 1) + (D,)).expand_as(X).contiguous()
    _, dY = torch.func.jvp(f, (X,), (T,))
    return dY.movedim(0, -1)
