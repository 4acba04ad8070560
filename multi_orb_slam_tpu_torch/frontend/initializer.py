"""Monocular two-view initialization: batched H / F RANSAC + reconstruction.

Counterpart of `multi_orb_slam_tpu/frontend/initializer.py` (which
re-designs `Initializer`, reference src/Initializer.cc:33-124 Initialize,
:125-282 FindHomography / FindFundamental, :283-754 ReconstructF / H): every
hypothesis of both models is generated and scored in one batch, two batched
SVDs and two dense scoring passes.

Model selection and thresholds are the reference's:
- symmetric transfer scoring with chi2 gates 5.991 (H) / 3.841 (F) and the
  score offset th_score = 5.991 (Initializer.cc:462-576)
- RH = SH / (SH + SF) > 0.40 selects the homography (Initializer.cc:118)
- reconstruction requires a dominant cheirality winner (or a clearly lower
  reprojection error than the runner-up) and enough points

The module is split where the random numbers enter, as `reloc/pnp.py` is:
`sample_hypotheses` draws the minimal sets from a `torch.Generator` (one
Gumbel top-k draw per hypothesis: its first 4 indices make the homography's
set and its first 8 the fundamental's, as the reference draws both from one
key per hypothesis); `solve_two_view` takes the draws.  A comparison hands
both packages the same draws.

`solve_two_view` is `graphs.graphed`, as the reference jits
`initialize_two_view`: one CUDA graph replay a call on the card, the draws
made outside it.  So it reads nothing back to the host and calls no
`torch.linalg` decomposition, inverse or determinant (their error checks
read back) where the reference takes SVDs, inverses and determinants:

- the null vector of each minimal set's 8x9 system (`_null_vector`) is the
  eigenvector of the smallest eigenvalue of the 9x9 normal matrix A^T A,
  computed in float64 (its condition number is A's squared) by
  `align.jacobi_eigh` in NULL_SWEEPS round-robin sweeps;
- the 3x3 SVDs (`_svd3`: E = K^T F K and the calibrated homography) come
  from the Jacobi eigen-decomposition of M^T M in float64, the singular
  values in descending order, U's first two columns M v / |M v| and its
  third their cross product (det U = +1), V's third column signed so that
  M v3 = s3 u3; the rank-2 projection of F is F (I - v3 v3^T);
- inverses and determinants are the closed-form 3x3 adjugate
  (`optim/global_ba.inv3`) and triple product (`_det3`).

The SVD's signs are not unique, and the Jacobi form may choose other ones
than LAPACK does for the reference.  Both decompositions enumerate every
sign case (R1 / R2 x +-t for E, e1 x e3 for the homography), `fix_det` makes
each rotation proper, and the cheirality vote picks among them, so a sign
flip only reorders the candidates.

The monocular pipeline is dormant in the reference itself (its
Tracking::MonocularInitialization is never run by its drivers); this module
completes the capability and is held by synthetic two-view tests.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..geometry import align
from ..ops.hamming import top_k
from ..optim.global_ba import inv3
from ..utils import graphs

CHI2_H = 5.991
CHI2_F = 3.841
TH_SCORE = 5.991
# round-robin Jacobi sweeps of the float64 eigen-solves: the 9x9 normal
# matrices of the minimal sets reach round-off after 7, the 3x3 M^T M after
# 4 (`tests/test_torch_mono_init.py` measures the off-diagonal mass left);
# one sweep more of each is margin
NULL_SWEEPS = 8
SVD3_SWEEPS = 5


class InitResult(NamedTuple):
    ok: torch.Tensor              # [] bool
    used_homography: torch.Tensor # [] bool
    R: torch.Tensor               # [3, 3] rotation cam1 -> cam2
    t: torch.Tensor               # [3] unit translation
    points: torch.Tensor          # [N, 3] triangulated points in cam1 frame
    is_good: torch.Tensor         # [N] bool inlier & positive depth & parallax


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    """x where |x| > eps, else eps (the reference's `where(|x| > eps, x, eps)`)."""
    return torch.where(torch.abs(x) > eps, x, torch.full_like(x, eps))


def _normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization (reference Normalize, Initializer.cc:756-800)."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(pts * w[:, None], dim=0) / n
    md = torch.sum(torch.abs(pts - mean) * w[:, None], dim=0) / n
    s = 1.0 / torch.clamp(md, min=1e-9)
    zero, one = s.new_zeros(()), s.new_ones(())
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (pts - mean) * s, T


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinants of (..., 3, 3) matrices: the triple product of the rows."""
    return torch.sum(M[..., 0, :] * torch.linalg.cross(M[..., 1, :], M[..., 2, :]), dim=-1)


def _smallest_eigenvector(N: torch.Tensor, sweeps: int) -> torch.Tensor:
    """Unit eigenvector (..., n) of the smallest eigenvalue of symmetric
    (..., n, n) matrices, the lowest column among equals."""
    w, V = align.jacobi_eigh(N, sweeps, parallel=True)
    return align.column(V, w.argmin(dim=-1))


def _null_vector(A: torch.Tensor) -> torch.Tensor:
    """[B, 8, 9] -> [B, 3, 3]: the right singular vector of the smallest
    singular value (the eigenvector of A^T A's smallest eigenvalue, in
    float64), as a 3x3 matrix."""
    A64 = A.to(torch.float64)
    v = _smallest_eigenvector(A64.transpose(-1, -2) @ A64, NULL_SWEEPS)
    return v.to(A.dtype).reshape(-1, 3, 3)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-300)


def _svd3(M: torch.Tensor):
    """M = U diag(s) V^T for (..., 3, 3) M: (U, s, V) in M's dtype, s
    descending, det U = +1, from the eigen-decomposition of M^T M in
    float64 (see the module's docstring)."""
    M64 = M.to(torch.float64)
    w, V = align.jacobi_eigh(M64.transpose(-1, -2) @ M64, SVD3_SWEEPS, parallel=True)
    w, order = torch.sort(w, dim=-1, descending=True, stable=True)
    V = torch.gather(V, -1, order[..., None, :].expand(V.shape))
    s = torch.sqrt(torch.clamp(w, min=0.0))
    MV = M64 @ V
    u0 = _unit(MV[..., 0])
    u1 = MV[..., 1]
    u1 = _unit(u1 - torch.sum(u0 * u1, dim=-1, keepdim=True) * u0)
    u2 = torch.linalg.cross(u0, u1)
    sign = torch.where(torch.sum(u2 * MV[..., 2], dim=-1) < 0, -1.0, 1.0)
    V = torch.cat([V[..., :2], V[..., 2:] * sign[..., None, None]], dim=-1)
    U = torch.stack([u0, u1, u2], dim=-1)
    return U.to(M.dtype), s.to(M.dtype), V.to(M.dtype)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """The nearest rank-2 matrix of each (..., 3, 3) F: F (I - v v^T), v the
    right singular vector of the smallest singular value."""
    F64 = F.to(torch.float64)
    v = _smallest_eigenvector(F64.transpose(-1, -2) @ F64, SVD3_SWEEPS)
    return (F64 - (F64 @ v[..., None]) @ v[..., None, :]).to(F.dtype)


def _dlt_h(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """4-point homography DLT: p1, p2 [B, 4, 2] -> H [B, 3, 3], p2 ~ H p1."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    r2 = torch.stack([x, y, o, z, z, z, -u * x, -u * y, -u], dim=-1)
    A = torch.stack([r1, r2], dim=2).reshape(p1.shape[0], 8, 9)   # rows r1_0, r2_0, r1_1, ...
    return _null_vector(A)


def _eight_point_f(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental: [B, 8, 2] x2 -> F [B, 3, 3], rank 2 enforced."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    A = torch.stack([u * x, u * y, u, v * x, v * y, v, x, y, torch.ones_like(x)], dim=-1)
    return _rank2(_null_vector(A))


def _homogeneous(a: torch.Tensor) -> torch.Tensor:
    return torch.cat([a, torch.ones_like(a[:, :1])], dim=-1)


def _score_h(H, H_inv, p1, p2, mask, sigma2=1.0):
    """Symmetric transfer score of each H [B, 3, 3] (CheckHomography,
    Initializer.cc:462-521) -> (score [B], inliers [B, N])."""
    def transfer(M, a):
        q = _homogeneous(a) @ M.transpose(1, 2)              # [B, N, 3]
        return q[..., :2] / _safe(q[..., 2:], 1e-12)

    e12 = torch.sum((transfer(H, p1) - p2) ** 2, dim=-1) / sigma2
    e21 = torch.sum((transfer(H_inv, p2) - p1) ** 2, dim=-1) / sigma2
    ok = (e12 < CHI2_H) & (e21 < CHI2_H) & mask
    zero = torch.zeros_like(e12)
    score = torch.sum(torch.where(mask & (e12 < CHI2_H), TH_SCORE - e12, zero)
                      + torch.where(mask & (e21 < CHI2_H), TH_SCORE - e21, zero), dim=-1)
    return score, ok


def _score_f(F, p1, p2, mask, sigma2=1.0):
    """Epipolar-distance score of each F [B, 3, 3] (CheckFundamental,
    Initializer.cc:523-576) -> (score [B], inliers [B, N])."""
    p1h, p2h = _homogeneous(p1), _homogeneous(p2)
    l2 = p1h @ F.transpose(1, 2)      # lines in image 2 [B, N, 3]
    l1 = p2h @ F                      # lines in image 1
    d2 = (torch.sum(l2 * p2h, dim=-1) ** 2
          / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)) / sigma2
    d1 = (torch.sum(l1 * p1h, dim=-1) ** 2
          / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)) / sigma2
    ok = (d1 < CHI2_F) & (d2 < CHI2_F) & mask
    zero = torch.zeros_like(d1)
    score = torch.sum(torch.where(mask & (d2 < CHI2_F), TH_SCORE - d2, zero)
                      + torch.where(mask & (d1 < CHI2_F), TH_SCORE - d1, zero), dim=-1)
    return score, ok


def _rays(K: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return torch.stack([(p[:, 0] - K[2]) / K[0], (p[:, 1] - K[3]) / K[1],
                        torch.ones_like(p[:, 0])], dim=-1)


def _triangulate(R, t, K, p1, p2):
    """Midpoint triangulation of calibrated rays (cam1 frame)."""
    d1 = _rays(K, p1)
    d2 = _rays(K, p2) @ R             # ray direction in cam1 frame
    r = (-R.T @ t)[None, :]           # cam2 centre in cam1 frame
    a = torch.sum(d1 * d1, -1)
    b = torch.sum(d1 * d2, -1)
    c = torch.sum(d2 * d2, -1)
    d_ = torch.sum(r * d1, -1)
    e_ = torch.sum(r * d2, -1)
    den = a * c - b * b
    den = torch.where(torch.abs(den) < 1e-12, torch.full_like(den, 1e-12), den)
    s1 = (c * d_ - b * e_) / den
    s2 = (b * d_ - a * e_) / den
    X = 0.5 * (d1 * s1[:, None] + r + d2 * s2[:, None])
    # parallax between the two rays
    cosp = torch.sum(d1 * d2, -1) / torch.clamp(
        torch.linalg.norm(d1, dim=-1) * torch.linalg.norm(d2, dim=-1), min=1e-12)
    z2 = X @ R.T[:, 2] + t[2]
    return X, (s1 > 0) & (s2 > 0) & (X[:, 2] > 0) & (z2 > 0), cosp


def _check_rt(R, t, K, p1, p2, inlier):
    X, pos, cosp = _triangulate(R, t, K, p1, p2)

    # reprojection gate in BOTH views (reference CheckRT requires < 4 px,
    # Initializer.cc:850-980): it rejects the twisted pair of a homography
    # decomposition
    def reproj(Xc, uv):
        z = _safe(Xc[:, 2], 1e-9)
        u = K[0] * Xc[:, 0] / z + K[2]
        v = K[1] * Xc[:, 1] / z + K[3]
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    e1 = reproj(X, p1)
    e2 = reproj(X @ R.T + t[None, :], p2)
    good = inlier & pos & (cosp < 0.99998) & (e1 < 4.0) & (e2 < 4.0)
    n_good = torch.sum(good.to(torch.int32))
    # model-quality score over ALL positive-depth inliers, clipped so gross
    # outliers don't dominate
    sel = inlier & pos
    n_sel = torch.sum(sel.to(torch.int32))
    mean_err = (torch.sum(torch.where(sel, torch.clamp(e1 + e2, max=100.0),
                                      torch.zeros_like(e1)))
                / torch.clamp(n_sel.to(e1.dtype), min=1.0))
    return n_good, X, good, mean_err


def _select(i: torch.Tensor, *xs: torch.Tensor):
    """Row i (a 0-dim device index) of each x, read with `index_select`
    (indexing with a 0-dim tensor would read it back to the host)."""
    i = i.reshape(1)
    return tuple(x.index_select(0, i)[0] for x in xs)


def _pick(cands, K, p1, p2, inl):
    """The cheirality vote over (R, t) candidates: (ok, R, t, X, good)."""
    results = [_check_rt(R_, t_, K, p1, p2, inl) for R_, t_ in cands]
    counts = torch.stack([r[0] for r in results])
    errs = torch.stack([r[3] for r in results])
    Xs = torch.stack([r[1] for r in results])
    goods = torch.stack([r[2] for r in results])
    Rall = torch.stack([c[0] for c in cands])
    tall = torch.stack([c[1] for c in cands])
    best = torch.argmax(counts)
    Rb, tb, n_best, err_best, X_best, good_best = _select(best, Rall, tall, counts, errs, Xs,
                                                          goods)
    # dominant winner: the runner-up must be clearly worse.  Degenerate
    # decompositions can emit the SAME (R, t) twice; such duplicates are not
    # competing interpretations and are left out of the test
    tr = torch.einsum("cij,ij->c", Rall, Rb)
    same = (tr > 2.999) & (torch.abs(tall @ tb) > 0.999)
    idx = torch.arange(len(cands), device=counts.device)
    others = torch.where(same | (idx == best), torch.full_like(counts, -1), counts)
    second, err_second = _select(torch.argmax(others), others, errs)
    # dominance by count (the reference's secondBest < 0.75 * best), or a
    # decisively smaller mean reprojection error than the runner-up's
    dominant = second < 0.75 * n_best
    tiebreak = err_best * 2.0 < err_second
    ok = ((n_best > 0.7 * torch.sum(inl.to(torch.int32)))
          & (dominant | tiebreak) & (n_best >= 8))
    return ok, Rb, tb, X_best, good_best


def _fix_det(R: torch.Tensor) -> torch.Tensor:
    return R * torch.sign(_det3(R))


def sample_hypotheses(mask: torch.Tensor, n_hyp: int, generator: torch.Generator):
    """Minimal sets of distinct valid indices, drawn from `generator`:
    (idx_h [n_hyp, 4], idx_f [n_hyp, 8]).  Each hypothesis takes the top 8
    of one Gumbel draw per index (invalid indices pushed down by 1e9); the
    homography uses the first 4 of them."""
    u = torch.rand((n_hyp, mask.shape[0]), generator=generator, dtype=torch.float32,
                   device=generator.device).to(mask.device)
    tiny = torch.finfo(torch.float32).tiny
    g = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    g = g + torch.where(mask, 0.0, -1e9)
    _, idx = top_k(g, 8)
    return idx[:, :4], idx


@functools.lru_cache(maxsize=None)
def _constants(dtype: torch.dtype, device: torch.device):
    """(the last row of K's matrix, W = Rz(90 deg)), filled in on the device
    once (constants, never a copy from the host)."""
    last = graphs.filled([0.0, 0.0, 1.0], dtype, device)
    W = graphs.filled([0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0], dtype, device)
    return last, W.reshape(3, 3)


@graphs.graphed()
def solve_two_view(xy1: torch.Tensor, xy2: torch.Tensor, mask: torch.Tensor,
                   idx_h: torch.Tensor, idx_f: torch.Tensor, K: torch.Tensor) -> InitResult:
    """Two-view initialization on given minimal sets (reference Initialize,
    src/Initializer.cc:33-124): H and F hypotheses, model selection by
    RH > 0.4, pose recovery (E decomposition for F; the plane-induced
    decomposition for H, through the same cheirality vote) and the
    triangulation of the winning model's inliers.

    xy1, xy2 [N, 2] matched pixel coords; mask [N]; idx_h [B, 4], idx_f
    [B, 8] (`sample_hypotheses`); K [4] = fx, fy, cx, cy.
    """
    dt, dev = xy1.dtype, xy1.device
    K = K.to(dev, dt)
    n1, T1 = _normalize(xy1, mask)
    n2, T2 = _normalize(xy2, mask)
    T2inv = inv3(T2)
    eye = torch.eye(3, dtype=dt, device=dev)

    # --- homography hypotheses (4-point) ---
    Hs = T2inv @ _dlt_h(n1[idx_h], n2[idx_h]) @ T1            # pixel space
    Hs_inv = inv3(Hs + 1e-12 * eye)
    sh, okh = _score_h(Hs, Hs_inv, xy1, xy2, mask)
    SH, H_best, H_inl = _select(torch.argmax(sh), sh, Hs, okh)

    # --- fundamental hypotheses (8-point) ---
    Fs = T2.T @ _eight_point_f(n1[idx_f], n2[idx_f]) @ T1
    sf, okf = _score_f(Fs, xy1, xy2, mask)
    SF, F_best, F_inl = _select(torch.argmax(sf), sf, Fs, okf)

    use_h = SH / torch.clamp(SH + SF, min=1e-9) > 0.40

    last, W = _constants(dt, dev)
    zero = K.new_zeros(())
    Km = torch.stack([torch.stack([K[0], zero, K[2]]), torch.stack([zero, K[1], K[3]]), last])

    # F path: E = K^T F K, 4 (R, t) candidates
    Ue, _, Ve = _svd3(Km.T @ F_best @ Km)
    Vte = Ve.T
    R1 = _fix_det(Ue @ W @ Vte)
    R2 = _fix_det(Ue @ W.T @ Vte)
    tf_ = Ue[:, 2] / torch.clamp(torch.linalg.norm(Ue[:, 2]), min=1e-12)
    f_cands = [(R1, tf_), (R1, -tf_), (R2, tf_), (R2, -tf_)]

    # H path: Faugeras-style decomposition of the calibrated homography
    # A = K^-1 H K (reference ReconstructH, Initializer.cc:584-754), scaled
    # to a middle singular value of 1 (the scaling leaves U and V as they are)
    Ua, Sa, Va = _svd3(inv3(Km) @ H_best @ Km)
    Sa = Sa / _safe(Sa[1], 1e-12)
    Vta = Va.T
    d1s, d3s = Sa[0], Sa[2]
    s_det = _det3(Ua) * _det3(Vta)
    gap = torch.clamp(d1s * d1s - d3s * d3s, min=1e-12)
    x1_ = torch.sqrt(torch.clamp((d1s * d1s - 1.0) / gap, min=0.0))
    x3_ = torch.sqrt(torch.clamp((1.0 - d3s * d3s) / gap, min=0.0))
    st_ = (torch.sqrt(torch.clamp((d1s * d1s - 1.0) * (1.0 - d3s * d3s), min=0.0))
           / torch.clamp(d1s + d3s, min=1e-12))
    ct_ = (1.0 + d1s * d3s) / torch.clamp(d1s + d3s, min=1e-12)
    zero, one = d1s.new_zeros(()), d1s.new_ones(())
    h_cands = []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            Rp = torch.stack([torch.stack([ct_, zero, -e1 * e3 * st_]),
                              torch.stack([zero, one, zero]),
                              torch.stack([e1 * e3 * st_, zero, ct_])])
            tp = torch.stack([e1 * x1_, zero, -e3 * x3_]) * (d1s - d3s)
            th = Ua @ tp
            h_cands.append((_fix_det(s_det * Ua @ Rp @ Vta),
                            th / torch.clamp(torch.linalg.norm(th), min=1e-12)))

    okf_, Rf_, tf2_, Xf_, gf_ = _pick(f_cands, K, xy1, xy2, F_inl)
    okh_, Rh_, th_, Xh_, gh_ = _pick(h_cands, K, xy1, xy2, H_inl)
    return InitResult(
        ok=torch.where(use_h, okh_, okf_), used_homography=use_h,
        R=torch.where(use_h, Rh_, Rf_), t=torch.where(use_h, th_, tf2_),
        points=torch.where(use_h, Xh_, Xf_), is_good=torch.where(use_h, gh_, gf_))


def initialize_two_view(xy1: torch.Tensor, xy2: torch.Tensor, mask: torch.Tensor,
                        K: torch.Tensor, n_hyp: int = 256,
                        generator: torch.Generator | None = None) -> InitResult:
    """Sample `n_hyp` hypotheses from `generator` (a fresh CPU generator
    seeded with 0 when None), then `solve_two_view`."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    idx_h, idx_f = sample_hypotheses(mask, n_hyp, generator)
    return solve_two_view(xy1, xy2, mask, idx_h, idx_f, K)
