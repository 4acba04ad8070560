"""PyTorch port vs JAX reference: the monocular two-view initializer.

`tests/test_mono_init.py`'s synthetic two-view problems (a general 3D
scene, which must select the fundamental path, and a rough tilted plane,
which must select the homography).

- The solver on the reference's own `jax.random` draws (its Gumbel top-k of
  one key per hypothesis: the first 4 indices for H, 8 for F): the same
  `ok`, `used_homography` and `is_good`, R and t within 1e-4.  The SVD's
  signs may differ from LAPACK's; the cheirality vote over every sign case
  must still pick the same (R, t).
- `test_mono_init.py`'s two tests, run with the port's own generator.
- The SVD-free decompositions (`solve_two_view` is a CUDA graph on the card,
  which `torch.linalg.svd` / `inv` / `det` refuse): `align.jacobi_eigh`
  against `numpy.linalg.eigh`, `_svd3`, `_rank2` and `_null_vector` against
  `numpy.linalg.svd`, on random and near-degenerate matrices; the sweep
  counts against the off-diagonal mass they leave on the minimal sets'
  normal matrices; and the solver against its `torch.linalg.svd` form over
  200 seeded two-view problems: the same decisions on all but 3 of them
  (1.5%), rotations within 1e-4 where both accept.
- `solve_two_view` leaves its inputs unchanged and reads nothing back
  through its graph entry (`test_torch_graphs`' checks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.frontend import initializer as j_init
from multi_orb_slam_tpu_torch.frontend import initializer as t_init

from multi_orb_slam_tpu_torch.geometry import align as t_align
from multi_orb_slam_tpu_torch.geometry import se3 as t_se3

from test_mono_init import K, angle_between, make_views
from test_torch_graphs import assert_pure, assert_reads_nothing_back

torch.set_num_threads(2)
N_HYP = 256


def reference_draws(key, mask, n_hyp=N_HYP):
    """The reference's minimal sets for `key` (initializer.py:188-195)."""
    keys = jax.random.split(key, n_hyp)

    def sample(k):
        g = jax.random.gumbel(k, (mask.shape[0],)) + jnp.where(mask, 0.0, -1e9)
        return jax.lax.top_k(g, 8)[1]

    idx = np.asarray(jax.vmap(sample)(keys)).astype(np.int64)
    return torch.from_numpy(idx[:, :4].copy()), torch.from_numpy(idx)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("planar,seed", [(False, 0), (True, 1)])
def test_solver_on_reference_draws(planar, seed):
    uv1, uv2, mask, _, _, _, _ = make_views(planar=planar)
    key = jax.random.PRNGKey(seed)
    ref = j_init.initialize_two_view(key, uv1, uv2, mask, N_HYP, jnp.asarray(K))
    idx_h, idx_f = reference_draws(key, mask)
    got = t_init.solve_two_view(_t(uv1), _t(uv2), _t(mask), idx_h, idx_f, _t(K))
    assert bool(got.ok) == bool(ref.ok)
    assert bool(got.used_homography) == bool(ref.used_homography) == planar
    np.testing.assert_array_equal(got.is_good.numpy(), np.asarray(ref.is_good))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-4)
    good = got.is_good.numpy()
    np.testing.assert_allclose(got.points.numpy()[good], np.asarray(ref.points)[good],
                               rtol=1e-3, atol=1e-4)


def test_sampler_draws_distinct_valid_indices():
    mask = torch.rand(300, generator=torch.Generator().manual_seed(3)) < 0.7
    idx_h, idx_f = t_init.sample_hypotheses(mask, 64, torch.Generator().manual_seed(0))
    assert idx_h.shape == (64, 4) and idx_f.shape == (64, 8)
    assert torch.equal(idx_h, idx_f[:, :4])
    assert bool(mask[idx_f].all())
    assert all(len(set(row.tolist())) == 8 for row in idx_f)
    again = t_init.sample_hypotheses(mask, 64, torch.Generator().manual_seed(0))[1]
    assert torch.equal(idx_f, again)


def test_general_scene_uses_f_and_recovers_pose():
    uv1, uv2, mask, R, t, X, out_idx = make_views(planar=False)
    res = t_init.initialize_two_view(_t(uv1), _t(uv2), _t(mask), _t(K), N_HYP,
                                     torch.Generator().manual_seed(0))
    assert bool(res.ok)
    assert not bool(res.used_homography)
    assert angle_between(res.R.numpy(), R) < 1.0
    # translation up to scale and known sign
    assert np.abs(np.dot(res.t.numpy(), t)) > 0.995
    # triangulated inliers land near the true points (up to global scale)
    good = res.is_good.numpy()
    assert good.sum() > 150
    Xe, Xt = res.points.numpy()[good], X[good]
    s = np.median(Xt[:, 2] / np.maximum(Xe[:, 2], 1e-9))
    assert np.median(np.linalg.norm(Xe * s - Xt, axis=-1)) < 0.15
    # none of the injected outliers survive
    assert not good[out_idx].any()


def test_planar_scene_selects_homography():
    uv1, uv2, mask, R, t, X, _ = make_views(planar=True)
    res = t_init.initialize_two_view(_t(uv1), _t(uv2), _t(mask), _t(K), N_HYP,
                                     torch.Generator().manual_seed(1))
    assert bool(res.used_homography)
    assert bool(res.ok)
    assert angle_between(res.R.numpy(), R) < 2.0
    assert np.abs(np.dot(res.t.numpy(), t)) > 0.99


# ---------------------------------------------------------------------------
# the SVD-free decompositions
# ---------------------------------------------------------------------------


def _sets(planar, model):
    """The normalized minimal-set systems [256, 8, 9] of one scene, in
    float64: the 4-point homography's or the 8-point fundamental's."""
    uv1, uv2, mask, *_ = make_views(planar=planar)
    m = _t(mask)
    n1, _ = t_init._normalize(_t(uv1), m)
    n2, _ = t_init._normalize(_t(uv2), m)
    idx_h, idx_f = t_init.sample_hypotheses(m, N_HYP, torch.Generator().manual_seed(0))
    captured = []
    null = t_init._null_vector
    t_init._null_vector = lambda A: captured.append(A) or null(A)
    try:
        if model == "H":
            t_init._dlt_h(n1[idx_h], n2[idx_h])
        else:
            t_init._eight_point_f(n1[idx_f], n2[idx_f])
    finally:
        t_init._null_vector = null
    return captured[0].to(torch.float64)


def _off_diagonal(N, sweeps):
    """Largest ||V^T N V - diag|| / ||N|| over the batch after `sweeps`."""
    _, V = t_align.jacobi_eigh(N, sweeps, parallel=True)
    D = V.transpose(-1, -2) @ N @ V
    off = D - torch.diag_embed(torch.diagonal(D, dim1=-2, dim2=-1))
    return float((torch.linalg.norm(off, dim=(-2, -1))
                  / torch.linalg.norm(N, dim=(-2, -1))).max())


def _near_degenerate(n, batch, seed):
    """Random symmetric matrices, half of them with a repeated eigenvalue and
    a 1e-9-scale one (float64)."""
    rng = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rng.randn(batch, n, n))
    w = rng.uniform(0.1, 10.0, (batch, n))
    w[::2, 1] = w[::2, 0]
    w[::2, -1] = 1e-9
    return torch.from_numpy((Q * w[:, None, :]) @ Q.transpose(0, 2, 1))


@pytest.mark.parametrize("planar,model", [(False, "F"), (False, "H"), (True, "F"), (True, "H")])
def test_sweep_count_reaches_round_off_on_the_minimal_sets(planar, model):
    """The measurement behind NULL_SWEEPS: every 9x9 normal matrix of a
    scene's 256 minimal sets is diagonal to float64 round-off (< 1e-14 of
    its norm) after NULL_SWEEPS - 1 = 7 round-robin sweeps (one more is
    margin), and not after 5 (2e-10 to 5e-5 left)."""
    A = _sets(planar, model)
    N = A.transpose(-1, -2) @ A
    assert _off_diagonal(N, t_init.NULL_SWEEPS - 1) < 1e-14
    assert _off_diagonal(N, 5) > 1e-12
    # the null vector against the SVD of A, up to sign: the normal
    # matrix's squared condition number costs ~1e-10, far below float32
    v = t_init._null_vector(A.to(torch.float32)).reshape(-1, 9).to(torch.float64)
    ref = torch.from_numpy(np.linalg.svd(A.numpy())[2][:, -1])
    assert float(torch.minimum((v - ref).abs().amax(-1), (v + ref).abs().amax(-1)).max()) < 1e-6


@pytest.mark.parametrize("n,sweeps", [(3, t_init.SVD3_SWEEPS), (4, t_align.JACOBI_SWEEPS),
                                      (9, t_init.NULL_SWEEPS)])
def test_jacobi_eigh_against_numpy(n, sweeps):
    """Eigenvalues to 1e-12 of the largest, eigenvectors orthonormal and
    diagonalizing, on random and near-degenerate (repeated, ~0) spectra."""
    rng = np.random.RandomState(n)
    R = rng.randn(64, n, n)
    for N in (torch.from_numpy(R @ R.transpose(0, 2, 1)), _near_degenerate(n, 64, n)):
        w, V = t_align.jacobi_eigh(N, sweeps)
        ref = np.linalg.eigh(N.numpy())[0]
        scale = np.abs(ref).max(-1, keepdims=True)
        np.testing.assert_array_less(np.abs(np.sort(w.numpy(), -1) - ref) / scale, 1e-12)
        eye = torch.eye(n, dtype=N.dtype)
        assert float((V.transpose(-1, -2) @ V - eye).abs().max()) < 1e-12
        assert float((V @ torch.diag_embed(w) @ V.transpose(-1, -2) - N).abs().max()
                     / scale.max()) < 1e-12


def test_svd3_and_rank2_against_numpy():
    """`_svd3`: singular values to 1e-5 relative, U S V^T = M, U and V
    orthonormal, det U = +1; `_rank2`: numpy's truncated SVD; on random
    float32 3x3 matrices and on near-rank-2 ones (an essential matrix's
    spectrum: two equal values and a ~0 one)."""
    rng = np.random.RandomState(0)
    M = rng.randn(500, 3, 3).astype(np.float32)
    Q1, _ = np.linalg.qr(rng.randn(500, 3, 3))
    Q2, _ = np.linalg.qr(rng.randn(500, 3, 3))
    E = ((Q1 * np.array([1.0, 1.0, 1e-7])[None, None, :]) @ Q2.transpose(0, 2, 1))
    for m in (M, E.astype(np.float32)):
        U, s, V = t_init._svd3(torch.from_numpy(m))
        ref_u, ref_s, ref_vt = np.linalg.svd(m.astype(np.float64))
        np.testing.assert_allclose(s.numpy(), ref_s, rtol=1e-5, atol=1e-6)
        rec = U @ torch.diag_embed(s) @ V.transpose(-1, -2)
        assert float((rec - torch.from_numpy(m)).abs().max()) < 1e-5
        for X in (U, V):
            assert float((X.transpose(-1, -2) @ X - torch.eye(3)).abs().max()) < 1e-5
        assert float((t_init._det3(U) - 1.0).abs().max()) < 1e-5
        trunc = (ref_u[..., :2] * ref_s[:, None, :2]) @ ref_vt[:, :2]
        np.testing.assert_allclose(t_init._rank2(torch.from_numpy(m)).numpy(), trunc, atol=1e-5)


# the helpers' `torch.linalg.svd` forms (a capture refuses them): the
# reference of the 200-problem comparison
def _null_vector_svd(A):
    return torch.linalg.svd(A, full_matrices=True)[2][:, -1].reshape(-1, 3, 3)


def _rank2_svd(F):
    u, s, vh = torch.linalg.svd(F)
    return u @ torch.diag_embed(torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], -1)) @ vh


def _svd3_svd(M):
    u, s, vh = torch.linalg.svd(M)
    return u, s, vh.transpose(-1, -2)


def random_two_view(seed, n=150):
    """A seeded two-view problem: a random rotation of up to ~0.25 rad, a
    random unit baseline, a general scene (even seeds) or a rough plane (odd
    seeds), 0.3 px of noise and 10% gross outliers, `test_mono_init.py`'s K."""
    rng = np.random.RandomState(seed)
    X = rng.uniform([-2, -1.5, 4.0], [2, 1.5, 8.0], (n, 3)).astype(np.float32)
    if seed % 2:
        a, b = rng.uniform(-0.4, 0.4, 2)
        X[:, 2] = 6.0 + a * X[:, 0] + b * X[:, 1] + rng.randn(n).astype(np.float32) * 0.05
    R = t_se3.so3_exp(torch.from_numpy(rng.uniform(-0.15, 0.15, 3).astype(np.float32))).numpy()
    t = rng.randn(3).astype(np.float32)
    t /= np.linalg.norm(t)

    def proj(R_, t_):
        Xc = X @ R_.T + t_
        return (np.stack([K[0] * Xc[:, 0] / Xc[:, 2] + K[2], K[1] * Xc[:, 1] / Xc[:, 2] + K[3]],
                         -1), Xc[:, 2])

    uv1, z1 = proj(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    uv2, z2 = proj(R, t)
    uv1 = uv1 + rng.randn(n, 2) * 0.3
    uv2 = uv2 + rng.randn(n, 2) * 0.3
    out = rng.choice(n, n // 10, replace=False)
    uv2[out] += rng.uniform(20, 80, (len(out), 2)) * rng.choice([-1, 1], (len(out), 2))
    return (_t(uv1.astype(np.float32)), _t(uv2.astype(np.float32)), _t((z1 > 0) & (z2 > 0)))


def test_against_the_svd_form_on_200_problems(monkeypatch):
    """The solver with its SVD-free decompositions against the same solver
    with `torch.linalg.svd` in their place, on 200 seeded problems and the
    same 64 draws each: `ok` and `used_homography` the same on at least 97%
    of the problems, and where both accept with the same model, R within
    1e-4 and t within 1e-3 on at least 98% and the median R gap below 1e-5.
    Measured: 197 of 200 decisions equal; the 3 others (seeds 79, 81, 165)
    are rough planes whose homography candidates tie in support, where the
    SVD's signs order the candidates and so the winner of the tie; the R gap
    median 8.1e-7, at most 1.2e-5 over the 127 both accept."""
    Kt = _t(K)
    decided, r_gap, t_gap = [], [], []
    for seed in range(200):
        uv1, uv2, mask = random_two_view(seed)
        idx_h, idx_f = t_init.sample_hypotheses(mask, 64, torch.Generator().manual_seed(seed))
        got = t_init.solve_two_view(uv1, uv2, mask, idx_h, idx_f, Kt)
        with monkeypatch.context() as mp:
            mp.setattr(t_init, "_null_vector", _null_vector_svd)
            mp.setattr(t_init, "_rank2", _rank2_svd)
            mp.setattr(t_init, "_svd3", _svd3_svd)
            ref = t_init.solve_two_view(uv1, uv2, mask, idx_h, idx_f, Kt)
        same = (bool(got.ok) == bool(ref.ok)
                and bool(got.used_homography) == bool(ref.used_homography))
        decided.append(same)
        if same and bool(got.ok):
            r_gap.append(float((got.R - ref.R).abs().max()))
            t_gap.append(float((got.t - ref.t).abs().max()))
    r_gap, t_gap = np.asarray(r_gap), np.asarray(t_gap)
    print(f"decisions equal on {np.mean(decided):.1%} of 200; {len(r_gap)} accepted by both: "
          f"R gap median {np.median(r_gap):.2e}, max {r_gap.max():.2e}; t gap max "
          f"{t_gap.max():.2e}")
    assert np.mean(decided) >= 0.97
    assert len(r_gap) >= 100
    assert np.mean((r_gap < 1e-4) & (t_gap < 1e-3)) >= 0.98 and np.median(r_gap) < 1e-5


def test_solver_is_pure_and_reads_nothing_back(monkeypatch):
    uv1, uv2, mask, *_ = make_views(planar=False)
    idx_h, idx_f = t_init.sample_hypotheses(_t(mask), N_HYP, torch.Generator().manual_seed(0))
    args = (_t(uv1), _t(uv2), _t(mask), idx_h, idx_f, _t(K))
    assert_pure(t_init.solve_two_view, args)
    assert_reads_nothing_back(monkeypatch, t_init.solve_two_view, args)
