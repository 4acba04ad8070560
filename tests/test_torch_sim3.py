"""PyTorch port vs JAX reference: Sim(3), the Sim3 RANSAC solver, the Sim3
LM and the essential-graph optimization.

The same numpy inputs (from a seed) go through both packages' functions.
Tolerances:

- `sim3` ops 1e-5; the forward-mode Jacobian of `log o compose o exp` 1e-5
  on the general branch and on each series branch of `_W` (small theta,
  small sigma, both).  Between a series threshold (1e-4) and ~1e-2 the
  reference's closed form subtracts nearly equal float32 numbers, and there
  the two packages' Jacobians part by up to ~1e-3 (other `sin` / `cos` /
  `exp` roundings, the same formula): those inputs are not used here.
- RANSAC on the reference's own triplets (drawn with its `jax.random` lines):
  the Sim3 to 1e-4, the inlier masks equal except for points whose error lies
  within 1% of the gate.
- `optimize_sim3` on the problems of `tests/test_sim3_opt.py` and
  `tests/test_sim3_multicam.py`: the Sim3 to 1e-4, inliers as above.
- `build_essential_edges`: the edges equal, the measurements to 1e-5;
  `optimize_essential_graph` to 1e-4.

The forms that run inside CUDA graphs on the card: `align.umeyama_quat`
(the RANSAC's SVD-free closed form) against the SVD `umeyama`; the three
graphed solvers leave their inputs bit-unchanged and read nothing back
through their entries; `sim3.jacfwd_batched` reads nothing back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.geometry import sim3 as j_sim3
from multi_orb_slam_tpu.loop import sim3_solver as j_solver
from multi_orb_slam_tpu.optim import pose_graph as j_pg
from multi_orb_slam_tpu.optim import sim3_opt as j_opt
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.geometry import sim3 as t_sim3
from multi_orb_slam_tpu_torch.loop import sim3_solver as t_solver
from multi_orb_slam_tpu_torch.optim import pose_graph as t_pg
from multi_orb_slam_tpu_torch.optim import sim3_opt as t_opt

import test_sim3_multicam
import test_sim3_opt

torch.set_num_threads(2)


def _t(a):
    return convert._field_to_torch(np.asarray(a), "cpu")


def _tangents(kind, n, rng):
    """[n, 7] tangents: rotation and log-scale at least 0.05 (the general
    branch), or below 1e-5 where `kind` makes them small (a series branch)."""
    xi = (rng.randn(n, 7) * 0.4).astype(np.float32)
    xi[:, 3:7] += np.sign(xi[:, 3:7]) * 0.05
    if kind in ("small_theta", "both_small"):
        xi[:, 3:6] *= 1e-5 / np.abs(xi[:, 3:6]).max()
    if kind in ("small_sigma", "both_small"):
        xi[:, 6] *= 1e-5 / np.abs(xi[:, 6]).max()
    return xi


@pytest.mark.parametrize("kind", ["general", "small_theta", "small_sigma", "both_small"])
def test_sim3_ops(kind):
    rng = np.random.RandomState(1)
    xi, xi2 = _tangents(kind, 40, rng), _tangents("general", 40, rng)
    x = rng.randn(40, 3).astype(np.float32)
    gj, gj2 = j_sim3.exp(jnp.asarray(xi)), j_sim3.exp(jnp.asarray(xi2))
    gt, gt2 = t_sim3.exp(_t(xi)), t_sim3.exp(_t(xi2))
    pairs = [
        ("exp", gj, gt),
        ("log", j_sim3.log(gj), t_sim3.log(gt)),
        ("compose", j_sim3.compose(gj, gj2), t_sim3.compose(gt, gt2)),
        ("inverse", j_sim3.inverse(gj), t_sim3.inverse(gt)),
        ("apply", j_sim3.apply(gj, jnp.asarray(x)), t_sim3.apply(gt, _t(x))),
        ("apply [N, 3]", j_sim3.apply(gj[0], jnp.asarray(x)), t_sim3.apply(gt[0], _t(x))),
        ("to_se3", j_sim3.to_se3(gj), t_sim3.to_se3(gt)),
        ("from_se3", j_sim3.from_se3(j_sim3.to_se3(gj)), t_sim3.from_se3(t_sim3.to_se3(gt))),
        ("W", j_sim3._W(jnp.asarray(xi[:, 3:6]), jnp.asarray(xi[:, 6])),
         t_sim3._W(_t(xi[:, 3:6]), _t(xi[:, 6]))),
    ]
    for name, a, b in pairs:
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5, err_msg=name)
    # log inverts exp
    np.testing.assert_allclose(t_sim3.log(gt).numpy(), xi, atol=2e-5)
    assert torch.equal(t_sim3.identity(), _t(np.asarray(j_sim3.identity())))


@pytest.mark.parametrize("kind", ["general", "small_theta", "small_sigma", "both_small"])
def test_jacobian_of_log_compose(kind):
    """d/dx log(exp(x) * g * h) at x = 0, as the pose graph takes it, and at
    a tangent x on the chosen branch."""
    rng = np.random.RandomState(2)
    g_xi, h_xi = _tangents("general", 30, rng), _tangents("general", 30, rng)
    gj, hj = j_sim3.exp(jnp.asarray(g_xi)), j_sim3.exp(jnp.asarray(h_xi))
    gt, ht = t_sim3.exp(_t(g_xi)), t_sim3.exp(_t(h_xi))
    for x in (np.zeros((30, 7), np.float32), _tangents(kind, 30, rng)):
        Jj = jax.vmap(jax.jacfwd(
            lambda x_, g, h: j_sim3.log(j_sim3.compose(j_sim3.exp(x_), j_sim3.compose(g, h)))))(
            jnp.asarray(x), gj, hj)
        Jt = t_sim3.jacfwd_batched(
            lambda x_: t_sim3.log(t_sim3.compose(t_sim3.exp(x_), t_sim3.compose(gt, ht))), _t(x))
        assert Jt.shape == (30, 7, 7) and Jt.dtype == torch.float32
        assert bool(torch.isfinite(Jt).all())
        np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-5)
    # through the series branches themselves: log o exp at the tangent
    xs = _tangents(kind, 30, rng)
    Jj = jax.vmap(jax.jacfwd(lambda x_: j_sim3.log(j_sim3.exp(x_))))(jnp.asarray(xs))
    Jt = t_sim3.jacfwd_batched(lambda x_: t_sim3.log(t_sim3.exp(x_)), _t(xs))
    np.testing.assert_allclose(Jt.numpy(), np.asarray(Jj), atol=1e-5)


def _reference_triplets(key, valid, n_hyp=128):
    """The draws of `sim3_solver.solve_sim3_ransac` (its lines `keys = ...`
    to `tri = ...`)."""
    N = valid.shape[0]
    keys = jax.random.split(key, n_hyp)

    def sample3(k):
        g = jax.random.gumbel(k, (N,)) + jnp.where(valid, 0.0, -1e9)
        _, idx = jax.lax.top_k(g, 3)
        return idx

    return np.asarray(jax.vmap(sample3)(keys))


def _two_way_errors(g, pts_a, pts_b, cams, T_rc, K):
    """Squared reprojection errors of both directions under g (numpy)."""
    def proj(X, c):
        Trc = T_rc[c]
        Xc = np.einsum("nij,nj->ni", Trc[:, :3, :3], X) + Trc[:, :3, 3]
        return np.stack([K[c, 0] * Xc[:, 0] / Xc[:, 2] + K[c, 2],
                         K[c, 1] * Xc[:, 1] / Xc[:, 2] + K[c, 3]], -1)

    gj = jnp.asarray(g)
    X_ab = np.asarray(j_sim3.apply(gj, jnp.asarray(pts_b)))
    X_ba = np.asarray(j_sim3.apply(j_sim3.inverse(gj), jnp.asarray(pts_a)))
    e_ab = np.sum((proj(X_ab, cams) - proj(pts_a, cams)) ** 2, -1)
    e_ba = np.sum((proj(X_ba, cams) - proj(pts_b, cams)) ** 2, -1)
    return e_ab, e_ba


def _ransac_case(case):
    """(pts_a, pts_b, cam ids, valid, T_rc, K) of `test_sim3_multicam`'s pair."""
    _, (pts_a, pts_b, cams, T_rc) = test_sim3_multicam.make_pair(
        noise=0.01 if case == "noisy_outliers" else 0.0)
    n = pts_a.shape[0]
    valid = np.ones(n, bool)
    if case == "noisy_outliers":
        rng = np.random.RandomState(3)
        bad = rng.choice(n, 40, replace=False)
        pts_b[bad] += rng.uniform(-0.5, 0.5, (40, 3)).astype(np.float32)
        valid[-20:] = False
    cam_in = np.zeros(n, np.int32) if case == "cam_ids_zeroed" else cams
    return pts_a, pts_b, cam_in, valid, T_rc, np.asarray(test_sim3_multicam.K2)


def _hold_ransac(case, g_t, inl_t, n_t, g_j, inl_j, n_j):
    """The port's RANSAC result against the reference's on the same draws:
    g to 1e-4, inlier flags equal but where a point's error sits within 1%
    of the gate, counts apart by at most those."""
    pts_a, pts_b, cam_in, valid, T_rc, K = _ransac_case(case)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)
    e_ab, e_ba = _two_way_errors(np.asarray(g_j), pts_a, pts_b, cam_in, np.asarray(T_rc), K)
    th2 = 9.210 * 10.0
    differ = np.nonzero(inl_t.numpy() != np.asarray(inl_j))[0]
    near = (np.abs(e_ab - th2) < 0.01 * th2) | (np.abs(e_ba - th2) < 0.01 * th2)
    assert near[differ].all(), differ
    assert abs(int(n_t) - int(n_j)) <= len(differ)
    if case != "cam_ids_zeroed":
        assert int(n_t) >= 0.6 * pts_a.shape[0]


def _reference_ransac(case, key):
    pts_a, pts_b, cam_in, valid, T_rc, K = _ransac_case(case)
    return j_solver.solve_sim3_ransac(
        key, jnp.asarray(pts_a), jnp.asarray(pts_b), jnp.asarray(cam_in), jnp.asarray(cam_in),
        jnp.asarray(valid), T_rc, jnp.asarray(K))


@pytest.mark.parametrize("case", ["clean", "noisy_outliers", "cam_ids_zeroed"])
def test_ransac_solver_on_the_reference_triplets(case):
    pts_a, pts_b, cam_in, valid, T_rc, K = _ransac_case(case)
    key = jax.random.PRNGKey(7)
    tri = _reference_triplets(key, jnp.asarray(valid))
    out_t = t_solver.solve_sim3(
        torch.from_numpy(tri.copy()).long(), _t(pts_a), _t(pts_b), _t(cam_in), _t(cam_in),
        _t(valid), _t(np.asarray(T_rc)), _t(K))
    _hold_ransac(case, *out_t, *_reference_ransac(case, key))


@pytest.mark.parametrize("case", ["clean", "noisy_outliers"])
def test_solve_sim3_ransac_on_the_reference_draws(case, monkeypatch):
    """`solve_sim3_ransac` (the draws from a `torch.Generator`, then the
    graphed solver) with its sampler handed the reference's draws for the
    key: the reference's result, as `solve_sim3` is held; and with the
    port's own draws, a generator that draws alike gives the same bits."""
    pts_a, pts_b, cam_in, valid, T_rc, K = _ransac_case(case)
    key = jax.random.PRNGKey(7)
    tri = torch.from_numpy(_reference_triplets(key, jnp.asarray(valid)).copy()).long()
    args = (_t(pts_a), _t(pts_b), _t(cam_in), _t(cam_in), _t(valid), _t(np.asarray(T_rc)), _t(K))
    with monkeypatch.context() as mp:
        mp.setattr(t_solver, "sample_triplets", lambda v, n_hyp, gen: tri[:n_hyp])
        out_t = t_solver.solve_sim3_ransac(torch.Generator(), *args)
    _hold_ransac(case, *out_t, *_reference_ransac(case, key))
    own = [t_solver.solve_sim3_ransac(torch.Generator().manual_seed(3), *args) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*own))
    assert int(own[0][2]) >= 0.6 * pts_a.shape[0]


def test_edge_residual():
    """The pose graph's residual on random Sim(3) poses, tangents and
    measurements, rows indexed by arrays and by ints: the reference's to
    1e-5."""
    rng = np.random.RandomState(0)
    K, E = 12, 30
    g = np.asarray(j_sim3.exp(jnp.asarray(rng.randn(K, 7).astype(np.float32) * 0.3)))
    xi = rng.randn(K, 7).astype(np.float32) * 0.05
    meas = np.asarray(j_sim3.exp(jnp.asarray(rng.randn(E, 7).astype(np.float32) * 0.2)))
    i, j = rng.randint(0, K, E), rng.randint(0, K, E)
    ref = np.asarray(j_pg.edge_residual(jnp.asarray(g), jnp.asarray(xi), jnp.asarray(i),
                                        jnp.asarray(j), jnp.asarray(meas)))
    got = t_pg.edge_residual(_t(g), _t(xi), torch.from_numpy(i), torch.from_numpy(j), _t(meas))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    one = t_pg.edge_residual(_t(g), _t(xi), 3, 7, _t(meas[0]))
    np.testing.assert_allclose(one.numpy(), np.asarray(j_pg.edge_residual(
        jnp.asarray(g), jnp.asarray(xi), 3, 7, jnp.asarray(meas[0]))), atol=1e-5)


def _sim3_problems():
    g_true, obs, _ = test_sim3_opt.make_problem()
    g0 = j_sim3.compose(j_sim3.exp(jnp.asarray(
        [0.05, -0.03, 0.08, 0.01, 0.02, -0.015, 0.0])), g_true)
    yield "fixed scale, outliers", g0, obs, jnp.asarray(test_sim3_opt.K0), None, True
    g_true, obs, _ = test_sim3_opt.make_problem(outlier_frac=0.0, noise_px=0.2)
    obs = obs._replace(X_b=obs.X_b / 1.25)
    g_scaled = j_sim3.compose(g_true, j_sim3.pack(jnp.asarray(1.25), jnp.eye(3), jnp.zeros(3)))
    g0 = j_sim3.compose(j_sim3.exp(jnp.asarray([0.03, 0.0, 0.05, 0.0, 0.01, 0.0, 0.1])), g_scaled)
    yield "free scale", g0, obs, jnp.asarray(test_sim3_opt.K0), None, False
    g_true, (pts_a, pts_b, cams, T_rc) = test_sim3_multicam.make_pair(noise=0.002)
    K2 = np.asarray(test_sim3_multicam.K2)

    def cam_uv(X):
        Trc = np.asarray(T_rc)[cams]
        Xc = np.einsum("nij,nj->ni", Trc[:, :3, :3], X) + Trc[:, :3, 3]
        return np.stack([K2[cams, 0] * Xc[:, 0] / Xc[:, 2] + K2[cams, 2],
                         K2[cams, 1] * Xc[:, 1] / Xc[:, 2] + K2[cams, 3]], -1)

    n = pts_a.shape[0]
    uv_a = cam_uv(pts_a).astype(np.float32)
    uv_a[:25] += 30.0                       # a few gross outliers in camera 0
    obs = j_opt.Sim3Obs(
        X_a=jnp.asarray(pts_a), X_b=jnp.asarray(pts_b), uv_a=jnp.asarray(uv_a),
        uv_b=jnp.asarray(cam_uv(pts_b).astype(np.float32)),
        inv_sigma2_a=jnp.ones(n), inv_sigma2_b=jnp.ones(n), mask=jnp.ones(n, bool),
        cam_a=jnp.asarray(cams), cam_b=jnp.asarray(cams))
    g0 = j_sim3.compose(j_sim3.exp(jnp.asarray([0.02, -0.01, 0.03, 0.05, -0.04, 0.02, 0.0])),
                        g_true)
    yield "two cameras", g0, obs, jnp.asarray(K2), T_rc, True


@pytest.mark.parametrize("which", [0, 1, 2])
def test_optimize_sim3(which):
    name, g0, obs, K, T_rc, fix = list(_sim3_problems())[which]
    g_j, inl_j, n_j = j_opt.optimize_sim3(g0, obs, K, T_rc=T_rc, fix_scale=fix)
    obs_t = convert.to_torch(obs, t_opt.Sim3Obs, "cpu")
    g_t, inl_t, n_t = t_opt.optimize_sim3(
        _t(g0), obs_t, _t(K), T_rc=None if T_rc is None else _t(T_rc), fix_scale=fix)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4, err_msg=name)
    # chi2 of both edge families at the reference's solution
    multi = T_rc is not None

    def proj(X, cam):
        if multi:
            Trc = np.asarray(T_rc)[cam]
            X = np.einsum("nij,nj->ni", Trc[:, :3, :3], X) + Trc[:, :3, 3]
            Kc = np.asarray(K)[cam]
        else:
            Kc = np.broadcast_to(np.asarray(K), (X.shape[0], 4))
        return np.stack([Kc[:, 0] * X[:, 0] / X[:, 2] + Kc[:, 2],
                         Kc[:, 1] * X[:, 1] / X[:, 2] + Kc[:, 3]], -1)

    cam = np.asarray(obs.cam_a) if multi else None
    X1 = np.asarray(j_sim3.apply(g_j, obs.X_b))
    X2 = np.asarray(j_sim3.apply(j_sim3.inverse(g_j), obs.X_a))
    c1 = np.sum((np.asarray(obs.uv_a) - proj(X1, cam)) ** 2, -1)
    c2 = np.sum((np.asarray(obs.uv_b) - proj(X2, cam)) ** 2, -1)
    near = (np.abs(c1 - 10.0) < 0.1) | (np.abs(c2 - 10.0) < 0.1)
    differ = np.nonzero(inl_t.numpy() != np.asarray(inl_j))[0]
    assert near[differ].all(), (name, differ)
    assert abs(int(n_t) - int(n_j)) <= len(differ) and int(n_t) >= 100
    if fix:
        assert abs(float(g_t[7]) - 1.0) < 1e-5


def _pose_graph_case(K=24, seed=4):
    """A drifted chain of K keyframes on a circle, banded covisibility with
    a few strong pairs, one loop (last -> first) and its corrected
    neighbourhood: the inputs of `build_essential_edges` (numpy)."""
    rng = np.random.RandomState(seed)
    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    xi_true = np.zeros((K, 7), np.float32)
    xi_true[:, 0] = 3 * np.cos(ang)
    xi_true[:, 2] = 3 * np.sin(ang)
    xi_true[:, 4] = ang
    drift = np.cumsum(rng.randn(K, 7).astype(np.float32) * 0.01, axis=0)
    drift[:, 6] = 0.0
    g_old = np.asarray(j_sim3.exp(jnp.asarray(xi_true + drift)))
    covis = np.zeros((K, K), np.float32)
    for k in range(K):
        for d in (1, 2, 3):
            if k + d < K:
                covis[k, k + d] = covis[k + d, k] = [150, 60, 20][d - 1] + rng.randint(0, 10)
    covis[0, K - 1] = covis[K - 1, 0] = 40
    kf_valid = np.ones(K, bool)
    kf_valid[5] = False                       # a culled slot
    covis[5] = covis[:, 5] = 0
    frame_id = (np.arange(K) * 7).astype(np.int32)
    frame_id[[3, 4]] = frame_id[[4, 3]]       # slot order != frame order
    corr_mask = np.zeros(K, bool)
    corr_mask[[K - 1, K - 2, K - 3]] = True
    g_corr = g_old.copy()
    g_corr[corr_mask] = np.asarray(j_sim3.exp(jnp.asarray(xi_true[corr_mask])))
    return covis, kf_valid, frame_id, g_old, g_corr, corr_mask, [(K - 1, 0)]


def test_build_and_optimize_essential_graph():
    covis, kf_valid, frame_id, g_old, g_corr, corr_mask, loops = _pose_graph_case()
    K = covis.shape[0]
    ej_ = j_pg.build_essential_edges(covis, kf_valid, frame_id, jnp.asarray(g_old),
                                     (g_corr, corr_mask), loops, max_edges=256)
    et_ = t_pg.build_essential_edges(covis, kf_valid, frame_id, _t(g_old),
                                     (_t(g_corr), corr_mask), loops, max_edges=256)
    for name, a, b in zip(("e_i", "e_j", "ok"), (ej_[0], ej_[1], ej_[3]), (et_[0], et_[1], et_[3])):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=name)
    np.testing.assert_allclose(et_[2].numpy(), np.asarray(ej_[2]), atol=1e-5)
    n_edges = int(np.asarray(ej_[3]).sum())
    edges = set(zip(et_[0][:n_edges].tolist(), et_[1][:n_edges].tolist()))
    assert 20 <= n_edges < 256 and (0, K - 1) in edges and not any(5 in e for e in edges)
    # the measurements are taken from the poses the solve starts at, so
    # that start is the minimum already (in both packages); start it from a
    # perturbed copy to make the solver work
    kf_free = kf_valid & (np.arange(K) != 0)
    pert = np.random.RandomState(5).randn(K, 7).astype(np.float32) * 0.02
    pert[:, 6] = 0.0
    pert[~kf_free] = 0.0
    g0 = np.asarray(j_sim3.compose(j_sim3.exp(jnp.asarray(pert)), jnp.asarray(g_corr)))
    gj = j_pg.optimize_essential_graph(jnp.asarray(g0), jnp.asarray(kf_free), *ej_)
    gt = t_pg.optimize_essential_graph(_t(g0), _t(kf_free), *et_)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=1e-4)
    # it moved back towards the consistent poses
    moved = np.abs(np.asarray(gj) - g0)[kf_free].max()
    assert moved > 1e-3 and np.abs(gt.numpy() - g_corr)[kf_free].max() < 0.5 * moved
    # fixed slots only take a zero step (composed, so rounded once)
    np.testing.assert_allclose(gt.numpy()[~kf_free], g0[~kf_free], atol=1e-6)


# ---------------------------------------------------------------------------
# the forms that run inside CUDA graphs: no SVD, no host read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,noise,weighted", [(3, 0.0, False), (3, 0.3, False),
                                               (40, 0.05, True), (200, 1.0, False)])
def test_umeyama_quat_is_umeyama(n, noise, weighted):
    """`align.umeyama_quat` (Horn's quaternion form, Jacobi sweeps) against
    `align.umeyama` (SVD) in float64 on the same float32 inputs, 500 draws:
    a proper rotation whose fit costs no more than the optimum plus 1e-5 of
    the data's spread, and (s, R, t) to 1e-5 in the median draw.  The
    3-point sets of the RANSAC are near-degenerate in a few draws, where the
    cost is flat along one rotation and neither solver pins R down; with 40
    or more points every draw is within 1e-5."""
    from multi_orb_slam_tpu_torch.geometry import align, se3

    rng = np.random.RandomState(n)
    B = 500
    src = _t(rng.randn(B, n, 3).astype(np.float32) * 2)
    R = se3.so3_exp(_t(rng.randn(B, 3).astype(np.float32) * 1.5))
    dst = (1.3 * (src @ R.transpose(-1, -2)) + _t(rng.randn(B, 1, 3).astype(np.float32))
           + noise * _t(rng.randn(B, n, 3).astype(np.float32)))
    w = _t((rng.rand(B, n) < 0.7).astype(np.float32)) if weighted else torch.ones(B, n)

    def cost(fit):
        s_, R_, t_ = (x.double() for x in fit)
        r = dst.double() - (s_[:, None, None] * (src.double() @ R_.transpose(-1, -2))
                            + t_[:, None])
        return torch.sum(w.double() * torch.sum(r * r, -1), -1)

    spread = torch.sum(w.double() * torch.sum(dst.double() ** 2, -1), -1)
    for with_scale in (False, True):
        ref = align.umeyama(src.double(), dst.double(), w.double(), with_scale)
        quat = align.umeyama_quat(src, dst, w, with_scale)
        assert bool((cost(quat) <= cost(ref) + 1e-5 * spread).all()), with_scale
        assert torch.allclose(torch.linalg.det(quat[1]), torch.ones(B), atol=1e-5)
        for a, c in zip(ref, quat):
            err = (c.double() - a).abs().reshape(B, -1).amax(dim=1)
            assert float(err.median()) < 1e-5 and (n < 40 or float(err.max()) < 1e-5)


@pytest.fixture(scope="module")
def loop_solver_calls():
    """{name: (graphed function, arguments)} of the loop's three solvers on
    the cases above."""
    _, (pts_a, pts_b, cams, T_rc) = test_sim3_multicam.make_pair(noise=0.01)
    valid = np.ones(pts_a.shape[0], bool)
    tri = _reference_triplets(jax.random.PRNGKey(7), jnp.asarray(valid))
    K = _t(np.asarray(test_sim3_multicam.K2))
    _, g0, obs, K2, T_rc2, fix = list(_sim3_problems())[2]
    covis, kf_valid, frame_id, g_old, g_corr, corr_mask, loops = _pose_graph_case()
    edges = t_pg.build_essential_edges(covis, kf_valid, frame_id, _t(g_old),
                                       (_t(g_corr), corr_mask), loops, max_edges=256)
    kf_free = kf_valid & (np.arange(covis.shape[0]) != 0)
    return {
        "solve_sim3": (t_solver.solve_sim3, (
            torch.from_numpy(tri.copy()).long(), _t(pts_a), _t(pts_b), _t(cams), _t(cams),
            _t(valid), _t(np.asarray(T_rc)), K)),
        "optimize_sim3": (t_opt.optimize_sim3, (
            _t(g0), convert.to_torch(obs, t_opt.Sim3Obs, "cpu"), _t(K2), _t(T_rc2), fix)),
        "optimize_essential_graph": (t_pg.optimize_essential_graph,
                                     (_t(g_corr), _t(kf_free)) + tuple(edges)),
    }


@pytest.mark.parametrize("name", ["solve_sim3", "optimize_sim3", "optimize_essential_graph"])
def test_loop_solver_leaves_inputs_unchanged(loop_solver_calls, name):
    from test_torch_graphs import assert_pure

    assert_pure(*loop_solver_calls[name])


@pytest.mark.parametrize("name", ["solve_sim3", "optimize_sim3", "optimize_essential_graph"])
def test_loop_solver_reads_nothing_back(loop_solver_calls, monkeypatch, name):
    """Each solver through its entry with every host reader patched to
    raise (`test_torch_graphs.assert_reads_nothing_back`): the Sim3 LM and the
    essential graph take their Jacobians with `sim3.jacfwd_batched`
    (`torch.func.jvp`), the RANSAC its closed form with `umeyama_quat`."""
    from test_torch_graphs import assert_reads_nothing_back

    assert_reads_nothing_back(monkeypatch, *loop_solver_calls[name])


def test_jacfwd_batched_reads_nothing_back(monkeypatch):
    """The forward-mode Jacobian alone under the same check: `torch.func.jvp`
    over the tangent batch reads nothing back and makes no tensor from host
    data."""
    from test_torch_fused import _NoHostRead, _raiser

    rng = np.random.RandomState(3)
    gt, ht = t_sim3.exp(_t(_tangents("general", 30, rng))), t_sim3.exp(
        _t(_tangents("general", 30, rng)))

    def f(x_):
        return t_sim3.log(t_sim3.compose(t_sim3.exp(x_), t_sim3.compose(gt, ht)))

    x = _t(_tangents("small_sigma", 30, rng))
    want = t_sim3.jacfwd_batched(f, x)
    for attr in ("tolist", "item", "__bool__", "__int__", "__float__", "__index__"):
        monkeypatch.setattr(torch.Tensor, attr, _raiser(f"Tensor.{attr}"))
    for attr in ("tensor", "as_tensor", "from_numpy"):
        monkeypatch.setattr(torch, attr, _raiser(f"torch.{attr}"))
    with _NoHostRead():
        got = t_sim3.jacfwd_batched(f, x)
    monkeypatch.undo()
    assert torch.equal(got, want)
