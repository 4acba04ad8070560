"""PyTorch port vs JAX reference: `local_ba.solve_ba`.

The scenarios of `tests/test_local_ba.py` (its synthetic windowed problems,
built from a numpy seed) go through both packages' `solve_ba` with the same
`phases`.  Tolerances: `kf_Tcw` atol 1e-4 and `mp_pos` atol 1e-4 m (float32
LM iterations whose dense solve pivots, and whose reductions sum, in another
order than XLA's); fixed keyframes bit-unchanged; inlier masks equal except
where an observation's chi2 lies within 1e-3 (relative) of its gate.  A
point whose inlier observations do not fix its depth (none left after the
re-gate, or a single mono one) has a singular Hessian block that only the
damping floor holds, so round-off decides where it slides along its ray:
such points are held to 1e-3 m instead.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.optim import local_ba as j_ba
from multi_orb_slam_tpu_torch import convert
from multi_orb_slam_tpu_torch.optim import local_ba as t_ba
from multi_orb_slam_tpu_torch.optim import residuals as t_res
from test_local_ba import make_ba_problem

torch.set_num_threads(2)


def _scenario(name):
    if name == "multicam":
        return make_ba_problem(n_cams=2)
    prob, poses_gt, pts_gt, T_rc, K, bf = make_ba_problem()
    if name == "outliers":
        uvr = np.asarray(prob.obs_uvr).copy()
        rng = np.random.RandomState(3)
        for _ in range(20):
            l, j = rng.randint(uvr.shape[0]), rng.randint(uvr.shape[2])
            if np.asarray(prob.obs_mp)[l, 0, j] >= 0:
                uvr[l, 0, j, :2] += rng.uniform(20, 50, 2)
        prob = prob._replace(obs_uvr=jnp.asarray(uvr))
    if name == "mono_invalid":
        rng = np.random.RandomState(4)
        uvr = np.asarray(prob.obs_uvr).copy()
        uvr[..., 2] = np.where(rng.rand(*uvr.shape[:3]) < 0.4, -1.0, uvr[..., 2])
        mp_valid = rng.rand(prob.mp_pos.shape[0]) < 0.9
        kf_valid = np.ones(prob.kf_valid.shape[0], bool)
        kf_valid[1] = False
        is2 = (1.0 / 1.44 ** rng.randint(0, 4, uvr.shape[:3])).astype(np.float32)
        prob = prob._replace(obs_uvr=jnp.asarray(uvr), mp_valid=jnp.asarray(mp_valid),
                             kf_valid=jnp.asarray(kf_valid), obs_inv_sigma2=jnp.asarray(is2))
    return prob, poses_gt, pts_gt, T_rc, K, bf


def _chi2(prob, kf_Tcw, mp_pos, T_rc, K, bf):
    """chi2 [L, C, F] and gate [L, C, F] of every observation at a state."""
    L, C, F = prob.obs_mp.shape
    g = prob.obs_mp.clamp(min=0).long()
    e, _, _, is_st, posd = t_res.reproj_residual(
        kf_Tcw[:, None, None], mp_pos[g], T_rc[None, :, None], K[None, :, None], bf,
        prob.obs_uvr, want_jac=False)
    chi2 = torch.sum(e * e * t_res.row_weights(is_st), dim=-1) * prob.obs_inv_sigma2
    return chi2.numpy(), np.where(is_st.numpy(), 7.815, 5.991)


def _hold_to_reference(prob, T_rc, K, bf, phases):
    """Both packages' `solve_ba` on one problem, held together at the
    tolerances above; returns the port's live LM trips."""
    kf_j, mp_j, inl_j = j_ba.solve_ba(prob, T_rc, K, bf, phases=phases)
    tprob = convert.to_torch(prob, t_ba.BAProblem, "cpu")
    T = lambda x: torch.from_numpy(np.asarray(x).copy())  # noqa: E731
    before = t_ba.STATS.read()
    kf_t, mp_t, inl_t = t_ba.solve_ba(tprob, T(T_rc), T(K), T(bf), phases=phases)
    after = t_ba.STATS.read()
    n_it = after["iterations"] - before.get("iterations", 0)
    assert after["solves"] == before.get("solves", 0) + 1
    assert 1 <= n_it <= sum(p[0] for p in phases)
    assert after["trips"] - before.get("trips", 0) == sum(p[0] for p in phases)

    np.testing.assert_allclose(kf_t.numpy(), np.asarray(kf_j), atol=1e-4)
    inl_j, inl_t = np.asarray(inl_j), inl_t.numpy()
    obs = np.asarray(prob.obs_mp)
    both = inl_j & inl_t
    n_inl = np.bincount(obs[both], minlength=prob.mp_pos.shape[0])
    n_st = np.bincount(obs[both & (np.asarray(prob.obs_uvr)[..., 2] >= 0)],
                       minlength=prob.mp_pos.shape[0])
    held = (n_inl >= 2) | (n_st >= 1)            # inliers fix the depth
    np.testing.assert_allclose(mp_t.numpy()[held], np.asarray(mp_j)[held], atol=1e-4)
    np.testing.assert_allclose(mp_t.numpy(), np.asarray(mp_j), atol=1e-3)
    assert held.sum() >= 0.8 * np.asarray(prob.mp_valid).sum()
    fixed = ~np.asarray(prob.kf_free)
    np.testing.assert_array_equal(kf_t.numpy()[fixed], np.asarray(prob.kf_Tcw)[fixed])
    differ = inl_j != inl_t
    if differ.any():
        chi2, gate = _chi2(tprob, kf_t, mp_t, T(T_rc), T(K), T(bf))
        assert (np.abs(chi2 - gate)[differ] <= 1e-3 * gate[differ]).all(), \
            (int(differ.sum()), chi2[differ], gate[differ])
    assert inl_t.sum() > 0.5 * (np.asarray(prob.obs_mp) >= 0).sum()
    return n_it, inl_t


@pytest.mark.parametrize("phases", [((5, True), (10, False)), ((5, True), (8, False)),
                                    ((2, True), (3, False))])
@pytest.mark.parametrize("name", ["default", "outliers", "multicam", "mono_invalid"])
def test_solve_ba_matches_reference(name, phases):
    prob, _, _, T_rc, K, bf = _scenario(name)
    _, inl_t = _hold_to_reference(prob, T_rc, K, bf, phases)
    if name == "outliers":
        assert (~inl_t & (np.asarray(prob.obs_mp) >= 0)).sum() >= 10


def test_solve_ba_early_exit_and_phase_jump_match_reference():
    """Started at the truth (0.1 px of noise in the measurements), the
    Huber phase stagnates in fewer than its 5 iterations, so the schedule
    jumps to the next phase boundary, and the final phase stagnates before
    its 20 run out: fewer live trips than the 25 computed, more than the
    Huber phase takes alone.  The result is the reference's.  (The Huber
    phase alone is not held to the reference: its last step, at the
    optimum, is accepted or not on a cost change at round-off.)"""
    prob, _, _, T_rc, K, bf = make_ba_problem(pose_noise=0.0, point_noise=0.0)
    T = lambda x: torch.from_numpy(np.asarray(x).copy())  # noqa: E731
    before = t_ba.STATS.read()
    t_ba.solve_ba(convert.to_torch(prob, t_ba.BAProblem, "cpu"), T(T_rc), T(K), T(bf),
                  phases=((5, True),))
    n_huber = t_ba.STATS.read()["iterations"] - before.get("iterations", 0)
    before = t_ba.STATS.read()
    n_both, _ = _hold_to_reference(prob, T_rc, K, bf, ((5, True), (20, False)))
    assert t_ba.STATS.read()["trips"] - before["trips"] == 25
    assert n_huber < 5 and n_huber < n_both < 25, (n_huber, n_both)


def test_ba_problem_converts_both_ways():
    prob = make_ba_problem(n_cams=2)[0]
    back = j_ba.BAProblem(**convert.to_numpy(convert.to_torch(prob, t_ba.BAProblem, "cpu")))
    for f in prob._fields:
        a, b = np.asarray(getattr(prob, f)), np.asarray(getattr(back, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
