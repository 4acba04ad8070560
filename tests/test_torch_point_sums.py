"""PyTorch port vs JAX reference: the `point_sums` kernel's plain version.

`point_sums_plain` (what the wrapper runs for CPU tensors) against
`pallas_kernels.point_sums_pallas` in interpret mode, on the inputs the
reference's own test builds (each row a random injection of F features into
P points, the rest -1).  `gathered` is a selection and must be equal;
`summed` adds LC float32 values in another order than the reference's
accumulator may, so it is held to atol 1e-5.  And the local-BA re-layout
through `point_sums` equals the reference's two `take_along_axis` gathers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.ops import pallas_kernels as pk
from multi_orb_slam_tpu_torch.ops import kernels
from multi_orb_slam_tpu_torch.optim import local_ba as t_ba

torch.set_num_threads(2)


def _inputs(LC, F, P, D, seed=0, empty_row=None):
    rng = np.random.RandomState(seed)
    V = rng.randn(LC, F, D).astype(np.float32)
    inv = np.full((LC, P), -1, np.int32)
    for r in range(LC):
        inv[r, rng.choice(P, F, replace=False)] = rng.permutation(F)
    if empty_row is not None:
        inv[empty_row] = -1
    return V, inv


@pytest.mark.parametrize("D,empty_row", [(30, None), (4, None), (4, 2), (1, 0)])
def test_point_sums_plain_matches_pallas(D, empty_row):
    LC, F, P = 4, 128, 700
    V, inv = _inputs(LC, F, P, D, seed=D, empty_row=empty_row)
    s_j, g_j = pk.point_sums_pallas(jnp.asarray(V), jnp.asarray(inv), True)
    s_t, g_t = kernels.point_sums(torch.from_numpy(V), torch.from_numpy(inv))
    assert g_t.shape == (LC, P, D) and s_t.shape == (P, D)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-5)
    if empty_row is not None:
        assert not g_t[empty_row].any()


def test_point_sums_all_empty_and_checks():
    V = torch.randn(3, 8, 4)
    inv = torch.full((3, 5), -1, dtype=torch.int32)
    s, g = kernels.point_sums(V, inv)
    assert not s.any() and not g.any()
    with pytest.raises(TypeError):
        kernels.point_sums(V, inv.long())
    with pytest.raises(ValueError):
        kernels.point_sums(V, inv[:2])
    # an index >= F is clamped to the last row, in the plain version as in
    # the kernel
    inv[0, 0] = 99
    assert torch.equal(kernels.point_sums(V, inv)[1][0, 0], V[0, 7])


def test_solve_ba_relayout_matches_reference():
    """`relayout_observations` (through `point_sums`) against the
    reference's inverse map + take_along_axis, with invalid keyframes,
    invalid points, mono observations and empty slots in the mix."""
    rng = np.random.RandomState(5)
    L, C, F, P = 5, 2, 48, 70
    obs_mp = np.full((L, C, F), -1, np.int32)
    for l in range(L):
        for c in range(C):
            n = rng.randint(10, F)
            obs_mp[l, c, rng.choice(F, n, replace=False)] = rng.choice(P, n, replace=False)
    uvr = rng.uniform(0, 300, (L, C, F, 3)).astype(np.float32)
    uvr[..., 2] = np.where(rng.rand(L, C, F) < 0.3, -1.0, uvr[..., 2])
    is2 = rng.uniform(0.2, 1.0, (L, C, F)).astype(np.float32)
    kf_valid = np.array([1, 1, 0, 1, 1], bool)
    mp_valid = rng.rand(P) < 0.9
    prob = t_ba.BAProblem(
        kf_slot=torch.arange(L, dtype=torch.int32), kf_Tcw=torch.eye(4).repeat(L, 1, 1),
        kf_free=torch.ones(L, dtype=torch.bool), kf_valid=torch.from_numpy(kf_valid),
        mp_slot=torch.arange(P, dtype=torch.int32), mp_pos=torch.zeros(P, 3),
        mp_valid=torch.from_numpy(mp_valid), obs_mp=torch.from_numpy(obs_mp),
        obs_uvr=torch.from_numpy(uvr), obs_inv_sigma2=torch.from_numpy(is2))
    inv_t, ok_t, uvr_t, is2_t = t_ba.relayout_observations(prob)

    # the reference's re-layout, as at the head of its solve_ba
    ok_f = ((obs_mp >= 0) & kf_valid[:, None, None] & mp_valid[np.clip(obs_mp, 0, P - 1)])
    pidx = jnp.where(ok_f, obs_mp, P)
    inv = jnp.full((L, C, P + 1), -1, jnp.int32).at[
        jnp.arange(L)[:, None, None], jnp.arange(C)[None, :, None], pidx].set(
        jnp.broadcast_to(jnp.arange(F, dtype=jnp.int32), (L, C, F)))[:, :, :P]
    valid = inv >= 0
    ginv = jnp.clip(inv, 0, F - 1)[..., None]
    uvr_g = jnp.where(valid[..., None], jnp.take_along_axis(jnp.asarray(uvr), ginv, axis=2),
                      jnp.asarray([0.0, 0.0, -1.0], jnp.float32))
    is2_g = jnp.where(valid, jnp.take_along_axis(jnp.asarray(is2), ginv[..., 0], axis=2), 0.0)
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv))
    np.testing.assert_array_equal(ok_t.numpy(), ok_f)
    np.testing.assert_array_equal(uvr_t.numpy(), np.asarray(uvr_g))
    np.testing.assert_array_equal(is2_t.numpy(), np.asarray(is2_g))
