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
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.frontend import initializer as j_init
from multi_orb_slam_tpu_torch.frontend import initializer as t_init

from test_mono_init import K, angle_between, make_views

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
