"""PyTorch port vs JAX reference: se3, camera, align and the synthetic renderer.

Same numpy inputs (seeded) through both packages; float32 geometry agrees
to atol 1e-5 (the two frameworks' float32 transcendental functions and
reduction orders differ in the last bits).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.geometry import align as j_align
from multi_orb_slam_tpu.geometry import camera as j_cam
from multi_orb_slam_tpu.geometry import se3 as j_se3
from multi_orb_slam_tpu.io import synthetic as j_syn
from multi_orb_slam_tpu_torch.geometry import align as t_align
from multi_orb_slam_tpu_torch.geometry import camera as t_cam
from multi_orb_slam_tpu_torch.geometry import se3 as t_se3
from multi_orb_slam_tpu_torch.io import synthetic as t_syn

torch.set_num_threads(2)
ATOL = 1e-5


def _both(fn_j, fn_t, *arrays):
    got_j = fn_j(*[jnp.asarray(a) for a in arrays])
    got_t = fn_t(*[torch.from_numpy(np.array(a)) for a in arrays])
    return np.asarray(got_j), got_t.numpy()


def _rng_xi(n=64, scale=1.0, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 6) * scale).astype(np.float32)


@pytest.mark.parametrize("scale", [1e-5, 0.3, 2.5])
def test_se3_exp_log(scale):
    xi = _rng_xi(scale=scale)
    j, t = _both(j_se3.exp, t_se3.exp, xi)
    np.testing.assert_allclose(t, j, atol=ATOL)
    T = j
    j, t = _both(j_se3.log, t_se3.log, T)
    np.testing.assert_allclose(t, j, atol=1e-4 if scale > 1 else ATOL)


@pytest.mark.parametrize("name", ["inverse", "camera_center", "to_quaternion",
                                  "normalize_rotation"])
def test_se3_unary(name):
    T = np.asarray(j_se3.exp(jnp.asarray(_rng_xi(seed=1))))
    j, t = _both(getattr(j_se3, name), getattr(t_se3, name), T)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_se3_points_and_quaternion_roundtrip():
    rng = np.random.RandomState(2)
    T = np.asarray(j_se3.exp(jnp.asarray(_rng_xi(8, seed=2))))
    pts = rng.randn(8, 50, 3).astype(np.float32)
    j, t = _both(j_se3.transform_points, t_se3.transform_points, T, pts)
    np.testing.assert_allclose(t, j, atol=ATOL)
    q = rng.randn(20, 4).astype(np.float32)
    j, t = _both(j_se3.from_quaternion, t_se3.from_quaternion, q)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_camera_functions():
    rng = np.random.RandomState(3)
    K = np.array([520.9, 521.0, 320.0, 240.0], np.float32)
    dist = np.array([0.1, -0.05, 0.001, -0.002, 0.01], np.float32)
    xc = np.concatenate([rng.uniform(-2, 2, (200, 2)), rng.uniform(0.5, 6, (200, 1))],
                        axis=1).astype(np.float32)
    uv = rng.uniform(0, 640, (200, 2)).astype(np.float32)
    depth = np.where(rng.rand(200) < 0.8, rng.uniform(0.3, 5, 200), 0).astype(np.float32)
    for fj, ft, args in (
        (j_cam.project, t_cam.project, (K, xc)),
        (j_cam.distort_project, t_cam.distort_project, (K, dist, xc)),
        (j_cam.undistort_pixels, t_cam.undistort_pixels, (K, dist, uv)),
        (j_cam.backproject, t_cam.backproject, (K, uv, depth)),
        (j_cam.virtual_right_u, t_cam.virtual_right_u,
         (np.float32(40.0), uv[:, 0], depth)),
    ):
        j, t = _both(fj, ft, *args)
        np.testing.assert_allclose(t, j, atol=1e-3 if fj is not j_cam.backproject else ATOL,
                                   rtol=1e-6)


def test_frustum_check():
    rng = np.random.RandomState(4)
    K = np.array([260.0, 260.0, 160.0, 120.0], np.float32)
    Tcw = np.asarray(j_se3.exp(jnp.asarray(_rng_xi(1, 0.1, 4)[0])))
    pw = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    pw[:, 2] += 3.0
    dmin = rng.uniform(0.1, 2, 300).astype(np.float32)
    dmax = (dmin * 6).astype(np.float32)
    nrm = rng.randn(300, 3).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    out_j = j_cam.frustum_check(*[jnp.asarray(a) for a in (K, Tcw, pw)], 320, 240,
                                jnp.asarray(dmin), jnp.asarray(dmax), jnp.asarray(nrm))
    out_t = t_cam.frustum_check(*[torch.from_numpy(a) for a in (K, Tcw, pw)], 320, 240,
                                torch.from_numpy(dmin), torch.from_numpy(dmax),
                                torch.from_numpy(nrm))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for a, b in zip(out_t[1:], out_j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3, rtol=1e-6)


def test_ate_rmse():
    rng = np.random.RandomState(5)
    gt = rng.randn(40, 3).astype(np.float32)
    R = np.asarray(j_se3.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
    est = (gt @ R.T + np.array([0.5, 0.1, -0.2], np.float32)
           + 0.01 * rng.randn(40, 3)).astype(np.float32)
    j, t = _both(j_align.ate_rmse, t_align.ate_rmse, est, gt)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("trajectory", ["orbit", "circuit"])
def test_synthetic_copy_renders_identical_arrays(trajectory):
    T_rc = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
    T_rc[1, 0, 3] = 0.16
    kw = dict(n_frames=2, K=np.array([260.0, 260.0, 160.0, 120.0], np.float32),
              T_rc=T_rc, height=120, width=160, n_points=600, trajectory=trajectory)
    a = j_syn.make_sequence(**kw)
    b = t_syn.make_sequence(**kw)
    for x, y in zip(a.grays + a.depths, b.grays + b.depths):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.poses_gt, b.poses_gt)
    da = j_syn.degrade_sequence(a)
    db = t_syn.degrade_sequence(b)
    np.testing.assert_array_equal(da.grays[1], db.grays[1])
    np.testing.assert_array_equal(da.depths[1], db.depths[1])
