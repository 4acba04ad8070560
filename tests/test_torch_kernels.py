"""The port's three kernels (`ops/kernels.py`) against the JAX reference.

On the CPU each wrapper runs its plain PyTorch version; that version must
equal the reference exactly:

- `fast_score`: `pallas_kernels.fast_score_pallas(interpret=True)` on the
  whole image (both read zeros outside), `orb.fast_score` on the interior
  (the jnp version wraps at the edges);
- `gather_patches`: the vmapped `dynamic_slice` of `orb.extract_orb`'s CPU
  path;
- `window_match`: `window_match_reference`, indices included (the port
  keeps its first-argmin tie rules), and the distances of
  `window_match_pallas(interpret=True)`.

The CUDA kernels themselves are held against these plain versions on the
card by `tests/test_torch_cuda.py` and `chip_smoke.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_orb_slam_tpu.ops import orb as j_orb
from multi_orb_slam_tpu.ops import pallas_kernels as pk
from multi_orb_slam_tpu_torch.ops import kernels

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def image():
    rng = np.random.RandomState(0)
    return rng.uniform(0, 255, (120, 160)).astype(np.float32)


def test_fast_score_matches_pallas_interpret(image):
    ref = np.asarray(pk.fast_score_pallas(jnp.asarray(image), interpret=True))
    got = kernels.fast_score(torch.from_numpy(image)[None], [image.shape])[0].numpy()
    np.testing.assert_array_equal(got, ref)


def test_fast_score_matches_jnp_interior(image):
    ref = np.asarray(jax.jit(j_orb.fast_score)(jnp.asarray(image)))
    got = kernels.fast_score(torch.from_numpy(image)[None], [image.shape])[0].numpy()
    np.testing.assert_array_equal(got[8:-8, 8:-8], ref[8:-8, 8:-8])


def test_fast_score_batched_extents(image):
    """One call over images of different true extents on one canvas equals
    the reference run per image at its true shape, and is 0 outside."""
    extents = [(120, 160), (100, 133), (83, 111)]
    canvas = np.zeros((3, 120, 160), np.float32)
    for b, (h, w) in enumerate(extents):
        canvas[b, :h, :w] = image[:h, :w] * (1.0 + 0.1 * b)
    got = kernels.fast_score(torch.from_numpy(canvas), extents).numpy()
    for b, (h, w) in enumerate(extents):
        ref = np.asarray(pk.fast_score_pallas(jnp.asarray(canvas[b, :h, :w]),
                                              interpret=True))
        np.testing.assert_array_equal(got[b, :h, :w], ref)
        assert not got[b, h:].any() and not got[b, :, w:].any()


def test_gather_patches_matches_dynamic_slice():
    rng = np.random.RandomState(1)
    L, H, W, side, F = 4, 120, 160, 45, 300
    canvas = rng.uniform(0, 255, (L, H, W)).astype(np.float32)
    level = rng.randint(0, L, F).astype(np.int32)
    y0 = rng.randint(0, H - side + 1, F).astype(np.int32)
    x0 = rng.randint(0, W - side + 1, F).astype(np.int32)
    # starts past the end: both sides clamp them to the last full patch
    y0[:5] = H
    x0[5:10] = W

    def slice_patch(lv, y, x):
        return jax.lax.dynamic_slice(jnp.asarray(canvas), (lv, y, x), (1, side, side))[0]

    ref = np.asarray(jax.vmap(slice_patch)(level, y0, x0))
    idx = torch.from_numpy(np.stack([level, y0, x0], axis=1))
    got = kernels.gather_patches(torch.from_numpy(canvas), idx, side).numpy()
    np.testing.assert_array_equal(got, ref)


def _window_args(seed, L=300, F=256):
    rng = np.random.RandomState(seed)
    q_lmin = rng.randint(0, 3, L).astype(np.int32)
    return dict(
        q_uv=rng.uniform(0, 300, (L, 2)).astype(np.float32),
        q_rad=rng.uniform(5, 30, L).astype(np.float32),
        q_lmin=q_lmin, q_lmax=(q_lmin + 2).astype(np.int32),
        q_ur=np.where(rng.rand(L) < 0.5, rng.uniform(0, 300, L), -1e9).astype(np.float32),
        q_desc=rng.randint(0, 2**32, (L, 8), dtype=np.uint64).astype(np.uint32),
        f_xy=rng.uniform(0, 300, (F, 2)).astype(np.float32),
        f_ur=np.where(rng.rand(F) < 0.7, rng.uniform(0, 300, F), -1).astype(np.float32),
        f_level=rng.randint(0, 8, F).astype(np.int32),
        f_mask=rng.rand(F) < 0.9,
        f_desc=rng.randint(0, 2**32, (F, 8), dtype=np.uint64).astype(np.uint32),
    )


def _port_window_match(a, cams=1):
    """Reference-layout numpy args -> the port's [C, ...] call (the same
    rows repeated on `cams` cameras, descriptor words viewed as int32)."""
    def t(x, q=False):
        x = x.view(np.int32) if x.dtype == np.uint32 else x
        x = torch.from_numpy(np.ascontiguousarray(x))[None]
        return x if q else x.expand((cams,) + tuple(x.shape[1:])).contiguous()
    out = kernels.window_match(
        t(a["q_uv"]), t(a["q_rad"]), t(a["q_lmin"]), t(a["q_lmax"]), t(a["q_ur"]),
        t(a["q_desc"], q=True), t(a["f_xy"]), t(a["f_ur"]), t(a["f_level"]),
        t(a["f_mask"]), t(a["f_desc"]))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("seed", [1, 2])
def test_window_match_matches_reference(seed):
    a = _window_args(seed)
    ref = [np.asarray(r) for r in pk.window_match_reference(
        *[jnp.asarray(v) for v in a.values()])]
    got = _port_window_match(a, cams=2)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g[0], r)
        np.testing.assert_array_equal(g[1], r)


def test_window_match_distances_match_pallas_interpret():
    a = _window_args(3)
    ref = [np.asarray(r) for r in pk.window_match_pallas(
        *[jnp.asarray(v) for v in a.values()], interpret=True)]
    bi, bd, b2, _ = _port_window_match(a)
    np.testing.assert_array_equal(bd[0], ref[1])
    np.testing.assert_array_equal(b2[0], ref[2])
    uniq = ref[1] < ref[2]
    np.testing.assert_array_equal(bi[0][uniq], ref[0][uniq])


def test_window_match_tie_rows():
    """All-masked row, single-candidate row, equal-distance rows and a
    displaced best: the port and the reference give the hand-derived
    (best idx, best d, second d, second idx)."""
    tie = kernels.window_match_tie_rows()
    expected = tie.pop("expected")
    got = kernels.window_match(*[torch.from_numpy(v) for v in tie.values()])
    np.testing.assert_array_equal(np.stack([g[0].numpy() for g in got], 1), expected)
    ref_args = [jnp.asarray(v[0].view(np.uint32) if v.dtype == np.int32 and k.endswith("desc")
                            else v[0]) for k, v in tie.items()]
    ref = np.stack([np.asarray(r) for r in pk.window_match_reference(*ref_args)], 1)
    np.testing.assert_array_equal(ref, expected)
