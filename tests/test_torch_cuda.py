"""The port's kernel wrappers: routing, checks, launch counts, and (on a
card) each CUDA kernel against its plain PyTorch version.

This file imports no jax, so it also runs where jax is absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tests marked `cuda` build the kernels with nvcc and skip without a card.
"""

import numpy as np
import pytest
import torch

from multi_orb_slam_tpu_torch.ops import kernels, orb

torch.set_num_threads(2)


def _window_args(rng, C=2, Q=300, F=256, dev="cpu"):
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    q_lmin = rng.randint(-1, 6, (C, Q)).astype(np.int32)
    return (
        T(rng.uniform(0, 300, (C, Q, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, Q) < 0.9, rng.uniform(5, 30, (C, Q)), -1).astype(np.float32)),
        T(q_lmin), T(q_lmin + 2),
        T(np.where(rng.rand(C, Q) < 0.5, rng.uniform(0, 300, (C, Q)), -1e9).astype(np.float32)),
        T(rng.randint(-2**31, 2**31, (1, Q, 8), dtype=np.int64).astype(np.int32)),
        T(rng.uniform(0, 300, (C, F, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, F) < 0.7, rng.uniform(0, 300, (C, F)), -1).astype(np.float32)),
        T(rng.randint(0, 8, (C, F)).astype(np.int32)),
        T(rng.rand(C, F) < 0.9),
        T(rng.randint(-2**31, 2**31, (C, F, 8), dtype=np.int64).astype(np.int32)),
    )


def test_cpu_tensors_take_the_plain_version_without_counting():
    kernels.reset_launch_counts()
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.uniform(0, 255, (1, 2, 64, 80)).astype(np.float32))
    orb.extract_orb(img[0], orb.ORBConfig(n_features=64, n_levels=2))
    kernels.window_match(*_window_args(rng, Q=20, F=16))
    assert kernels.LAUNCHES == {"fast_score": 0, "gather_patches": 0, "window_match": 0}


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "extents"])
def test_wrappers_reject_bad_inputs(bad):
    canvas = torch.zeros((2, 40, 50))
    if bad == "dtype":
        with pytest.raises(TypeError):
            kernels.fast_score(canvas.double(), [(40, 50)] * 2)
    elif bad == "contiguity":
        with pytest.raises(ValueError):
            kernels.gather_patches(canvas.transpose(1, 2), torch.zeros((3, 3), dtype=torch.int32), 5)
    elif bad == "shape":
        args = list(_window_args(np.random.RandomState(1), Q=10, F=8))
        args[2] = args[2][:, :5].contiguous()
        with pytest.raises(ValueError):
            kernels.window_match(*args)
    else:
        with pytest.raises(ValueError):
            kernels.fast_score(canvas, [(40, 50)])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fast_score", "gather_patches", "window_match"])
def test_cuda_kernel_matches_plain(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.RandomState(2)
    before = kernels.LAUNCHES[name]
    if name == "fast_score":
        canvas = torch.from_numpy(rng.uniform(0, 255, (3, 120, 160)).astype(np.float32)).to(dev)
        extents = [(120, 160), (100, 133), (83, 111)]
        assert torch.equal(kernels.fast_score(canvas, extents),
                           kernels.fast_score_plain(canvas, extents))
    elif name == "gather_patches":
        canvas = torch.from_numpy(rng.uniform(0, 255, (3, 120, 160)).astype(np.float32)).to(dev)
        idx = np.stack([rng.randint(0, 3, 200), rng.randint(0, 76, 200),
                        rng.randint(0, 116, 200)], 1).astype(np.int32)
        idx[:4] = (5, 500, -3)     # clamped into range by both versions
        idx = torch.from_numpy(idx).to(dev)
        assert torch.equal(kernels.gather_patches(canvas, idx, 45),
                           kernels.gather_patches_plain(canvas, idx, 45))
    else:
        args = _window_args(rng, dev=dev)
        for g, p in zip(kernels.window_match(*args), kernels.window_match_plain(*args)):
            assert torch.equal(g, p)
        tie = kernels.window_match_tie_rows()
        expected = tie.pop("expected")
        out = kernels.window_match(*[torch.from_numpy(v).to(dev) for v in tie.values()])
        np.testing.assert_array_equal(torch.stack([o[0] for o in out], 1).cpu().numpy(),
                                      expected)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] > before
