"""Sums in one fixed order in the loop stage's solvers (`optim/segments.py`).

The global BA (`optim/global_ba.schur_lm`, also the distributed BA's step)
and the essential graph (`optim/pose_graph.optimize_essential_graph`) sum
their blocks with `Segments`: a stable sort of the rows' segment index and
each segment's offsets, built once a solve, then a segment sum that adds a
segment's rows in ascending row order.  On the card that is what makes two
calls on one input give the same bits (`index_add_` adds there with atomics,
in no fixed order); the card tests in `test_torch_cuda.py` and
`chip_smoke.py`'s `determinism` phase hold it there.  Here, on the CPU:

- `Segments.sum` is the CPU's `index_add_`, which adds rows in order, to the
  bit: repeated indices, empty segments, rows left out (pads), sorted and
  unsorted indices; the block form is the sum over each block;
- the global BA and the essential graph on one input twice give the same
  bits, and the essential graph's result does not depend on where its
  padded edges sit;
- the global BA with every sum as the `index_add_` it replaced gives the
  fixed-order result but for the pose blocks' order of summation.

The JAX package's agreement on the same solvers is held, at the old
tolerances, by `test_torch_loop.py` (global BA, `run_global_ba_jit`),
`test_torch_sim3.py` (the essential graph) and `test_torch_parallel.py`
(the distributed step against world 1 and the JAX step).
"""

import numpy as np
import pytest
import torch

from multi_orb_slam_tpu_torch.optim import global_ba, pose_graph
from multi_orb_slam_tpu_torch.optim.segments import Segments


def _values(rng, N, shape):
    """Rows whose sums depend on the order of the adds: magnitudes spread
    over twelve decades, and a few signed zeros."""
    v = rng.randn(N, *shape) * 10.0 ** rng.uniform(-6, 6, (N,) + (1,) * len(shape))
    v[rng.rand(N) < 0.05] = -0.0
    return torch.from_numpy(v.astype(np.float32))


def _index_case(case, rng, N, S):
    """(index [N], keep [N] or None) of one case."""
    if case == "repeated indices":
        return torch.from_numpy(rng.randint(0, 4, N)), None
    if case == "empty segments":                # only every third segment has rows
        return torch.from_numpy(3 * rng.randint(0, S // 3, N)), None
    if case == "pads":                          # left-out rows point at segment 0
        keep = rng.rand(N) < 0.4
        return torch.from_numpy(np.where(keep, rng.randint(0, S, N), 0)), torch.from_numpy(keep)
    if case == "sorted":                        # the observation grid's keyframe index
        return torch.from_numpy(np.sort(rng.randint(0, S, N))), None
    return torch.from_numpy(rng.randint(0, S, N)), None


@pytest.mark.parametrize("shape", [(3,), (3, 3), (49,)])
@pytest.mark.parametrize("case", ["repeated indices", "empty segments", "pads", "sorted",
                                  "unsorted"])
def test_segment_sum_is_index_add(case, shape):
    """`Segments.of_index(...).sum` against `index_add_` over the rows kept,
    to the bit; left-out rows may hold anything (NaN here) and add nothing;
    the rows' order matters to these values (the reversed order's sums
    differ), so the equality says the order is the rows' own."""
    rng = np.random.RandomState(len(case) + len(shape))
    N, S = 600, 40
    idx, keep = _index_case(case, rng, N, S)
    v = _values(rng, N, shape)
    kept = torch.ones(N, dtype=torch.bool) if keep is None else keep
    want = torch.zeros((S,) + shape).index_add_(0, idx[kept], v[kept])
    if keep is not None:
        v[~keep] = float("nan")
    seg = Segments.of_index(idx, S, keep)
    got = seg.sum(v)
    assert got.shape == (S,) + shape and torch.equal(got, want)
    assert torch.equal(seg.sum(v), got)
    counts = torch.bincount(idx[kept], minlength=S)
    assert torch.equal(seg.offsets.diff(), counts)
    assert not got[counts == 0].any()
    rev = torch.zeros((S,) + shape).index_add_(0, idx[kept].flip(0), v[kept].flip(0))
    assert not torch.equal(rev, want)


def test_segment_sum_block_form():
    """`Segments.blocks(n, block)`: row r into segment r // block, summed as
    `sum(1)` over the [n, block, ...] view, which `index_add_` over that map
    matches to float32 rounding."""
    rng = np.random.RandomState(4)
    n, block = 6, 250
    v = torch.from_numpy(rng.randn(n * block, 48).astype(np.float32))
    got = Segments.blocks(n, block).sum(v)
    assert torch.equal(got, v.reshape(n, block, 48).sum(1))
    want = torch.zeros(n, 48).index_add_(0, torch.arange(n * block) // block, v)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def _gba_problem():
    from test_torch_cuda import _gba_map

    st, calib, cfg = _gba_map("cpu")
    return global_ba.global_ba_arrays(st, calib, cfg), cfg


def test_global_ba_twice_is_the_same_bits():
    """`run_global_ba_arrays` (the annealed `schur_lm`) twice on one map:
    the same bits, and work done (poses moved)."""
    (state_arrays, calib_arrays, kf_free), cfg = _gba_problem()
    a = global_ba.run_global_ba_arrays(state_arrays, calib_arrays, kf_free, cfg, 9)
    b = global_ba.run_global_ba_arrays(state_arrays, calib_arrays, kf_free, cfg, 9)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float((a[0] - state_arrays[0]).abs().max()) > 1e-3


def test_global_ba_against_the_index_add_form(monkeypatch):
    """Every `Segments` sum replaced by the `index_add_` it took the place
    of (on the CPU that adds in row order): the points' sums are the same
    bits, the poses' block sums (`sum(1)`) round apart, so the solutions
    agree to 1e-5 on poses, and on points to `test_torch_loop.py`'s JAX
    tolerance of 1e-3 m, 99% of them to 1e-4 m (a weakly held point slides
    along its ray with the rounding: 2e-4 m at most here)."""
    (state_arrays, calib_arrays, kf_free), cfg = _gba_problem()
    fixed = global_ba.run_global_ba_arrays(state_arrays, calib_arrays, kf_free, cfg, 9)

    def index_add_sum(self, v):
        index = torch.arange(v.shape[0]) // self.block if self.block else self.index
        out = torch.zeros((self.n + 1,) + v.shape[1:], dtype=v.dtype)
        return out.index_add_(0, index, v)[:self.n]

    monkeypatch.setattr(Segments, "sum", index_add_sum)
    added = global_ba.run_global_ba_arrays(state_arrays, calib_arrays, kf_free, cfg, 9)
    valid = state_arrays[6]
    assert float((fixed[0] - added[0]).abs().max()) < 1e-5
    d_pts = (fixed[1] - added[1])[valid].abs().amax(1)
    assert float(d_pts.max()) < 1e-3 and float(torch.quantile(d_pts, 0.99)) < 1e-4


def _essential_graph_problem():
    from test_torch_sim3 import _pose_graph_case, _t

    covis, kf_valid, frame_id, g_old, g_corr, corr_mask, loops = _pose_graph_case()
    K = covis.shape[0]
    edges = pose_graph.build_essential_edges(covis, kf_valid, frame_id, _t(g_old),
                                             (_t(g_corr), corr_mask), loops, max_edges=256)
    kf_free = kf_valid & (np.arange(K) != 0)
    pert = np.random.RandomState(5).randn(K, 7).astype(np.float32) * 0.02
    pert[:, 6] = 0.0
    pert[~kf_free] = 0.0
    from multi_orb_slam_tpu_torch.geometry import sim3

    g0 = sim3.compose(sim3.exp(_t(pert)), _t(g_corr))
    return g0, _t(kf_free), edges


def test_essential_graph_twice_is_the_same_bits_wherever_the_pads_sit():
    """`optimize_essential_graph` on `test_torch_sim3.py`'s problem twice
    (5 iterations): the same bits; then with its padded edges (`ok` False)
    spread between the real ones, the real ones in their order: the same
    bits again."""
    g0, kf_free, (ei, ej, meas, ok) = _essential_graph_problem()
    a = pose_graph.optimize_essential_graph(g0, kf_free, ei, ej, meas, ok, n_iters=5)
    b = pose_graph.optimize_essential_graph(g0, kf_free, ei, ej, meas, ok, n_iters=5)
    assert torch.equal(a, b)
    assert float((a - g0).abs().max()) > 1e-3
    E, n = ok.shape[0], int(ok.sum())
    assert 0 < n < E
    rng = np.random.RandomState(2)
    slots = torch.from_numpy(np.sort(rng.choice(E, n, replace=False)))
    src = torch.full((E,), n, dtype=torch.long)       # a pad slot reads pad n
    src[slots] = torch.arange(n)
    spread = [x[src] for x in (ei, ej, meas, ok)]
    assert not torch.equal(spread[3], ok)
    c = pose_graph.optimize_essential_graph(g0, kf_free, *spread, n_iters=5)
    assert torch.equal(a, c)
