"""CPU models of the redesigned CUDA kernels against the plain versions.

`window_match_split` reaches `window_match_plain`'s four outputs the way
`csrc/window_match.cu` does: each lane scans the features l, l + lanes, ...
and keeps its two smallest (distance, index) keys, then the lanes merge
pairwise.  `fast_arcs_blocks` computes the sixteen arc minima and maxima as
`csrc/fast_score.cu` does, from block prefixes and suffixes
(`fast_arcs_doubling`: the scheme it replaced).  All must equal the plain versions
exactly, indices included: integer outputs, and min / max do not round.
`point_sums_tiled` walks tiles of points and chunks of rows as
`csrc/point_sums.cu` does and carries each sum across the chunks: the same
float32 adds in the same order, so `gathered` and `summed` are bit-equal.
Nothing here needs the reference package.
"""

import numpy as np
import pytest
import torch

from multi_orb_slam_tpu_torch.ops import kernels

torch.set_num_threads(2)

LANES = [1, 8, 32]


def _window_args(seed, C, Q, F):
    rng = np.random.RandomState(seed)
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    q_lmin = rng.randint(-1, 6, (C, Q)).astype(np.int32)
    return (
        T(rng.uniform(0, 100, (C, Q, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, Q) < 0.9, rng.uniform(5, 60, (C, Q)), -1).astype(np.float32)),
        T(q_lmin), T(q_lmin + 2),
        T(np.where(rng.rand(C, Q) < 0.5, rng.uniform(0, 100, (C, Q)), -1e9).astype(np.float32)),
        # few distinct descriptor words: many equal distances
        T(rng.randint(0, 4, (1, Q, 8)).astype(np.int32)),
        T(rng.uniform(0, 100, (C, F, 2)).astype(np.float32)),
        T(np.where(rng.rand(C, F) < 0.7, rng.uniform(0, 100, (C, F)), -1).astype(np.float32)),
        T(rng.randint(0, 8, (C, F)).astype(np.int32)),
        T(rng.rand(C, F) < 0.9),
        T(rng.randint(0, 4, (C, F, 8)).astype(np.int32)),
    )


def _dense_args(seed, C, Q, F):
    """Every gate open, as `search.match_frame_kf_brute` calls the kernel."""
    rng = np.random.RandomState(seed)
    rad = np.where(rng.rand(C, Q) < 0.9, np.inf, -1.0).astype(np.float32)
    return (
        torch.zeros((C, Q, 2)), torch.from_numpy(rad),
        torch.full((C, Q), -1, dtype=torch.int32),
        torch.full((C, Q), 1 << 30, dtype=torch.int32),
        torch.full((C, Q), -1e9),
        torch.from_numpy(rng.randint(-2**31, 2**31, (C, Q, 8), dtype=np.int64).astype(np.int32)),
        torch.zeros((C, F, 2)), torch.full((C, F), -1.0),
        torch.zeros((C, F), dtype=torch.int32),
        torch.from_numpy(rng.rand(C, F) < 0.9),
        torch.from_numpy(rng.randint(-2**31, 2**31, (C, F, 8), dtype=np.int64).astype(np.int32)),
    )


def _hold_split(args, lanes):
    want = kernels.window_match_plain(*args)
    got = kernels.window_match_split(*args, lanes=lanes)
    for name, g, w in zip(("best_idx", "best_d", "second_d", "second_idx"), got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("F,Q", [(70, 5), (1, 5), (31, 300), (256, 300)])
def test_window_match_split_equals_plain(F, Q, lanes):
    _hold_split(_window_args(F + Q, 2, Q, F), lanes)


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("strided", [False, True])
def test_window_match_split_tie_rows(strided, lanes):
    tie = kernels.window_match_tie_rows(strided=strided)
    expected = tie.pop("expected")
    args = [torch.from_numpy(v) for v in tie.values()]
    got = kernels.window_match_split(*args, lanes=lanes)
    np.testing.assert_array_equal(np.stack([g[0].numpy() for g in got], 1), expected)
    _hold_split(args, lanes)


@pytest.mark.parametrize("lanes", LANES)
def test_window_match_split_dense(lanes):
    _hold_split(_dense_args(7, 2, 96, 130), lanes)


def test_window_match_split_rejects_odd_lanes():
    with pytest.raises(ValueError):
        kernels.window_match_split(*_window_args(0, 1, 3, 5), lanes=12)


def _canvas(kind):
    rng = np.random.RandomState(3)
    if kind == "uniform":
        img = rng.uniform(0, 255, (3, 60, 80))
    elif kind == "fractions":
        # values that differ in their last bits: differences that round
        img = 100.0 + rng.uniform(0, 1e-3, (3, 60, 80))
    elif kind == "integers":
        img = rng.randint(0, 4, (3, 60, 80))       # flat runs, many ties
    else:
        img = np.full((3, 60, 80), 7.25)
    return torch.from_numpy(img.astype(np.float32))


@pytest.mark.parametrize("kind", ["uniform", "fractions", "integers", "constant"])
@pytest.mark.parametrize("scheme", ["blocks", "doubling"])
def test_fast_arcs_model_equals_loop(scheme, kind):
    model = {"blocks": kernels.fast_arcs_blocks, "doubling": kernels.fast_arcs_doubling}[scheme]
    canvas = _canvas(kind)
    extents = [(60, 80), (41, 53), (7, 7)]
    ds, inside = kernels.fast_ring_differences(canvas, extents)
    loop = kernels.fast_arcs_loop(ds)
    got = model(ds)
    assert torch.equal(got, loop)
    assert torch.equal(torch.where(inside, got, torch.zeros_like(got)),
                       kernels.fast_score_plain(canvas, extents))
    if kind == "constant":
        assert not got[0, 3:-3, 3:-3].any()


def test_fast_score_rejects_extents_outside_the_canvas():
    with pytest.raises(ValueError):
        kernels.fast_score(torch.zeros((1, 40, 50)), [(41, 50)])


def _point_sums_inputs(LC, F, P, D, seed):
    rng = np.random.RandomState(seed)
    V = rng.randn(LC, F, D).astype(np.float32)
    inv = np.full((LC, P), -1, np.int32)
    n = min(F, P)
    for r in range(LC - 1):                      # the last row stays empty
        inv[r, rng.choice(P, n, replace=False)] = rng.permutation(F)[:n]
    return torch.from_numpy(V), torch.from_numpy(inv)


@pytest.mark.parametrize("LC,F,P,D,tile,chunk", [
    (48, 1024, 2048, 4, 8, 128),     # the main path: LC smaller than a chunk
    (128, 1024, 2048, 4, 8, 128),    # the largest window: one whole chunk
    (48, 1024, 4096, 30, 64, 8),     # the reference kernel's design shape
    (300, 64, 77, 4, 8, 128),        # a P that no tile divides, three chunks
    (5, 16, 3, 4, 8, 128),           # fewer points than a tile
    (37, 50, 61, 1, 8, 16),          # D = 1, ragged tiles and chunks
    (37, 50, 61, 30, 5, 7),
])
def test_point_sums_tiled_equals_plain(LC, F, P, D, tile, chunk):
    V, inv = _point_sums_inputs(LC, F, P, D, seed=LC + P + D)
    s_p, g_p = kernels.point_sums_plain(V, inv)
    s_t, g_t = kernels.point_sums_tiled(V, inv, tile_points=tile, chunk_rows=chunk)
    assert torch.equal(g_t, g_p)
    assert torch.equal(s_t, s_p)
    assert not g_t[-1].any()


def test_point_sums_tiled_rejects_empty_tiles():
    V, inv = _point_sums_inputs(3, 8, 5, 4, seed=0)
    with pytest.raises(ValueError):
        kernels.point_sums_tiled(V, inv, tile_points=0)
