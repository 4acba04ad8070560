"""Batched Hamming distance and masked matching primitives.

Counterpart of `multi_orb_slam_tpu/ops/hamming.py`.  Descriptors are
[..., 8] int32 words (256 bits; the reference's uint32 words reinterpreted,
see `convert.py`).  Thresholds: TH_HIGH = 100, TH_LOW = 50,
HISTO_LENGTH = 30.
"""

from __future__ import annotations

import math

import torch

from .kernels import BIG, popcount32  # noqa: F401  (re-exported)

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30


def hamming_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance between (..., 8) descriptor pairs."""
    return popcount32(torch.bitwise_xor(a, b)).sum(dim=-1, dtype=torch.int32)


def unpack_pm1(d: torch.Tensor) -> torch.Tensor:
    """[..., 8] int32 descriptors -> [..., 256] float32 in {-1, +1}."""
    shifts = torch.arange(32, device=d.device, dtype=torch.int32)
    bits = (d[..., :, None] >> shifts) & 1                  # [..., 8, 32]
    pm1 = bits.to(torch.float32) * 2 - 1
    return pm1.reshape(d.shape[:-1] + (256,))


def pairwise_hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: a [..., N, 8], b [..., M, 8] -> [..., N, M].

    With descriptors unpacked to s in {-1, +1}^256, <s_a, s_b> =
    256 - 2 * hamming, so one float32 matmul gives every distance exactly
    (products are +-1 and partial sums are integers <= 256).
    """
    dot = unpack_pm1(a) @ unpack_pm1(b).transpose(-1, -2)
    return ((256.0 - dot) * 0.5).to(torch.int32)


def masked_argmin2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over masked columns.

    Returns (best_idx, best_dist, second_dist); masked entries read as BIG.
    """
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = torch.argmin(d, dim=-1)
    best = torch.gather(d, -1, best_idx[..., None])[..., 0]
    col = torch.arange(d.shape[-1], device=d.device)
    d2 = torch.where(col == best_idx[..., None], torch.full_like(d, BIG), d)
    second = torch.amin(d2, dim=-1)
    return best_idx, best, second


def mutual_best(dist: torch.Tensor, mask: torch.Tensor):
    """Cross-check matching: i<->j only if each is the other's best.

    Returns (match_j [N] with -1 for unmatched, best_dist [N]).
    """
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_j = torch.argmin(d, dim=1)
    best_i = torch.argmin(d, dim=0)
    rows = torch.arange(d.shape[0], device=d.device)
    ok = best_i[best_j] == rows
    bd = torch.gather(d, 1, best_j[:, None])[:, 0]
    ok = ok & (bd < BIG)
    return torch.where(ok, best_j, torch.full_like(best_j, -1)), bd


def top_k(x: torch.Tensor, k: int):
    """Largest k along the last axis, lower index first among ties.

    The tie order of `jax.lax.top_k`; `torch.topk` promises none, so every
    top-k site of the port goes through this stable sort.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def rotation_histogram_filter(angle_delta: torch.Tensor, match_mask: torch.Tensor,
                              n_bins: int = HISTO_LENGTH, keep_top: int = 3) -> torch.Tensor:
    """Keep only matches whose angle difference falls in the top-3 bins
    (ComputeThreeMaxima: bins 2 and 3 drop when < 0.1 x bin 1).

    angle_delta [N] radians, match_mask [N] bool -> [N] bool.
    """
    two_pi = 2.0 * math.pi
    frac = torch.remainder(angle_delta, two_pi) / two_pi
    bins = torch.clamp((frac * n_bins).to(torch.int32), 0, n_bins - 1).long()
    counts = torch.zeros(n_bins, dtype=torch.int32, device=bins.device)
    counts.index_add_(0, bins, match_mask.to(torch.int32))
    top_vals, top_idx = top_k(counts, keep_top)
    limit = 0.1 * top_vals[0].to(torch.float32)
    keep_bin_valid = top_vals.to(torch.float32) >= limit
    in_top = torch.zeros(n_bins, dtype=torch.bool, device=bins.device)
    in_top[top_idx] = keep_bin_valid
    return match_mask & in_top[bins]
