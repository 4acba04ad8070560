"""Batched Hamming distance and masked matching primitives.

Counterpart of `multi_orb_slam_tpu/ops/hamming.py`.  Descriptors are
[..., 8] int32 words (256 bits; the reference's uint32 words reinterpreted,
see `convert.py`).  Thresholds: TH_HIGH = 100, TH_LOW = 50,
HISTO_LENGTH = 30.
"""

from __future__ import annotations

import math

import torch

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30

BIG = 1 << 20  # sentinel distance for masked entries (window_match's no-candidate distance)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Per-word popcount of int32 descriptor words (as unsigned 32-bit), by
    the reference's SWAR steps in int64."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


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


def first_argmin(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the minimum along `dim`, the lowest index among equals.

    The tie order of `jnp.argmin`, written out so that it rests on no
    backend's reduction order."""
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    idx = torch.arange(n, device=x.device).reshape(shape)
    is_min = x == torch.amin(x, dim=dim, keepdim=True)
    return torch.amin(torch.where(is_min, idx, n), dim=dim)


def masked_argmin2(dist: torch.Tensor, mask: torch.Tensor):
    """Per-row best and second-best over masked columns.

    Returns (best_idx, best_dist, second_dist); masked entries read as BIG.
    """
    d = torch.where(mask, dist, torch.full_like(dist, BIG))
    best_idx = first_argmin(d, dim=-1)
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
