"""Plain numpy reference of a decoded TUM frame: the arrays the benchmark
wrote, as the TUM driver hands them on (grey as float32, depth as float32
metres: the stored uint16 times 1 / depth factor)."""

from __future__ import annotations

import numpy as np


def expected(g8: np.ndarray, d16: np.ndarray, depth_factor: float):
    return g8.astype(np.float32), d16.astype(np.float32) * (1.0 / depth_factor)


def max_gap(decoded_grey, decoded_depth, g8, d16, depth_factor: float) -> float:
    """The largest difference from the reference over both images (0 when
    the decoder is exact)."""
    g, d = expected(g8, d16, depth_factor)
    if decoded_grey.shape != g.shape or decoded_depth.shape != d.shape:
        return float("inf")
    return float(max(np.abs(decoded_grey.astype(np.float64) - g).max(),
                     np.abs(decoded_depth.astype(np.float64) - d).max()))
