"""The yardstick of the kernels' roofline shares: the H100's peaks and the
share of one kernel's roofline over the traced stretch.  Each
`<kernel>_roofline.py` beside this file names its kernel's symbol and counts
the bytes and operations of one launch at a configuration's shapes.

The bound of a launch is the larger of bytes over 3.35 TB/s and operations
over 67 Tflop/s (the H100 SXM's HBM3 rate and float32 rate outside the
tensor cores, taken for the integer work too), at the card's 700 W limit.
A share is launches x bound over their device time: it cannot pass 100%
unless the counts or the time are wrong.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def level_shapes(h: int, w: int, n_levels: int, scale: float) -> list:
    return [(max(int(round(h / scale ** l)), 32), max(int(round(w / scale ** l)), 32))
            for l in range(n_levels)]


def bound_s(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def share(symbol: str, work, run: dict):
    """The share (%) of its roofline of every device operation whose name
    holds `symbol`, one launch doing `work(shapes)` = (bytes, operations);
    None where the trace saw no launch of it."""
    tr = run.get("trace")
    if not tr:
        return None
    hits = [v for name, v in tr["kernels"].items() if symbol in name]
    launches, seconds = sum(n for n, _ in hits), sum(s for _, s in hits)
    if launches == 0 or seconds <= 0:
        return None
    return 100.0 * launches * bound_s(*work(run["shapes"])) / seconds
