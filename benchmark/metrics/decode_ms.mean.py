"""Host ms to read and decode one frame's PNGs with the drivers' `io/png.py`,
mean over the window (layer: drivers; moves frames_per_s)."""

import numpy as np


def read(run):
    v = [r["decode_ms"] for r in run["records"] if r["decode_ms"] is not None]
    return float(np.mean(v)) if v else None
