"""A frame's device-complete time less its PNG decoding and its keyframe
callback (the mapping and loop stages), median over the window (layer:
tracker; moves frames_per_s)."""

import numpy as np


def read(run):
    v = [r["ms"] - r["hook_ms"] - (r["decode_ms"] or 0.0) for r in run["records"]]
    return float(np.median(v)) if v else None
