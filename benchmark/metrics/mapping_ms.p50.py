"""A keyframe's callback less its loop stage: the mapping stage, median over
the window's keyframes (layer: mapping stage; moves frames_per_s)."""

import numpy as np


def read(run):
    v = [r["hook_ms"] - r["loop_ms"] for r in run["records"] if r["keyframes"]]
    return float(np.median(v)) if v else None
