"""Operations a frame makes the host wait on the device for, counted under
`torch.cuda.set_sync_debug_mode("warn")` around `track_rgbd`, mean over the
window (layer: facade; moves frames_per_s)."""

import numpy as np


def read(run):
    v = [r["syncs"] for r in run["records"] if r["syncs"] is not None]
    return float(np.mean(v)) if v else None
