"""gather_patches's share of its roofline (%), from the traced stretch's
device time (layer: kernels; moves frames_per_s).

One launch copies C * F patches of 45 x 45 float32 (F the features a
camera, as the port extracts them: nFeatures on every camera); it writes
each patch once and reads as much, or the canvas if that is less, plus the
[C * F, 3] int32 starts; no arithmetic.  Frozen from `chip_smoke.py`'s
`bound()` and its counts.
"""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("bench_roofline", Path(__file__).with_name("roofline.py"))
roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(roofline)

SYMBOL = "gather_patches_kernel"
PATCH_SIDE = 45


def work(s: dict) -> tuple[float, float]:
    C, H, W, L = s["n_cams"], s["height"], s["width"], s["n_levels"]
    n = C * s["n_features"]
    out = 4 * n * PATCH_SIDE * PATCH_SIDE
    return out + min(out, 4 * C * L * H * W) + 4 * n * 3, 0


def read(run):
    return roofline.share(SYMBOL, work, run)
