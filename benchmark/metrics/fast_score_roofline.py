"""fast_score's share of its roofline (%), from the traced stretch's device
time (layer: kernels; moves frames_per_s).

One launch scores a [C * L, H, W] float32 canvas (every level of every
camera on a zero canvas of the level-0 size); it reads each live pixel of
each level once and writes the whole canvas; per live pixel the least
arithmetic known for the function: 16 differences, the 16 arc minima and 16
arc maxima from block prefixes and suffixes (44 + 44), 30 to combine them,
1 negation and 1 final maximum (136).  Frozen from `chip_smoke.py`'s
`bound()` and its counts.
"""

import importlib.util
from pathlib import Path

_spec = importlib.util.spec_from_file_location("bench_roofline", Path(__file__).with_name("roofline.py"))
roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(roofline)

SYMBOL = "fast_score_kernel"


def work(s: dict) -> tuple[float, float]:
    C, H, W, L = s["n_cams"], s["height"], s["width"], s["n_levels"]
    live = C * sum(h * w for h, w in roofline.level_shapes(H, W, L, s["scale_factor"]))
    return 4 * live + 4 * C * L * H * W, 136 * live


def read(run):
    return roofline.share(SYMBOL, work, run)
