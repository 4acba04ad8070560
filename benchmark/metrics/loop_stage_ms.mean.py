"""The loop closer's `process_keyframe`, device-complete, per keyframe,
closed loops and their global BA included, mean over the window's
keyframes (layer: loop stage; moves frames_per_s)."""


def read(run):
    n = sum(r["loop_stages"] for r in run["records"])
    return sum(r["loop_ms"] for r in run["records"]) / n if n else None
