"""The share of the traced stretch in which no kernel, copy or set ran on
the device (layer: device; moves frames_per_s)."""


def read(run):
    tr = run.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
