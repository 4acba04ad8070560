"""The share (%) of the mapping stage's Levenberg-Marquardt trips that did
useful work: 100 x `optim/local_ba.STATS` `iterations` (live trips) over
`trips` (trips computed, live or dead), read once after the window (layer:
mapping stage; moves frames_per_s).

The counters live on the device, inside the graphs, and count over the
whole process, set-up included.  On a cell that runs a fresh system each
pass the warm pass plays the window's traffic, so the process's share is
the window's share."""


def read(run):
    try:
        from multi_orb_slam_tpu_torch.optim import local_ba
    except ImportError:
        return None
    stats = getattr(local_ba, "STATS", None)
    if stats is None or not hasattr(stats, "read"):
        return None
    c = stats.read()
    trips = c.get("trips", 0)
    return 100.0 * c.get("iterations", 0) / trips if trips > 0 else None
