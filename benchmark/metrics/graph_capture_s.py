"""Seconds of warm-up and capture of every CUDA graph entry the process holds
once set-up is done (`utils/graphs` entries' `warmup_ms` + `capture_ms`):
the port's compile time (layer: jit boundaries; moves setup_s)."""


def read(run):
    return run["graph_capture_s"] if run["graph_capture_s"] > 0 else None
