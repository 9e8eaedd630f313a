"""The window's 95th percentile of segment durations, where it is a
per-layer metric: from CUDA events recorded after each segment's copy in
the traced run's window, which runs as an untraced run's does."""


def read(readings):
    w = readings.window
    return None if not w else w["segment_ms_p95"]
