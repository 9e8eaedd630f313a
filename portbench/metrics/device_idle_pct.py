"""Share of the profiled sub-window in which no device operation ran:
1 - (union of the device operations' intervals, clipped to the
sub-window) / (the sub-window's wall span, its edges included)."""


def read(readings):
    p = readings.profile
    if not p or p["window_s"] <= 0 or not p["n_ops"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
