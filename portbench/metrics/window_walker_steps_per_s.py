"""The window's walker-steps a second, where it is a per-layer metric:
walkers x DE steps of the traced run's window, which runs as an untraced
run's does (no synchronize but its last), over its wall seconds (host
clock)."""


def read(readings):
    w = readings.window
    return None if not w else w["walker_steps_per_s"]
