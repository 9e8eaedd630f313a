"""Kernel K4's share of its roofline: the least time at the cell's own
shape (``roofline/k4_transport_moments.py``, from the reference's
campaign, and the published peaks of ``roofline/peaks.py``) over the
mean device time of one K4 call (``transport_moments_kernel`` and its
``fixed_point_to_float`` pass) in the profiled sub-window.  Nothing when
no K4 launch was traced."""
from portbench.roofline import k4_transport_moments as k4, peaks


def read(readings):
    p = readings.profile
    chip = peaks.peaks_of(readings.device_name)
    if not p or chip is None:
        return None
    n, total = k4.calls(p["kernel_s"])
    if not n or total <= 0:
        return None
    least, _ = k4.bound_s(k4.shape(readings.campaign, readings.walkers),
                          chip)
    return 100.0 * least / (total / n)
