"""Kernel K2's share of its roofline: the least time at the cell's own
lattice shape (``roofline/k2_tof_hist.py``, from the reference's
campaign, and the published peaks of ``roofline/peaks.py``) over its
mean device time a launch in the profiled sub-window.  Nothing when no
K2 launch was traced."""
from portbench.roofline import k2_tof_hist, peaks


def read(readings):
    p = readings.profile
    chip = peaks.peaks_of(readings.device_name)
    if not p or chip is None:
        return None
    times = [t for name, ts in p["kernel_s"].items()
             if k2_tof_hist.is_launch(name) for t in ts]
    if not times:
        return None
    shape = k2_tof_hist.shape(readings.campaign, readings.walkers)
    least, _ = k2_tof_hist.bound_s(shape, chip)
    return 100.0 * least / (sum(times) / len(times))
