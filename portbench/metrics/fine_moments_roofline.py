"""The fine-cell moments' share of their roofline: the least time at the
cell's own shape (``roofline/fine_cell_moments.py``, from the
reference's campaign, and the published peaks of ``roofline/peaks.py``)
over the mean device time an evaluation of the kernels that accumulate
the fine cells (``fine_cell_moments.is_launch``) in the profiled
sub-window A, whose steps are two evaluations each (the DE move's two
half-updates).  Today's reading times the four ``scatter_add_`` launches
alone: the elementwise passes before them (the cell indices, the
channels, their fixed-point rounding) are left out, so the stage as a
whole sits further from its bound than this reads.  Nothing when no such
launch was traced."""
from portbench.roofline import fine_cell_moments as fcm, peaks


def read(readings):
    p = readings.profile
    chip = peaks.peaks_of(readings.device_name)
    if not p or chip is None or not p["steps"]:
        return None
    total = sum(t for name, ts in p["kernel_s"].items()
                if fcm.is_launch(name) for t in ts)
    if total <= 0:
        return None
    least, _ = fcm.bound_s(fcm.shape(readings.campaign, readings.walkers),
                           chip)
    return 100.0 * least / (total / (2 * p["steps"]))
