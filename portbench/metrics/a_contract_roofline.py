"""The A contraction's kernel's share of its roofline: the least time at
the cell's own shape (``roofline/a_contract.py``, from the reference's
campaign and its operator's nonzeros, and the published peaks of
``roofline/peaks.py``) over its mean device time a launch
(``a_contract_kernel``) in the profiled sub-window.  Nothing when no
such launch was traced."""
from portbench.roofline import a_contract, peaks


def read(readings):
    p = readings.profile
    chip = peaks.peaks_of(readings.device_name)
    if not p or chip is None:
        return None
    times = [t for name, ts in p["kernel_s"].items()
             if a_contract.is_launch(name) for t in ts]
    if not times:
        return None
    least, _ = a_contract.bound_s(
        a_contract.shape(readings.campaign, readings.walkers), chip)
    return 100.0 * least / (sum(times) / len(times))
