"""The device's busy time a DE step outside kernel K4, in the profiled
sub-window: the union of the device operations' intervals less the
device time of the K4 calls (``transport_moments_kernel`` and its
``fixed_point_to_float`` pass), over the steps, in ms.  What the beam
draw, the Taylor contraction and the shared stages keep the card busy
for.  Nothing when no K4 launch was traced."""
from portbench.roofline import k4_transport_moments as k4


def read(readings):
    p = readings.profile
    if not p or not p["steps"] or not p["n_ops"]:
        return None
    n, total = k4.calls(p["kernel_s"])
    if not n:
        return None
    return 1e3 * (p["busy_s"] - total) / p["steps"]
