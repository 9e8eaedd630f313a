"""Kernel K2 (``csrc/tof_hist.cu``, the zero-degree TOF histogram): the
bytes it must move and the operations it must do at a lattice shape.

Shape: ``rows`` walkers x ``runs`` x (``n_x`` x ``n_ed``) lattice cells,
each spread over ``n_seg`` zero-degree segments into one of ``n_pad``
window bins per run.  Bytes: the lattice's times and draw counts read
once (float32), the (n_ed, n_seg) segment times and weights read once,
the (rows, runs, n_pad) histogram written once.  Operations: a time and
a weight per cell, then per in-window (cell, segment) sample a bin and a
weighted add, 4 + 5 n_seg a cell at most; at every shape the benchmark
runs, even that upper bound needs less time than the bytes, so the bound
is the bytes'.
"""
KERNEL_NAME = "tof_hist"        # a profiler kernel name containing this
EXCLUDE = ("bwd",)              # and none of these is a K2 forward launch


def shape(campaign, walkers: int) -> dict:
    """K2's shape in a half-update of ``walkers`` walkers on a campaign
    of the counts reference (``reference/tables.py::Campaign``)."""
    return dict(rows=walkers // 2, runs=campaign.n_runs, n_x=campaign.x.n,
                n_ed=campaign.ed.n, n_seg=campaign.zt.shape[1],
                n_pad=max(w.n_bins for w in campaign.windows))


def bytes_moved(rows, runs, n_x, n_ed, n_seg, n_pad) -> int:
    cells = rows * runs * n_x * n_ed
    return 4 * (2 * cells + 2 * n_ed * n_seg + rows * runs * n_pad)


def operations(rows, runs, n_x, n_ed, n_seg, n_pad) -> int:
    cells = rows * runs * n_x * n_ed
    return 4 * cells + 5 * cells * n_seg


def bound_s(shape: dict, peaks: dict) -> tuple[float, str]:
    """(least seconds, what bounds it) at ``shape`` on a chip of
    ``peaks``."""
    t_bytes = bytes_moved(**shape) / peaks["bytes_per_s"]
    t_ops = operations(**shape) / peaks["f32_flop_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def is_launch(name: str) -> bool:
    return KERNEL_NAME in name and not any(x in name for x in EXCLUDE)
