"""Kernel K4 (``csrc/transport_moments.cu``, the fused RK4 transport and
moment histograms): the bytes it must move and the operations it must do
at a shape.

Shape: ``rows`` (walker, run) rows of ``n`` initial energies, carried
through ``n_x`` depths with ``substeps`` RK4 steps each and binned at
every depth into ``n_bins`` eD bins of four channels (1, d, d^2, d^3).
Bytes: the energies read once (float32), the (rows, n_x, 4, n_bins)
float32 histograms written once.  Operations: per (sample, depth) pair,
44 a substep (four dE/dx, each a logarithm, a division and five more,
and the RK4 sums) and 2 for the bin's test, the count of
``chip_smoke.py::k4_bound`` without its 14 per in-range pair, which
depend on the data: a lower bound whatever implements the kernel.  At
every shape the benchmark runs the operations bound it.

One K4 call is two launches: ``transport_moments_kernel`` and its
``fixed_point_to_float`` pass, which rounds the int64 sums once.
"""
KERNEL_NAME = "transport_moments_kernel"
PASS_NAME = "fixed_point_to_float"


def shape(campaign, walkers: int) -> dict:
    """K4's shape in a half-update of ``walkers`` walkers on an mc
    campaign (``reference/mc.py::McCampaign``)."""
    return dict(rows=walkers // 2 * campaign.n_runs, n=campaign.n_samples,
                n_x=campaign.x.n, n_bins=campaign.ed.n,
                substeps=campaign.rk4.substeps)


def bytes_moved(rows, n, n_x, n_bins, substeps) -> int:
    return 4 * (rows * n + rows * n_x * 4 * n_bins)


def operations(rows, n, n_x, n_bins, substeps) -> int:
    return (44 * substeps + 2) * rows * n * n_x


def bound_s(shape: dict, peaks: dict) -> tuple[float, str]:
    """(least seconds, what bounds it) at ``shape`` on a chip of
    ``peaks``."""
    t_bytes = bytes_moved(**shape) / peaks["bytes_per_s"]
    t_ops = operations(**shape) / peaks["f32_flop_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def is_launch(name: str) -> bool:
    """Either launch of a K4 call, by its profiler kernel name."""
    return KERNEL_NAME in name or PASS_NAME in name


def calls(kernel_s: dict) -> tuple[int, float]:
    """(K4 calls, their total device seconds) in a profiled sub-window's
    seconds of each kernel launch by name: the calls are the launches of
    ``transport_moments_kernel``, the seconds both launches' of each."""
    n = sum(len(ts) for name, ts in kernel_s.items() if KERNEL_NAME in name)
    total = sum(t for name, ts in kernel_s.items() if is_launch(name)
                for t in ts)
    return n, total
