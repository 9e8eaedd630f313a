"""The fine-cell moments of the mc estimator on the e0grid operator
(``ops/e0grid.py::fine_cell_moments``): the bytes they must move and the
operations they must do at a shape.

Shape: ``rows`` (walker, run) rows of ``n`` initial energies, each
summed by fine e0 cell into the four channels (1, t, t^2, t^3) of
``n_fine`` cells.  Bytes: the (rows, n) float32 energies read once and
the (rows, 4, n_fine) float32 moments written once.  Operations, a
sample: the range test (2), the cell (a subtraction, a product, a
floor: 3), t (2), t^2 and t^3 (2) and the four accumulations (4): 13,
none of them dependent on the data.  At every shape the benchmark runs
the bytes bound it.

The program sums the channels as int64 fixed point by one
``scatter_add_`` a channel (PyTorch's ``_scatter_gather`` kernels); a
kernel of the port's own whose name holds ``fine_cell_moments`` would
take their place.  Either counts as the stage's accumulation
(:func:`is_launch`), so the bound reads the same work whatever
implements it.
"""
OPS_PER_SAMPLE = 13
KERNEL_NAMES = ("_scatter_gather", "fine_cell_moments")


def shape(campaign, walkers: int) -> dict:
    """The moments' shape in a half-update of ``walkers`` walkers on a
    campaign with an e0-space operator (``reference/tables.py::Campaign``,
    as ``reference/mc_table.py`` builds it)."""
    return dict(rows=walkers // 2 * campaign.n_runs, n=campaign.n_samples,
                n_fine=campaign.operator.n_fine)


def bytes_moved(rows, n, n_fine) -> int:
    return 4 * (rows * n + rows * 4 * n_fine)


def operations(rows, n, n_fine) -> int:
    return OPS_PER_SAMPLE * rows * n


def bound_s(shape: dict, peaks: dict) -> tuple[float, str]:
    """(least seconds, what bounds it) at ``shape`` on a chip of
    ``peaks``."""
    t_bytes = bytes_moved(**shape) / peaks["bytes_per_s"]
    t_ops = operations(**shape) / peaks["f32_flop_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def is_launch(name: str) -> bool:
    """A launch that accumulates the fine cells, by its profiler kernel
    name."""
    return any(k in name for k in KERNEL_NAMES)
