"""The A contraction's kernel (``csrc/a_contract.cu``, the fine-cell
moments times the e0-space operator A): the bytes it must move and the
operations it must do at a shape.

Shape: ``rows`` (walker, run) rows of ``k`` = 4 F fine-cell moments,
contracted with A (k, ``n_cols``), n_cols = M x Be grid cells, of which
``nnz`` entries are not zero.  Bytes: the rows read once and the (rows,
n_cols) output written once (float32), and each nonzero's value and row
index read once (4 + 4 bytes).  Operations: a multiply and an add per
row and nonzero.  The nonzeros, not the width of the kernel's packing,
are the work, so the bound reads the same whatever implements it; at
every shape the benchmark runs the bytes bound it.
"""
import numpy as np

KERNEL_NAME = "a_contract_kernel"   # a profiler kernel name containing this


def shape(campaign, walkers: int) -> dict:
    """The contraction's shape in a half-update of ``walkers`` walkers on
    a campaign of the counts reference (``reference/tables.py::Campaign``):
    A as the reference holds it, its nonzeros counted."""
    a = campaign.operator.a_matrix
    return dict(rows=walkers // 2 * campaign.n_runs, k=a.shape[0],
                n_cols=a.shape[1], nnz=int(np.count_nonzero(a)))


def bytes_moved(rows, k, n_cols, nnz) -> int:
    return 4 * (rows * k + rows * n_cols) + 8 * nnz


def operations(rows, k, n_cols, nnz) -> int:
    return 2 * rows * nnz


def bound_s(shape: dict, peaks: dict) -> tuple[float, str]:
    """(least seconds, what bounds it) at ``shape`` on a chip of
    ``peaks``."""
    t_bytes = bytes_moved(**shape) / peaks["bytes_per_s"]
    t_ops = operations(**shape) / peaks["f32_flop_per_s"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def is_launch(name: str) -> bool:
    return KERNEL_NAME in name
