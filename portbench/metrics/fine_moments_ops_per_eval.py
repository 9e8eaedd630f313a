"""Device operations (kernels, copies, memsets) that the fine-cell
moments of the mc estimator on the e0grid operator
(``mcmctof.fine_moments``: ``ops/e0grid.py::fine_cell_moments``) launch
an evaluation, in the profiled sub-window C (``program_spans.py``):
operations whose launching call ran with ``mcmctof.fine_moments`` the
innermost span open, over the calls of ``mcmctof.logp``.  Nothing where
no device operation was traced, the program has no spans or no such
span (a program before the span, or another estimator)."""
from portbench import program_spans


def read(readings):
    _, prof = program_spans.of(readings)
    if not prof or not prof["n_ops"]:
        return None
    evals = prof["calls"].get("mcmctof.logp", 0)
    if not evals or "mcmctof.fine_moments" not in prof["calls"]:
        return None
    return prof["ops"].get("mcmctof.fine_moments", 0) / evals
