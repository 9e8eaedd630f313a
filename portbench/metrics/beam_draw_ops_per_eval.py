"""Device operations (kernels, copies, memsets) that the mc beam draw
(``mcmctof.beam_draw``: the uniforms and the truncated lognormal's
inverse CDF) launches an evaluation, in the profiled sub-window C
(``program_spans.py``): operations whose launching call ran with
``mcmctof.beam_draw`` the innermost span open, over the calls of
``mcmctof.logp``.  Nothing where no device operation was traced, the
program has no spans or the cell's estimator no beam draw."""
from portbench import program_spans


def read(readings):
    _, prof = program_spans.of(readings)
    if not prof or not prof["n_ops"]:
        return None
    evals = prof["calls"].get("mcmctof.logp", 0)
    if not evals or "mcmctof.beam_draw" not in prof["calls"]:
        return None
    return prof["ops"].get("mcmctof.beam_draw", 0) / evals
