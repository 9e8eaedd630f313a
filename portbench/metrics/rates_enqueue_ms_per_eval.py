"""Host time of the counts estimator's rate stage an evaluation
(``ops/e0grid.py::counts_lambdas``, the ndtr chain), from the program's
spans in sub-window B (``program_spans.py``): the total of
``mcmctof.rates`` over the calls of ``mcmctof.logp``.  No synchronize.
Nothing where the program has no spans or the cell's estimator no rate
stage."""
from portbench import program_spans


def read(readings):
    program, _ = program_spans.of(readings)
    if not program:
        return None
    rates = program["spans"].get("mcmctof.rates")
    logp = program["spans"].get("mcmctof.logp")
    if not rates or not logp or not logp["calls"]:
        return None
    return rates["total_ms"] / logp["calls"]
