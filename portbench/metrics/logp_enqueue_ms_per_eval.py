"""Host time of one log-prob evaluation (``models/problem.py``, a
half-step: W/2 walkers x R runs), from the program's ``mcmctof.logp``
span in sub-window B (``program_spans.py``): its total over its calls.
No synchronize, so on a host-bound cell this is what an evaluation costs
the host.  Nothing where the program has no spans."""
from portbench import program_spans


def read(readings):
    program, _ = program_spans.of(readings)
    s = program and program["spans"].get("mcmctof.logp")
    if not s or not s["calls"]:
        return None
    return s["total_ms"] / s["calls"]
