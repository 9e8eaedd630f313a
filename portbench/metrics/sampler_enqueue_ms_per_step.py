"""The sampler's own host time a DE step (``sampler/stretch.py``), from
the program's spans in sub-window B (``program_spans.py``): the total of
``mcmctof.step``, its ``mcmctof.half_update`` children included, less
the ``mcmctof.logp`` evaluations inside it (every one of the sub-window
is), over the steps.  No synchronize.  Nothing where the program has no
spans."""
from portbench import program_spans


def read(readings):
    program, _ = program_spans.of(readings)
    if not program:
        return None
    step = program["spans"].get("mcmctof.step")
    logp = program["spans"].get("mcmctof.logp")
    if not step or not logp or not step["calls"]:
        return None
    return (step["total_ms"] - logp["total_ms"]) / step["calls"]
