"""The sampler's own time a DE step (``sampler/stretch.py``): each traced
segment's wall time, less the time inside its log-prob calls, over its
steps.  The benchmark's spans around the log-prob callable it hands to
``run_mcmc`` end in a synchronize, as does each traced segment."""


def read(readings):
    s = readings.spans
    if not s or not s["steps"]:
        return None
    return (sum(s["segment_ms"]) - sum(s["logp_ms"])) / s["steps"]
