"""Wall time of one log-prob evaluation (a half-step: W/2 walkers x R
runs; ``models/problem.py``), from the benchmark's spans around the
callable it hands to ``run_mcmc``, each ending in a synchronize."""


def read(readings):
    s = readings.spans
    if not s or not s["logp_ms"]:
        return None
    return sum(s["logp_ms"]) / len(s["logp_ms"])
