"""The program's simultFit joint fit (``models/simult.py``) from a
configuration file and a traffic mix."""
from __future__ import annotations


def build(config: dict, traffic: dict, device):
    from mcmctoffitting_tpu_torch.models import simult
    spec = simult.default_spec(
        int(config["n_samples"]), sampling=traffic["sampling"],
        fine_grid=traffic.get("fine_grid"),
        xs_mode=traffic.get("xs_mode", "e0grid"),
        transport=traffic.get("transport", "table"))
    return simult.SimultFitProblem(spec, int(config["n_runs"]),
                                   traffic["likelihood"], device=device)
