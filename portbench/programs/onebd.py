"""The program's csi_oneBD joint fit (``models/onebd.py``) from a
configuration file and a traffic mix."""
from __future__ import annotations


def build(config: dict, traffic: dict, device):
    from mcmctoffitting_tpu_torch.models import onebd
    spec = onebd.default_spec(
        int(config["n_samples"]), hardcore=bool(config.get("hardcore")),
        sampling=traffic["sampling"], fine_grid=traffic.get("fine_grid"),
        xs_mode=traffic.get("xs_mode", "e0grid"))
    return onebd.OneBDProblem(spec, int(config["n_runs"]),
                              traffic["likelihood"], device=device)
