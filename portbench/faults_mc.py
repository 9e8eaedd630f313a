"""Faults planted in the mc estimator's timed path on the ODE path, each
of which the check of an mc cell has to find: the CPU tests plant them at
a tiny size, and ``control_mc.py --fault <name>`` reads the check's
numbers under one on the card at the cell's own size.  A fault is
(module, owner, attribute, wrap), as in ``faults.py``: ``wrap(real)``
replaces the attribute."""
from __future__ import annotations

import importlib


def _third_moment_dropped(real):
    """K4's d^3 channel left out of the moment histograms."""
    def dropped(e0, c, bins, **kw):
        moments = real(e0, c, bins, **kw).clone()
        moments[..., 3, :] = 0.0
        return moments
    return dropped


def _stopping_table(real):
    """The stopping-table lookup in place of the RK4 transport: the same
    mathematics approximated, not computed."""
    def table(e0, c, bins, **kw):
        from mcmctoffitting_tpu_torch.models import simult
        from mcmctoffitting_tpu_torch.ops.cuda_transport import \
            energy_moments
        from mcmctoffitting_tpu_torch.ops.stopping import eval_stopped
        tab = simult._build_table(8.565e-5)
        coeffs = tab.coeffs_tensor(e0.device)
        return energy_moments(lambda e: eval_stopped(tab, e, coeffs), e0,
                              len(c.h), bins)
    return table


def _seed_words_shifted(real):
    """The beam draw's device generator seeded one above the seed words'
    64-bit seed."""
    def shifted(generator, device):
        gen = real(generator, device)
        gen.manual_seed((gen.initial_seed() + 1) % 2 ** 64)
        return gen
    return shifted


_FORWARD = "mcmctoffitting_tpu_torch.models.forward"
FAULTS = {
    "third_moment_dropped": (_FORWARD, None, "transport_moments",
                             _third_moment_dropped),
    "stopping_table": (_FORWARD, None, "transport_moments", _stopping_table),
    "seed_words_shifted": ("mcmctoffitting_tpu_torch.ops.pdfs", None,
                           "device_generator", _seed_words_shifted),
}


def planted(name: str):
    """(object, attribute, replacement) of fault ``name``."""
    module, owner, attr, wrap = FAULTS[name]
    obj = importlib.import_module(module)
    if owner is not None:
        obj = getattr(obj, owner)
    return obj, attr, wrap(getattr(obj, attr))


def plant(name: str) -> None:
    """Plant fault ``name`` for the rest of the process."""
    obj, attr, new = planted(name)
    setattr(obj, attr, new)
