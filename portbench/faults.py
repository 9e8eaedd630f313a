"""Faults planted in the program's timed path, each of which the check
has to find: the CPU tests plant them at a tiny size, and
``control.py --fault <name>`` reads the check's numbers under one on the
card at the cell's own size.  A fault is (module, owner, attribute,
wrap): ``wrap(real)`` replaces the attribute."""
from __future__ import annotations

import importlib

import torch


def _answer_altered(real):
    """Every log-prob 1 nat high."""
    return lambda self, *a, **k: real(self, *a, **k) + 1.0


def _half_the_batch(real):
    """The second half of the batch left out, given the mean of the
    rest."""
    def half(self, thetas, generator, observed, **rows):
        n = thetas.shape[0] // 2
        kept = real(self, thetas[:n], generator, observed, **rows)
        rest = torch.full((thetas.shape[0] - n,), float(kept.mean()),
                          device=kept.device, dtype=kept.dtype)
        return torch.cat([kept, rest])
    return half


def _state_unchanged(real):
    """A half-update that returns its state unchanged."""
    return lambda pos, lp, parity, accept, *rest: accept


def _de_factor(real):
    """The DE move's factor gamma0 off by 1%."""
    return lambda pos, lp, parity, gen, eval_gen, logp, gamma0, sigma: real(
        pos, lp, parity, gen, eval_gen, logp, gamma0 * 1.01, sigma)


def _de_partners_from_the_active_half(real):
    """The DE move's partners drawn from the walker's own half."""
    return lambda pos, lp, parity: (pos[parity::2], pos[parity::2],
                                    lp[parity::2])


_PROBLEM = "mcmctoffitting_tpu_torch.models.problem"
_STRETCH = "mcmctoffitting_tpu_torch.sampler.stretch"
FAULTS = {
    "answer_altered": (_PROBLEM, "JointFitProblem", "log_prob",
                       _answer_altered),
    "half_the_batch": (_PROBLEM, "JointFitProblem", "log_prob",
                       _half_the_batch),
    "state_unchanged": (_STRETCH, None, "_commit", _state_unchanged),
    "de_factor": (_STRETCH, None, "_half_update_de", _de_factor),
    "de_partners_from_the_active_half": (
        _STRETCH, None, "_halves", _de_partners_from_the_active_half),
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
