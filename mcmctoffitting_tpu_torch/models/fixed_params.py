"""Reduced-dimension diagnostic fits: freeze a subset of parameters.

Port of ``mcmctoffitting_tpu/models/fixed_params.py`` (which generalises
the reference's ``tests/simultFit_oneParam.py``: fix everything but E0
and walk that one, ``:395-407``).  It wraps any of the port's problems:
the sampler sees only the free subspace, and a batch of free thetas
(W, D_free) becomes the full (W, D) by one ``index_copy`` into the frozen
values before the base problem's batched log-prob runs.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FixedParamProblem:
    """View of a full problem with some parameters frozen.

    ``template``: a full-dimension parameter vector holding the frozen
    values (the free entries are ignored).  ``free_mask``: True = sampled.
    """

    base: object                 # any problem with make_log_prob_fn
    template: tuple
    free_mask: tuple

    @classmethod
    def freeze(cls, base, template, free_indices) -> "FixedParamProblem":
        template = tuple(float(v) for v in np.asarray(template))
        mask = np.zeros(len(template), dtype=bool)
        mask[list(free_indices)] = True
        return cls(base, template, tuple(bool(b) for b in mask))

    @property
    def n_dim(self) -> int:
        return int(np.sum(self.free_mask))

    @property
    def free_indices(self) -> np.ndarray:
        return np.nonzero(np.asarray(self.free_mask))[0]

    def expand(self, theta_free: torch.Tensor) -> torch.Tensor:
        """(..., n_free) -> (..., D): the frozen values with the free
        entries filled in, on ``theta_free``'s device and dtype."""
        theta_free = torch.as_tensor(theta_free)
        full = torch.as_tensor(self.template, dtype=theta_free.dtype,
                               device=theta_free.device)
        full = full.expand(theta_free.shape[:-1] + full.shape)
        idx = torch.as_tensor(self.free_indices, device=theta_free.device)
        return torch.index_copy(full, full.dim() - 1, idx, theta_free)

    def collapse(self, theta_full):
        """(..., D) -> (..., n_free) numpy: the free entries."""
        return np.asarray(theta_full)[..., self.free_indices]

    def make_log_prob_fn(self, observed, **kwargs):
        """The base problem's batched log-prob on expanded thetas:
        (thetas (W, n_free), generator) -> (W,)."""
        base_logp = self.base.make_log_prob_fn(observed, **kwargs)

        def logp(theta_free, generator):
            return base_logp(self.expand(theta_free), generator)

        return logp
