"""Binned Poisson likelihoods and the box prior, batched.

Port of ``mcmctoffitting_tpu/ops/likelihoods.py`` (``poisson_binned_loglike``,
``poisson_logpmf_loglike``, ``box_lnprior``), reducing over the last axis:
model (..., n_bins) against observed (n_bins,) or (..., n_bins) -> (...).
An optional boolean ``mask`` (broadcast like the model) drops bins, for
per-run spectra padded to a common width.  The numerical semantics are the
JAX package's, NaN guards included: a NaN model bin contributes -inf, and
a NaN total maps to -inf.
"""
from __future__ import annotations

import torch


def poisson_binned_terms(model_counts, observed_counts):
    """Per-bin terms of the faithful binned form: after clamping obs == 0
    and model == 0 to 1, obs * (-obs - gammaln(floor(model) + 1)
    + model * log(obs)) — the floor makes it a sawtooth in the model; a
    NaN model bin is -inf (the JAX package's default ``nan_guard``)."""
    model, obs = model_counts, observed_counts
    obs_c = torch.where(obs == 0, 1.0, obs)
    model_safe = torch.where(torch.isnan(model), 1.0, model)
    model_c = torch.where(model_safe == 0, 1.0, model_safe)
    poi = (-obs_c - torch.lgamma(torch.floor(model_c) + 1.0)
           + torch.where(model_c > 0, model_c * torch.log(obs_c), 0.0))
    contrib = obs_c * poi
    return torch.where(torch.isnan(model), -torch.inf, contrib)


def _total(terms, mask):
    if mask is not None:
        terms = torch.where(mask, terms, 0.0)
    total = torch.sum(terms, dim=-1)
    return torch.where(torch.isnan(total), -torch.inf, total)


def poisson_binned_loglike(model_counts, observed_counts, *, mask=None):
    """The faithful ("reference") binned-Poisson log-likelihood."""
    return _total(poisson_binned_terms(model_counts, observed_counts), mask)


POISSON_RATE_FLOOR = 1e-3


def poisson_logpmf_terms(model_counts, observed_counts):
    """Per-bin Poisson(obs | rate) log-pmf with the rate floored at
    ``POISSON_RATE_FLOOR``."""
    model, obs = model_counts, observed_counts
    rate = torch.clamp_min(model, POISSON_RATE_FLOOR)
    logpmf = obs * torch.log(rate) - rate - torch.lgamma(obs + 1.0)
    return torch.where(torch.isnan(model), -torch.inf, logpmf)


def poisson_logpmf_loglike(model_counts, observed_counts, *, mask=None):
    """The corrected Poisson(obs | rate=model) binned log-likelihood."""
    return _total(poisson_logpmf_terms(model_counts, observed_counts), mask)


def box_lnprior(theta, lo, hi, *, inclusive: bool = False):
    """Uniform box prior over the last axis: 0 inside, -inf outside
    (closed bounds when ``inclusive``)."""
    if inclusive:
        ok = torch.all((theta >= lo) & (theta <= hi), dim=-1)
    else:
        ok = torch.all((theta > lo) & (theta < hi), dim=-1)
    return torch.where(ok, 0.0, -torch.inf)
