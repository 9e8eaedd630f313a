"""The 'shifting Gaussian' analytic study model.

Port of ``mcmctoffitting_tpu/models/shifting_gaussian.py``, a rebuild of
``tests/shiftingGaussian_brute.py``: y ~ N(m x + b, sigma) with x
marginalized uniformly over [0, 10]; the projected pdf in closed form (an
erf difference, with the reference's 1/m factor) or by a fixed 64-node
Gauss-Legendre rule (nodes and weights built in numpy float64, as the JAX
package builds them), the unbinned log-likelihood on it, and the strict box
prior ``sigma in (0, 5), b in (0, 10), m in (-0.5, 0.1)``.

Batch-native: every function of theta takes a leading axis of thetas,
(B, 3) = (sigma, m, b) -> (B,), and one call evaluates them all against
the (N,) observations.  The numeric likelihood at 1,000 thetas x 500
observations x 64 nodes holds 32M float32 values per intermediate.  The
model draws no random numbers, so its log-probability ignores the
sampler's host generator.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

X_MIN, X_MAX = 0.0, 10.0
PARAM_LO = np.array([0.0, -0.5, 0.0])   # sigma, m, b
PARAM_HI = np.array([5.0, 0.1, 10.0])


def eval_pdf(x, y, sigma, m, b):
    """Joint density in y at location x (``evalPdf``), broadcast."""
    mean = m * x + b
    return (torch.exp(-((y - mean) ** 2) / (2.0 * sigma * sigma))
            / (sigma * math.sqrt(2.0 * math.pi)))


def projected_prob_analytic(y, m, b, sigma):
    """Closed-form x-marginal (``getProjectedProb``): the reference's exact
    expression incl. its 1/m factor (undefined at m=0, as it notes).  The
    parameters broadcast against ``y``."""
    arg_max = (b + m * X_MAX - y) / (math.sqrt(2.0) * sigma)
    arg_min = (b + m * X_MIN - y) / (math.sqrt(2.0) * sigma)
    return (math.sqrt(math.pi / 2.0) * sigma
            * (torch.erf(arg_max) - torch.erf(arg_min)) / m)


@functools.lru_cache(maxsize=8)
def _legendre_rule(n_nodes: int, device: torch.device):
    """Nodes and weights on [X_MIN, X_MAX], built in numpy float64 and
    rounded to float32 on ``device`` once."""
    nodes, weights = np.polynomial.legendre.leggauss(n_nodes)
    xs = 0.5 * (X_MAX - X_MIN) * (nodes + 1.0) + X_MIN
    ws = 0.5 * (X_MAX - X_MIN) * weights
    return (torch.as_tensor(xs, dtype=torch.float32, device=device),
            torch.as_tensor(ws, dtype=torch.float32, device=device))


def projected_prob_numeric(y, m, b, sigma, n_nodes: int = 64):
    """Fixed-node Gauss-Legendre x-projection (the JAX package's stand-in
    for scipy ``quad``): the nodes form a new last axis; the parameters
    broadcast against ``y``."""
    xs, ws = _legendre_rule(n_nodes, y.device)
    sigma, m, b = (torch.as_tensor(v, dtype=y.dtype, device=y.device)[
        ..., None] for v in (sigma, m, b))
    vals = eval_pdf(xs, y[..., None], sigma, m, b)
    return torch.sum(vals * ws, dim=-1)


def loglike_projected(theta, observed, *, numeric: bool = False):
    """Unbinned log-likelihood from the projected pdf
    (``lnlikeFromProjProb`` / ``numLnlikeFromProjProb``): (B, 3) thetas,
    (N,) observations -> (B,); log(max(p, 0)) summed, NaN -> -inf."""
    sigma, m, b = (theta[:, k, None] for k in range(3))      # (B, 1) each
    if numeric:
        p = projected_prob_numeric(observed, m, b, sigma)
    else:
        p = projected_prob_analytic(observed, m, b, sigma)
    ll = torch.sum(torch.log(torch.clamp_min(p, 0.0)), dim=-1)
    return torch.where(torch.isnan(ll), -torch.inf, ll)


def lnprior(theta):
    """Strict box prior (``lnPriors :113-120``): (B, 3) -> (B,)."""
    sigma, m, b = theta[:, 0], theta[:, 1], theta[:, 2]
    ok = ((sigma > 0.0) & (sigma < 5.0) & (b > 0.0) & (b < 10.0)
          & (m < 0.1) & (m > -0.5))
    return torch.where(ok, 0.0, -torch.inf)


def lnprob(theta, observed, *, numeric: bool = False):
    prior = lnprior(theta)
    ll = loglike_projected(theta, observed, numeric=numeric)
    return torch.where(torch.isneginf(prior), -torch.inf, prior + ll)


def generate_data(generator: torch.Generator, n: int, sigma: float,
                  m: float, b: float) -> torch.Tensor:
    """Draw (n,) y samples from the model (x uniform, then the shifted
    Gaussian), float32 on the generator's device."""
    dev = generator.device
    x = X_MIN + (X_MAX - X_MIN) * torch.rand(n, generator=generator,
                                             device=dev)
    return m * x + b + sigma * torch.randn(n, generator=generator,
                                           device=dev)


def make_log_prob_fn(observed, *, numeric: bool = False):
    """Closure (thetas (B, 3), host generator) -> (B,) for the ensemble
    sampler; the generator is unused (the model draws nothing)."""
    obs = torch.as_tensor(observed, dtype=torch.float32)

    def logp(thetas, generator):
        del generator
        return lnprob(thetas, obs.to(thetas.device), numeric=numeric)

    return logp


def make_pt_fns(observed, *, numeric: bool = False):
    """(loglike_fn, logprior_fn) pair of batched functions of (B, 3)
    thetas for ``sampler.pt.sample_pt``."""
    obs = torch.as_tensor(observed, dtype=torch.float32)

    def loglike(thetas):
        return loglike_projected(thetas, obs.to(thetas.device),
                                 numeric=numeric)

    return loglike, lnprior
