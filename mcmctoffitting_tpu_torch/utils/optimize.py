"""MAP/ML seeding optimisers.

Port of ``mcmctoffitting_tpu/utils/optimize.py``: SciPy minimisers on the
host for any log-prob (gradient-free, with common random numbers for the
stochastic Monte-Carlo likelihoods), and Adam with autograd gradients for
the deterministic ones.  ``logp_fn(theta (D,), generator) -> scalar``.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..models.forward import resolve_device


def minimize_nll(logp_fn: Callable, x0, *,
                 generator: Optional[torch.Generator] = None,
                 method: str = "Nelder-Mead",
                 bounds: Optional[Sequence] = None, tol: float | None = None,
                 maxiter: int | None = None, eps: float = 1e-3,
                 device="cuda"):
    """Minimise -logp with SciPy (TNC / Nelder-Mead / SLSQP / ...).

    Every evaluation starts ``generator`` from the same state (common
    random numbers), so that a stochastic likelihood becomes a
    deterministic objective, as these optimisers need.  With ``bounds``
    the optimiser runs in unit-box coordinates z = (x - lo) / (hi - lo)
    (the parameters span five decades, and SciPy's finite differences use
    one absolute step); ``eps`` is that step in z units.  lo == hi pins a
    parameter.  A non-finite objective reads as 1e30.  ``device`` is
    where theta is handed to ``logp_fn``: the GPU unless the caller asks
    for the CPU.
    """
    from scipy import optimize as sopt

    device = resolve_device(device)

    if generator is None:
        generator = torch.Generator().manual_seed(0)
    start = generator.get_state()

    lo = span = None
    if bounds is not None:
        lo = np.asarray([b[0] for b in bounds], np.float64)
        hi = np.asarray([b[1] for b in bounds], np.float64)
        span = np.where(hi > lo, hi - lo, 1.0)

    def to_x(z):
        return lo + z * span if lo is not None else z

    def obj(z):
        generator.set_state(start)
        theta = torch.as_tensor(np.asarray(to_x(z), np.float32),
                                device=device)
        with torch.no_grad():
            v = -float(logp_fn(theta, generator))
        return v if np.isfinite(v) else 1e30

    options = {}
    if maxiter is not None:
        # TNC spells its evaluation budget 'maxfun'
        options["maxfun" if method == "TNC" else "maxiter"] = maxiter
    if bounds is not None:
        z0 = np.clip((np.asarray(x0, np.float64) - lo) / span, 0.0, 1.0)
        if method in ("TNC", "SLSQP", "L-BFGS-B"):
            options["eps"] = eps
        z_bounds = [(0.0, 0.0) if h <= l else (0.0, 1.0)
                    for l, h in zip(lo, hi)]
        res = sopt.minimize(obj, z0, method=method, bounds=z_bounds,
                            tol=tol, options=options or None)
        res.x = to_x(res.x)
        return res
    return sopt.minimize(obj, np.asarray(x0, dtype=np.float64),
                         method=method, tol=tol, options=options or None)


def adam_map(logp_fn: Callable, x0, *,
             generator: Optional[torch.Generator] = None, steps: int = 500,
             learning_rate: float = 1e-2, device="cuda"):
    """Gradient-based MAP for a differentiable (deterministic) log-prob:
    ``torch.optim.Adam``, whose defaults (betas 0.9 / 0.999, eps 1e-8) are
    optax's.  Returns (theta as a numpy array, the last loss: -logp at the
    point before the last update), as the JAX package does.  Theta lives
    on ``device``: the GPU unless the caller asks for the CPU."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    x = torch.tensor(np.asarray(x0, np.float32), device=device,
                     requires_grad=True)
    opt = torch.optim.Adam([x], lr=learning_rate)
    loss = torch.tensor(np.inf)
    for _ in range(steps):
        opt.zero_grad()
        loss = -logp_fn(x, generator)
        loss.backward()
        opt.step()
    return x.detach().cpu().numpy(), loss.item()
