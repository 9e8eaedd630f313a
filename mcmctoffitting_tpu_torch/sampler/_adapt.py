"""What the gradient samplers (``hmc.py``, ``nuts.py``) share: the
log-prob-and-gradient of a batch of chains by autograd, and the step-size
adaptation (Nesterov dual averaging, Hoffman and Gelman).

Port of ``mcmctoffitting_tpu/sampler/_adapt.py``.  The warm-up is a Python
loop; its arithmetic stays in float32 0-dim tensors on the chains' device,
op for op as in the JAX package, so that it adds no synchronisation.  The
JAX package's ``scan_segments`` only bounded the length of a TPU dispatch
and has no counterpart.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models.forward import resolve_device

_GAMMA = 0.05
_T0 = 10.0
_KAPPA = 0.75


class LogpAndGrad:
    """log p and its gradient for a batch of chains: (C, D) -> ((C,),
    (C, D)), both detached, by one forward and one backward of
    ``log_prob_fn`` (C, D) -> (C,) (the chains are independent rows, so the
    gradient of the summed log-prob is each chain's own).  ``calls``
    counts the batched evaluations, ``chain_evals`` the chains evaluated."""

    def __init__(self, log_prob_fn: Callable):
        self.log_prob_fn = log_prob_fn
        self.calls = 0
        self.chain_evals = 0

    def __call__(self, z: torch.Tensor):
        with torch.enable_grad():
            z = z.detach().requires_grad_(True)
            lp = self.log_prob_fn(z)
            if lp.requires_grad:
                grad, = torch.autograd.grad(lp.sum(), z)
            else:                    # a log-prob that does not depend on z
                grad = torch.zeros_like(z)
        self.calls += 1
        self.chain_evals += z.shape[0]
        return lp.detach(), grad


def dual_averaging_warmup(state, one_step: Callable, n_warmup: int,
                          init_step_size: float, target_accept: float, *,
                          device="cuda"):
    """Adapt the step size over ``n_warmup`` iterations.

    ``one_step(state, step_size) -> (state, alpha)`` advances the sampler
    one transition at ``step_size`` (a float32 0-dim tensor on ``device``);
    ``alpha`` is the per-chain acceptance statistic, whose mean drives the
    adaptation.  A non-finite alpha (a divergent trajectory's NaN
    Hamiltonian) counts as 0, so the step size shrinks.

    ``device`` is the GPU unless the caller asks for the CPU.

    Returns (warmed state, adapted step size as a float32 0-dim tensor).
    """
    device = resolve_device(device)
    def f32(x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    mu = torch.log(f32(10.0 * init_step_size))
    # log_eps_bar starts at log(init_step_size), so n_warmup=0 returns it
    log_eps = log_eps_bar = torch.log(f32(init_step_size))
    h_bar = f32(0.0)
    for i in range(n_warmup):
        state, alpha = one_step(state, torch.exp(log_eps))
        alpha = torch.where(torch.isfinite(alpha), alpha, 0.0)
        a = torch.mean(alpha).to(device)
        t = f32(i + 1.0)
        frac = 1.0 / (t + _T0)
        h_bar = (1.0 - frac) * h_bar + frac * (target_accept - a)
        log_eps = mu - torch.sqrt(t) / _GAMMA * h_bar
        eta = t ** -_KAPPA
        log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
    return state, torch.exp(log_eps_bar)
