"""Gradient-based samplers: HMC with step-size adaptation, and
random-walk Metropolis.

Port of ``mcmctoffitting_tpu/sampler/hmc.py``: static leapfrog
trajectories of jittered length (Neal's jittered trajectories), dual
averaging of the step size towards a target acceptance during warm-up,
identity mass matrix.  Batch-native: ``log_prob_fn`` takes the chains'
positions (C, D) and returns (C,), and one call (with its backward)
evaluates every chain at once.  Draws come from ``generator``, a
``torch.Generator`` on the chains' device; the deterministic core
(:func:`_leapfrog`) takes its momenta as an argument.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ._adapt import LogpAndGrad, dual_averaging_warmup


@dataclasses.dataclass
class HMCChain:
    positions: torch.Tensor    # (S, C, D) for C parallel chains
    log_probs: torch.Tensor    # (S, C)
    accept_prob: torch.Tensor  # (S, C)
    step_size: float
    n_grad_evals: int = 0      # batched log-prob-and-gradient calls
    n_chain_grads: int = 0     # chains evaluated over those calls


def _leapfrog(logp_and_grad, q, p, grad, lp, step_size, n_active,
              inv_mass):
    """Leapfrog integration of every chain for its own number of steps,
    ``n_active`` (an int for all chains, or a (C,) tensor): positions
    (C, D), momenta, gradients and log-probs at the start -> the same at
    the end.  A chain stops moving after its ``n_active`` steps; the loop
    runs as long as the longest, each step one batched ``logp_and_grad``
    call."""
    per_chain = torch.is_tensor(n_active)
    for i in range(int(n_active.max()) if per_chain else int(n_active)):
        p1 = p + 0.5 * step_size * grad
        q1 = q + step_size * (inv_mass * p1)
        lp1, grad1 = logp_and_grad(q1)
        p1 = p1 + 0.5 * step_size * grad1
        if not per_chain:
            q, p, grad, lp = q1, p1, grad1, lp1
            continue
        live = i < n_active
        q = torch.where(live[:, None], q1, q)
        p = torch.where(live[:, None], p1, p)
        grad = torch.where(live[:, None], grad1, grad)
        lp = torch.where(live, lp1, lp)
    return q, p, grad, lp


def hmc_sample(generator: torch.Generator, p0, n_steps: int,
               log_prob_fn: Callable, *, n_warmup: int = 200,
               n_leapfrog: int = 16, init_step_size: float = 0.1,
               target_accept: float = 0.8, jitter: float = 0.2) -> HMCChain:
    """Run C parallel HMC chains from ``p0`` (C, D).

    Warm-up adapts the step size by dual averaging; sampling keeps it
    fixed (identity mass matrix: standardise the parameters beforehand).
    Each iteration integrates a trajectory of random length, uniform in
    [(1 - jitter) L, (1 + jitter) L], one length for all chains.
    """
    dev = generator.device
    p0 = torch.as_tensor(p0, dtype=torch.float32, device=dev)
    n_chains, n_dim = p0.shape
    logp_grad = LogpAndGrad(log_prob_fn)
    inv_mass = torch.ones(n_dim, device=dev)

    len_lo = max(1, int(round(n_leapfrog * (1.0 - jitter))))
    len_hi = max(len_lo, int(round(n_leapfrog * (1.0 + jitter))))

    def one_step(state, step_size):
        q, lp, grad = state
        p = torch.randn(q.shape, generator=generator, device=dev)
        n_active = int(torch.randint(len_lo, len_hi + 1, (),
                                     generator=generator, device=dev))
        q_new, p_new, grad_new, lp_new = _leapfrog(
            logp_grad, q, p, grad, lp, step_size, n_active, inv_mass)
        h_old = lp - 0.5 * torch.sum(p * p, dim=-1)
        h_new = lp_new - 0.5 * torch.sum(p_new * p_new, dim=-1)
        log_alpha = torch.minimum(h_new - h_old, torch.zeros_like(h_new))
        u = torch.rand(n_chains, generator=generator, device=dev)
        accept = torch.log(u) < log_alpha
        q = torch.where(accept[:, None], q_new, q)
        lp = torch.where(accept, lp_new, lp)
        grad = torch.where(accept[:, None], grad_new, grad)
        return (q, lp, grad), torch.exp(log_alpha)

    lp0, g0 = logp_grad(p0)
    state, eps = dual_averaging_warmup((p0, lp0, g0), one_step, n_warmup,
                                       init_step_size, target_accept,
                                       device=dev)
    step_size = float(eps)
    eps = torch.tensor(step_size, dtype=torch.float32, device=dev)

    qs, lps, alphas = [], [], []
    for _ in range(n_steps):
        state, alpha = one_step(state, eps)
        qs.append(state[0])
        lps.append(state[1])
        alphas.append(alpha)
    return HMCChain(_stack(qs, (0, n_chains, n_dim), dev),
                    _stack(lps, (0, n_chains), dev),
                    _stack(alphas, (0, n_chains), dev), step_size,
                    logp_grad.calls, logp_grad.chain_evals)


def _stack(items, empty_shape, device):
    if items:
        return torch.stack(items)
    return torch.zeros(empty_shape, device=device)


def metropolis_sample(generator: torch.Generator, p0, n_steps: int,
                      log_prob_fn: Callable, *, proposal_scale=0.1):
    """Gaussian random-walk Metropolis, C parallel chains (p0: (C, D));
    ``log_prob_fn`` (C, D) -> (C,).  Returns (positions (S, C, D),
    log-probs (S, C), accepted (S, C))."""
    dev = generator.device
    p0 = torch.as_tensor(p0, dtype=torch.float32, device=dev)
    scale = torch.as_tensor(proposal_scale, dtype=torch.float32,
                            device=dev).expand(p0.shape[-1])
    q, lp = p0, log_prob_fn(p0)
    qs, lps, accs = [], [], []
    for _ in range(n_steps):
        prop = q + scale * torch.randn(q.shape, generator=generator,
                                       device=dev)
        lp_new = log_prob_fn(prop)
        u = torch.rand(q.shape[0], generator=generator, device=dev)
        accept = torch.log(u) < lp_new - lp
        q = torch.where(accept[:, None], prop, q)
        lp = torch.where(accept, lp_new, lp)
        qs.append(q)
        lps.append(lp)
        accs.append(accept)
    n_chains, n_dim = p0.shape
    return (_stack(qs, (0, n_chains, n_dim), dev),
            _stack(lps, (0, n_chains), dev),
            torch.stack(accs) if accs else torch.zeros(
                (0, n_chains), dtype=torch.bool, device=dev))
