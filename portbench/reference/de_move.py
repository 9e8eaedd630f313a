"""The differential-evolution move of the ensemble sampler (ter Braak
2006; emcee's ``DEMove``), as the benchmark holds the program to it.

The walkers are split into two halves that update in turn.  For each
walker x of the active half: a first partner j1 drawn uniformly from the
complementary half, a second j2 uniformly from the others, a factor
g = gamma0 (1 + sigma N(0, 1)) with gamma0 = 2.38 / sqrt(2 D) and
sigma = 1e-5, the proposal x + g (x_j1 - x_j2), accepted when
log u < lp(proposal) - lp(x).  The draws come from the move generator in
that order: j1, the offset of j2, g, then (after the log-prob) u.
"""
from __future__ import annotations

import numpy as np
import torch

GAMMA_SCALE = 2.38
SIGMA = 1e-5
# a proposal coordinate agrees when within 4 float32 ulps of the sum's
# terms' scale: any order of the two roundings, or a fused multiply-add
TOLERANCE = 4 * float(np.finfo(np.float32).eps)


def draws(generator: torch.Generator, n_half: int, n_dim: int, skip: int):
    """(j1, j2, g, u) of one half-update, drawn from ``generator`` after
    ``skip`` uniforms (the previous half-update's acceptance draws)."""
    dev = generator.device
    if skip:
        torch.rand(skip, generator=generator, device=dev)
    j1 = torch.randint(0, n_half, (n_half,), generator=generator, device=dev)
    j2 = (j1 + 1 + torch.randint(0, n_half - 1, (n_half,),
                                 generator=generator, device=dev)) % n_half
    gamma0 = GAMMA_SCALE / (2.0 * n_dim) ** 0.5
    g = gamma0 * (1.0 + SIGMA * torch.randn(n_half, generator=generator,
                                            device=dev))
    u = torch.rand(n_half, generator=generator, device=dev)
    return j1, j2, g, u


def proposal_mismatches(proposal: np.ndarray, active: np.ndarray,
                        passive: np.ndarray, j1, j2, g) -> int:
    """Walkers whose proposal differs from x + g (x_j1 - x_j2), in
    float32, beyond :data:`TOLERANCE` of its terms' scale."""
    j1, j2 = j1.cpu().numpy(), j2.cpu().numpy()
    g = g.cpu().numpy().astype(np.float32)[:, None]
    step = g * (passive[j1] - passive[j2])
    expected = active + step
    scale = np.abs(active).astype(np.float64) + np.abs(step)
    with np.errstate(invalid="ignore"):
        gap = np.abs(proposal.astype(np.float64) - expected)
    agree = (proposal == expected) | (gap <= TOLERANCE * scale)
    return int(np.sum(~np.all(agree, axis=-1)))
