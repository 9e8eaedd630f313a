"""Affine-invariant ensemble sampler: stretch and DE-MC moves.

Port of ``mcmctoffitting_tpu/sampler/stretch.py``.  Walkers are a tensor
axis; each step updates the even walkers, then the odd ones (red-black
split), against the other half as the complementary ensemble.  One
batched log-probability call evaluates a whole half-ensemble.

* stretch (emcee's default move): y = x_j + z (x - x_j), z ~ g(z) on
  [1/a, a] with g ∝ 1/sqrt(z), accepted on ln U < (D-1) ln z + dlogp;
* 'de' (ter Braak's DE-MC, emcee's DEMove): y = x + g (x_j1 - x_j2) with
  two distinct partners and g = gamma0 (1 + sigma N(0, 1)), gamma0 =
  2.38 / sqrt(2 D), accepted on ln U < dlogp;
* 'mixed' alternates stretch (even steps) and DE (odd steps).

Randomness: the moves draw from ``generator`` (on the walkers' device);
the log-probability gets ``eval_generator`` (a host generator, from which
the forward model draws the seed words of its kernels).  Retained
log-probs are never re-evaluated (pseudo-marginal semantics, as emcee).
Bitwise equality with the JAX package's chains is not a goal.  Steps run
as a Python loop; nothing synchronises with the device inside it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import torch

from ..utils.profiling import span

LogpBatch = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


class EnsembleState(NamedTuple):
    """Sampler state: walkers, their log-probs, both generators and the
    global step counter."""

    positions: torch.Tensor          # (W, D)
    log_probs: torch.Tensor          # (W,)
    generator: torch.Generator       # moves, on the walkers' device
    eval_generator: torch.Generator  # log-prob estimator seeds, host
    step: int


@dataclasses.dataclass
class Chain:
    """A sampled chain segment and the state to resume from."""

    positions: torch.Tensor      # (S, W, D)
    log_probs: torch.Tensor      # (S, W)
    n_accepted: torch.Tensor     # (W,) accepted moves in this segment
    state: EnsembleState

    @property
    def acceptance_fraction(self) -> torch.Tensor:
        return self.n_accepted / self.positions.shape[0]


def init_state(p0: torch.Tensor, logp_batch: LogpBatch, *,
               generator: torch.Generator,
               eval_generator: torch.Generator) -> EnsembleState:
    """Evaluate the initial log-probs, with the pseudo-marginal refresh
    guard: a walker whose first estimate is non-finite is re-estimated
    (position unchanged) up to 8 times, stopping early once a round fixes
    nothing (walkers outside the prior box stay -inf, as they should)."""
    p0 = p0.to(torch.float32)
    n_walkers = p0.shape[0]
    if n_walkers % 2:
        raise ValueError(
            f"n_walkers must be even for the red-black stretch move, "
            f"got {n_walkers}")
    lp0 = logp_batch(p0, eval_generator)
    tries, improved = 0, True
    while tries < 8 and improved and not bool(torch.isfinite(lp0).all()):
        lp_new = logp_batch(p0, eval_generator)
        finite = torch.isfinite(lp0)
        improved = bool((torch.isfinite(lp_new) & ~finite).any())
        lp0 = torch.where(finite, lp0, lp_new)
        tries += 1
    return EnsembleState(p0, lp0, generator, eval_generator, 0)


def _halves(pos, lp, parity):
    return pos[parity::2], pos[1 - parity::2], lp[parity::2]


def _commit(pos, lp, parity, accept, proposal, lp_prop):
    """Write the accepted proposals of one half back in place."""
    active, lp_active = pos[parity::2], lp[parity::2]
    pos[parity::2] = torch.where(accept[:, None], proposal, active)
    lp[parity::2] = torch.where(accept, lp_prop, lp_active)
    return accept


def _half_update(pos, lp, parity, gen, eval_gen, logp_batch, a):
    """Stretch-move update of the even (parity 0) or odd walkers."""
    active, passive, lp_active = _halves(pos, lp, parity)
    n_half, n_dim = active.shape
    dev = pos.device
    u = torch.rand(n_half, generator=gen, device=dev)
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    j = torch.randint(0, n_half, (n_half,), generator=gen, device=dev)
    partners = passive[j]
    proposal = partners + z[:, None] * (active - partners)
    lp_prop = logp_batch(proposal, eval_gen)
    log_ratio = (n_dim - 1.0) * torch.log(z) + lp_prop - lp_active
    accept = torch.log(torch.rand(n_half, generator=gen, device=dev)) \
        < log_ratio
    return _commit(pos, lp, parity, accept, proposal, lp_prop)


def _half_update_de(pos, lp, parity, gen, eval_gen, logp_batch, gamma0,
                    de_sigma):
    """Differential-evolution update of one half (symmetric proposal, so
    the Metropolis ratio is the log-prob difference alone)."""
    active, passive, lp_active = _halves(pos, lp, parity)
    n_half = active.shape[0]
    if n_half < 2:
        raise ValueError("the DE move needs >= 4 walkers (two distinct "
                         "complementary-half partners per proposal)")
    dev = pos.device
    j1 = torch.randint(0, n_half, (n_half,), generator=gen, device=dev)
    # distinct second partner: uniform over the other n_half - 1 indices
    j2 = (j1 + 1 + torch.randint(0, n_half - 1, (n_half,), generator=gen,
                                 device=dev)) % n_half
    g = gamma0 * (1.0 + de_sigma * torch.randn(n_half, generator=gen,
                                                device=dev))
    proposal = active + g[:, None] * (passive[j1] - passive[j2])
    lp_prop = logp_batch(proposal, eval_gen)
    accept = torch.log(torch.rand(n_half, generator=gen, device=dev)) \
        < lp_prop - lp_active
    return _commit(pos, lp, parity, accept, proposal, lp_prop)


def make_step(logp_batch: LogpBatch, a: float = 2.0, *,
              move: str = "stretch", gamma0: Optional[float] = None,
              de_sigma: float = 1e-5):
    """One full ensemble step (both half-updates):
    ``step(state) -> (new_state, accepted (W,) bool)``.  The returned
    state's positions and log-probs are the input's, updated in place."""
    if move not in ("stretch", "de", "mixed"):
        raise ValueError(f"unknown move {move!r}")

    def step(state: EnsembleState):
        pos, lp, gen, eval_gen, step_idx = state
        n_dim = pos.shape[1]
        g0 = (2.38 / (2.0 * n_dim) ** 0.5) if gamma0 is None else gamma0
        use_de = move == "de" or (move == "mixed" and step_idx % 2 == 1)
        accepted = torch.empty(pos.shape[0], dtype=torch.bool,
                               device=pos.device)
        for parity in (0, 1):
            with span("mcmctof.half_update"):
                if use_de:
                    acc = _half_update_de(pos, lp, parity, gen, eval_gen,
                                          logp_batch, g0, de_sigma)
                else:
                    acc = _half_update(pos, lp, parity, gen, eval_gen,
                                       logp_batch, a)
                accepted[parity::2] = acc
        return EnsembleState(pos, lp, gen, eval_gen, step_idx + 1), accepted

    return step


def run_mcmc(state: EnsembleState, n_steps: int, logp_batch: LogpBatch, *,
             a: float = 2.0, move: str = "stretch",
             gamma0: Optional[float] = None, de_sigma: float = 1e-5
             ) -> Chain:
    """Advance the ensemble ``n_steps`` steps; ``state`` is not modified
    (the walkers are copied before the first step)."""
    step = make_step(logp_batch, a, move=move, gamma0=gamma0,
                     de_sigma=de_sigma)
    pos, lp = state.positions.clone(), state.log_probs.clone()
    state = state._replace(positions=pos, log_probs=lp)
    n_walkers, n_dim = pos.shape
    pos_hist = torch.empty((n_steps, n_walkers, n_dim), dtype=pos.dtype,
                           device=pos.device)
    lp_hist = torch.empty((n_steps, n_walkers), dtype=lp.dtype,
                          device=lp.device)
    n_accepted = torch.zeros(n_walkers, dtype=torch.int64, device=pos.device)
    for i in range(n_steps):
        with span("mcmctof.step"):
            state, accepted = step(state)
            pos_hist[i] = state.positions
            lp_hist[i] = state.log_probs
            n_accepted += accepted
    return Chain(pos_hist, lp_hist, n_accepted, state)


def sample(p0: torch.Tensor, n_steps: int, logp_batch: LogpBatch, *,
           generator: torch.Generator, eval_generator: torch.Generator,
           a: float = 2.0, move: str = "stretch",
           gamma0: Optional[float] = None) -> Chain:
    """One-call convenience API: init + run."""
    state = init_state(p0, logp_batch, generator=generator,
                       eval_generator=eval_generator)
    return run_mcmc(state, n_steps, logp_batch, a=a, move=move,
                    gamma0=gamma0)
