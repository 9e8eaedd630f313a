"""Parallel-tempering ensemble sampler (replica exchange).

Port of ``mcmctoffitting_tpu/sampler/pt.py``, the counterpart of
``emcee.PTSampler`` as the reference's analytic-vs-numeric study uses it
(20 temperatures x 100 walkers, ``tests/shiftingGaussian_brute.py:
349-360``).  The temperature ladder is one more leading tensor axis: the
walkers are (T, W, D), each half-update moves the even (then odd) walkers
of every rung at once, and the replica exchange swaps walkers between
adjacent rungs.

Tempered posterior at inverse temperature beta: logprior + beta * loglike.
Swap acceptance between adjacent rungs (i cold, j = i + 1 hot), with the
walkers of the hotter rung randomly permuted: ln U < (beta_i - beta_j) *
(loglike_j - loglike_i).  The sweep takes the pairs from the hottest to the
coldest, one after another: each pair sees the swaps of the hotter pairs
before it (a simultaneous sweep would change the chain's law).

The within-rung moves are the ensemble sampler's (``move=`` 'stretch' |
'de' | 'mixed'; ``sampler/stretch.py``), with the beta weighting in the
Metropolis ratio.  Each move is split into its draws and a deterministic
core that takes them (:func:`tempered_stretch_core`,
:func:`tempered_de_core`, :func:`replica_exchange_core`), so that the
cores can be fed any draws, the JAX package's included.

Randomness: the moves and the exchange draw from ``generator`` (on the
walkers' device); the log-likelihood gets ``eval_generator`` (a host
generator, from which a stochastic forward model draws its seeds), once
per half-update: one batched call evaluates the flattened (T x W/2, D)
proposals of every rung.  Retained log-likelihoods are never
re-evaluated, and swaps carry them (pseudo-marginal semantics, as emcee).
The chain stays on the device in preallocated (S, T, W, .) tensors, and
nothing synchronises with the device inside the step loop.  beta is
float32 on the device inside a step; the chain keeps its ladder as a
tuple of Python floats (float64), on which the thermodynamic integration
runs in numpy float64.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

# (N, D) thetas and the host generator -> (N,)
LogBatch = Callable[[torch.Tensor, torch.Generator], torch.Tensor]
# (T, W/2, D) proposals -> their (log-likelihoods, log-priors), (T, W/2)
Evaluate = Callable[[torch.Tensor], tuple]


def default_beta_ladder(n_temps: int, t_max: float | None = None) -> np.ndarray:
    """Geometric inverse-temperature ladder, beta_0 = 1 (cold chain).

    Default spacing 1/sqrt(2) per rung like emcee 2's PTSampler default;
    with ``t_max`` given, spaces geometrically down to 1/t_max.
    """
    if t_max is None:
        ratio = 2.0 ** 0.5
        return (1.0 / ratio) ** np.arange(n_temps)
    return np.geomspace(1.0, 1.0 / t_max, n_temps)


class PTState(NamedTuple):
    """Sampler state: walkers, their log-likelihoods and log-priors, both
    generators and the global step counter."""

    positions: torch.Tensor          # (T, W, D)
    log_like: torch.Tensor           # (T, W)
    log_prior: torch.Tensor          # (T, W)
    generator: torch.Generator       # moves and swaps, on the device
    eval_generator: torch.Generator  # log-likelihood seeds, host
    step: int


@dataclasses.dataclass
class PTChain:
    """A tempered chain: rows 0, thin, 2 thin, ... of the steps."""

    positions: torch.Tensor          # (S, T, W, D)
    log_like: torch.Tensor           # (S, T, W)
    log_prior: torch.Tensor          # (S, T, W)
    n_accepted: torch.Tensor         # (T, W) over ALL n_steps, not just kept
    n_swaps_accepted: torch.Tensor   # (T-1,)
    n_steps: int                     # steps sampled (before thinning)
    state: PTState
    # (T,) ladder the chain was sampled at, in float64: the TI integral
    # runs in float64, and a float32 copy would shift ln Z
    betas: tuple

    @property
    def acceptance_fraction(self) -> torch.Tensor:
        return self.n_accepted / self.n_steps

    @property
    def cold_chain(self) -> torch.Tensor:
        """(S, W, D) samples of the beta=1 target posterior."""
        return self.positions[:, 0]

    def thermodynamic_integration_log_evidence(self, betas=None, *,
                                               fburnin: float = 0.1):
        """(ln Z, error) for the ladder this chain was sampled at
        (``self.betas``: for ``sample_pt_adaptive`` chains the FINAL
        adapted ladder); ``betas`` overrides it."""
        if betas is None:
            betas = self.betas
        return thermodynamic_integration_log_evidence(
            self.log_like, betas, fburnin=fburnin)


def thermodynamic_integration_log_evidence(log_like, betas, *,
                                           fburnin: float = 0.1):
    """Log-evidence ln Z = ln p(data) by thermodynamic integration.

    ln Z(beta=1) - ln Z(beta=0) = integral_0^1 <ln L>_beta dbeta, with the
    per-rung posterior expectations <ln L>_beta estimated from the tempered
    chains (``emcee.PTSampler.thermodynamic_integration_log_evidence``):
    trapezoid rule over the (descending) ladder, constant extrapolation
    from the hottest rung to beta=0 when the ladder does not reach it, and
    an error estimate from re-integrating on every other rung, both
    endpoints kept.  All in numpy float64.

    Parameters
    ----------
    log_like : (S, T, W) tempered log-likelihood chain (``PTChain.log_like``,
        a tensor on any device, or an array)
    betas : (T,) inverse temperatures, descending, betas[0] == 1
    fburnin : fraction of the S axis discarded as burn-in

    Returns ``(ln_z, d_ln_z)``.
    """
    if isinstance(log_like, torch.Tensor):
        log_like = log_like.detach().cpu().double().numpy()
    ll = np.asarray(log_like, dtype=np.float64)
    betas = np.asarray(betas, dtype=np.float64)
    if ll.ndim != 3 or ll.shape[1] != betas.shape[0]:
        raise ValueError(f"log_like (S, T, W) with T == len(betas); got "
                         f"{ll.shape} vs {betas.shape}")
    if np.any(np.diff(betas) >= 0.0) or abs(betas[0] - 1.0) > 1e-6:
        raise ValueError("betas must be strictly decreasing from 1.0")
    start = int(fburnin * ll.shape[0])
    mean_logls = ll[start:].mean(axis=(0, 2))              # (T,)

    if betas[-1] != 0.0:
        betas = np.concatenate([betas, [0.0]])
        mean_logls = np.concatenate([mean_logls, mean_logls[-1:]])

    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2.0
    ln_z = -trapezoid(mean_logls, betas)
    # half-resolution ladder: every other rung with BOTH endpoints kept (a
    # bare betas[::2] drops the appended beta=0 on an odd rung count)
    idx = np.arange(0, betas.size, 2)
    if idx[-1] != betas.size - 1:
        idx = np.concatenate([idx, [betas.size - 1]])
    ln_z2 = -trapezoid(mean_logls[idx], betas[idx])
    return float(ln_z), float(abs(ln_z - ln_z2))


def _make_batched(fn: Callable, stochastic: bool) -> LogBatch:
    """A batched function of (N, D) thetas as the sampler calls it,
    ``(thetas, eval_generator)``: a stochastic ``fn`` takes the generator,
    a deterministic one does not."""
    if stochastic:
        return fn
    return lambda thetas, generator: fn(thetas)


def _evaluator(loglike_batch: LogBatch, logprior_batch: LogBatch,
               eval_generator: torch.Generator) -> Evaluate:
    """One call of each batched function on the flattened (T x n, D)
    walkers, reshaped back to (T, n) float32."""
    def evaluate(thetas):
        lead = thetas.shape[:-1]
        flat = thetas.reshape(-1, thetas.shape[-1])
        return tuple(fn(flat, eval_generator).reshape(lead).to(torch.float32)
                     for fn in (loglike_batch, logprior_batch))

    return evaluate


def init_pt_state(p0: torch.Tensor, loglike_batch: LogBatch,
                  logprior_batch: LogBatch, *, generator: torch.Generator,
                  eval_generator: torch.Generator) -> PTState:
    """p0: (T, W, D); the log-likelihoods and log-priors of every walker
    in one batched call each."""
    p0 = p0.to(torch.float32)
    if p0.dim() != 3 or p0.shape[1] % 2:
        raise ValueError(f"p0 must be (T, W, D) with W even (red-black "
                         f"half-updates), got {tuple(p0.shape)}")
    ll, lp = _evaluator(loglike_batch, logprior_batch, eval_generator)(p0)
    return PTState(p0, ll, lp, generator, eval_generator, 0)


def _gather_walkers(walkers, idx):
    """walkers (T, n, D), idx (T, m) -> (T, m, D)."""
    return torch.gather(walkers, 1,
                        idx[..., None].expand(-1, -1, walkers.shape[-1]))


def _commit(pos, ll, lp, parity, accept, prop, ll_new, lp_new):
    """Write the accepted proposals of one half back in place."""
    pos[:, parity::2] = torch.where(accept[..., None], prop,
                                    pos[:, parity::2])
    ll[:, parity::2] = torch.where(accept, ll_new, ll[:, parity::2])
    lp[:, parity::2] = torch.where(accept, lp_new, lp[:, parity::2])
    return accept


def tempered_stretch_core(pos, ll, lp, betas, parity, u, j, log_u,
                          evaluate: Evaluate, a: float = 2.0):
    """Stretch half-update of the even (parity 0) or odd walkers of every
    rung, from its draws: ``u`` (T, W/2) uniforms of the stretch factor
    z = ((a - 1) u + 1)^2 / a, ``j`` (T, W/2) partner indices into the
    other half, ``log_u`` (T, W/2) log-uniforms of the acceptance test.
    ``evaluate`` gives the proposals' (log-likelihoods, log-priors).
    Updates pos (T, W, D), ll, lp (T, W) in place; returns the accept mask
    (T, W/2)."""
    n_dim = pos.shape[-1]
    active, passive = pos[:, parity::2], pos[:, 1 - parity::2]
    z = ((a - 1.0) * u + 1.0) ** 2 / a
    partners = _gather_walkers(passive, j)
    prop = partners + z[..., None] * (active - partners)
    ll_new, lp_new = evaluate(prop)
    beta = betas[:, None]
    logpost_new = lp_new + beta * ll_new
    logpost_old = lp[:, parity::2] + beta * ll[:, parity::2]
    log_ratio = (n_dim - 1.0) * torch.log(z) + logpost_new - logpost_old
    return _commit(pos, ll, lp, parity, log_u < log_ratio, prop, ll_new,
                   lp_new)


def tempered_de_core(pos, ll, lp, betas, parity, g, j1, j2, log_u,
                     evaluate: Evaluate):
    """Differential-evolution half-update of every rung, from its draws:
    ``g`` (T, W/2) scale factors, ``j1``, ``j2`` (T, W/2) two distinct
    partner indices into the other half, ``log_u`` (T, W/2).  The proposal
    is symmetric, so the ratio is the tempered log-posterior difference.
    In place; returns the accept mask (T, W/2)."""
    active, passive = pos[:, parity::2], pos[:, 1 - parity::2]
    d = _gather_walkers(passive, j1) - _gather_walkers(passive, j2)
    prop = active + g[..., None] * d
    ll_new, lp_new = evaluate(prop)
    beta = betas[:, None]
    log_ratio = (lp_new + beta * ll_new - lp[:, parity::2]
                 - beta * ll[:, parity::2])
    return _commit(pos, ll, lp, parity, log_u < log_ratio, prop, ll_new,
                   lp_new)


def replica_exchange_core(pos, ll, lp, betas, perms, log_u):
    """One sweep of adjacent-rung swaps, from its draws: pair i (rungs i
    and i + 1) permutes the hotter rung's walkers by ``perms[i]`` (T-1, W)
    and accepts where ``log_u[i]`` < (beta_i - beta_{i+1}) (ll_hot -
    ll_i).  The pairs go from the hottest to the coldest, each after the
    one before.  Walker, log-likelihood and log-prior travel together (one
    packed (T, W, D + 2) tensor).  In place; returns the accept masks
    (T-1, W)."""
    n_temps, n_walkers, n_dim = pos.shape
    accepts = torch.empty((n_temps - 1, n_walkers), dtype=torch.bool,
                          device=pos.device)
    x = torch.cat([pos, ll[..., None], lp[..., None]], dim=-1)
    d_beta = betas[:-1] - betas[1:]
    for i in range(n_temps - 2, -1, -1):
        perm = perms[i]
        cold = x[i]
        hot = x[i + 1][perm]
        accept = log_u[i] < d_beta[i] * (hot[:, n_dim] - cold[:, n_dim])
        take = accept[:, None]
        # the hot rung receives the displaced cold walkers at the permuted
        # slots (computed before the cold rung is overwritten)
        x[i + 1].index_put_((perm,), torch.where(take, cold, hot))
        x[i] = torch.where(take, hot, cold)
        accepts[i] = accept
    pos.copy_(x[..., :n_dim])
    ll.copy_(x[..., n_dim])
    lp.copy_(x[..., n_dim + 1])
    return accepts


def _stretch_half(pos, ll, lp, betas, parity, gen, evaluate, a):
    """Draw the stretch move's numbers, then run its core."""
    n_temps, n_walkers, _ = pos.shape
    n_half, dev = n_walkers // 2, pos.device
    u = torch.rand((n_temps, n_half), generator=gen, device=dev)
    j = torch.randint(0, n_half, (n_temps, n_half), generator=gen,
                      device=dev)
    log_u = torch.log(torch.rand((n_temps, n_half), generator=gen,
                                 device=dev))
    return tempered_stretch_core(pos, ll, lp, betas, parity, u, j, log_u,
                                 evaluate, a)


def _de_half(pos, ll, lp, betas, parity, gen, evaluate, gamma0, de_sigma):
    """Draw the DE move's numbers, then run its core."""
    n_temps, n_walkers, _ = pos.shape
    n_half, dev = n_walkers // 2, pos.device
    if n_half < 2:
        raise ValueError("the DE move needs >= 4 walkers per rung")
    shape = (n_temps, n_half)
    j1 = torch.randint(0, n_half, shape, generator=gen, device=dev)
    # distinct second partner: uniform over the other n_half - 1 indices
    j2 = (j1 + 1 + torch.randint(0, n_half - 1, shape, generator=gen,
                                 device=dev)) % n_half
    g = gamma0 * (1.0 + de_sigma * torch.randn(shape, generator=gen,
                                                device=dev))
    log_u = torch.log(torch.rand(shape, generator=gen, device=dev))
    return tempered_de_core(pos, ll, lp, betas, parity, g, j1, j2, log_u,
                            evaluate)


def _exchange(pos, ll, lp, betas, gen):
    """Draw the sweep's permutations and uniforms, then run its core;
    returns the accepted swaps per pair (T-1,)."""
    n_temps, n_walkers, _ = pos.shape
    if n_temps < 2:
        return torch.zeros(0, dtype=torch.int64, device=pos.device)
    perms = torch.stack([torch.randperm(n_walkers, generator=gen,
                                        device=pos.device)
                         for _ in range(n_temps - 1)])
    log_u = torch.log(torch.rand((n_temps - 1, n_walkers), generator=gen,
                                 device=pos.device))
    return replica_exchange_core(pos, ll, lp, betas, perms, log_u).sum(1)


def make_pt_step(loglike_batch: LogBatch, logprior_batch: LogBatch, betas,
                 a: float = 2.0, *, move: str = "stretch",
                 gamma0: Optional[float] = None, de_sigma: float = 1e-5):
    """One tempered step (both half-updates, then the exchange sweep):
    ``step(state) -> (new_state, accepted (T, W) bool, swaps (T-1,))``.
    The returned state's tensors are the input's, updated in place.
    ``betas`` may be an array (copied to the walkers' device as float32
    once) or a float32 tensor there (the adaptive ladder's)."""
    if move not in ("stretch", "de", "mixed"):
        raise ValueError(f"unknown move {move!r}")
    on_device = {}

    def device_betas(dev):
        if isinstance(betas, torch.Tensor):
            return betas
        if dev not in on_device:
            on_device[dev] = torch.as_tensor(
                np.asarray(betas, np.float32), device=dev)
        return on_device[dev]

    def step(state: PTState):
        pos, ll, lp, gen, eval_gen, step_idx = state
        b = device_betas(pos.device)
        n_dim = pos.shape[-1]
        g0 = (2.38 / (2.0 * n_dim) ** 0.5) if gamma0 is None else gamma0
        evaluate = _evaluator(loglike_batch, logprior_batch, eval_gen)
        use_de = move == "de" or (move == "mixed" and step_idx % 2 == 1)
        accepted = torch.empty(pos.shape[:2], dtype=torch.bool,
                               device=pos.device)
        for parity in (0, 1):
            if use_de:
                acc = _de_half(pos, ll, lp, b, parity, gen, evaluate, g0,
                               de_sigma)
            else:
                acc = _stretch_half(pos, ll, lp, b, parity, gen, evaluate,
                                    a)
            accepted[:, parity::2] = acc
        swaps = _exchange(pos, ll, lp, b, gen)
        return (PTState(pos, ll, lp, gen, eval_gen, step_idx + 1),
                accepted, swaps)

    return step


def _run(state: PTState, n_steps: int, step, thin: int, record=None):
    """Advance ``n_steps`` steps from a copy of ``state``, keeping rows 0,
    thin, 2 thin, ... in preallocated device tensors; ``record(k)`` is
    called after row k is kept."""
    if thin < 1:
        raise ValueError(f"thin must be >= 1, got {thin}")
    pos, ll, lp = (state.positions.clone(), state.log_like.clone(),
                   state.log_prior.clone())
    state = state._replace(positions=pos, log_like=ll, log_prior=lp)
    n_temps, n_walkers, n_dim = pos.shape
    n_rows = -(-n_steps // thin)
    dev = pos.device
    pos_hist = torch.empty((n_rows, n_temps, n_walkers, n_dim),
                           dtype=pos.dtype, device=dev)
    ll_hist = torch.empty((n_rows, n_temps, n_walkers), dtype=ll.dtype,
                          device=dev)
    lp_hist = torch.empty_like(ll_hist)
    n_accepted = torch.zeros((n_temps, n_walkers), dtype=torch.int64,
                             device=dev)
    n_swaps = torch.zeros(max(n_temps - 1, 0), dtype=torch.int64,
                          device=dev)
    for i in range(n_steps):
        state, accepted, swaps = step(state)
        n_accepted += accepted
        n_swaps += swaps
        if i % thin == 0:
            k = i // thin
            pos_hist[k] = state.positions
            ll_hist[k] = state.log_like
            lp_hist[k] = state.log_prior
            if record is not None:
                record(k)
    return pos_hist, ll_hist, lp_hist, n_accepted, n_swaps, state


def _tempered_p0(p0, n_temps):
    p0 = p0.to(torch.float32)
    if p0.dim() == 2:
        if n_temps is None:
            raise ValueError("give p0 as (T, W, D) or pass n_temps")
        p0 = p0.expand((n_temps,) + tuple(p0.shape)).contiguous()
    return p0


def run_pt(state: PTState, n_steps: int, loglike_batch: LogBatch,
           logprior_batch: LogBatch, betas, *, a: float = 2.0,
           thin: int = 1, move: str = "stretch") -> PTChain:
    """Advance a tempered ensemble ``n_steps`` steps from ``state`` (which
    is not modified: the walkers are copied first), keeping every
    ``thin``-th step; the retained log-likelihoods go on as they are."""
    step = make_pt_step(loglike_batch, logprior_batch, betas, a, move=move)
    pos, ll, lp, acc, swaps, final = _run(state, n_steps, step, thin)
    return PTChain(pos, ll, lp, acc, swaps, n_steps, final,
                   tuple(float(b) for b in np.asarray(betas, np.float64)))


def sample_pt(p0: torch.Tensor, n_steps: int, loglike_fn, logprior_fn, *,
              generator: torch.Generator, eval_generator: torch.Generator,
              betas=None, n_temps: Optional[int] = None, a: float = 2.0,
              stochastic: bool = False, thin: int = 1,
              move: str = "stretch",
              loglike_batch: Optional[LogBatch] = None,
              logprior_batch: Optional[LogBatch] = None) -> PTChain:
    """PTSampler equivalent: p0 (T, W, D), or (W, D) with n_temps given,
    on the device the chain runs on.

    ``loglike_fn``/``logprior_fn`` are batched functions of (N, D) thetas
    (and, with ``stochastic``, of the host generator as well).
    ``loglike_batch``/``logprior_batch`` override them with caller-built
    evaluators ``(thetas (N, D), eval_generator) -> (N,)``: the hook that
    shards the walker axis over several devices while the tempered move
    bookkeeping stays in one place.
    """
    p0 = _tempered_p0(p0, n_temps)
    if betas is None:
        betas = default_beta_ladder(p0.shape[0])
    if loglike_batch is None:
        loglike_batch = _make_batched(loglike_fn, stochastic)
    if logprior_batch is None:
        logprior_batch = _make_batched(logprior_fn, stochastic)
    state = init_pt_state(p0, loglike_batch, logprior_batch,
                          generator=generator, eval_generator=eval_generator)
    return run_pt(state, n_steps, loglike_batch, logprior_batch, betas, a=a,
                  thin=thin, move=move)


def sample_pt_adaptive(p0: torch.Tensor, n_steps: int, loglike_fn,
                       logprior_fn, *, generator: torch.Generator,
                       eval_generator: torch.Generator, betas=None,
                       n_temps: Optional[int] = None, a: float = 2.0,
                       stochastic: bool = False, thin: int = 1,
                       adapt_t0: float = 100.0, adapt_nu: float = 10.0):
    """PT with on-the-fly temperature-ladder adaptation (Vousden, Farr &
    Mandel 2016 scheme), stretch moves.

    The log temperature gaps S_i = log(1/beta_{i+1} - 1/beta_i) evolve as
    dS_i = eta(t) (A_i - A_{i+1}) with the step's pair swap-acceptance
    fractions A_i and the decaying rate eta(t) = t0 / (nu (t + t0)):
    interior pair acceptances equalize and the adaptation freezes as t
    grows.  beta_0 = 1 and the TOTAL 1/beta span are held fixed (the gaps
    renormalize each step), so the caller chooses the temperature range
    and the adaptation redistributes the interior spacing.  The ladder
    lives on the device in float32, as the JAX package's does.

    Returns (PTChain, betas_final (T,), betas_history (S, T)).
    """
    p0 = _tempered_p0(p0, n_temps)
    n_t, n_walkers = p0.shape[0], p0.shape[1]
    if betas is None:
        betas = default_beta_ladder(n_t)
    b32 = np.asarray(betas, np.float32)
    if n_t < 3:
        raise ValueError("ladder adaptation needs >= 3 temperatures")
    if abs(float(b32[0]) - 1.0) > 1e-6:
        # the adapted ladder is parameterized by log-gaps above a cold
        # chain pinned at beta=1; a non-cold-anchored ladder would sample
        # a different target than requested
        raise ValueError("sample_pt_adaptive requires betas[0] == 1.0 "
                         "(cold-anchored ladder); use sample_pt for "
                         "arbitrary fixed ladders")
    if not np.all(np.diff(b32) < 0.0):
        # log(diff(1/betas)) of a non-decreasing ladder is NaN
        raise ValueError("sample_pt_adaptive requires strictly decreasing "
                         "betas (hottest last)")

    loglike_batch = _make_batched(loglike_fn, stochastic)
    logprior_batch = _make_batched(logprior_fn, stochastic)
    state = init_pt_state(p0, loglike_batch, logprior_batch,
                          generator=generator, eval_generator=eval_generator)
    dev = p0.device
    log_gaps = torch.log(torch.diff(1.0 / torch.as_tensor(b32, device=dev)))
    span0 = torch.sum(torch.exp(log_gaps))             # 1/beta_top - 1
    one = torch.ones(1, device=dev)

    def betas_of(gaps):
        return 1.0 / torch.cat([one, 1.0 + torch.cumsum(torch.exp(gaps), 0)])

    ladder = betas_of(log_gaps)      # the current ladder, updated in place
    step = make_pt_step(loglike_batch, logprior_batch, ladder, a)
    n_rows = -(-n_steps // thin)
    b_hist = torch.empty((n_rows, n_t), dtype=torch.float32, device=dev)

    def adapt_step(st: PTState):
        st, accepted, swaps = step(st)
        # equalize adjacent pair acceptances, then renormalize so that the
        # total 1/beta span (the caller's temperature range) is kept
        pair_acc = swaps.to(torch.float32) / n_walkers
        eta = adapt_t0 / (adapt_nu * (float(st.step - 1) + adapt_t0))
        log_gaps[:-1] += eta * (pair_acc[:-1] - pair_acc[1:])
        log_gaps.add_(torch.log(span0 / torch.sum(torch.exp(log_gaps))))
        ladder.copy_(betas_of(log_gaps))
        return st, accepted, swaps

    def record(k):
        b_hist[k] = ladder

    pos, ll, lp, acc, swaps, final = _run(state, n_steps, adapt_step, thin,
                                          record)
    chain = PTChain(pos, ll, lp, acc, swaps, n_steps, final,
                    tuple(float(b) for b in
                          ladder.double().cpu().numpy()))
    return chain, ladder, b_hist
