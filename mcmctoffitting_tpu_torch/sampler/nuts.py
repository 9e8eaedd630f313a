"""No-U-Turn Sampler (NUTS), batch-native.

Port of ``mcmctoffitting_tpu/sampler/nuts.py``: multinomial NUTS with
biased progressive sampling (Betancourt, "A conceptual introduction to
HMC") and the momentum-sum U-turn criterion, iterative formulation:

* the doubling loop runs while depth < ``max_depth``;
* each doubling builds a subtree of 2^depth leaves, stopping a chain's
  subtree early on divergence (leaf energy error below -1000) or an
  internal U-turn;
* the U-turn checks on every balanced (dyadic) sub-subtree are replayed
  iteratively from the subtree's leaf momenta and their prefix sums: at
  leaf ``i`` every dyadic interval that ends at ``i`` (one per trailing
  1-bit of ``i``) is checked with the interval's momentum sum against its
  endpoint velocities;
* a divergence or an internal U-turn discards the whole new subtree.

The JAX package runs one chain per ``vmap`` lane of nested while loops;
here all chains advance together.  Every chain still in the transition
takes its doubling at the same depth, so the loops are Python loops over
the depth and the leaf index, and each leaf is ONE batched
log-prob-and-gradient call for the chains whose subtree is still alive;
finished chains are masked, as the vmapped loops mask them.  Draws come
from ``generator`` on the chains' device.  Warm-up: Stan-style windows
with a diagonal metric (mass adaptation only when ``n_warmup >= 60``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ._adapt import LogpAndGrad, dual_averaging_warmup

_DIVERGENCE_THRESHOLD = 1000.0


@dataclasses.dataclass
class NUTSChain:
    positions: torch.Tensor     # (S, C, D)
    log_probs: torch.Tensor     # (S, C)
    accept_stat: torch.Tensor   # (S, C) mean leaf acceptance statistic
    tree_depth: torch.Tensor    # (S, C) doublings performed
    diverging: torch.Tensor     # (S, C) bool
    step_size: float
    inv_mass: torch.Tensor = None   # (D,) adapted diagonal inverse mass
    n_grad_evals: int = 0       # batched log-prob-and-gradient calls
    n_chain_grads: int = 0      # chains evaluated over those calls


class _Subtree(NamedTuple):
    z: torch.Tensor          # far endpoint (C, D), momentum, gradient
    r: torch.Tensor
    g: torch.Tensor
    zp: torch.Tensor         # the subtree's multinomial proposal
    lpp: torch.Tensor
    gp: torch.Tensor
    lsw: torch.Tensor        # log of the subtree's summed leaf weights
    rho: torch.Tensor        # momentum sum of the subtree
    turning: torch.Tensor
    diverging: torch.Tensor
    sum_alpha: torch.Tensor
    n_alpha: torch.Tensor


def _dot(a, inv_mass, b):
    return torch.sum(a * (inv_mass * b), dim=-1)


def _build_subtree(logp_grad, z, r, g, eps, n_leaf: int, live, h0,
                   inv_mass, max_depth: int, generator) -> _Subtree:
    """Integrate ``n_leaf`` leapfrog leaves from (z, r, g) with per-chain
    steps ``eps`` (C,), for the chains in ``live`` (C,) bool.  A chain's
    subtree ends early once it diverges or turns; each leaf evaluates the
    chains still building theirs."""
    n_chains, n_dim = z.shape
    dev = z.device
    r_buf = torch.zeros((n_chains, n_leaf, n_dim), device=dev)
    rho_pre = torch.zeros((n_chains, n_leaf + 1, n_dim), device=dev)
    lsw = torch.full((n_chains,), -torch.inf, device=dev)
    zp, lpp, gp = z, torch.full((n_chains,), -torch.inf, device=dev), g
    turning = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_alpha = torch.zeros(n_chains, device=dev)
    n_alpha = torch.zeros(n_chains, device=dev)
    alive = live
    half = (0.5 * eps)[:, None]
    for i in range(n_leaf):
        rows = torch.nonzero(alive).squeeze(1)
        if rows.numel() == 0:
            break
        r1 = r + half * g
        z1 = z + eps[:, None] * (inv_mass * r1)
        if rows.numel() == n_chains:
            lp1, g1 = logp_grad(z1)
        else:
            lp_part, g_part = logp_grad(z1[rows])
            lp1 = torch.full((n_chains,), -torch.inf, device=dev)
            g1 = torch.zeros_like(z1)
            lp1[rows] = lp_part
            g1[rows] = g_part
        r1 = r1 + half * g1
        lw = (lp1 - 0.5 * _dot(r1, inv_mass, r1)) - h0
        lw = torch.where(torch.isnan(lw), -torch.inf, lw)
        diverged = lw < -_DIVERGENCE_THRESHOLD

        # progressive multinomial sampling within the subtree
        u = torch.log(torch.rand(n_chains, generator=generator, device=dev))
        new_lsw = torch.logaddexp(lsw, lw)
        take = alive & (u < lw - new_lsw)
        zp = torch.where(take[:, None], z1, zp)
        lpp = torch.where(take, lp1, lpp)
        gp = torch.where(take[:, None], g1, gp)

        a2 = alive[:, None]
        r_buf[:, i] = torch.where(a2, r1, r_buf[:, i])
        rho_pre[:, i + 1] = torch.where(a2, rho_pre[:, i] + r1,
                                        rho_pre[:, i + 1])
        # U-turn checks of every dyadic interval that ends at leaf i: size
        # 2^k applies iff the low k bits of i are all 1
        turn = torch.zeros_like(turning)
        for k in range(1, max_depth):
            size = 1 << k
            if (i & (size - 1)) != size - 1:
                continue
            s = i - size + 1
            rho_int = rho_pre[:, i + 1] - rho_pre[:, s]
            turn = turn | ((_dot(rho_int, inv_mass, r_buf[:, s]) < 0)
                           | (_dot(rho_int, inv_mass, r1) < 0))

        z = torch.where(a2, z1, z)
        r = torch.where(a2, r1, r)
        g = torch.where(a2, g1, g)
        lsw = torch.where(alive, new_lsw, lsw)
        turning = turning | (alive & turn)
        diverging = diverging | (alive & diverged)
        sum_alpha = torch.where(alive, sum_alpha + torch.clamp_max(
            torch.exp(lw), 1.0), sum_alpha)
        n_alpha = torch.where(alive, n_alpha + 1.0, n_alpha)
        alive = alive & ~(turning | diverging)
    # the momentum sum of a valid (complete) subtree; an invalid one is
    # discarded by the caller
    return _Subtree(z, r, g, zp, lpp, gp, lsw, rho_pre[:, n_leaf], turning,
                    diverging, sum_alpha, n_alpha)


def _transition(logp_grad, z, lp, grad, step_size, max_depth: int,
                inv_mass, generator):
    """One NUTS transition of every chain: (z (C, D), lp (C,), grad) ->
    (z, lp, grad, accept_stat, depth, diverged).

    ``inv_mass`` (D,) is the diagonal inverse mass matrix.  Momenta are
    drawn r ~ N(0, M); the kinetic energy is r^T M^-1 r / 2, the leapfrog
    position update uses the velocity M^-1 r, and the U-turn criterion
    compares momentum sums against velocities (Stan's Euclidean-metric
    generalisation)."""
    n_chains, n_dim = z.shape
    dev = z.device
    r0 = torch.rsqrt(inv_mass) * torch.randn((n_chains, n_dim),
                                             generator=generator, device=dev)
    h0 = lp - 0.5 * _dot(r0, inv_mass, r0)

    z_minus = z_plus = z_prop = z
    r_minus = r_plus = r0
    g_minus = g_plus = g_prop = grad
    lp_prop = lp
    log_sum_w = torch.zeros(n_chains, device=dev)   # root weight exp(0)
    rho = r0
    depth = torch.zeros(n_chains, dtype=torch.int32, device=dev)
    turning = torch.zeros(n_chains, dtype=torch.bool, device=dev)
    diverging = torch.zeros_like(turning)
    sum_alpha = torch.zeros(n_chains, device=dev)
    n_alpha = torch.zeros(n_chains, device=dev)

    for d in range(max_depth):
        active = ~(turning | diverging)      # every active chain is at d
        if not bool(torch.any(active)):
            break
        go_right = torch.rand(n_chains, generator=generator, device=dev) < 0.5
        u_take = torch.rand(n_chains, generator=generator, device=dev)
        eps = torch.where(go_right, step_size, -step_size)
        right = go_right[:, None]
        sub = _build_subtree(
            logp_grad, torch.where(right, z_plus, z_minus),
            torch.where(right, r_plus, r_minus),
            torch.where(right, g_plus, g_minus), eps, 1 << d, active, h0,
            inv_mass, max_depth, generator)
        sub_ok = active & ~(sub.turning | sub.diverging)

        # biased progressive sampling across the doubling
        take = sub_ok & (torch.log(u_take) < sub.lsw - log_sum_w)
        z_prop = torch.where(take[:, None], sub.zp, z_prop)
        lp_prop = torch.where(take, sub.lpp, lp_prop)
        g_prop = torch.where(take[:, None], sub.gp, g_prop)

        # merge the ends and the tree statistics of valid subtrees
        plus = (sub_ok & go_right)[:, None]
        minus = (sub_ok & ~go_right)[:, None]
        z_plus = torch.where(plus, sub.z, z_plus)
        r_plus = torch.where(plus, sub.r, r_plus)
        g_plus = torch.where(plus, sub.g, g_plus)
        z_minus = torch.where(minus, sub.z, z_minus)
        r_minus = torch.where(minus, sub.r, r_minus)
        g_minus = torch.where(minus, sub.g, g_minus)
        rho = torch.where(sub_ok[:, None], rho + sub.rho, rho)
        log_sum_w = torch.where(sub_ok, torch.logaddexp(log_sum_w, sub.lsw),
                                log_sum_w)

        turning_top = ((_dot(rho, inv_mass, r_minus) < 0)
                       | (_dot(rho, inv_mass, r_plus) < 0))
        # an invalid subtree ends the transition as a U-turn does
        turning = torch.where(active, (sub_ok & turning_top) | sub.turning,
                              turning)
        diverging = diverging | (active & sub.diverging)
        sum_alpha = sum_alpha + torch.where(active, sub.sum_alpha, 0.0)
        n_alpha = n_alpha + torch.where(active, sub.n_alpha, 0.0)
        depth = depth + active.to(torch.int32)
    accept_stat = sum_alpha / torch.clamp_min(n_alpha, 1.0)
    return z_prop, lp_prop, g_prop, accept_stat, depth, diverging


def nuts_sample(generator: torch.Generator, p0, n_steps: int,
                log_prob_fn: Callable, *, n_warmup: int = 300,
                max_depth: int = 8, init_step_size: float = 0.1,
                target_accept: float = 0.8,
                adapt_mass: bool = True) -> NUTSChain:
    """Run C parallel NUTS chains from ``p0`` (C, D); ``log_prob_fn``
    (C, D) -> (C,) is differentiated by autograd.

    Warm-up (Stan-style windows): (1) dual-averaging step-size adaptation
    under the identity metric for half the budget, (2) a collection window
    (a quarter) estimating the per-dimension posterior variance within
    chains, (3) a second dual-averaging run under the adapted diagonal
    metric.  Sampling keeps both fixed.  ``adapt_mass=False``, or fewer
    than 60 warm-up steps, keeps the identity metric and one window.
    """
    dev = generator.device
    p0 = torch.as_tensor(p0, dtype=torch.float32, device=dev)
    n_chains, n_dim = p0.shape
    logp_grad = LogpAndGrad(log_prob_fn)
    lp0, g0 = logp_grad(p0)

    def one_step(state, eps, inv_mass):
        z, lp, g = state
        return _transition(logp_grad, z, lp, g, eps, max_depth, inv_mass,
                           generator)

    def warm_step(inv_mass):
        def step(state, eps):
            z, lp, g, alpha, _, _ = one_step(state, eps, inv_mass)
            return (z, lp, g), alpha
        return step

    inv_mass = torch.ones(n_dim, device=dev)
    state = (p0, lp0, g0)
    if adapt_mass and n_warmup >= 60:
        # windows clamp to the requested budget (~50% / 25% / 25%)
        n_w1 = n_warmup // 2
        n_collect = n_warmup // 4
        n_w2 = n_warmup - n_w1 - n_collect
        state, eps1 = dual_averaging_warmup(
            state, warm_step(inv_mass), n_w1, init_step_size, target_accept,
            device=dev)
        zs = []
        for _ in range(n_collect):
            z, lp, g, _, _, _ = one_step(state, eps1, inv_mass)
            state = (z, lp, g)
            zs.append(z)
        # within-chain variance averaged over chains (a pooled variance
        # would carry the between-chain spread of an unmixed ensemble)
        var = torch.mean(torch.var(torch.stack(zs), dim=0, unbiased=False),
                         dim=0)
        # Stan's regularisation towards unit scale
        inv_mass = (var * n_collect / (n_collect + 5.0)
                    + 1e-3 * 5.0 / (n_collect + 5.0))
        state, eps = dual_averaging_warmup(
            state, warm_step(inv_mass), n_w2, float(eps1), target_accept,
            device=dev)
    else:
        if adapt_mass and n_warmup > 0:
            print("nuts_sample: n_warmup < 60 — skipping mass adaptation "
                  "(identity metric)")
        state, eps = dual_averaging_warmup(
            state, warm_step(inv_mass), n_warmup, init_step_size,
            target_accept, device=dev)
    step_size = float(eps)
    eps = torch.tensor(step_size, dtype=torch.float32, device=dev)

    out = []
    for _ in range(n_steps):
        z, lp, g, alpha, depth, div = one_step(state, eps, inv_mass)
        state = (z, lp, g)
        out.append((z, lp, alpha, depth, div))
    if out:
        zs, lps, alphas, depths, divs = (torch.stack(x) for x in zip(*out))
    else:
        zs = torch.zeros((0, n_chains, n_dim), device=dev)
        lps = alphas = torch.zeros((0, n_chains), device=dev)
        depths = torch.zeros((0, n_chains), dtype=torch.int32, device=dev)
        divs = torch.zeros((0, n_chains), dtype=torch.bool, device=dev)
    return NUTSChain(zs, lps, alphas, depths, divs, step_size, inv_mass,
                     logp_grad.calls, logp_grad.chain_evals)
