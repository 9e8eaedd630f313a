"""CLI driver: shifting-Gaussian analytic study + parallel tempering, on
the GPU.

Port of ``mcmctoffitting_tpu/cli/shifting_gaussian.py``: the same flags,
defaults, printed lines and files.  A rebuild of ``python
tests/shiftingGaussian_brute.py``: synthesize y ~ N(m x + b, sigma) with x
marginalized over [0, 10] (truth sigma=0.4, m=-0.3, b=5;
``tests/shiftingGaussian_brute.py:150-160``), then

1. plain ensemble fit with the numeric projected-pdf likelihood
   (100 walkers x 500 steps, ``:295-304``), acceptance-fraction
   diagnostics (``:329-334``);
2. the PTSampler configuration: 20 temperatures x 100 walkers,
   1000 burn-in + 10000 main steps thinned by 10 (``:349-360``),
   reporting the cold (beta=1) chain, per-rung swap acceptance, and the
   thermodynamic-integration log-evidence ln Z.

``-model tof`` instead runs PT on a REDUCED TOF POSTERIOR (simultFit,
2 runs at 50k draws, corrected likelihood, counts forward): the
beamE-eLoss direction is a long degeneracy ridge, which the hot rungs
traverse and replica exchange carries to the cold chain.  Each tempered
half-update evaluates the T x W/2 walkers' proposals of every rung in one
batched call (one K1 and one K2 launch); retained log-likelihoods are never
re-evaluated, and swaps carry them.

Besides the JAX CLI's lines, one JSON line gives the rates: PT
walker-steps/s (steps x temperatures x walkers over the PT phase's wall
clock, its initial evaluation and the chain's copy to the host included)
and the ensemble's.  ``-device cpu`` runs the kernels' plain PyTorch
versions.

Run: ``python -m mcmctoffitting_tpu_torch.cli.shifting_gaussian --debug``
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

TRUTH = (0.4, -0.3, 5.0)   # sigma, m, b (tests/shiftingGaussian_brute.py)
# -seed streams of this CLI (cli._driver.seeded_generator)
(STREAM_DATA, STREAM_WALKERS, STREAM_MOVES, STREAM_EVAL, STREAM_PT_WALKERS,
 STREAM_PT_MOVES, STREAM_PT_EVAL) = (99, 1, 2, 4, 5, 6, 7)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-model", choices=["analytic", "tof"],
                   default="analytic")
    p.add_argument("-nSamples", default=500, type=int,
                   help="observed y draws (reference :157)")
    p.add_argument("-nWalkers", default=100, type=int)
    p.add_argument("-nSteps", default=500, type=int)
    p.add_argument("-nTemps", default=20, type=int)
    p.add_argument("-ptWalkers", default=100, type=int)
    p.add_argument("-ptBurnin", default=1000, type=int)
    p.add_argument("-ptSteps", default=10_000, type=int)
    p.add_argument("-thin", default=10, type=int)
    p.add_argument("-skipEnsemble", action="store_true")
    p.add_argument("-move", choices=["stretch", "de", "mixed"],
                   default="stretch",
                   help="proposal family for BOTH the ensemble and the "
                        "PT rungs (stretch = reference-faithful)")
    p.add_argument("-seed", default=0, type=int)
    p.add_argument("--debug", action="store_true",
                   help="shrink every phase for a fast smoke run")
    p.add_argument("-outputPrefix", default="sg_", type=str)
    p.add_argument("-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the fits run: the GPU (default; without one "
                        "the CLI stops with an error) or the CPU, which "
                        "runs the kernels' plain PyTorch versions")
    return p


def run_tempered(p0, burnin: int, steps: int, thin: int, loglike_batch,
                 logprior_batch, *, seed: int, move: str):
    """Initial evaluation, ``burnin`` steps, then ``steps`` kept every
    ``thin``-th on the default ladder, the chain copied to the host:
    returns (initial state, main PTChain, wall-clock seconds)."""
    from ..sampler import pt
    from ._driver import seeded_generator

    t0 = time.perf_counter()
    state = pt.init_pt_state(
        p0, loglike_batch, logprior_batch,
        generator=seeded_generator(seed, STREAM_PT_MOVES, p0.device),
        eval_generator=seeded_generator(seed, STREAM_PT_EVAL))
    betas = pt.default_beta_ladder(p0.shape[0])
    burn = pt.run_pt(state, burnin, loglike_batch, logprior_batch, betas,
                     move=move)
    chain = pt.run_pt(burn.state, steps, loglike_batch, logprior_batch,
                      betas, thin=thin, move=move)
    # the copy to the host waits for the device
    chain.positions, chain.log_like, chain.log_prior = (
        chain.positions.cpu(), chain.log_like.cpu(), chain.log_prior.cpu())
    chain.n_swaps_accepted = chain.n_swaps_accepted.cpu()
    return state, chain, time.perf_counter() - t0


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from ..models.forward import resolve_device

    device = resolve_device(args.device)
    if args.debug:
        args.nSteps, args.nTemps, args.ptWalkers = 60, 4, 32
        args.ptBurnin, args.ptSteps, args.thin = 40, 80, 2
        args.nWalkers = 32

    if args.model == "tof":
        return _run_tof_pt(args, device)

    from ..models import shifting_gaussian as sg
    from ..sampler import stretch
    from ..utils import chain_io
    from ._driver import seeded_generator

    data = sg.generate_data(seeded_generator(args.seed, STREAM_DATA, device),
                            args.nSamples, *TRUTH)
    print(f"synthesized {args.nSamples} observations at truth "
          f"sigma={TRUTH[0]}, m={TRUTH[1]}, b={TRUTH[2]}")
    truth = torch.as_tensor(TRUTH, dtype=torch.float32, device=device)
    result = {}
    names = ["sigma", "m", "b"]
    if not args.skipEnsemble:
        logp = sg.make_log_prob_fn(data, numeric=True)
        p0 = truth + 1e-4 * torch.randn(
            (args.nWalkers, 3),
            generator=seeded_generator(args.seed, STREAM_WALKERS, device),
            device=device)
        t0 = time.perf_counter()
        chain = stretch.sample(
            p0, args.nSteps, logp,
            generator=seeded_generator(args.seed, STREAM_MOVES, device),
            eval_generator=seeded_generator(args.seed, STREAM_EVAL),
            move=args.move)
        positions = chain.positions.cpu().numpy()
        result["ensemble_walker_steps_per_sec"] = (
            args.nSteps * args.nWalkers / (time.perf_counter() - t0))
        acc = chain.acceptance_fraction.cpu().numpy()
        keep = args.nSteps * 2 // 5
        flat = positions[keep:].reshape(-1, 3)
        q = np.percentile(flat, [16, 50, 84], axis=0)
        print(f"ensemble: acceptance mean {acc.mean():.3f} "
              f"(min {acc.min():.3f}, max {acc.max():.3f})")
        for d, n in enumerate(names):
            print(f"  {n} = {q[1, d]:.4g} +{q[2, d] - q[1, d]:.3g} "
                  f"-{q[1, d] - q[0, d]:.3g} (truth {TRUTH[d]})")
        chain_io.append_chain_text(
            args.outputPrefix + "chain.dat", positions,
            chain.log_probs.cpu().numpy(), mode="w")
        result["ensemble"] = {n: float(q[1, d])
                              for d, n in enumerate(names)}

    # --- parallel tempering (PTSampler configuration, :349-360)
    loglike, logprior, p0 = analytic_pt_setup(data, args.seed, args.nTemps,
                                              args.ptWalkers, device)
    _, main_chain, seconds = run_tempered(
        p0, args.ptBurnin, args.ptSteps, args.thin, loglike, logprior,
        seed=args.seed, move=args.move)
    result["pt_walker_steps_per_sec"] = (
        (args.ptBurnin + args.ptSteps) * args.nTemps * args.ptWalkers
        / seconds)
    cold_s = main_chain.cold_chain.numpy()
    cold = cold_s.reshape(-1, 3)
    q = np.percentile(cold, [16, 50, 84], axis=0)
    swaps = main_chain.n_swaps_accepted.numpy() / args.ptSteps \
        / args.ptWalkers
    # the model-comparison payoff of tempered sampling, the method of emcee
    # 2's PTSampler; the chain carries the ladder it was sampled at
    ln_z, d_ln_z = main_chain.thermodynamic_integration_log_evidence()
    print(f"PT ({args.nTemps} temps x {args.ptWalkers} walkers, "
          f"{args.ptBurnin}+{args.ptSteps} steps thin {args.thin}):")
    print(f"  swap acceptance per rung: {np.round(swaps, 3).tolist()}")
    print(f"  ln Z (thermodynamic integration) = {ln_z:.3f} +- {d_ln_z:.3f}")
    for d, n in enumerate(names):
        print(f"  {n} = {q[1, d]:.4g} +{q[2, d] - q[1, d]:.3g} "
              f"-{q[1, d] - q[0, d]:.3g} (truth {TRUTH[d]})")
    chain_io.append_chain_text(
        args.outputPrefix + "pt_coldchain.dat", cold_s,
        (main_chain.log_like[:, 0] + main_chain.log_prior[:, 0]).numpy(),
        mode="w")
    result["pt"] = {n: float(q[1, d]) for d, n in enumerate(names)}
    result["pt_swap_acceptance"] = swaps.tolist()
    result["pt_ln_evidence"] = [float(ln_z), float(d_ln_z)]
    print(json.dumps({k: result[k] for k in (
        "pt_walker_steps_per_sec", "ensemble_walker_steps_per_sec")
        if k in result}))
    print(json.dumps({"pt_cold_medians": result["pt"]}))
    return result


def analytic_pt_setup(data, seed: int, n_temps: int, n_walkers: int,
                      device):
    """The analytic PT posterior on ``data`` (the observed y): (batched
    log-likelihood and log-prior of (N, D) thetas and the host generator,
    initial walkers (T, W, 3) at the truth + 1e-3 N(0, 1))."""
    import torch

    from ..models import shifting_gaussian as sg
    from ._driver import seeded_generator

    loglike, logprior = sg.make_pt_fns(data, numeric=True)
    truth = torch.as_tensor(TRUTH, dtype=torch.float32, device=device)
    p0 = truth + 1e-3 * torch.randn(
        (n_temps, n_walkers, 3),
        generator=seeded_generator(seed, STREAM_PT_WALKERS, device),
        device=device)
    return (lambda th, g: loglike(th)), (lambda th, g: logprior(th)), p0


def tof_pt_setup(seed: int, n_temps: int, n_walkers: int, device, *,
                 observed=None):
    """The reduced TOF posterior of ``-model tof``: (problem, observed
    count arrays, batched log-likelihood and log-prior of (N, D) thetas and
    the host generator, initial walkers (T, W, D)).  simultFit, 2 runs at
    50k draws, counts forward, corrected likelihood; data synthesized at
    the truth unless ``observed`` (the runs' counts) is given; walkers
    from ``initial_walkers_from_observed``.  The log-likelihood takes
    ``walker_offset`` and ``walker_blocks``
    (``parallel.make_sharded_pt_batch`` with ``by_row``)."""
    import torch

    from ..models import simult
    from ..ops.likelihoods import box_lnprior
    from ..utils import data_io
    from ._driver import seeded_generator, stream_seed

    n_runs = 2
    spec = simult.default_spec(n_samples=50_000, sampling="counts")
    problem = simult.SimultFitProblem(spec, n_runs=n_runs,
                                      likelihood="poisson", device=device)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(n_runs, 5.0e4)])
    if observed is None:
        observed = data_io.synthesize_observed(
            stream_seed(seed, STREAM_DATA), problem, truth)
    obs = problem.observed_runs(observed)
    lo, hi = (torch.as_tensor(v, dtype=torch.float32, device=device)
              for v in (problem.param_lo, problem.param_hi))

    def loglike(thetas, generator, **rows):
        return problem.log_like(thetas, generator, obs, **rows)

    def logprior(thetas, generator):
        return box_lnprior(thetas, lo, hi, inclusive=True)

    p0 = problem.initial_walkers_from_observed(
        seeded_generator(seed, STREAM_PT_WALKERS, device),
        n_temps * n_walkers, observed).reshape(n_temps, n_walkers,
                                               problem.n_dim)
    return problem, observed, loglike, logprior, p0


def _run_tof_pt(args, device) -> dict:
    """PT on a reduced TOF posterior (simultFit, 2 runs): the tempered
    ladder carrying walkers along the beamE-eLoss ridge."""
    import torch

    problem, _, loglike, logprior, p0 = tof_pt_setup(
        args.seed, args.nTemps, args.ptWalkers, device)
    n_runs = problem.n_runs
    init, chain, seconds = run_tempered(
        p0, args.ptBurnin, args.ptSteps, args.thin, loglike, logprior,
        seed=args.seed, move=args.move)
    finite = float(torch.isfinite(init.log_like).double().mean())
    rate = ((args.ptBurnin + args.ptSteps) * args.nTemps * args.ptWalkers
            / seconds)
    cold = chain.cold_chain.numpy().reshape(-1, problem.n_dim)
    swaps = chain.n_swaps_accepted.numpy() / args.ptSteps / args.ptWalkers
    names = ["beamE", "eLoss", "scale", "s"] + [
        f"N{i + 1}" for i in range(n_runs)]
    q = np.percentile(cold, [16, 50, 84], axis=0)
    span = np.percentile(cold[:, 0], [2.5, 97.5])
    print(f"PT on reduced TOF posterior ({args.nTemps} temps x "
          f"{args.ptWalkers} walkers):")
    print(f"  swap acceptance per rung: {np.round(swaps, 3).tolist()}")
    for d, n in enumerate(names):
        print(f"  {n} = {q[1, d]:.4g} +{q[2, d] - q[1, d]:.3g} "
              f"-{q[1, d] - q[0, d]:.3g}")
    print(f"  cold-chain beamE 95% span: [{span[0]:.1f}, {span[1]:.1f}] "
          f"({span[1] - span[0]:.1f} keV of ridge traversed)")
    # ln Z of the TOF posterior by thermodynamic integration.  NOTE: under
    # the pseudo-marginal (stochastic) likelihood this is approximate and
    # biased LOW -- E[ln L-hat] <= ln E[L-hat] = ln L (Jensen), so each
    # rung's <ln L>_beta is depressed by ~Var[ln L-hat]/2; report it as a
    # lower bound (an unbiased ln Z would need a non-stochastic -- e.g.
    # expected-forward -- likelihood evaluation along the ladder)
    ln_z, d_ln_z = chain.thermodynamic_integration_log_evidence()
    print(f"  ln Z (thermodynamic integration) = {ln_z:.3f} +- {d_ln_z:.3f}")
    print(f"  initial log-likelihoods finite: {finite:.4f} of the "
          f"{args.nTemps} x {args.ptWalkers} walkers")
    print(json.dumps({"pt_walker_steps_per_sec": rate}))
    print(json.dumps({"beamE_span_keV": float(span[1] - span[0]),
                      "swap_acceptance": swaps.tolist()}))
    return {"beamE_span_keV": float(span[1] - span[0]),
            "swap_acceptance": swaps.tolist(),
            "pt_ln_evidence": [float(ln_z), float(d_ln_z)],
            "pt_walker_steps_per_sec": rate,
            "initial_finite_fraction": finite}


if __name__ == "__main__":
    main()
