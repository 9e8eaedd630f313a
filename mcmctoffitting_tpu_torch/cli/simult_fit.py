"""CLI driver: simultaneous multi-standoff fit (flagship #1), on the GPU.

Port of ``mcmctoffitting_tpu/cli/simult_fit.py``: the same flags,
defaults, printed lines and files.  Chains stream to ``burninchain.dat``
/ ``mainchain.dat`` in the emcee text format, with a ``.npz`` checkpoint
per phase for exact resume (``-resume main.ckpt.npz``).  ``-datafile``
defaults to synthetic data at the guess parameters.  The fit runs on the
GPU; ``-device cpu`` runs the kernels' plain PyTorch versions.

Run: ``python -m mcmctoffitting_tpu_torch.cli.simult_fit -nRuns 4 -debug 1``
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ._driver import add_common_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-nRuns", choices=[1, 2, 3, 4, 5], default=4, type=int)
    p.add_argument("-datafile", default=None, type=str,
                   help="multistandoff TSV (default: synthesize)")
    add_common_flags(p, {
        "check_eval": "tests/simultFit.py:474-512",
        "nthreads": "tests/simultFit.py:46",
        "mpi": "tests/simultFit.py:688-706",
        "fine_defaults": "256 mc / 512 counts (1024 below 100k draws)",
    })
    return p


def sizes(args):
    """(walkers, burn-in steps, main steps, draws per eval); ``-debug``
    shrinks the ensemble unless -nWalkers was given explicitly."""
    n_walkers = (2 * 9 if args.debug and args.nWalkers == 256
                 else args.nWalkers)
    burnin_steps = 10 if args.debug else args.nBurninSteps
    main_steps = 10 if args.debug else args.nMainSteps
    n_draws = 5000 if args.debug else args.nDrawsPerEval
    return n_walkers, burnin_steps, main_steps, n_draws


def build_problem(args, device):
    """The fit's problem from the flags (the JAX CLI's preset choices)."""
    from ..models import simult
    from ._driver import resolve_gradient_spec, resolve_sampling

    sampling, fine_grid = resolve_sampling(args)
    spec = simult.default_spec(
        n_samples=sizes(args)[3],
        fine_grid=fine_grid,
        xs_mode="e0grid" if sampling != "mc" else args.gridMode,
        sampling=sampling)
    if args.momentClosure != "exact" or args.aDtype:
        spec = dataclasses.replace(spec, moment_closure=args.momentClosure,
                                   a_dtype=args.aDtype or spec.a_dtype)
    spec = resolve_gradient_spec(args, spec)
    return simult.SimultFitProblem(spec, n_runs=args.nRuns,
                                   likelihood=args.likelihood, device=device)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from ..models import simult
    from ..utils import data_io
    from ._driver import (STREAM_CHECK, STREAM_DATA, build_logp_batch,
                          check_likelihood_eval, common_setup, fit_phases,
                          mesh_ranks, run_gradient_sampler, run_ranks,
                          seeded_generator, stream_seed)

    n_walkers, burnin_steps, main_steps, _ = sizes(args)
    n_ranks = mesh_ranks(args, n_walkers)
    if n_ranks > 1:
        return run_ranks(main, argv, args, n_ranks)
    device, mesh = common_setup(args)
    problem = build_problem(args, device)

    if args.datafile:
        tof_data = data_io.read_multi_standoff_tof_data(args.datafile,
                                                        args.nRuns)
        observed = tuple(
            data_io.select_window(tof_data, i, w.lo, w.hi)[0]
            for i, w in enumerate(problem.windows))
    else:
        truth = np.concatenate([simult.GUESS_SHARED,
                                np.full(args.nRuns, 5.0e4)])
        observed = data_io.synthesize_observed(
            stream_seed(args.seed, STREAM_DATA), problem, truth)
        print("using synthetic observed data at guess parameters")

    if args.quitEarly:
        print("quitEarly: setup complete")
        return {"status": "quitEarly"}

    if args.checkLikelihoodEval:
        total = check_likelihood_eval(
            problem, observed, seeded_generator(args.seed, STREAM_CHECK),
            prefix=args.outputPrefix, batch=bool(args.batch))
        return {"status": "checkLikelihoodEval", "total_loglike": total}

    names = ["beamE", "eLoss", "scale", "s"] + [
        f"N{i + 1}" for i in range(args.nRuns)]
    if args.sampler != "ensemble":
        return run_gradient_sampler(args, problem, observed, names=names)
    logp_batch = build_logp_batch(problem.make_log_prob_fn(observed), args,
                                  mesh, by_row=problem.draws_by_row)
    return fit_phases(args, problem, observed, logp_batch,
                      n_walkers=n_walkers, burnin_steps=burnin_steps,
                      main_steps=main_steps, names=names, mesh=mesh)


if __name__ == "__main__":
    main()
