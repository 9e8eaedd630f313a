"""CLI driver: csi_oneBD fit (flagship #2), on the GPU.

Port of ``mcmctoffitting_tpu/cli/csi_onebd.py``: fixed beam reference
energy, per-run scale + Poisson background, spline-table stopping, cell
attenuation, the -qnd/-quickish/-hardcore sampling presets and the
-shiftTOF systematic, with the JAX CLI's flags, defaults, printed lines
and files.  The fit runs on the GPU; ``-device cpu`` runs the kernels'
plain PyTorch versions.

Run: ``python -m mcmctoffitting_tpu_torch.cli.csi_onebd -debug 1``
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from ._driver import add_common_flags


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-run", choices=[0, 1, 2, 3], default=0, type=int,
                   help="accepted for surface parity; vestigial in the "
                        "reference (its window selection is immediately "
                        "overwritten, tests/csi_oneBD.py:178-183)")
    p.add_argument("-inputDataFilename", default=None, type=str)
    # the reference spells these as int choices (-qnd 1,
    # tests/csi_oneBD.py:71-73); accept both that and bare-flag style
    p.add_argument("-qnd", type=int, choices=[0, 1], nargs="?", const=1,
                   default=0, help="quick and dirty: 60k draws")
    p.add_argument("-quickish", type=int, choices=[0, 1], nargs="?",
                   const=1, default=0, help="100k draws")
    p.add_argument("-hardcore", type=int, choices=[0, 1], nargs="?",
                   const=1, default=0, help="400 eD x 20 x binning")
    p.add_argument("-shiftTOF", default=0, type=int,
                   help="shift observed spectra by whole bins (systematic)")
    p.add_argument("-deterministicBG", action="store_true",
                   help="add the expected background level instead of a "
                        "fresh Poisson draw per eval (default: the "
                        "reference-faithful draw, tests/csi_oneBD.py:521)")
    add_common_flags(p, {
        "check_eval": "tests/csi_oneBD.py:654-712",
        "nthreads": "tests/csi_oneBD.py:62",
        "mpi": "tests/csi_oneBD.py:61",
        "fine_defaults": "512 mc / 1024 hardcore / 1024 counts "
                         "(2048 below 100k draws)",
    })
    return p


def sizes(args):
    """(walkers, burn-in steps, main steps, draws per eval): -quickish,
    then -qnd, then -debug set the draws; ``-debug`` shrinks the ensemble
    unless -nWalkers was given explicitly."""
    n_draws = args.nDrawsPerEval
    if args.quickish:
        n_draws = 100_000
    if args.qnd:
        n_draws = 60_000
    if args.debug:
        n_draws = 5000
    n_walkers = (2 * 9 if args.debug and args.nWalkers == 256
                 else args.nWalkers)
    burnin_steps = 10 if args.debug else args.nBurninSteps
    main_steps = 10 if args.debug else args.nMainSteps
    return n_walkers, burnin_steps, main_steps, n_draws


def build_problem(args, device):
    """The fit's problem from the flags (the JAX CLI's preset choices)."""
    from ..models import onebd
    from ._driver import resolve_gradient_spec, resolve_sampling

    sampling, fine_grid = resolve_sampling(args)
    spec = onebd.default_spec(
        n_samples=sizes(args)[3], hardcore=args.hardcore,
        fine_grid=fine_grid,
        xs_mode="e0grid" if sampling != "mc" else args.gridMode,
        sampling=sampling)
    if args.deterministicBG:
        spec = dataclasses.replace(spec, bg_mode="expected")
    if args.momentClosure != "exact" or args.aDtype:
        spec = dataclasses.replace(spec, moment_closure=args.momentClosure,
                                   a_dtype=args.aDtype or spec.a_dtype)
    spec = resolve_gradient_spec(args, spec)
    return onebd.OneBDProblem(spec, n_runs=3, likelihood=args.likelihood,
                              device=device)


def shift_tof(tof_data: np.ndarray, shift: int) -> np.ndarray:
    """-shiftTOF: relabel the count rows against the time axis by whole
    bins, before window selection (tests/csi_oneBD.py:698-706)."""
    if shift > 0:
        edges = tof_data[:-shift, 0]
        tof_data = tof_data[shift:].copy()
        tof_data[:, 0] = edges
    elif shift < 0:
        edges = tof_data[-shift:, 0]
        tof_data = tof_data[:shift].copy()
        tof_data[:, 0] = edges
    return tof_data


def observed_from_file(path: str, problem, shift: int = 0):
    """The three runs' windows of a multi-standoff TSV, -shiftTOF
    applied."""
    from ..utils import data_io

    tof_data = shift_tof(data_io.read_multi_standoff_tof_data(path, 3), shift)
    return tuple(data_io.select_window(tof_data, i, w.lo, w.hi)[0]
                 for i, w in enumerate(problem.windows))


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
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

    if args.inputDataFilename:
        observed = observed_from_file(args.inputDataFilename, problem,
                                      args.shiftTOF)
    else:
        observed = data_io.synthesize_observed(
            stream_seed(args.seed, STREAM_DATA), problem,
            data_io.ONEBD_TRUTH)
        print("using synthetic observed data at guess parameters")

    if args.quitEarly:
        print("quitEarly: setup complete")
        return {"status": "quitEarly"}

    if args.checkLikelihoodEval:
        total = check_likelihood_eval(
            problem, observed, seeded_generator(args.seed, STREAM_CHECK),
            prefix=args.outputPrefix, batch=bool(args.batch))
        return {"status": "checkLikelihoodEval", "total_loglike": total}

    names = (["eLoss", "scale", "s"] + [f"N{i+1}" for i in range(3)]
             + [f"BG{i+1}" for i in range(3)])
    if args.sampler != "ensemble":
        return run_gradient_sampler(args, problem, observed, names=names)
    logp_batch = build_logp_batch(problem.make_log_prob_fn(observed), args,
                                  mesh, by_row=problem.draws_by_row)
    return fit_phases(args, problem, observed, logp_batch,
                      n_walkers=n_walkers, burnin_steps=burnin_steps,
                      main_steps=main_steps, names=names, mesh=mesh)


if __name__ == "__main__":
    main()
