"""CLI driver: non-parametric template unfolding (35-dim fit), on the GPU.

Port of ``mcmctoffitting_tpu/cli/template_fit.py`` (the reference's
``python tests/devShapeTemplates.py``): the same flags, printed lines and
files.  Generate (or load from the CSV cache) 32 monoenergetic-slice
templates per standoff, then fit 3 run scales + 32 coefficients with the
wide-Gaussian likelihood.  The templates are one batched forward of all
128 (run, slice) rows (``models/templates.py``: kernel K4 once, kernel K2
once); the walkers' log-probs are one batch per half-step.  Writes
``{prefix}burninchain.dat`` (every 10th step), the rate line, and where
matplotlib is installed ``{prefix}trace.png`` and
``{prefix}unfolded_spectrum.png``.  ``-device cpu`` runs the kernels'
plain PyTorch versions.

Run: ``python -m mcmctoffitting_tpu_torch.cli.template_fit --debug``
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-filename", default=None, type=str,
                   help="observed multistandoff TSV (default: synthesize)")
    p.add_argument("-templateFile", default="templates.csv", type=str)
    p.add_argument("-nDraws", default=200_000, type=int)
    p.add_argument("-nWalkers", default=500, type=int)
    p.add_argument("-nBurnin", default=10_000, type=int)
    p.add_argument("-seed", default=0, type=int)
    p.add_argument("--debug", action="store_true")
    p.add_argument("-outputPrefix", default="tmpl_", type=str)
    p.add_argument("-doML", action="store_true",
                   help="run a bounded SLSQP maximum-likelihood fit first "
                        "and start the walkers from its optimum (the "
                        "reference's doML option, "
                        "tests/devShapeTemplates.py:508-518)")
    p.add_argument("-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the fit runs: the GPU (default; without one "
                        "the CLI stops with an error) or the CPU, which "
                        "runs the kernels' plain PyTorch versions")
    return p


# --debug sizes: draws per template, walkers, steps
DEBUG_SIZES = (5000, 80, 30)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from ..models import templates as T
    from ..models.forward import resolve_device
    from ..sampler import stretch
    from ..utils import chain_io, data_io, plotting
    from ._driver import (STREAM_DATA, STREAM_EVAL, STREAM_MOVES,
                          STREAM_WALKERS, draw_figure, seeded_generator)

    device = resolve_device(args.device)
    n_draws, n_walkers, n_steps = (DEBUG_SIZES if args.debug else
                                   (args.nDraws, args.nWalkers, args.nBurnin))

    spec = T.default_spec(n_samples=n_draws)
    problem = T.TemplateFitProblem(n_runs=4, device=device)

    generate_s = None
    if os.path.exists(args.templateFile):
        print(f"loading templates from {args.templateFile}")
        templates = T.load_templates_csv(args.templateFile, 4)
    else:
        print("generating templates (4 standoffs x 32 slices)...")
        t0 = time.time()
        templates = T.generate_templates(
            seeded_generator(args.seed, STREAM_DATA), spec, device=device)
        generate_s = time.time() - t0
        T.save_templates_csv(args.templateFile, templates)
        print(f"templates done in {generate_s:.1f}s "
              f"-> {args.templateFile}")

    coeff_guess = problem.initial_guess_model()
    if args.filename:
        tof_data = data_io.read_multi_standoff_tof_data(args.filename, 4)
        observed = [data_io.select_window(tof_data, i, w.lo, w.hi)[0]
                    for i, w in enumerate(problem.windows)]
    else:
        true_scales = [1.0, 1.1, 0.6, 1.5]
        observed = [T.build_model_tof(
            true_scales[r], torch.as_tensor(coeff_guess, dtype=torch.float32),
            torch.as_tensor(np.asarray(templates[r], np.float32))).numpy()
            for r in range(4)]
        observed = [np.random.default_rng(r).poisson(np.maximum(o, 0.0))
                    for r, o in enumerate(observed)]
        print("using synthetic observed data from guess-model coefficients")

    logp = problem.make_log_prob_fn(observed, templates)
    guess = np.concatenate([[1.1, 0.6, 1.5], coeff_guess])
    lo = np.concatenate([[lim[0] for lim in T.SCALE_LIMS],
                         np.zeros(T.N_TEMPLATES)])
    hi = np.concatenate([[lim[1] for lim in T.SCALE_LIMS],
                         np.full(T.N_TEMPLATES, T.COEFF_LIM[1])])
    ml = None
    if args.doML:
        # bounded SLSQP ML fit preceding the MCMC; the template likelihood
        # is deterministic, so no common-random-number handling is needed
        from ..utils.optimize import minimize_nll
        res = minimize_nll(lambda th, g: logp(th[None], g)[0], guess,
                           method="SLSQP",
                           bounds=list(zip(lo.tolist(), hi.tolist())),
                           maxiter=10_000, device=device)
        print(f"SLSQP ML fit: nll {res.fun:.6g} success={res.success}")
        print("optimized coefficients that will be used:",
              np.round(res.x, 4).tolist())
        ml = {"x": np.asarray(res.x), "nll": float(res.fun),
              "nll_start": -float(logp(torch.as_tensor(
                  guess[None], dtype=torch.float32, device=device),
                  None)[0]),
              "success": bool(res.success)}
        guess = np.asarray(res.x)
    noise = torch.rand((n_walkers, problem.n_dim),
                       generator=seeded_generator(args.seed, STREAM_WALKERS),
                       dtype=torch.float64).numpy()
    p0 = torch.as_tensor(np.clip(guess * (0.9 + 0.2 * noise), lo + 1e-6,
                                 hi - 1e-6), dtype=torch.float32,
                         device=device)

    t0 = time.time()
    chain = stretch.sample(
        p0, n_steps, logp,
        generator=seeded_generator(args.seed, STREAM_MOVES, device),
        eval_generator=seeded_generator(args.seed, STREAM_EVAL))
    positions = chain.positions.cpu().numpy()
    elapsed = time.time() - t0
    chain_io.append_chain_text(args.outputPrefix + "burninchain.dat",
                               positions[::10],
                               chain.log_probs[::10].cpu().numpy(), mode="w")

    keep = max(n_steps * 3 // 5, 1)
    samples = positions[keep:].reshape(-1, problem.n_dim)
    q = np.percentile(samples, [16, 50, 84], axis=0)
    print("recovered run scales (median):", np.round(q[1, :3], 3).tolist())
    rate = n_steps * n_walkers / elapsed
    print(json.dumps({"walker_steps_per_sec": rate,
                      "acceptance": float(chain.acceptance_fraction.mean())}))

    def draw():
        plotting.trace_plot(positions, None,
                            args.outputPrefix + "trace.png", max_params=6)
        # the reference's closing posterior visualization: unfolded
        # spectrum band + run-scale histograms with quantile lines
        # (tests/devShapeTemplates.py:584-631)
        centers = 0.5 * (T.TEMPLATE_BOUNDS[:-1] + T.TEMPLATE_BOUNDS[1:])
        plotting.unfolded_spectrum_plot(
            centers, samples,
            filename=args.outputPrefix + "unfolded_spectrum.png")

    if draw_figure(draw):
        print(f"unfolded-spectrum plot -> "
              f"{args.outputPrefix}unfolded_spectrum.png")
    return {"scales_median": q[1, :3].tolist(),
            "coeffs_median": q[1, 3:].tolist(),
            "walker_steps_per_sec": rate, "generate_s": generate_s,
            "ml": ml, "observed": observed, "templates": templates}


if __name__ == "__main__":
    main()
