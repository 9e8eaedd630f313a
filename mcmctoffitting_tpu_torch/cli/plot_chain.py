"""CLI driver: chain diagnostics from a file.

Port of ``mcmctoffitting_tpu/cli/plot_chain.py`` (the reference's
``python tests/plotChainFromFile.py`` and ``utilities/plotChains_oneBD.py``
/ ``plotChains_templateFitting.py``): the same flags and printed lines.
It prints the convergence summary of an emcee-text-format chain file and
draws trace plots, lnprob-vs-parameter scatters, marginal histograms and
a corner plot; where matplotlib is not installed it prints the line that
says so instead of the figures.

Run: ``python -m mcmctoffitting_tpu_torch.cli.plot_chain -filename mainchain.dat``
"""
from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-filename", required=True, type=str)
    p.add_argument("-outputPrefix", default="chain_", type=str)
    p.add_argument("-nStepsToInclude", default=50, type=int)
    p.add_argument("-paramNames", default=None, type=str,
                   help="comma-separated names")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    from ..utils import chain_io, plotting
    from ..utils.diagnostics import chain_summary, format_summary
    from ._driver import draw_figure

    if not os.path.exists(args.filename):
        sys.exit(f"error: chain file not found: {args.filename}")
    try:
        chain, probs, n_params, n_walkers, n_steps = \
            chain_io.read_chain_text(args.filename)
    except Exception as e:
        sys.exit(f"error: could not parse chain file {args.filename}: {e}")
    print(f"chain: {n_steps} steps x {n_walkers} walkers x {n_params} params")
    names = args.paramNames.split(",") if args.paramNames else None

    if n_steps >= 8:
        summary = chain_summary(chain)
        print(format_summary(summary))
        per = "  ".join(f"p{d}: tau={summary['tau'][d]:.1f} "
                        f"ess={summary['ess'][d]:.0f} "
                        f"rhat={summary['rhat'][d]:.3f}"
                        for d in range(n_params))
        print(per)

    def draw():
        prefix = args.outputPrefix
        plotting.trace_plot(chain, names, prefix + "trace.png")
        for d in range(n_params):
            plotting.lnprob_scatter(chain, probs, d,
                                    names[d] if names else None,
                                    f"{prefix}lnprob_vs_p{d}.png")
            plotting.param_hist(chain, d,
                                filename=f"{prefix}hist_p{d}.png")
        plotting.corner_plot(chain[-args.nStepsToInclude:], names,
                             filename=prefix + "corner.png")

    if draw_figure(draw):
        print(f"wrote plots with prefix {args.outputPrefix}")
    return {"n_steps": n_steps, "n_walkers": n_walkers,
            "n_params": n_params}


if __name__ == "__main__":
    main()
