"""CLI driver: posterior-predictive checks + SDEF export, on the GPU.

Port of ``mcmctoffitting_tpu/cli/ppc.py`` (the reference's
``python tests/testPPC.py`` / ``tests/ppcPlotting_oneBD.py``): the same
flags, defaults, printed lines and files.  Load an emcee-text chain file,
sample the posterior tail, push the draws through the forward model in
batches (``utils/ppc.py``), and write the 16/50/84% credible bands of
every run (``{prefix}run{r}_bands.txt``), the MCNP SDEF card of the
collapsed neutron spectrum (``{prefix}sdef.txt``) and, where matplotlib
is installed, a corner plot and the band plots.  The draws run on the
GPU; ``-device cpu`` runs the kernels' plain PyTorch versions.

Run: ``python -m mcmctoffitting_tpu_torch.cli.ppc -chainFilename mainchain.dat``
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-chainFilename", required=True, type=str)
    p.add_argument("-model", choices=["simult", "onebd", "csi2016"],
                   default="simult",
                   help="csi2016 = ppcTools-era skewnorm-parameterized "
                        "chains (theta = e0, sigma0, skew0, scaleFactor)")
    p.add_argument("-nRuns", default=4, type=int)
    p.add_argument("-nSamplesFromTOF", default=50_000, type=int,
                   help="MC draws per PPC forward eval")
    p.add_argument("-nChainEntries", default=100, type=int,
                   help="number of posterior draws")
    p.add_argument("-lnprobcut", default=None, type=float,
                   help="discard chain samples below this lnprob "
                        "(ppcTools_oneBD behavior)")
    p.add_argument("-observedData", default=None, type=str,
                   help="multistandoff TSV for band overlay plots")
    p.add_argument("-outputPrefix", default="ppc_", type=str)
    p.add_argument("-sdefDistNumber", default=100, type=int)
    p.add_argument("-seed", default=0, type=int)
    p.add_argument("-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the draws run: the GPU (default; without "
                        "one the CLI stops with an error) or the CPU, "
                        "which runs the kernels' plain PyTorch versions")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from ..models import csi2016, onebd, simult
    from ..models.forward import resolve_device
    from ..utils import chain_io, data_io, plotting
    from ..utils.ppc import (PPCSampler, collapse_neutron_spectrum,
                             make_sdef_sia_cumulative, percentile_bands)
    from ._driver import draw_figure

    device = resolve_device(args.device)
    if not os.path.exists(args.chainFilename):
        sys.exit(f"error: chain file not found: {args.chainFilename}")
    try:
        chain, probs, n_params, n_walkers, n_steps = \
            chain_io.read_chain_text(args.chainFilename)
    except Exception as e:
        sys.exit(f"error: could not parse chain file "
                 f"{args.chainFilename}: {e}")
    print(f"chain: {n_steps} steps x {n_walkers} walkers x {n_params} params")

    if args.model == "simult":
        spec = simult.default_spec(n_samples=args.nSamplesFromTOF)
        problem = simult.SimultFitProblem(spec, n_runs=args.nRuns,
                                          device=device)
    elif args.model == "csi2016":
        spec = csi2016.default_spec(n_samples=args.nSamplesFromTOF)
        problem = csi2016.Csi2016Problem(spec, n_runs=args.nRuns,
                                         device=device)
    else:
        spec = onebd.default_spec(n_samples=args.nSamplesFromTOF)
        problem = onebd.OneBDProblem(spec, n_runs=3, device=device)

    sampler = PPCSampler(problem, chain, probs)
    t0 = time.perf_counter()
    result = sampler.generate(torch.Generator().manual_seed(args.seed),
                              args.nChainEntries, lnprob_cut=args.lnprobcut)
    generate_s = time.perf_counter() - t0

    out = {}
    for run, spectra in enumerate(result.tof_spectra):
        bands = percentile_bands(spectra)
        out[f"run{run}_bands"] = bands
        np.savetxt(f"{args.outputPrefix}run{run}_bands.txt", bands)

    # neutron spectrum summed over draws + cell length -> SDEF card
    neutron_spectrum = collapse_neutron_spectrum(result.neutron_spectra)
    sdef = make_sdef_sia_cumulative(problem.spec.en_centers(),
                                    neutron_spectrum, args.sdefDistNumber)
    with open(args.outputPrefix + "sdef.txt", "w") as f:
        f.write(sdef["si"] + "\n" + sdef["sp"] + "\n")
    print(f"wrote {args.outputPrefix}sdef.txt")

    def draw():
        plotting.corner_plot(chain[-50:],
                             filename=args.outputPrefix + "corner.png")
        if args.observedData:
            tof_data = data_io.read_multi_standoff_tof_data(
                args.observedData, len(problem.windows))
            for run, w in enumerate(problem.windows):
                obs, _ = data_io.select_window(tof_data, run, w.lo, w.hi)
                plotting.ppc_band_plot(
                    obs, out[f"run{run}_bands"],
                    filename=f"{args.outputPrefix}run{run}.png")

    if draw_figure(draw):
        print("wrote PPC plots")
    return {"n_draws": args.nChainEntries, "sdef": sdef,
            "generate_s": generate_s}


if __name__ == "__main__":
    main()
