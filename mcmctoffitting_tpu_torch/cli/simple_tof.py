"""CLI driver: the historical simple-model family (v0-v2.5), on the GPU.

Port of ``mcmctoffitting_tpu/cli/simple_tof.py``: the same flags,
``MODEL_CONFIGS``, windows, standoffs, printed lines and files.  One
driver covering four reference scripts:
  --model v0   -> tests/simpleTOFmodel.py   (E0+E1 x, 3 params, fake data)
  --model v1   -> tests/simpleTOFfit.py     (cubic E(x), 5 params)
  --model v2   -> tests/intermediateTOFfit.py (6 params, XS weights + conv)
  --model v2.5 -> tests/intermediateTOFmodel.py (Bethe transport, 2 params)

v0 runs the reference's closure experiment: generate fake data at the
truth, fit, print recovered quantiles vs truth.  v1/v2 accept a real TSV
via --datafile.  The walkers' log-probs run as one batch per half-step
(``models/simple.py``: one K3 histogram launch per evaluation); the chain
goes to ``mainchain.dat``.  ``-device cpu`` runs the kernels' plain
PyTorch versions.  Besides the JAX CLI's lines, one line gives the share
of non-finite initial log-probs (the multinomial likelihood is -inf where
a model bin with data is empty; the refresh guard re-draws them).

Run: ``python -m mcmctoffitting_tpu_torch.cli.simple_tof --model v0``
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

MODEL_CONFIGS = {
    # poly_order, sigma_growth, xs, conv, bethe, window, truth, lo, hi
    "v0": dict(poly_order=1, n_dim=3,
               truth=(1100.0, -100.0, 50.0),
               lo=(800.0, -200.0, 10.0), hi=(1200.0, 0.0, 100.0),
               n_walkers=50, n_steps=500),
    "v1": dict(poly_order=3, n_dim=5,
               truth=(900.0, -50.0, -10.0, -5.0, 60.0),
               lo=(800.0, -150.0, -30.0, -10.0, 40.0),
               hi=(1100.0, 0.0, 0.0, 0.0, 100.0),
               n_walkers=100, n_steps=500),
    "v2": dict(poly_order=3, n_dim=6, sigma_growth=True, xs=True, conv=True,
               truth=(900.0, -50.0, -10.0, -5.0, 0.05, 0.01),
               lo=(800.0, -150.0, -30.0, -10.0, 0.005, 0.0),
               hi=(1100.0, 0.0, 0.0, 0.0, 0.2, 0.1),
               n_walkers=100, n_steps=500),
    "v2.5": dict(poly_order=0, n_dim=2, bethe=True, xs=True, conv=True,
                 truth=(900.0, 0.05),
                 lo=(500.0, 0.005), hi=(1300.0, 0.5),
                 n_walkers=100, n_steps=500),
}


# --debug sizes: walkers, steps, draws
DEBUG_SIZES = (16, 40, 100_000)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", choices=list(MODEL_CONFIGS), default="v0")
    p.add_argument("--datafile", default=None,
                   help="observed TOF TSV (default: synthesize at truth)")
    p.add_argument("--nDraws", default=200_000, type=int)
    p.add_argument("--nWalkers", default=0, type=int)
    p.add_argument("--nSteps", default=0, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--outputPrefix", default="", type=str)
    p.add_argument("--minimizeSeed", action="store_true",
                   help="seed the walkers from a bounded TNC fit of the "
                        "NLL first (the v1 reference behavior, "
                        "tests/simpleTOFfit.py:267-271; common random "
                        "numbers make the stochastic NLL deterministic)")
    p.add_argument("-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the fit runs: the GPU (default; without one "
                        "the CLI stops with an error) or the CPU, which "
                        "runs the kernels' plain PyTorch versions")
    return p


def build_problem(model: str, n_draws: int, device):
    """(spec, standoff, problem) of ``model`` as the JAX CLI builds them."""
    from ..constants import TUNL_SSA_CSI, TofWindow
    from ..models.simple import SimpleProblem, SimpleSpec
    from ..ops.stopping import d2_gas_stopping

    cfg = MODEL_CONFIGS[model]
    window = (TofWindow(175.0, 200.0, 25) if model == "v0"
              else TofWindow(175.0, 225.0, 50))
    spec = SimpleSpec(
        window=window,
        poly_order=cfg.get("poly_order", 1),
        sigma_growth=cfg.get("sigma_growth", False),
        xs_weighting=cfg.get("xs", False),
        convolve_beam=cfg.get("conv", False),
        bethe_transport=cfg.get("bethe", False),
        # the v2.5 driver's own gas density (tests/intermediateTOFmodel.py:92)
        # -- NOT the simultFit red-notebook 8.565e-5 default
        stopping=d2_gas_stopping(rho=8.37e-5) if cfg.get("bethe") else None,
        add_half_zero_deg=model != "v0",
        n_samples=n_draws,
    )
    standoff = (TUNL_SSA_CSI.cell_to_zero if model == "v0"
                else TUNL_SSA_CSI.standoff_mid)
    problem = SimpleProblem(spec, standoff, cfg["lo"], cfg["hi"],
                            device=device)
    return spec, standoff, problem


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)

    import torch

    from ..models.forward import resolve_device
    from ..models.simple import sample_tof
    from ..sampler import stretch
    from ..utils import chain_io
    from ._driver import (STREAM_CHECK, STREAM_DATA, STREAM_EVAL,
                          STREAM_MOVES, STREAM_WALKERS, seeded_generator)

    device = resolve_device(args.device)
    cfg = MODEL_CONFIGS[args.model]
    n_walkers = args.nWalkers or cfg["n_walkers"]
    n_steps = args.nSteps or cfg["n_steps"]
    n_draws = args.nDraws
    if args.debug:
        # keep draws high enough that the multinomial likelihood rarely
        # sees zero-model bins (-inf) -- acceptance stays healthy
        n_walkers, n_steps, n_draws = DEBUG_SIZES
    spec, standoff, problem = build_problem(args.model, n_draws, device)
    window = spec.window

    truth = np.asarray(cfg["truth"])
    if args.datafile:
        from ..utils import data_io
        tof_data = data_io.read_multi_standoff_tof_data(args.datafile, 1)
        observed, _ = data_io.select_window(tof_data, 0, window.lo,
                                            window.hi)
    else:
        tofs, _, _, _ = sample_tof(
            seeded_generator(args.seed, STREAM_DATA),
            torch.as_tensor(truth[None], dtype=torch.float32, device=device),
            spec, standoff)
        observed, _ = np.histogram(tofs[0, :10_000].cpu().numpy(),
                                   window.n_bins, window.range)
        print(f"synthesized fake data at truth {truth.tolist()}")

    logp = problem.make_log_prob_fn(observed.astype(np.float64))
    center = torch.as_tensor(truth * 1.02, dtype=torch.float32,
                             device=device)
    if args.minimizeSeed:
        # bounded TNC fit of the NLL, walkers seeded from its optimum
        # (tests/simpleTOFfit.py:267-283: minimize -> p0 around .x)
        from ..utils.optimize import minimize_nll
        res = minimize_nll(lambda th, g: logp(th[None], g)[0],
                           center.cpu().numpy(),
                           generator=seeded_generator(args.seed, STREAM_CHECK),
                           method="TNC",
                           bounds=list(zip(cfg["lo"], cfg["hi"])), tol=1.0,
                           device=device)
        print(f"TNC seed: nll {res.fun:.6g} at "
              f"{np.round(res.x, 4).tolist()} (success={res.success})")
        center = torch.as_tensor(res.x, dtype=torch.float32, device=device)
    p0 = center + 1e-2 * torch.randn(
        (n_walkers, cfg["n_dim"]),
        generator=seeded_generator(args.seed, STREAM_WALKERS, device),
        device=device)
    t0 = time.time()
    state = stretch.init_state(
        p0, logp, generator=seeded_generator(args.seed, STREAM_MOVES, device),
        eval_generator=seeded_generator(args.seed, STREAM_EVAL))
    n_bad = int((~torch.isfinite(state.log_probs)).sum())
    chain = stretch.run_mcmc(state, n_steps, logp)
    positions = chain.positions.cpu().numpy()
    elapsed = time.time() - t0
    print(f"initial log-probs: {n_bad} of {n_walkers} non-finite after the "
          f"refresh guard")

    chain_io.append_chain_text(args.outputPrefix + "mainchain.dat",
                               positions, chain.log_probs.cpu().numpy(),
                               mode="w")
    keep = n_steps * 3 // 5
    samples = positions[keep:].reshape(-1, cfg["n_dim"])
    q = np.percentile(samples, [16, 50, 84], axis=0)
    print("MCMC result (median +sigma -sigma vs truth):")
    result = {}
    for d in range(cfg["n_dim"]):
        med, lo, hi = q[1, d], q[1, d] - q[0, d], q[2, d] - q[1, d]
        t = truth[d] if d < len(truth) else float("nan")
        print(f"  theta[{d}] = {med:.4g} +{hi:.3g} -{lo:.3g} (truth {t})")
        result[f"theta{d}"] = [float(med), float(hi), float(lo)]
    rate = n_steps * n_walkers / elapsed
    acc = float(chain.acceptance_fraction.mean())
    print(json.dumps({"walker_steps_per_sec": rate, "acceptance": acc}))
    return {"quantiles": result, "walker_steps_per_sec": rate,
            "acceptance": acc, "initial_nonfinite": n_bad}


if __name__ == "__main__":
    main()
