"""Where the time of one half-step goes, on the GPU.

    python -m mcmctoffitting_tpu_torch.utils.stages [--sampling mc]
        [--xs-mode taylor] [--walkers 256] [--draws 200000]
        [--out chiprun_out/stages_mc_taylor.json]

Builds the simultFit problem (``--sampling counts``: F = 512 e0grid;
``--sampling mc``: the ODE path, ``transport='rk4'``) on the GPU, warms
it up, then measures, for one half-step's log-prob (``walkers / 2``
walkers x 4 runs):

* the stage split: each stage of the log-prob run alone, with a
  ``torch.cuda.synchronize`` after it, host clock, mean of ``--reps``;
  the synchronizes add a launch round trip per stage, so the sum
  overstates the plain eval, which is timed too;
* ``run_mcmc``: ms per DE step (host clock around a synchronized
  window);
* ``torch.profiler`` over ``--profile-steps`` DE steps: device time by
  kernel, the number of device operations (kernels, copies, memsets),
  and the device's busy share of the unprofiled step time.

Prints one JSON object (also written to ``--out``) with the card's name
and power limit.  Needs a CUDA GPU; it never runs on the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .. import sampler
from ..models import simult
from ..models.forward import _e0grid_contract
from ..ops.cuda_poisson import poisson
from ..ops.e0grid import CountsRates, moments_from_counts
from ..ops.likelihoods import (box_lnprior, poisson_binned_loglike,
                               poisson_logpmf_loglike)
from ..ops.poisson import seed_words
from . import data_io


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _timed(fn, reps):
    """Mean host ms of ``fn`` followed by a synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def _stages(problem, thetas, obs, gen):
    """(name, fn) per stage of ``problem.log_prob``; each fn returns its
    output, fed by the previous stage's stored result."""
    fwd = problem.forward
    spec = problem.spec
    params = thetas[:, :4]
    out = {}

    def keep(name, fn):
        def run():
            out[name] = fn()
            return out[name]
        return name, run

    if spec.sampling == "counts":
        def k1():
            return poisson(out["rates"].lam, seed_words(gen),
                           n_runs=fwd.n_runs)

        def moments():
            per_run = CountsRates(*(t[:, None] for t in out["rates"]))
            return moments_from_counts(fwd.e0grid, out["counts"], per_run)

        grid_stages = [
            keep("rates", lambda: fwd.counts_rates(params)),
            keep("counts", k1),
            keep("moments", moments),
            keep("grid", lambda: (_e0grid_contract(fwd.e0grid,
                                                   out["moments"][0]),
                                  out["moments"][1])),
        ]
        names = ["rates (ndtr chain)", "K1 poisson", "moments_from_counts",
                 "A contraction"]
    else:
        grid_stages = [
            keep("e0", lambda: fwd.sample_beam_energies(params, gen)),
            keep("grid", lambda: (fwd.energy_weight_grid(out["e0"]),
                                  torch.mean(out["e0"], dim=-1))),
        ]
        names = ["beam draw (device uniforms, ndtri)",
                 "K4 moments + Taylor contraction"
                 if spec.xs_mode == "taylor" else
                 "RK4 + cross sections + K3 (row chunks)"]

    def like():
        spectra = out["spectra"]
        fn = (poisson_binned_loglike if problem.likelihood == "reference"
              else poisson_logpmf_loglike)
        return torch.sum(fn(spectra, obs.counts, mask=obs.mask), dim=-1)

    def prior():
        lo, hi = problem._bounds
        total = box_lnprior(thetas, lo, hi, inclusive=True) + out["like"]
        return torch.where(torch.isnan(total), -torch.inf, total)

    tail = [
        keep("lattice", lambda: fwd.lattice(*out["grid"])),
        keep("spectra", lambda: fwd.spectra(*out["lattice"],
                                            thetas[:, 4:4 + fwd.n_runs])),
        keep("like", like),
        keep("prior", prior),
    ]
    names += ["lattice + rint", "K2 TOF histogram + density + timing",
              f"{problem.likelihood} likelihood", "prior + NaN guards"]
    return list(zip(names, (fn for _, fn in grid_stages + tail)))


def measure(sampling="mc", xs_mode="taylor", likelihood="reference",
            n_walkers=256, n_draws=200_000, reps=20, steps=10,
            profile_steps=3):
    if not torch.cuda.is_available():
        raise SystemExit("stages: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    if sampling == "counts":
        spec = simult.default_spec(n_draws, sampling="counts")
    else:
        spec = simult.default_spec(n_draws, transport="rk4", sampling="mc",
                                   xs_mode=xs_mode)
    problem = simult.SimultFitProblem(spec, n_runs=4, likelihood=likelihood,
                                      device=dev)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])
    observed = data_io.synthesize_observed(9, problem, truth)
    obs = problem.observed_runs(observed)
    logp = problem.make_log_prob_fn(observed)
    gen = torch.Generator(dev).manual_seed(1)
    p0 = problem.initial_walkers_from_observed(gen, n_walkers, observed)
    eval_gen = torch.Generator().manual_seed(2)
    half = p0[: n_walkers // 2]

    stages = _stages(problem, half, obs, eval_gen)
    split = [(name, _timed(fn, reps)) for name, fn in stages]
    whole = _timed(lambda: logp(half, eval_gen), reps)

    state = sampler.init_state(p0, logp, generator=gen,
                               eval_generator=eval_gen)
    state = sampler.run_mcmc(state, 2, logp, move="de").state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = sampler.run_mcmc(state, steps, logp, move="de").state
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / steps

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sampler.run_mcmc(state, profile_steps, logp, move="de")
        torch.cuda.synchronize()
    device_us, ops, by_kernel = 0.0, 0, {}
    for evt in prof.key_averages():
        d_us = getattr(evt, "self_device_time_total", None)
        if d_us is None:
            d_us = getattr(evt, "self_cuda_time_total", 0.0)
        if d_us and evt.device_type.name == "CUDA":
            device_us += d_us
            ops += evt.count
            name = evt.key[:100]          # templated names run to pages
            by_kernel[name] = by_kernel.get(name, 0.0) + d_us
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    device_ms_per_step = device_us / 1e3 / profile_steps
    return {
        "card": _smi(), "sampling": sampling,
        "xs_mode": spec.xs_mode, "likelihood": likelihood,
        "walkers": n_walkers, "half_step_walkers": half.shape[0],
        "draws": n_draws,
        "stages_ms": dict(split), "stages_sum_ms": sum(t for _, t in split),
        "log_prob_ms": whole, "step_ms": step_ms,
        "walker_steps_per_s": n_walkers / (step_ms / 1e3),
        "profiled_steps": profile_steps,
        "device_ms_per_step": device_ms_per_step,
        "device_ops_per_step": ops / profile_steps,
        "device_busy_share": device_ms_per_step / step_ms,
        "top_kernels_ms_per_step": {k: v / 1e3 / profile_steps
                                    for k, v in top},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sampling", default="mc", choices=("mc", "counts"))
    ap.add_argument("--xs-mode", default="taylor",
                    choices=("taylor", "exact"))
    ap.add_argument("--likelihood", default="reference",
                    choices=("reference", "poisson"))
    ap.add_argument("--walkers", type=int, default=256)
    ap.add_argument("--draws", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = measure(args.sampling, args.xs_mode, args.likelihood,
                     args.walkers, args.draws, args.reps, args.steps,
                     args.profile_steps)
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
