"""Where the time of one half-step goes, on the GPU.

    python -m mcmctoffitting_tpu_torch.utils.stages [--model simult|onebd]
        [--hardcore] [--sampling mc|counts|expected]
        [--transport table|rk4] [--xs-mode e0grid|taylor|exact]
        [--fine-grid F] [--walkers 256] [--draws 200000]
        [--out chiprun_out/stages_onebd_hardcore_counts.json]

Builds the problem from the model's preset on the GPU (simultFit: 4 runs;
oneBD: 3 runs, ``--hardcore`` for the 400 x 20 grid; ``--transport rk4``
is simultFit's ODE path, where an 'e0grid' ``--xs-mode`` means 'taylor'),
warms it up, then measures, for one half-step's log-prob (``walkers / 2``
walkers):

* the stage split: the spans (``utils/profiling.py``) of ``--reps``
  real log-prob calls, host ms an evaluation of each stage (its total
  and its own time), once with no synchronize until the last call
  (``stages_ms``: what the host spends enqueueing the stage) and once
  with a synchronize after every call (``stages_sync_ms``: the same with
  the launch queue empty at each call's start); the plain evaluation,
  with a synchronize after it, is timed too.  A counts evaluation on the
  card replays a captured graph (``models/logp_graph.py``): its stages
  open at the capture, and the calls measured show ``mcmctof.logp`` and
  ``mcmctof.logp_graph`` alone;
* ``run_mcmc``: ms per DE step (host clock around a synchronized
  window);
* ``torch.profiler`` over ``--profile-steps`` DE steps: device time by
  kernel, the number of device operations (kernels, copies, memsets),
  and the device's busy share: the time some device operation was running
  over the span from the first operation's start to the last one's end,
  both read from the same profiled steps.  The profiler slows the host
  (``profiled_step_ms`` beside ``step_ms`` says by how much), so on a
  host-bound path the share is a lower bound of the unprofiled one.

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
from ..models import onebd, simult
from . import data_io, profiling


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


def stage_split(logp, thetas, gen, reps, *, sync_each):
    """Host ms an evaluation of each span of ``reps`` log-prob calls
    (spans on; ``sync_each``: a synchronize after every call, else one
    after the last): ``{name: {'calls', 'total_ms', 'self_ms'}}``, each
    divided by ``reps``."""
    with profiling.spans() as rec:
        for _ in range(reps):
            logp(thetas, gen)
            if sync_each:
                torch.cuda.synchronize()
    torch.cuda.synchronize()
    return {name: {"calls": s["calls"] / reps,
                   "total_ms": s["total_ms"] / reps,
                   "self_ms": s["self_ms"] / reps}
            for name, s in rec.summary().items()}


def build_problem(model="simult", hardcore=False, sampling="mc",
                  transport="table", xs_mode="e0grid",
                  likelihood="reference", n_draws=200_000, device="cuda",
                  fine_grid=None):
    """(problem, truth) of a preset (``fine_grid`` overrides its F)."""
    if model == "onebd":
        spec = onebd.default_spec(n_draws, hardcore=hardcore,
                                  fine_grid=fine_grid, xs_mode=xs_mode,
                                  sampling=sampling)
        problem = onebd.OneBDProblem(spec, likelihood=likelihood,
                                     device=device)
        truth = data_io.ONEBD_TRUTH
    else:
        spec = simult.default_spec(n_draws, fine_grid=fine_grid,
                                   transport=transport, xs_mode=xs_mode,
                                   sampling=sampling)
        problem = simult.SimultFitProblem(spec, n_runs=4,
                                          likelihood=likelihood,
                                          device=device)
        truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])
    return problem, truth


def measure(model="simult", hardcore=False, sampling="mc",
            transport="table", xs_mode="e0grid", likelihood="reference",
            n_walkers=256, n_draws=200_000, reps=20, steps=10,
            profile_steps=3, fine_grid=None):
    if not torch.cuda.is_available():
        raise SystemExit("stages: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    problem, truth = build_problem(model, hardcore, sampling, transport,
                                   xs_mode, likelihood, n_draws, dev,
                                   fine_grid)
    spec = problem.spec
    problem.forward                                 # build the buffers
    build_s = time.perf_counter() - t0
    observed = data_io.synthesize_observed(9, problem, truth)
    logp = problem.make_log_prob_fn(observed)
    gen = torch.Generator(dev).manual_seed(1)
    p0 = problem.initial_walkers_from_observed(gen, n_walkers, observed)
    eval_gen = torch.Generator().manual_seed(2)
    half = p0[: n_walkers // 2]

    whole = _timed(lambda: logp(half, eval_gen), reps)
    split = stage_split(logp, half, eval_gen, reps, sync_each=False)
    split_sync = stage_split(logp, half, eval_gen, reps, sync_each=True)

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
        t0 = time.perf_counter()
        sampler.run_mcmc(state, profile_steps, logp, move="de")
        torch.cuda.synchronize()
        profiled_step_ms = 1e3 * (time.perf_counter() - t0) / profile_steps
    device_us, by_kernel, spans = 0.0, {}, []
    for evt in prof.events():
        if evt.device_type.name != "CUDA":
            continue
        start, end = evt.time_range.start, evt.time_range.end
        spans.append((start, end))
        device_us += end - start
        name = evt.name[:100]             # templated names run to pages
        by_kernel[name] = by_kernel.get(name, 0.0) + (end - start)
    if not spans:
        raise SystemExit("stages: the profiler recorded no device operation")
    ops = len(spans)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    device_ms_per_step = device_us / 1e3 / profile_steps
    # busy share of the profiled window itself: the union of the device
    # operations' intervals over first start .. last end
    spans.sort()
    busy_us, (cur_lo, cur_hi) = 0.0, spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy_us += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy_us += cur_hi - cur_lo
    window_us = max(hi for _, hi in spans) - spans[0][0]
    return {
        "card": _smi(), "model": model, "hardcore": hardcore,
        "sampling": sampling, "transport": spec.transport,
        "xs_mode": spec.xs_mode, "likelihood": likelihood,
        "fine_cells": spec.e0_grid_fine if spec.xs_mode == "e0grid" else None,
        "a_dtype": spec.a_dtype,
        "grid": [spec.x_binning.n, spec.ed_binning.n],
        "runs": problem.n_runs, "build_seconds": build_s,
        "walkers": n_walkers, "half_step_walkers": half.shape[0],
        "draws": n_draws,
        "stages_ms": split, "stages_sync_ms": split_sync,
        "log_prob_ms": whole, "step_ms": step_ms,
        "walker_steps_per_s": n_walkers / (step_ms / 1e3),
        "profiled_steps": profile_steps,
        "profiled_step_ms": profiled_step_ms,
        "device_ms_per_step": device_ms_per_step,
        "device_ops_per_step": ops / profile_steps,
        "device_window_ms_per_step": window_us / 1e3 / profile_steps,
        "device_busy_share": busy_us / window_us,
        "top_kernels_ms_per_step": {k: v / 1e3 / profile_steps
                                    for k, v in top},
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="simult", choices=("simult", "onebd"))
    ap.add_argument("--hardcore", action="store_true")
    ap.add_argument("--sampling", default="mc",
                    choices=("mc", "counts", "expected"))
    ap.add_argument("--transport", default="table", choices=("table", "rk4"))
    ap.add_argument("--xs-mode", default="e0grid",
                    choices=("e0grid", "taylor", "exact"))
    ap.add_argument("--likelihood", default="reference",
                    choices=("reference", "poisson"))
    ap.add_argument("--fine-grid", type=int, default=None)
    ap.add_argument("--walkers", type=int, default=256)
    ap.add_argument("--draws", type=int, default=200_000)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    result = measure(args.model, args.hardcore, args.sampling,
                     args.transport, args.xs_mode, args.likelihood,
                     args.walkers, args.draws, args.reps, args.steps,
                     args.profile_steps, args.fine_grid)
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    main()
