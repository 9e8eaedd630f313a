"""Where the time of one gradient evaluation goes, on the card.

One evaluation of what the gradient samplers call per leaf or leapfrog
step (``sampler._adapt.LogpAndGrad``: the batched log-prob of the
differentiable configuration and its autograd backward) for both flagship
fits at their presets ('expected', corrected likelihood, no rint;
simultFit 4 runs F = 256, oneBD 3 runs F = 512 with the background's
expectation), at 256 and 64 chains: the host's wall clock of the forward
and of the backward (each ended by a synchronize, mean of 20 after 5
warm-ups), then ``torch.profiler`` over 10 evaluations: device time per
evaluation, kernel launches per evaluation, the busy share (device time
over the profiled window) and the five costliest device kernels.
``--float32-grid-backward`` differentiates the closed-form grid stage by
plain float32 autograd in place of ``ops.e0grid.expected_grid``'s float64
backward, to show what that backward costs.

    PYTHONPATH=. python perf/gradient_profile.py [--float32-grid-backward]
"""
import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mcmctoffitting_tpu_torch.models import forward as forward_mod
from mcmctoffitting_tpu_torch.models import onebd, simult
from mcmctoffitting_tpu_torch.ops import e0grid
from mcmctoffitting_tpu_torch.sampler._adapt import LogpAndGrad
from mcmctoffitting_tpu_torch.utils import data_io


def problems(dev):
    spec_s = dataclasses.replace(
        simult.default_spec(200_000, sampling="expected"), rint_draws=False)
    spec_o = dataclasses.replace(
        onebd.default_spec(200_000, sampling="expected"), rint_draws=False,
        bg_mode="expected")
    return {
        "simult": (simult.SimultFitProblem(spec_s, n_runs=4,
                                           likelihood="poisson", device=dev),
                   np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])),
        "onebd": (onebd.OneBDProblem(spec_o, n_runs=3, likelihood="poisson",
                                     device=dev), data_io.ONEBD_TRUTH)}


def host_ms(fn, reps=20, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def plain_expected_grid(grid, *args):
    moments, e0_mean = e0grid.expected_moments(grid, *args)
    return e0grid.contract(grid, moments), e0_mean


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--float32-grid-backward", action="store_true")
    plain = parser.parse_args().float32_grid_backward
    if plain:
        forward_mod.expected_grid = plain_expected_grid
    if not torch.cuda.is_available():
        raise SystemExit("gradient_profile: needs a CUDA GPU")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    cases = []
    for name, (prob, truth) in problems(dev).items():
        obs = data_io.synthesize_observed(9, prob, truth)
        logp = prob.make_log_prob_fn(obs)
        for n_chains in (256, 64):
            thetas = prob.initial_walkers_from_observed(
                torch.Generator(dev).manual_seed(1), n_chains, obs)
            cases.append((name, n_chains, logp, thetas))
    gen = torch.Generator()
    # host times first: once the profiler has run in a process, every
    # later launch costs the host more
    lines = []
    for name, n_chains, logp, thetas in cases:
        vg = LogpAndGrad(lambda z, logp=logp: logp(z, gen))

        def forward(logp=logp, thetas=thetas):
            with torch.no_grad():
                logp(thetas, gen)

        whole = host_ms(lambda: vg(thetas))
        fwd = host_ms(forward)
        lines.append({"model": name, "chains": n_chains, "card": smi,
                      "grid_backward": "float32" if plain else "float64",
                      "gradient_evaluation_ms": whole, "forward_ms": fwd,
                      "backward_ms": whole - fwd})
    for line, (_, _, logp, thetas) in zip(lines, cases):
        vg = LogpAndGrad(lambda z, logp=logp: logp(z, gen))
        vg(thetas)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                vg(thetas)
            torch.cuda.synchronize()
            window = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name == "CUDA"]
        device_us = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)
        line.update({
            "device_ms_per_evaluation": device_us / 1e3 / 10,
            "device_kernels_per_evaluation": sum(e.count
                                                 for e in kernels) / 10,
            "busy_share_profiled": device_us / 1e3 / window,
            "profiled_ms_per_evaluation": window / 10,
            "top_kernels_ms_per_evaluation": [
                [e.key[:60], e.self_device_time_total / 1e3 / 10]
                for e in top[:5]]})
        print(json.dumps(line))


if __name__ == "__main__":
    main()
