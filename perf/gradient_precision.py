"""How precise is the float32 gradient of the differentiable log-prob?

For both flagship fits at their presets ('expected', corrected likelihood,
no rint; simultFit 4 runs F = 256, oneBD 3 runs F = 512 with the
background's expectation), on the CPU: the port's float32 gradient
against the same port evaluated in float64 (its forward module widened
with ``.double()``), per chain, as relative L2, at 8 points of the fit's
initial-walker cloud and at 8 points 1% around the truth: as the port
ships it (the closed-form grid stage differentiated in float64,
``ops.e0grid.expected_grid``), by plain float32 autograd of that stage,
and with every stage after the grid in float64, fed the float32 grid
stage's values: what is left then is the float32 grid values' share.
The differences bound how closely two float32 implementations (the
card and the CPU, or the port and the JAX package) can agree.  With
``--device cuda`` the card's float32 gradient is held against the same
float64 reference and against the CPU's float32 one, with the worst
chain's components.  Last, per model, the spread of the relative L2
over 256 chains of the initial-walker cloud.

    PYTHONPATH=. python perf/gradient_precision.py [--device cuda]
"""
import argparse
import dataclasses
import json

import numpy as np
import torch

from mcmctoffitting_tpu_torch.models import forward as forward_mod
from mcmctoffitting_tpu_torch.models import onebd, simult
from mcmctoffitting_tpu_torch.ops import cuda_tof, e0grid
from mcmctoffitting_tpu_torch.utils import data_io


def problems(device="cpu"):
    spec_s = dataclasses.replace(
        simult.default_spec(200_000, sampling="expected"), rint_draws=False)
    spec_o = dataclasses.replace(
        onebd.default_spec(200_000, sampling="expected"), rint_draws=False,
        bg_mode="expected")
    return {
        "simult": (lambda d="cpu": simult.SimultFitProblem(
            spec_s, n_runs=4, likelihood="poisson", device=d),
            np.concatenate([simult.GUESS_SHARED, np.full(4, 5.0e4)])),
        "onebd": (lambda d="cpu": onebd.OneBDProblem(
            spec_o, n_runs=3, likelihood="poisson", device=d),
            data_io.ONEBD_TRUTH)}


def plain_expected_grid(grid, *args):
    moments, e0_mean = e0grid.expected_moments(grid, *args)
    return e0grid.contract(grid, moments), e0_mean


def widened_after_grid(p32, p64):
    """``run_spectra`` of ``p32`` whose grid stage is float32 and whose
    later stages run on ``p64``'s float64 forward."""
    def run_spectra(thetas, generator):
        params, scales, bg_levels = p32.split_theta(thetas)
        grids, e0_means = p32.forward.grid_and_mean(params.float(),
                                                     generator)
        base, draws = p64.forward.lattice(grids.double(), e0_means.double())
        background = (None if bg_levels is None
                      else p64.forward.background(bg_levels, generator))
        return p64.forward.spectra(base, draws, scales, background)
    return run_spectra


def gradient(problem, observed, thetas, dtype):
    x = torch.tensor(thetas, dtype=dtype, device=problem.device,
                     requires_grad=True)
    lp = problem.make_log_prob_fn(observed)(x, torch.Generator())
    g, = torch.autograd.grad(lp.sum(), x)
    return g.double().cpu()


def rel_l2(a, b):
    return ((a - b).norm(dim=1) / b.norm(dim=1)).tolist()


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device", default="cpu", choices=["cpu", "cuda"])
    device = parser.parse_args().device
    torch.set_num_threads(1)
    # the kernel wrapper takes float32; its plain version (the CPU's) runs
    # on widened inputs as well
    cuda_tof._check_args = lambda *args: None
    for name, (make, truth) in problems().items():
        p32, p64 = make(), make()
        p64.forward.double()
        observed = data_io.synthesize_observed(9, p32, truth)
        rng = np.random.default_rng(16)
        points = {
            "start": p32.initial_walkers_from_observed(
                torch.Generator().manual_seed(1), 8, observed).double(
                ).numpy(),
            "near_truth": truth * (1.0 + 0.01 * rng.standard_normal(
                (8, truth.size)))}
        for where, thetas in points.items():
            thetas = thetas.astype(np.float32).astype(np.float64)
            want = gradient(p64, observed, thetas, torch.float64)
            shipped = gradient(p32, observed, thetas, torch.float32)
            forward_mod.expected_grid = plain_expected_grid
            plain = gradient(p32, observed, thetas, torch.float32)
            forward_mod.expected_grid = e0grid.expected_grid
            hybrid = make()
            hybrid.run_spectra = widened_after_grid(p32, p64)
            after = gradient(hybrid, observed, thetas, torch.float64)
            line = {
                "model": name, "points": where,
                "float32_vs_float64": rel_l2(shipped, want),
                "float32_autograd_of_the_grid_vs_float64": rel_l2(plain,
                                                                  want),
                "float64_after_the_grid_vs_float64": rel_l2(after, want)}
            if device == "cuda":
                card = gradient(make("cuda"), observed, thetas,
                                torch.float32)
                worst = int(np.argmax(rel_l2(card, want)))
                line.update({
                    "card": torch.cuda.get_device_name(0),
                    "card_vs_float64": rel_l2(card, want),
                    "card_vs_cpu_float32": rel_l2(card, shipped),
                    "worst_chain": worst,
                    "worst_float64": want[worst].tolist(),
                    "worst_card": card[worst].tolist(),
                    "worst_cpu_float32": shipped[worst].tolist()})
            print(json.dumps(line))
        # the spread over 256 chains of the initial-walker cloud
        thetas = p32.initial_walkers_from_observed(
            torch.Generator().manual_seed(2), 256, observed).double().numpy()
        want = gradient(p64, observed, thetas, torch.float64)
        dist = {"cpu_float32": rel_l2(gradient(p32, observed, thetas,
                                               torch.float32), want)}
        forward_mod.expected_grid = plain_expected_grid
        dist["cpu_float32_autograd_of_the_grid"] = rel_l2(
            gradient(p32, observed, thetas, torch.float32), want)
        forward_mod.expected_grid = e0grid.expected_grid
        if device == "cuda":
            dist["card"] = rel_l2(gradient(make("cuda"), observed, thetas,
                                           torch.float32), want)
        for tag, rel in dist.items():
            print(json.dumps({
                "model": name, "points": "start, 256 chains",
                "vs_float64": tag,
                "quantiles_50_90_99": np.percentile(
                    rel, [50, 90, 99]).tolist(),
                "max": max(rel),
                "share_above_1e-3": float(np.mean(np.asarray(rel) > 1e-3))}))


if __name__ == "__main__":
    main()
