#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcmctoffitting_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, holds each against its
plain PyTorch version at the forward model's shapes, times both, and
drives the simultFit counts-mode fit at full size (256 walkers x 4 runs x
200k draws, F = 512, DE move) through the library's entry points.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  0. a CUDA device is required; print its name and power limit;
  1. build the kernels (nvcc, sm_90a) and print the build time;
  2. K1 Poisson kernel vs plain: Philox known answers, 1M draws at six
     rates (mean/variance z-scores within +-5, >= 99.9% of draws equal),
     and the slice's real (256*4, 514) rate array;
  3. K2 TOF-histogram kernel vs plain on the slice's real lattice and on
     the np.histogram edge cases;
  4. kernel and plain times at the half-step shapes (CUDA events, median);
  5. the GPU forward vs the CPU forward on 8 walkers, then the full-size
     fit for both likelihoods; both kernels must have been launched.
The last three lines: the per-kernel JSON summary, the nvidia-smi line,
and {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from mcmctoffitting_tpu_torch import sampler
from mcmctoffitting_tpu_torch.models import simult
from mcmctoffitting_tpu_torch.ops import cuda_build
from mcmctoffitting_tpu_torch.ops import poisson as plain_poisson
from mcmctoffitting_tpu_torch.ops.cuda_poisson import philox_cuda, poisson
from mcmctoffitting_tpu_torch.ops.cuda_tof import (tof_hist_segments,
                                                   tof_hist_segments_plain)
from mcmctoffitting_tpu_torch.utils import data_io

N_WALKERS, N_RUNS, N_DRAWS = 256, 4, 200_000
N_WARM, N_TIMED = 20, 200
LAMS = (0.5, 5.0, 10.0, 100.0, 1.0e4, 2.0e5)


def require(ok, what):
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg):
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def cuda_ms(fn, reps=30, warmup=3):
    """Median device time of one call, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def poisson_z(counts, lam):
    """Mean and variance z-scores of Poisson counts against their rates
    (elementwise rates; float64 sums)."""
    c, lam = counts.double(), lam.double()
    d2 = ((c - lam) ** 2).sum()
    z_mean = ((c - lam).sum() / lam.sum().sqrt()).item()
    z_var = ((d2 - lam.sum()) / (lam + 2 * lam * lam).sum().sqrt()).item()
    return z_mean, z_var


def phase_poisson(dev, rates):
    kat_in = np.array([[0, 0, 0, 0, 0, 0], [0xFFFFFFFF] * 6,
                       [0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344,
                        0xa4093822, 0x299f31d0]], np.uint32)
    kat_out = np.array([[0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8],
                        [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd],
                        [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]],
                       np.uint32)
    got = philox_cuda(torch.as_tensor(kat_in.view(np.int32), device=dev))
    require(np.array_equal(got.cpu().numpy().view(np.uint32), kat_out),
            "CUDA Philox4x32-10 known-answer vectors")
    log("phase 2: CUDA Philox4x32-10 matches the known-answer vectors")

    for i, lam in enumerate(LAMS):
        lam_t = torch.full((1 << 20,), lam, device=dev)
        seed = (2024, i)
        kern = poisson(lam_t, seed)
        plain = plain_poisson.poisson_ptrs(lam_t, seed)
        same = (kern == plain).double().mean().item()
        zk, zp = poisson_z(kern, lam_t), poisson_z(plain, lam_t)
        log(f"phase 2a: lam={lam:g} kernel z=({zk[0]:+.2f}, {zk[1]:+.2f}) "
            f"plain z=({zp[0]:+.2f}, {zp[1]:+.2f}) equal={same:.6f}")
        require(max(map(abs, zk + zp)) < 5, f"z-scores at lam={lam}")
        require(same >= 0.999, f"kernel == plain at lam={lam}")

    lam = rates.contiguous()
    kern = poisson(lam, (7, 8))
    plain = plain_poisson.poisson_ptrs(lam, (7, 8))
    same = (kern == plain).double().mean().item()
    err = (kern - plain).abs().max().item()
    zk, zp = poisson_z(kern, lam), poisson_z(plain, lam)
    log(f"phase 2b: slice rates {tuple(lam.shape)}: kernel z=({zk[0]:+.2f}, "
        f"{zk[1]:+.2f}) plain z=({zp[0]:+.2f}, {zp[1]:+.2f}) "
        f"equal={same:.6f} max|diff|={err:g}")
    require(max(map(abs, zk + zp)) < 5, "z-scores of the slice's rates")
    require(same >= 0.999, "kernel == plain on the slice's rates")
    return err


def phase_tof(dev, base, draws, forward):
    zt, zw, win = forward.zt, forward.zw, forward.win
    kern = tof_hist_segments(base, draws, zt, zw, win)
    plain = tof_hist_segments_plain(base, draws, zt, zw, win)
    total = (draws[..., None] * zw).sum(dim=(-3, -2, -1))[..., None]
    err = (kern - plain).abs()
    require(bool(torch.all(err <= 1e-5 * plain.abs() + 1e-5 * total)),
            "K2 kernel vs plain on the slice's lattice")
    log(f"phase 3: TOF kernel vs plain on {tuple(base.shape)}: "
        f"max|diff|={err.max().item():g} "
        f"(max rel to row total {(err / total).max().item():.2e})")

    # np.histogram edge cases, exact: v == hi -> last bin, v == lo -> first
    # bin, just outside and NaN -> dropped, padding bins zero
    e_base = torch.zeros((1,) + tuple(base.shape[1:]), device=dev)
    e_draws = torch.zeros_like(e_base)
    e_zt = torch.zeros_like(zt)
    e_zw = torch.zeros_like(zw)
    e_zw[:6, 0] = 1.0
    want = torch.zeros((1, base.shape[1], win.n_pad), device=dev)
    for r in range(base.shape[1]):
        lo, hi, nb1 = (win.lo[r].item(), win.hi[r].item(),
                       win.nb1[r].item())
        e_base[0, r, 0, :6] = torch.tensor(
            [hi, hi + 0.5, lo, lo - 0.5, float("nan"), lo + 1.5])
        e_draws[0, r, 0, :6] = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
        want[0, r, nb1] += 1.0
        want[0, r, 0] += 4.0
        want[0, r, int(1.5 * win.scale[r].item())] += 32.0
    got = tof_hist_segments(e_base, e_draws, e_zt, e_zw, win)
    require(torch.equal(got, want), "K2 np.histogram edge cases")
    log("phase 3: TOF kernel edge cases exact (v == hi, v == lo, outside, "
        "NaN, padding)")
    return err.max().item()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False "
                         "(this smoke test needs an NVIDIA GPU)")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    smi = smi_line()
    log(f"phase 0: {kind}; nvidia-smi: {smi}; torch {torch.__version__} "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    built = cuda_build.load_library()
    log(f"phase 1: kernels built in {built.build_seconds:.1f} s (load "
        f"{time.perf_counter() - t0:.1f} s) -> {built.path}")
    for line in built.ptxas_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    spec = simult.default_spec(n_samples=N_DRAWS, sampling="counts")
    require(spec.e0_grid_fine == 512, "F = 512 at 200k draws")
    truth = np.concatenate([simult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
    problem = simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                      likelihood="poisson", device=dev)
    forward = problem.forward
    observed = data_io.synthesize_observed(9, problem, truth)
    p0 = problem.initial_walkers_from_observed(
        torch.Generator(dev).manual_seed(1), N_WALKERS, observed)
    rates = forward.counts_rates(p0[:, :4])
    lam = rates.lam[:, None].expand(N_WALKERS, N_RUNS, -1).reshape(
        N_WALKERS * N_RUNS, -1)
    require(lam.shape == (1024, 514), f"rate array shape {lam.shape}")

    k1_err = phase_poisson(dev, lam)
    grids, e0_means = forward.grid_and_mean(p0[:, :4],
                                            torch.Generator().manual_seed(3))
    base, draws = forward.lattice(grids, e0_means)
    base, draws = base.contiguous(), draws.contiguous()
    k2_err = phase_tof(dev, base, draws, forward)

    # phase 4: times at the half-step shapes (128 walkers x 4 runs)
    half = N_WALKERS // 2
    lam_h = lam[: half * N_RUNS].contiguous()
    b_h, d_h = base[:half].contiguous(), draws[:half].contiguous()
    zt, zw, win = forward.zt, forward.zw, forward.win
    times = {
        "poisson": (cuda_ms(lambda: poisson(lam_h, (5, 6))),
                    cuda_ms(lambda: plain_poisson.poisson_ptrs(lam_h, (5, 6)),
                            reps=20)),
        "tof_hist": (cuda_ms(lambda: tof_hist_segments(b_h, d_h, zt, zw,
                                                       win)),
                     cuda_ms(lambda: tof_hist_segments_plain(b_h, d_h, zt,
                                                             zw, win))),
    }
    log(f"phase 4 ({smi}): K1 poisson {tuple(lam_h.shape)}: kernel "
        f"{times['poisson'][0]:.4f} ms, plain {times['poisson'][1]:.4f} ms; "
        f"K2 tof_hist {tuple(b_h.shape)}: kernel {times['tof_hist'][0]:.4f} "
        f"ms, plain {times['tof_hist'][1]:.4f} ms")

    # phase 5a: the GPU forward against the CPU forward (plain versions of
    # both kernels) on 8 walkers, same seeds: same Philox stream, so the
    # spectra agree up to rare last-ulp draws and rint flips
    cpu_problem = simult.SimultFitProblem(spec, n_runs=N_RUNS, device="cpu")
    small = p0[:8]
    spec_gpu = problem.run_spectra(small, torch.Generator().manual_seed(4))
    spec_cpu = cpu_problem.run_spectra(small.cpu(),
                                       torch.Generator().manual_seed(4))
    spec_gpu = spec_gpu.cpu()
    require(bool(torch.all(torch.isfinite(spec_gpu))), "finite spectra")
    rel_l1 = ((spec_gpu - spec_cpu).abs().sum(-1)
              / spec_cpu.abs().sum(-1)).max().item()
    log(f"phase 5a: GPU vs CPU spectra on 8 walkers x {N_RUNS} runs: "
        f"max rel L1 {rel_l1:.2e}")
    require(rel_l1 < 1e-3, "GPU forward vs CPU forward")

    # phase 5b: the full-size fit through the library's entry points
    poisson.launches = 0
    tof_hist_segments.launches = 0
    rate = {}
    for likelihood in ("reference", "poisson"):
        prob = simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                       likelihood=likelihood, device=dev)
        obs = data_io.synthesize_observed(9, prob, truth)
        logp = prob.make_log_prob_fn(obs)
        gen = torch.Generator(dev).manual_seed(1)
        walkers = prob.initial_walkers_from_observed(gen, N_WALKERS, obs)
        state = sampler.init_state(walkers, logp, generator=gen,
                                   eval_generator=torch.Generator()
                                   .manual_seed(2))
        n_bad = int((~torch.isfinite(state.log_probs)).sum())
        log(f"phase 5b: {likelihood} likelihood: {n_bad} of {N_WALKERS} "
            f"initial log-probs non-finite")
        # the faithful likelihood is -inf where a Poisson-drawn grid cell
        # rounds to -1 draws and leaves a negative model bin (floor ->
        # gammaln(0)); the JAX package does the same (ROADMAP Queue 3)
        require(n_bad == 0 if likelihood == "poisson"
                else n_bad <= N_WALKERS // 50,
                f"finite initial log-probs ({likelihood}: {n_bad} not)")
        warm = sampler.run_mcmc(state, N_WARM, logp, move="de")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chain = sampler.run_mcmc(warm.state, N_TIMED, logp, move="de")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        acc = ((warm.n_accepted + chain.n_accepted).sum().item()
               / (N_WALKERS * (N_WARM + N_TIMED)))
        require(chain.positions.shape == (N_TIMED, N_WALKERS, prob.n_dim)
                and bool(torch.all(torch.isfinite(chain.positions))),
                "chain shape / finite positions")
        require(0.01 < acc < 0.99, f"acceptance {acc} ({likelihood})")
        rate[likelihood] = N_TIMED * N_WALKERS / dt
        log(f"phase 5b ({smi}): {likelihood} likelihood: {N_TIMED} DE "
            f"steps x {N_WALKERS} walkers in {dt:.3f} s -> "
            f"{rate[likelihood]:.1f} walker-steps/s warm; acceptance "
            f"{acc:.3f}; final median logp "
            f"{chain.log_probs[-1].median().item():.6g}")
    launches = {"poisson": poisson.launches,
                "tof_hist": tof_hist_segments.launches}
    log(f"phase 5b: launches during the fit: {launches}")
    require(all(n > 0 for n in launches.values()),
            "both kernels launched on the main path")

    kernels = [
        {"name": "poisson", "route": "cuda",
         "source": "mcmctoffitting_tpu_torch/csrc/poisson.cu",
         "replaces": "mcmctoffitting_tpu/ops/pallas_poisson.py:68",
         "launches": launches["poisson"], "max_abs_err": k1_err,
         "ms": times["poisson"][0], "plain_ms": times["poisson"][1]},
        {"name": "tof_hist", "route": "cuda",
         "source": "mcmctoffitting_tpu_torch/csrc/tof_hist.cu",
         "replaces": "mcmctoffitting_tpu/ops/pallas_tof.py:60",
         "launches": launches["tof_hist"], "max_abs_err": k2_err,
         "ms": times["tof_hist"][0], "plain_ms": times["tof_hist"][1]},
    ]
    print(json.dumps({"kernels": kernels,
                      "walker_steps_per_s": rate}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
