#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcmctoffitting_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, holds each against its
plain PyTorch version at the forward model's shapes, times both beside
their bounds, and drives the simultFit fits through the library's entry
points at full width (256 walkers x 4 runs x 200k draws, DE move): the
counts estimator (F = 512), and the mc estimator on the literal ODE path
(transport='rk4') with xs_mode 'taylor' and 'exact'.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then non-zero):
  0. a CUDA device is required; print its name and power limit;
  1. build the kernels (one nvcc per source, in parallel) and print the
     build time and the compiler's register report;
  2. K1 Poisson kernel vs plain: Philox known answers, 1M draws at six
     rates (mean/variance z-scores within +-5, >= 99.9% of draws equal),
     and the slice's real (256, 514) rates drawn for 4 runs; the rates
     given per walker equal the rates copied per run, and the seed in a
     device tensor equals the seed by value, draw for draw;
  3. K2 TOF-histogram kernel vs plain on the slice's real lattice (within
     1e-6 of each row's total), the same on a second call, each bin the
     float32 nearest to the float64 sum of its weights, and the
     np.histogram edge cases exactly; then one K1 and one K2 launch in a
     CUDA graph, replayed with two seed tensors;
  4. K4 transport-moments kernel vs plain on one half-step's initial
     energies (128 walkers x 4 runs x 200k): bins equal on >= 99.99% of
     (sample, depth) pairs, moments within 1e-5 of each row's total, and
     per channel against the float64 sums of its energies' channels
     (counts exact, d-channels within their fixed-point steps);
  5. K3 weighted-histogram kernel vs plain on that half-step's transported
     energies and cross sections (5,120 rows x 200k), within 1e-6 of each
     row's total, the same on a second call, and its np.histogram edge
     cases exactly;
  6. kernel and library times at the half-step shapes as device times
     with the host out of them (K1, K2, torch.poisson: 100 launches in a
     replayed CUDA graph; K3, K4: queued behind a launch of their own),
     beside each kernel's bound (and K4's instruction-issue floor), the
     launch floor (an empty kernel in the same graph), the host's enqueue
     cost per call, and a cross-check: events around one call on an idle
     card; the plain versions by events around single calls;
  7. counts: the GPU forward vs the CPU forward on 8 walkers, then the
     full-width fit for both likelihoods (K1 and K2 must be launched);
  8. mc: the GPU forward vs the CPU forward on 8 walkers with the same
     initial energies, for 'taylor' and 'exact' (relative L1 < 1e-4);
     the full-width 'taylor' fit for both likelihoods (K2 and K4 must be
     launched), then a few steps of the 'exact' configuration (K2, K3);
  9. the second cross-check of phase 6: torch.profiler's kernel durations
     of K1 and K2 beside the graph's (last, because a profiler that has
     run makes every later launch dearer for the host).
Every initial log-prob of the mc fits must be finite.
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
from mcmctoffitting_tpu_torch.models.forward import exact_rows_per_chunk
from mcmctoffitting_tpu_torch.ops import cuda_build, cuda_hist, cuda_transport
from mcmctoffitting_tpu_torch.ops import poisson as plain_poisson
from mcmctoffitting_tpu_torch.ops import stopping
from mcmctoffitting_tpu_torch.ops.cuda_poisson import philox_cuda, poisson
from mcmctoffitting_tpu_torch.ops.cuda_tof import (tof_hist_segments,
                                                   tof_hist_segments_plain)
from mcmctoffitting_tpu_torch.utils import data_io, devtime

N_WALKERS, N_RUNS, N_DRAWS = 256, 4, 200_000
N_WARM, N_TIMED = 20, 200            # counts fit
MC_WARM, MC_TIMED = 5, 20            # mc 'taylor' fit
EXACT_WARM, EXACT_TIMED = 1, 3       # mc 'exact' configuration
LAMS = (0.5, 5.0, 10.0, 100.0, 1.0e4, 2.0e5)
# NVIDIA H100 SXM peaks (data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores; the bound counts logf and a division as one
# operation each
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12
# K4's instruction-issue floor, reported beside its bound: one float32
# lane-instruction per lane and cycle (132 SMs x 128 lanes x 1.98 GHz; no
# FMA pairing under -fmad=false), with logf and the IEEE division counted
# as the instructions they issue in a chain in the SASS for sm_90a (logf
# 25; the division's fast path 9: MUFU.RCP, FCHK, five FFMA and the
# branch around the slow path; read by perf/kernel_split.py)
INSTR_RATE, LOGF_INSTR, DIV_INSTR = 33.5e12, 25, 9


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
    """Median time of one call, CUDA events around each call on an idle
    card: the host's enqueue path is inside the interval, so this is for
    the plain versions (many launches each) and as the cross-check of
    what a kernel of a few microseconds is not."""
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


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    float32 operations over the float32 rate."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def poisson_z(counts, lam):
    """Mean and variance z-scores of Poisson counts against their rates
    (elementwise rates; float64 sums)."""
    c, lam = counts.double(), lam.double()
    d2 = ((c - lam) ** 2).sum()
    z_mean = ((c - lam).sum() / lam.sum().sqrt()).item()
    z_var = ((d2 - lam.sum()) / (lam + 2 * lam * lam).sum().sqrt()).item()
    return z_mean, z_var


def phase_poisson(dev, rates_w, n_runs):
    """K1 vs plain; ``rates_w`` (W, F + 2) are the slice's rates per
    walker, drawn for ``n_runs`` runs as the counts path draws them."""
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

    lam = rates_w[:, None].expand(-1, n_runs, -1).contiguous()
    kern = poisson(rates_w, (7, 8), n_runs=n_runs)
    plain = plain_poisson.poisson_ptrs(lam, (7, 8))
    require(torch.equal(kern, poisson(lam, (7, 8))),
            "K1 on rates per walker == K1 on the rates copied per run")
    words = torch.tensor([7, 8], dtype=torch.int64, device=dev)
    require(torch.equal(kern, poisson(rates_w, words, n_runs=n_runs)),
            "K1 with the seed in a device tensor == K1 with it by value")
    log("phase 2b: K1 on (W, F+2) rates with a run count equals K1 on the "
        "expanded (W, R, F+2) rates, and the seed as a device tensor "
        "equals the seed by value, draw for draw")
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
    # both sum float32 weights, ~70 per bin, in different orders: the
    # difference stays below 1e-6 of the row's total weight
    require(bool(torch.all(err <= 1e-6 * total)),
            "K2 kernel vs plain on the slice's lattice")
    again = tof_hist_segments(base, draws, zt, zw, win)
    log(f"phase 3: TOF kernel vs plain on {tuple(base.shape)}: "
        f"max|diff|={err.max().item():g} "
        f"(max rel to row total {(err / total).max().item():.2e}); a second "
        f"call equal: {torch.equal(kern, again)}")
    require(torch.equal(kern, again), "K2 the same on every call")
    # the kernel sums in fixed point and rounds once: every bin is the
    # float32 nearest to the float64 sum of its float32 weights (half an
    # ulp, 6e-8), up to the 2^-39 of the row's total that the fixed point
    # drops of each of the row's samples
    exact = tof_hist_segments_plain(base, draws, zt, zw, win, torch.float64)
    off = (kern.double() - exact).abs()
    log(f"phase 3: TOF kernel vs the float64 sums: max|diff|="
        f"{off.max().item():g} (max rel to the bin "
        f"{(off / exact.abs().clamp_min(1e-30)).max().item():.2e})")
    n_samples = base.shape[-2] * base.shape[-1] * zt.shape[1]
    require(bool(torch.all(off <= 6e-8 * exact.abs()
                           + n_samples * 2.0 ** -39 * total)),
            "K2 kernel: each bin the float32 nearest to its exact sum")

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


def phase_graph(dev, rates_w, n_runs, base, draws, forward):
    """One K1 launch (seed in a device tensor) and one K2 launch captured
    in a CUDA graph and replayed with two seeds: the K1 draws equal the
    uncaptured kernel's and the plain version's for each seed, the K2
    output equals the uncaptured call."""
    zt, zw, win = forward.zt, forward.zw, forward.win
    lam = rates_w[:, None].expand(-1, n_runs, -1).contiguous()
    want_hist = tof_hist_segments(base, draws, zt, zw, win)
    seed = torch.zeros(2, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        counts = poisson(rates_w, seed, n_runs=n_runs)
        hist = tof_hist_segments(base, draws, zt, zw, win)
    drawn = []
    for words in ((11, 12), (0xDEADBEEF, 0x12345678)):
        seed.copy_(torch.tensor(words, dtype=torch.int64))
        counts.zero_()
        hist.zero_()
        graph.replay()
        torch.cuda.synchronize()
        same = (counts == plain_poisson.poisson_ptrs(lam, words))
        require(torch.equal(counts, poisson(rates_w, words, n_runs=n_runs)),
                f"replayed K1 == uncaptured K1 at seed {words}")
        require(same.double().mean().item() >= 0.999,
                f"replayed K1 == plain at seed {words}")
        require(torch.equal(hist, want_hist),
                f"replayed K2 == uncaptured K2 (replay at seed {words})")
        drawn.append(counts.clone())
    require(not torch.equal(*drawn), "a new seed tensor gives new draws")
    log("phase 3b: a CUDA graph of one K1 and one K2 launch, replayed with "
        "two seed tensors: K1 equals the uncaptured kernel and the plain "
        "version for each seed, K2 equals the uncaptured call")


def in_range_bins(e, bins):
    """Bin index of every energy, -1 outside [lo, hi] (the moments'
    binning)."""
    idx, _ = cuda_transport.moment_channels(e, bins)
    return torch.where((e >= bins.lo) & (e <= bins.hi), idx, -1)


def phase_transport(e0, rk4, bins):
    """K4 vs plain on (rows, N) initial energies; returns (max error,
    the plain transported energies, the plain moments)."""
    kern, e_kern = cuda_transport.transport_moments(e0, rk4, bins,
                                                    energies_out=True)
    plain = cuda_transport.transport_moments_plain(e0, rk4, bins)
    n_rows = e0.shape[0]
    e_plain = torch.empty_like(e_kern)
    equal, counts_equal, ratio = 0, True, 0.0
    for start in range(0, n_rows, 32):
        rows = slice(start, start + 32)
        e_plain[rows] = stopping.rk4_transport(rk4, e0[rows])
        equal += (in_range_bins(e_kern[rows], bins)
                  == in_range_bins(e_plain[rows], bins)).sum().item()
        c_eq, r = cuda_transport.moment_check(kern[rows], e_kern[rows],
                                              bins)
        counts_equal, ratio = counts_equal and c_eq, max(ratio, r)
    share = equal / e_kern.numel()
    bits = (e_kern == e_plain).double().mean().item()
    total = plain[:, :, 0].sum(dim=(-2, -1))[:, None, None, None]
    err = (kern - plain).abs()
    rel = (err / total.clamp_min(1.0)).max().item()
    log(f"phase 4: K4 kernel vs plain on {tuple(e0.shape)}: bins equal on "
        f"{share:.6f} of (sample, depth) pairs, energies bitwise equal on "
        f"{bits:.6f}; moments max|diff| {err.max().item():g} ({rel:.2e} of "
        f"the row total); per channel against the float64 sums of its "
        f"energies: counts equal {counts_equal}, d-channels at "
        f"{ratio:.3f} of their tolerance")
    require(share >= 0.9999, "K4 bins equal on >= 99.99% of pairs")
    require(rel <= 1e-5, "K4 moments within 1e-5 of each row's total")
    require(counts_equal, "K4 count channel exact")
    require(ratio <= 1.0, "K4 d-channels within their fixed-point steps")
    return err.max().item(), e_plain, plain


def phase_hist(dev, values, weights, bins):
    """K3 vs plain on (rows, N) values and weights, in row chunks for the
    plain version; then the edge cases."""
    lo, hi, nb = bins
    kern = cuda_hist.weighted_histogram(values, lo, hi, nb, weights)
    max_err, max_rel = 0.0, 0.0
    for start in range(0, values.shape[0], 512):
        rows = slice(start, start + 512)
        plain = cuda_hist.weighted_histogram_plain(values[rows], lo, hi, nb,
                                                   weights[rows])
        err = (kern[rows] - plain).abs()
        total = plain.sum(-1, keepdim=True).clamp_min(1e-30)
        max_err = max(max_err, err.max().item())
        max_rel = max(max_rel, (err / total).max().item())
    again = cuda_hist.weighted_histogram(values, lo, hi, nb, weights)
    log(f"phase 5: K3 kernel vs plain on {tuple(values.shape)}: "
        f"max|diff| {max_err:g} ({max_rel:.2e} of the row total); a second "
        f"call equal: {torch.equal(kern, again)}")
    require(max_rel <= 1e-6, "K3 within 1e-6 of each row's total")
    require(torch.equal(kern, again), "K3 the same on every call")

    edge = torch.tensor([[hi, lo, hi - 0.01, hi + 0.01, lo - 0.1,
                          float("nan"), 0.5 * (lo + hi)]], device=dev)
    edge = torch.nn.functional.pad(edge, (0, 2041), value=hi + 5.0)
    w = torch.ones_like(edge)
    want = torch.zeros((1, nb), device=dev)
    want[0, nb - 1], want[0, 0], want[0, nb // 2] = 2.0, 1.0, 1.0
    got = cuda_hist.weighted_histogram(edge, lo, hi, nb, w)
    require(torch.equal(got, want), "K3 np.histogram edge cases")
    masked = cuda_hist.weighted_histogram(edge, lo, hi, nb, w, n_valid=2)
    want_m = torch.zeros((1, nb), device=dev)
    want_m[0, nb - 1], want_m[0, 0] = 1.0, 1.0
    require(torch.equal(masked, want_m), "K3 valid-length mask")
    log("phase 5: K3 edge cases exact (v == hi, v == lo, outside, NaN, "
        "masked tail)")
    return max_err


def fit(spec, likelihood, dev, truth, n_warm, n_timed, smi, label,
        max_bad=0):
    """Full-width DE fit through the entry points; returns walker-steps/s
    and the acceptance."""
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
    log(f"{label}: {likelihood} likelihood: {n_bad} of {N_WALKERS} "
        f"initial log-probs non-finite")
    require(n_bad <= max_bad,
            f"finite initial log-probs ({label}, {likelihood}: {n_bad} not)")
    warm = sampler.run_mcmc(state, n_warm, logp, move="de")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain = sampler.run_mcmc(warm.state, n_timed, logp, move="de")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    acc = ((warm.n_accepted + chain.n_accepted).sum().item()
           / (N_WALKERS * (n_warm + n_timed)))
    require(chain.positions.shape == (n_timed, N_WALKERS, prob.n_dim)
            and bool(torch.all(torch.isfinite(chain.positions))),
            "chain shape / finite positions")
    require(0.01 < acc < 0.99, f"acceptance {acc} ({label}, {likelihood})")
    rate = n_timed * N_WALKERS / dt
    log(f"{label} ({smi}): {likelihood} likelihood: {n_timed} DE steps x "
        f"{N_WALKERS} walkers in {dt:.3f} s -> {rate:.1f} walker-steps/s "
        f"warm; acceptance {acc:.3f}; final median logp "
        f"{chain.log_probs[-1].median().item():.6g}")
    return rate, acc


def reset_counts():
    for fn in (poisson, tof_hist_segments, cuda_hist.weighted_histogram,
               cuda_transport.transport_moments):
        fn.launches = 0


def read_counts():
    return {"poisson": poisson.launches,
            "tof_hist": tof_hist_segments.launches,
            "weighted_hist": cuda_hist.weighted_histogram.launches,
            "transport_moments": cuda_transport.transport_moments.launches}


def gpu_vs_cpu_mc(problem, cpu_problem, thetas, gen):
    """Spectra of the GPU and CPU forwards from the same initial energies:
    max relative L1 over (walker, run)."""
    spectra = []
    e0 = problem.forward.sample_beam_energies(thetas[:, :4], gen)
    for prob, e in ((problem, e0), (cpu_problem, e0.cpu())):
        fwd, t = prob.forward, thetas.to(e.device)
        grid = fwd.energy_weight_grid(e)
        spectra.append(fwd.spectra(*fwd.lattice(grid, e.mean(-1)),
                                   t[:, 4:4 + N_RUNS]).cpu())
    gpu, cpu = spectra
    require(bool(torch.all(torch.isfinite(gpu))), "finite mc spectra")
    return ((gpu - cpu).abs().sum(-1) / cpu.abs().sum(-1)).max().item()


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
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    truth = np.concatenate([simult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
    spec = simult.default_spec(n_samples=N_DRAWS, sampling="counts")
    require(spec.e0_grid_fine == 512, "F = 512 at 200k draws")
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

    k1_err = phase_poisson(dev, rates.lam, N_RUNS)
    grids, e0_means = forward.grid_and_mean(p0[:, :4],
                                            torch.Generator().manual_seed(3))
    base, draws = forward.lattice(grids, e0_means)
    base, draws = base.contiguous(), draws.contiguous()
    k2_err = phase_tof(dev, base, draws, forward)
    phase_graph(dev, rates.lam, N_RUNS, base, draws, forward)

    # phases 4-5: K4 and K3 on one half-step of the mc path (128 walkers x
    # 4 runs x 200k initial energies from the forward's own draw)
    half = N_WALKERS // 2
    spec_mc = simult.default_spec(N_DRAWS, transport="rk4", sampling="mc")
    spec_ex = simult.default_spec(N_DRAWS, transport="rk4", sampling="mc",
                                  xs_mode="exact")
    require(spec_mc.xs_mode == "taylor" and spec_mc.rk4_substeps == 1,
            "the rk4 preset falls back to xs_mode='taylor'")
    mc_problem = simult.SimultFitProblem(spec_mc, n_runs=N_RUNS, device=dev)
    ex_problem = simult.SimultFitProblem(spec_ex, n_runs=N_RUNS, device=dev)
    fwd_mc, fwd_ex = mc_problem.forward, ex_problem.forward
    rk4, mbins = fwd_mc.rk4, fwd_mc.moment_bins
    e0_h = fwd_mc.sample_beam_energies(
        p0[:half, :4], torch.Generator().manual_seed(5)).reshape(
            half * N_RUNS, N_DRAWS).contiguous()
    k4_err, e_at_x, moments_plain = phase_transport(e0_h, rk4, mbins)
    in_range_pairs = moments_plain[:, :, 0].sum().item()
    del moments_plain
    vals = e_at_x.reshape(-1, N_DRAWS)                    # (5120, N)
    wts = torch.empty_like(vals)
    for start in range(0, vals.shape[0], 512):
        rows = slice(start, start + 512)
        wts[rows] = spec_ex.xs(vals[rows])
    eb = spec_mc.ed_binning
    k3_err = phase_hist(dev, vals, wts, (eb.lo, eb.hi, eb.n))

    # phase 6: times at the half-step shapes, beside the bounds
    lam_h = lam[: half * N_RUNS].contiguous()
    rates_h = rates.lam[:half].contiguous()
    b_h, d_h = base[:half].contiguous(), draws[:half].contiguous()
    zt, zw, win = forward.zt, forward.zw, forward.win
    # K3 as the 'exact' path launches it: one chunk of (walker, run) rows
    chunk_rows = exact_rows_per_chunk(len(rk4.h), N_DRAWS) * len(rk4.h)
    v_c, w_c = vals[:chunk_rows], wts[:chunk_rows]

    def plain_hist():
        for start in range(0, v_c.shape[0], 512):
            cuda_hist.weighted_histogram_plain(
                v_c[start:start + 512], eb.lo, eb.hi, eb.n,
                w_c[start:start + 512])

    def k1_call():          # as the counts path calls it
        return poisson(rates_h, (5, 6), n_runs=N_RUNS)

    def k2_call():
        return tof_hist_segments(b_h, d_h, zt, zw, win)

    def k3_call():
        return cuda_hist.weighted_histogram(v_c, eb.lo, eb.hi, eb.n, w_c)

    def k4_call():
        return cuda_transport.transport_moments(e0_h, rk4, mbins)

    # device times with the host out of them (utils/devtime.py): K1, K2
    # and torch.poisson as 100 launches in a replayed CUDA graph, K3 and K4
    # (0.5 and 8 ms, far above their enqueue) queued behind a launch of
    # their own; the plain versions (many launches each, K1's with a
    # synchronize inside) by events around single calls, as before
    floor_ms = devtime.launch_floor_ms(dev)
    times = {
        "poisson": (devtime.graph_ms(k1_call),
                    cuda_ms(lambda: plain_poisson.poisson_ptrs(lam_h, (5, 6)),
                            reps=20),
                    devtime.graph_ms(lambda: torch.poisson(lam_h))),
        "tof_hist": (devtime.graph_ms(k2_call),
                     cuda_ms(lambda: tof_hist_segments_plain(b_h, d_h, zt,
                                                             zw, win)),
                     None),
        "weighted_hist": (devtime.queued_ms(k3_call, launches=20),
                          cuda_ms(plain_hist, reps=3, warmup=1), None),
        "transport_moments": (devtime.queued_ms(k4_call, launches=10),
                              cuda_ms(lambda: cuda_transport.
                                      transport_moments_plain(e0_h, rk4,
                                                              mbins),
                                      reps=3, warmup=1), None),
    }
    enqueue = {"poisson": devtime.enqueue_us(k1_call),
               "tof_hist": devtime.enqueue_us(k2_call),
               "weighted_hist": devtime.enqueue_us(k3_call, calls=20),
               "transport_moments": devtime.enqueue_us(k4_call, calls=10,
                                                       rounds=3)}
    # cross-check: what events around one call on an idle card give (the
    # host's enqueue path included)
    single = {"poisson": cuda_ms(k1_call), "tof_hist": cuda_ms(k2_call),
              "torch.poisson": cuda_ms(lambda: torch.poisson(lam_h))}
    log(f"phase 6 ({smi}): launch floor (an empty kernel in a replayed "
        f"graph) {floor_ms:.5f} ms; events around one call on an idle "
        f"card: K1 {single['poisson']:.4f}, K2 {single['tof_hist']:.4f}, "
        f"torch.poisson {single['torch.poisson']:.4f} ms")
    # the counts path's draw as it was before K1 read the rates per walker:
    # a copy of the rates along the run axis (one more kernel), then K1
    def k1_with_copy():
        return poisson(rates_h[:, None].expand(half, N_RUNS, -1)
                       .contiguous(), (5, 6))

    log(f"phase 6: K1 behind a copy of the rates along the run axis: "
        f"{devtime.graph_ms(k1_with_copy):.5f} ms, enqueue "
        f"{devtime.enqueue_us(k1_with_copy):.1f} us; K1 on the rates per "
        f"walker: {times['poisson'][0]:.5f} ms, enqueue "
        f"{enqueue['poisson']:.1f} us")
    # bounds: each input read once, each output written once; operations
    # counted at the float32 rate, what these inputs need
    n_lam = lam_h.numel()
    k2_vals = b_h[..., None] + zt                      # (W, R, M, Be, K)
    lo_r = win.lo[:, None, None, None]
    hi_r = win.hi[:, None, None, None]
    k2_in = ((k2_vals >= lo_r) & (k2_vals <= hi_r)).sum().item()
    del k2_vals
    k3_in = ((v_c >= eb.lo) & (v_c <= eb.hi)).sum().item()
    k3_in_full = ((vals >= eb.lo) & (vals <= eb.hi)).sum().item()
    pairs = e0_h.numel() * len(rk4.h)
    # per (sample, depth, substep): four dE/dx (clamp, logf, product, add,
    # division, negation, product) and the RK4 arithmetic, 44; per
    # (sample, depth): two compares, and in range the binning and four
    # atomic adds, 14 more
    k4_ops = 2 * pairs + 14 * in_range_pairs
    bounds = {
        # per rate: one Philox block (~100 integer operations) and the
        # inversion / PTRS arithmetic of one accepted round (~30)
        "poisson": bound(4 * (rates_h.numel() + n_lam), 130 * n_lam),
        # per segment sample: add, product, two compares; in range:
        # subtract, scale, floor, clamp, atomic add
        "tof_hist": bound(4 * (2 * b_h.numel() + 2 * zt.numel()
                               + b_h.shape[0] * N_RUNS * win.n_pad),
                          4 * b_h.numel() * zt.shape[1] + 5 * k2_in),
        # per value: two compares; in range: subtract, scale, floor,
        # clamp, atomic add
        "weighted_hist": bound(4 * (2 * v_c.numel() + v_c.shape[0] * eb.n),
                               2 * v_c.numel() + 5 * k3_in),
        "transport_moments": bound(
            4 * (e0_h.numel() + e0_h.shape[0] * len(rk4.h) * 4 * eb.n),
            44 * rk4.n_substeps * pairs + k4_ops),
    }
    # the same operations with logf and the division as the instructions
    # they issue, at the lane-instruction rate
    k4_instr = ((4 * (5 + LOGF_INSTR + DIV_INSTR) + 16) * rk4.n_substeps
                * pairs + k4_ops)
    issue_floor = {"transport_moments": 1e3 * k4_instr / INSTR_RATE}
    shapes = {"poisson": tuple(lam_h.shape), "tof_hist": tuple(b_h.shape),
              "weighted_hist": tuple(v_c.shape),
              "transport_moments": tuple(e0_h.shape)}
    for name, (k_ms, p_ms, l_ms) in times.items():
        b_ms, b_by = bounds[name]
        log(f"phase 6 ({smi}): {name} {shapes[name]}: kernel {k_ms:.5f} ms, "
            f"plain {p_ms:.4f} ms, library "
            f"{'none' if l_ms is None else f'{l_ms:.4f} ms'}, bound "
            f"{b_ms:.4f} ms ({b_by}), enqueue {enqueue[name]:.1f} us"
            + (f", instruction-issue floor {issue_floor[name]:.4f} ms"
               if name in issue_floor else ""))
    log(f"phase 6: in-range shares: K2 {k2_in / (b_h.numel() * 10):.4f}, "
        f"K3 {k3_in_full / vals.numel():.4f}, K4 "
        f"{in_range_pairs / pairs:.4f}")
    del vals, wts, v_c, w_c, e_at_x, e0_h
    torch.cuda.empty_cache()

    # phase 7: the counts path (the GPU forward against the CPU forward on
    # 8 walkers, same seeds: same Philox stream, so the spectra agree up to
    # rare last-ulp draws and rint flips), then the full-width fit
    cpu_problem = simult.SimultFitProblem(spec, n_runs=N_RUNS, device="cpu")
    small = p0[:8]
    spec_gpu = problem.run_spectra(small, torch.Generator().manual_seed(4))
    spec_cpu = cpu_problem.run_spectra(small.cpu(),
                                       torch.Generator().manual_seed(4))
    spec_gpu = spec_gpu.cpu()
    require(bool(torch.all(torch.isfinite(spec_gpu))), "finite spectra")
    rel_l1 = ((spec_gpu - spec_cpu).abs().sum(-1)
              / spec_cpu.abs().sum(-1)).max().item()
    log(f"phase 7a: counts GPU vs CPU spectra on 8 walkers x {N_RUNS} runs: "
        f"max rel L1 {rel_l1:.2e}")
    require(rel_l1 < 1e-3, "GPU forward vs CPU forward")

    rate, acc = {}, {}
    launches = {}
    reset_counts()
    for likelihood in ("reference", "poisson"):
        # the faithful likelihood is -inf where a Poisson-drawn grid cell
        # rounds to -1 draws and leaves a negative model bin (floor ->
        # gammaln(0)); the JAX package does the same (ROADMAP Queue 3)
        rate[f"counts_{likelihood}"], acc[f"counts_{likelihood}"] = fit(
            spec, likelihood, dev, truth, N_WARM, N_TIMED, smi, "phase 7b",
            max_bad=0 if likelihood == "poisson" else N_WALKERS // 50)
    launches["counts"] = read_counts()
    log(f"phase 7b: launches during the counts fits: {launches['counts']}")
    require(launches["counts"]["poisson"] > 0
            and launches["counts"]["tof_hist"] > 0,
            "K1 and K2 launched on the counts path")

    # phase 8: the mc path on the ODE transport
    small = p0[:8]
    for name, prob, sp in (("taylor", mc_problem, spec_mc),
                           ("exact", ex_problem, spec_ex)):
        cpu_prob = simult.SimultFitProblem(sp, n_runs=N_RUNS, device="cpu")
        rel = gpu_vs_cpu_mc(prob, cpu_prob, small,
                            torch.Generator().manual_seed(6))
        log(f"phase 8a: mc '{name}' GPU vs CPU spectra on 8 walkers x "
            f"{N_RUNS} runs, same initial energies: max rel L1 {rel:.2e}")
        require(rel < 1e-4, f"mc '{name}' GPU forward vs CPU forward")

    reset_counts()
    for likelihood in ("reference", "poisson"):
        rate[f"mc_taylor_{likelihood}"], acc[f"mc_taylor_{likelihood}"] = \
            fit(spec_mc, likelihood, dev, truth, MC_WARM, MC_TIMED, smi,
                "phase 8b (mc, taylor)")
    launches["mc_taylor"] = read_counts()
    log(f"phase 8b: launches during the mc 'taylor' fits: "
        f"{launches['mc_taylor']}")
    require(launches["mc_taylor"]["transport_moments"] > 0
            and launches["mc_taylor"]["tof_hist"] > 0,
            "K4 and K2 launched on the mc 'taylor' path")

    reset_counts()
    rate["mc_exact_poisson"], acc["mc_exact_poisson"] = fit(
        spec_ex, "poisson", dev, truth, EXACT_WARM, EXACT_TIMED, smi,
        "phase 8c (mc, exact)")
    launches["mc_exact"] = read_counts()
    log(f"phase 8c: launches during the mc 'exact' fit: "
        f"{launches['mc_exact']}")
    require(launches["mc_exact"]["weighted_hist"] > 0
            and launches["mc_exact"]["tof_hist"] > 0,
            "K3 and K2 launched on the mc 'exact' path")

    # phase 9: the second cross-check of phase 6's device times, the kernel
    # durations torch.profiler reports for eager calls.  It comes last: once
    # the profiler has run in a process, every later launch costs the host
    # more, which the host-bound counts fit would show (~2 ms per step).
    profiled = {
        "poisson": devtime.profiler_kernel_ms(k1_call, "poisson_kernel"),
        "tof_hist": devtime.profiler_kernel_ms(k2_call, "tof_hist"),
        "torch.poisson": devtime.profiler_kernel_ms(
            lambda: torch.poisson(lam_h), "poisson"),
        "empty": devtime.profiler_kernel_ms(
            lambda: devtime.empty_launch(dev), "empty_kernel")}
    log(f"phase 9 ({smi}): torch.profiler's kernel durations: K1 "
        f"{profiled['poisson']:.5f}, K2 {profiled['tof_hist']:.5f}, "
        f"torch.poisson {profiled['torch.poisson']:.5f}, empty kernel "
        f"{profiled['empty']:.5f} ms")
    for name in ("poisson", "tof_hist"):
        # the graph times a kernel and the card's gap to the next one, the
        # profiler the kernel alone.  Where they are more than 20% apart
        # (or the profiler saw no kernel: NaN), the graph's time is the one
        # reported: it is the card's own clock over 500 launches, while the
        # profiler's durations depend on its tracing being available
        ratio = times[name][0] / profiled[name]
        agree = 0.8 <= ratio <= 1.2
        log(f"phase 9: {name}: graph {times[name][0]:.5f} ms / profiler "
            f"{profiled[name]:.5f} ms = {ratio:.3f}: "
            + ("the two agree" if agree else
               "more than 20% apart, the graph's time is reported"))

    errs = {"poisson": k1_err, "tof_hist": k2_err, "weighted_hist": k3_err,
            "transport_moments": k4_err}
    meta = {
        "poisson": ("poisson.cu", "pallas_poisson.py:68", "counts"),
        "tof_hist": ("tof_hist.cu", "pallas_tof.py:60", "counts"),
        "weighted_hist": ("weighted_hist.cu", "pallas_hist.py:34",
                          "mc_exact"),
        "transport_moments": ("transport_moments.cu", "pallas_forward.py:54",
                              "mc_taylor"),
    }
    kernels = []
    for name, (src, tpu, path) in meta.items():
        k_ms, p_ms, l_ms = times[name]
        b_ms, b_by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"mcmctoffitting_tpu_torch/csrc/{src}",
            "replaces": f"mcmctoffitting_tpu/ops/{tpu}",
            "launches": launches[path][name], "max_abs_err": errs[name],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": l_ms,
            "issue_floor_ms": issue_floor.get(name),
            "enqueue_us": enqueue[name], "launch_floor_ms": floor_ms,
            "profiler_ms": profiled.get(name),
            "single_call_ms": single.get(name)})
    print(json.dumps({"kernels": kernels, "walker_steps_per_s": rate,
                      "acceptance": acc, "launches_by_path": launches}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
