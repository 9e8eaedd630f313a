#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (mcmctoffitting_tpu_torch) on one
NVIDIA GPU: builds the CUDA kernels from csrc/, holds each against its
plain PyTorch version at the forward models' shapes, times both beside
their bounds, and drives the fits through the library's entry points at
full width (256 walkers x 200k draws, DE move); then the simple family,
the template unfolding and the csi2016 PPC through their CLIs; then
parallel tempering: the shifting-Gaussian study and PT on the TOF
posterior through their CLI, and emcee's PTSampler.
simultFit (4 runs): the counts estimator (F = 512), the mc estimator on
the literal ODE path (transport='rk4') with xs_mode 'taylor' and
'exact', the default mc estimator on the stopping table (e0grid, F = 256) and the 'expected'
estimator.  csi_oneBD (3 runs, Poisson background): the -hardcore counts
fit (400 x 20 grid, F = 1024, bfloat16 A operator of 4096 x 8000) and the
default mc fit (100 x 10 grid, F = 512).

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
     (counts exact, d-channels within their fixed-point steps), and every
     channel the same bits on a second call;
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
  9. the default simultFit estimators: the GPU forward vs the CPU forward
     on 8 walkers for mc on the table (e0grid, same initial energies) and
     for 'expected', then a short fit of each (K2 must be launched);
 10. oneBD: K1 vs plain on the background's (128, 3, 25) rates (levels 0,
     0.5, 10, 1000) and on the hardcore fit's (128) x 3 x 1026 cell rates;
     K2 with one segment vs plain on the hardcore lattice (128, 3, 20,
     400), vs the float64 sums, the same on a second call; their device
     times beside their bounds; the GPU forward vs the CPU forward on 8
     walkers for hardcore counts (float32 and bfloat16 A) and the default
     mc; the full-width hardcore counts fit for both likelihoods (K1
     launched twice and K2 once per log-prob evaluation); a short default
     mc fit;
 12. determinism of the moment sums of mc on the table: on one half-step's
     initial energies (128 walkers x 4 runs x 200k), the fine-cell
     moments (e0grid) and the table 'taylor' moment channels, each called
     twice, equal bit for bit, and equal to the CPU's on the same
     energies (the moment channels on the first 16 of the 512 rows, which
     are summed independently);
 13. the command-line drivers at full width on the card, in process (256
     walkers, 200k draws, DE, 4 burn-in + 8 main steps in segments of 4):
     simultFit counts (corrected likelihood), simultFit at its defaults
     (mc on the table, e0grid) and oneBD -hardcore counts; finite
     quantiles, mainchain.dat parsing back to (8, 256, D), the CLI's
     walker-steps/s line, and K1/K2 launched per forward evaluation as
     the path says (simultFit counts 1/1, mc 0/1, oneBD counts 2/1); then
     one `python -m ...cli.simult_fit -debug 1 -batch 1` subprocess;
 14. exact resume on the card: for simultFit counts and the mc default, 4
     burn-in + 4 main steps, then -resume main.ckpt.npz for 4 more, give
     phase 13's mainchain.dat byte for byte;
 15. K2's backward (the tof_hist_bwd kernel of the autograd Function
     TofHistSegments) vs the float64 gather of the cotangent at each
     sample's bin and vs the autograd of the plain version, at simultFit's
     (256, 4, 10, 50) lattice with K = 10 and oneBD hardcore's (256, 3, 20,
     400) with K = 1 (each a kernel with K fixed at compile time), and at
     simultFit's lattice with its first three segments (the general
     kernel), each gradient within 1e-6 x sum_k |zw| x max|gbar|, the same
     bits on a second call, the np.histogram edge cases exact; its device
     time, bound and enqueue beside K2 forward's, and which kernel served;
 16. the gradient of the differentiable log-prob ('expected', corrected
     likelihood, no rint; oneBD with the background's expectation) on 8
     chains at the fit's initial walkers, the card against the CPU:
     simultFit (4 runs, F = 256) and oneBD (3 runs, 'expo'), relative L2
     <= 1e-3 per chain with the float32 grid stage's values shared (the
     whole gradient printed beside it: the float32 grid's own error sets
     how far two devices' whole gradients can differ);
 17. the gradient samplers through the command-line drivers at full width
     on the card, in process (256 chains, 200k draws, 'expected', -likelihood
     poisson, -maxDepth 6, 10 warm-up + 10 main steps): simultFit -sampler
     nuts and hmc, oneBD -sampler nuts -deterministicBG; finite quantiles,
     mainchain.dat parsing back to (10, 256, D), the CLI's rate line, the
     divergences and mean tree depth of NUTS, and K2 forward and backward
     launched once per gradient evaluation (the forward once more for the
     synthetic data), K1, K3 and K4 never;
 18. the posterior-predictive slice (before phase 11 too): (a) the batched
     forward of PPCSampler.generate on 8 draws at full width (simultFit
     default, oneBD default), the card against the CPU with the same
     thetas and initial energies, spectra and weight grids within 1e-4
     relative L1 per row, the oneBD background's K1 draws all equal to the
     plain version's; (b) cli.ppc on phase 13's chains at the CLI defaults
     (100 draws x 50k, simultFit and oneBD) and at the reference's size
     (500 x 200k, simultFit): bands (3, n_bins), finite, q16 <= q50 <=
     q84, one SDEF si/sp entry per neutron energy, K2 once per chunk of
     128 draws, K1 once per chunk on oneBD, K3 and K4 never; PPC draws/s
     of the CLI's one cold generate() and of 5 warm ones (median, range);
     (c) cli.plot_chain on phase 13's simultFit chain: the diagnostics,
     and the plots or the missing-matplotlib line;
 11. the second cross-check of phase 6: torch.profiler's kernel durations
     of K1 and K2 beside the graph's (after phases 12-18, because a
     profiler that has run makes every later launch dearer for the host);
 18d. last: one short simultFit counts CLI run with -profile DIR in a
     subprocess; its Chrome trace exists and names the tof_hist kernel.
Then the remaining forward models (before phase 11 too):
 19. the simple family: K3 against its plain version on one half-step's
     samples of v2 (50 walkers x 200k, XS weights, 50 bins) and of v0 (25
     x 200k, 25 bins), within 1e-6 of each row's total, the same on a
     second call, rows shared by blocks; its device time beside its bound;
     the log-probs of v0, v1, v2 and v2.5 card vs CPU on 8 walkers with
     the same draws within 1e-5 relative, one K3 launch each; then
     cli.simple_tof in process at the CLI's widths (v0 50 walkers, the
     others 100, 200k draws, 20 steps): finite quantiles, the rate line,
     K3 once per log-prob evaluation, K1, K2 and K4 never;
 20. the templates: K4 in depth tiles against its plain version at
     (128, 200k), M = 100, Be = 150, 4 substeps, phase 4's criteria; its
     device time, plain time, bound and issue floor; K2 with one segment
     on the templates' (32, 4, 100, 150) lattices as phase 3 holds it;
     the templates card vs CPU on the same energies of 4 rows within 1e-4
     relative L1; generate_templates (K4 once, K2 once) timed three
     times; cli.template_fit at 500 walkers x 200 steps with -doML:
     finite medians, the ML fit no worse than its start, the CSV cache
     read back equal to the templates the CLI made;
 21. the csi2016 PPC: PPCSampler.generate card vs CPU on 8 draws with the
     same energies within 1e-4 relative L1, K4 and K2 once for the chunk;
     K4 at a chunk's (500, 50k), M = 20, Be = 100, phase 4's criteria and
     times; cli.ppc -model csi2016 at the CLI defaults (100 draws x 50k)
     on a synthetic skew-normal chain: bands and SDEF card well formed, K4
     and K2 once per chunk, K1 and K3 never; PPC draws/s cold and warm.
Then parallel tempering (before phase 11 too):
 22. (a) the tempered stretch and DE cores and the replica-exchange core
     at (20, 100, 3), the same draws on the card and the CPU: positions,
     log-likelihoods, log-priors, accept masks and swap counts equal; (b)
     cli.shifting_gaussian at its defaults but the PT depth (ensemble 100
     x 500, then PT 20 temperatures x 100 walkers, 500 + 5000 steps thin
     10, half the defaults' 1000 + 10000): PT and
     ensemble walker-steps/s, every rung's swap acceptance in (0, 1), the
     cold medians of sigma and 5m + b near the truth, ln Z finite with an
     error below 1; (c) -model tof at full width (20 x 100 walkers, 2 runs,
     50k draws, 20 + 60 steps): PT walker-steps/s, device ms per step
     (torch.profiler over 3 steps; then the analytic step's over 20), K1
     and K2 once per half-update, peak
     device memory, initial log-likelihoods finite on >= 98% of the
     walkers, a finite beamE span, swap acceptances in [0, 1]; K1 and K2
     at one half-update's shapes ((1000) x 2 rates, (1000, 2, 10, 50)
     lattice) against their plain versions, with times and bounds; (d)
     compat.emcee.PTSampler with a torch log-likelihood on the card,
     sample -> reset -> sample: chain (T, W, S, D), lnlikelihood (T, W, S).
Then walker sharding over torch.distributed ranks (before phase 22):
 23. (a) K1 with a counter offset on the slice's (256) x 4 x 514 rates:
     rows [128, 256) drawn alone with offset 128 x 4 x 514 equal the full
     launch's (torch.equal), offset 0 the launch without one, a shard of
     every rung (blocks) its rows; the kernel against its plain version at
     the offset; device ms with offset 0 and with an offset; (b) a
     one-rank NCCL group at full width: make_sharded_logp_batch equals the
     plain evaluator bit for bit on 256 and 128 walkers; (c) two gloo
     ranks sharing cuda:0 (parallel/launch.py), 20 DE steps of the
     full-width counts fit: contract A against one process (positions rtol
     2e-5, log-probs rtol 2e-4; whether bitwise is printed), contract C,
     K1 and K2 once per evaluation on each rank's shard, walker-steps/s
     (not a scaling figure); (d) make_sharded_pt_batch over the two ranks,
     -model tof (20 x 100 walkers, 2 runs, 50k draws, 5 steps) against the
     unsharded sample_pt, contract A; (e) cli.simult_fit -mesh 2 on a
     one-GPU host: capped to one GPU, says so, and writes the -mesh 1
     chain byte for byte.
Then posterior parity with the JAX package (before phase 23):
 24. (a) the same-theta density parity of eight cases at full width
     against the JAX package's values in perf/parity/ (made on the CPU by
     perf/parity_reference.py): simultFit counts, oneBD -hardcore counts,
     simultFit mc default, mc on rk4 'taylor' and 'exact', counts with the
     faithful likelihood, the simple family's v2 (R = 16 evaluations at
     each of 48 thetas: the JAX tool's spread < max(5 noise, 1 nat) and
     chi2/dof <= 1 + 4 sqrt(2 / 47) on the finite repeats, and the -inf
     shares' two-proportion z < 4) and 'expected' (centred spread < 0.25
     nats, gradient relative L2 < 0.25 at every theta and < 0.01 in the
     median); K1-K4 and K2's backward launched as each path says; (b) the
     port's DE chains of simultFit counts, oneBD -hardcore counts and
     simple v2 at the JAX chains' walkers and steps, their dz tables
     against the JAX chain's summary: worst |dz| < 0.25 and worst |z_se|
     < 4, z_se in the batch-median standard error (the tool's printed
     beside it); (c) one seed of PT -model tof (the reference's cut of
     its steps): ln Z within 4 noise of the JAX seeds' and the cold
     chain's dz table against theirs.
Then the counts estimator's rate stage (after phase 3b):
 25. csrc/counts_rates.cu against ops/e0grid.py::counts_lambdas at both
     counts presets' half-step shapes (simultFit: 128 walkers, F = 512,
     truncated, the parameters a column view of the walkers; oneBD
     hardcore: 128, F = 1,024, untruncated): every field the same bits;
     the kernel's device time (100 launches in a replayed CUDA graph)
     beside its bytes bound and the plain stage's device time (its
     operations in a replayed graph), and the host's enqueue of each;
     in a segment of 10 DE steps with the spans on, one launch for every
     mcmctof.logp call.
Every initial log-prob of the mc fits must be finite.
The last three lines: the per-kernel JSON summary, the nvidia-smi line,
and {"ok": true, "device": {...}}.
"""
import contextlib
import ctypes
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from mcmctoffitting_tpu_torch import parallel, sampler
from mcmctoffitting_tpu_torch.cli import _driver as cli_driver
from mcmctoffitting_tpu_torch.cli import csi_onebd as cli_onebd
from mcmctoffitting_tpu_torch.cli import plot_chain as cli_plot_chain
from mcmctoffitting_tpu_torch.cli import ppc as cli_ppc
from mcmctoffitting_tpu_torch.cli import shifting_gaussian as cli_sg
from mcmctoffitting_tpu_torch.cli import simple_tof as cli_simple
from mcmctoffitting_tpu_torch.cli import simult_fit as cli_simult
from mcmctoffitting_tpu_torch.cli import template_fit as cli_template
from mcmctoffitting_tpu_torch.compat import emcee as emcee_shim
from mcmctoffitting_tpu_torch.models import (csi2016, onebd, simple, simult,
                                             templates)
from mcmctoffitting_tpu_torch.models import problem as problem_mod
from mcmctoffitting_tpu_torch.models import shifting_gaussian as sg_model
from mcmctoffitting_tpu_torch.models.forward import exact_rows_per_chunk
from mcmctoffitting_tpu_torch.ops import cuda_build, cuda_hist, cuda_transport
from mcmctoffitting_tpu_torch.ops import poisson as plain_poisson
from mcmctoffitting_tpu_torch.ops import e0grid, stopping
from mcmctoffitting_tpu_torch.ops.cuda_poisson import philox_cuda, poisson
from mcmctoffitting_tpu_torch.ops.cuda_rates import counts_rates
from mcmctoffitting_tpu_torch.ops.cuda_tof import (
    tof_hist_backward_variant, tof_hist_segments, tof_hist_segments_backward,
    tof_hist_segments_bwd_plain, tof_hist_segments_plain)
from mcmctoffitting_tpu_torch.parallel import distributed as parallel_dist
from mcmctoffitting_tpu_torch.parallel import launch as parallel_launch
from mcmctoffitting_tpu_torch.parallel import mesh as parallel_mesh
from mcmctoffitting_tpu_torch.utils import chain_io, data_io, devtime, parity
from mcmctoffitting_tpu_torch.utils import profiling
from mcmctoffitting_tpu_torch.utils import ppc as ppc_mod

N_WALKERS, N_RUNS, N_DRAWS = 256, 4, 200_000
N_WARM, N_TIMED = 20, 200            # counts fit
MC_WARM, MC_TIMED = 5, 20            # mc 'taylor' fit
EXACT_WARM, EXACT_TIMED = 1, 2       # mc 'exact' configuration
SHORT_WARM, SHORT_TIMED = 3, 10      # the default mc fits
ONEBD_RUNS = 3
ONEBD_WARM, ONEBD_TIMED = 20, 100    # oneBD hardcore counts fit
GRAD_WARM, GRAD_MAIN, GRAD_DEPTH = 10, 10, 6   # gradient samplers' CLIs
BG_LEVELS = (0.0, 0.5, 10.0, 1000.0)
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


def phase_tof(dev, base, draws, forward, label="phase 3"):
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
    log(f"{label}: TOF kernel vs plain on {tuple(base.shape)} "
        f"(K = {zt.shape[1]}): "
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
    log(f"{label}: TOF kernel vs the float64 sums: max|diff|="
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
    log(f"{label}: TOF kernel edge cases exact (v == hi, v == lo, outside, "
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


def phase_counts_rates(dev, smi):
    """Phase 25: the rate stage's kernel against counts_lambdas at the
    half-step shapes of both counts presets, bits and device times.
    Returns {preset: kernel ms, plain ms, bound ms, enqueue us}."""
    out = {}
    for name, spec, problem_of, truth in (
            ("simultfit", simult.default_spec(N_DRAWS, sampling="counts"),
             simult_problem, np.concatenate([simult.GUESS_SHARED,
                                             np.full(N_RUNS, 5.0e4)])),
            ("onebd_hardcore", onebd.default_spec(N_DRAWS, hardcore=True,
                                                  sampling="counts"),
             onebd_problem, data_io.ONEBD_TRUTH)):
        problem = problem_of(spec, "poisson", dev)
        forward = problem.forward
        observed = data_io.synthesize_observed(9, problem, truth)
        p0 = problem.initial_walkers_from_observed(
            torch.Generator(dev).manual_seed(1), N_WALKERS, observed)
        params = problem.shared_params(p0[:N_WALKERS // 2])
        grid = forward.e0grid
        args = (spec.n_samples, spec.truncated, spec.moment_closure)

        def kernel():
            return counts_rates(grid, params, *args)

        def plain():
            return e0grid.counts_lambdas(grid, params[:, 0], params[:, 1],
                                         params[:, 2], params[:, 3], *args)

        launches = counts_rates.launches
        got, want = kernel(), plain()
        require(counts_rates.launches == launches + 1,
                "counts_rates: one launch a call")
        err = 0.0
        for field, g, w in zip(e0grid.CountsRates._fields, got, want):
            require(g.shape == w.shape, f"phase 25 ({name}): {field} shape")
            # NaN equal to NaN; a NaN against a number, or infinities that
            # differ, count as an infinite error
            same = (g == w) | (torch.isnan(g) & torch.isnan(w))
            gap = torch.nan_to_num((g - w).abs(), nan=float("inf"))
            err = max(err, torch.where(same, 0.0, gap).max().item())
        require(err == 0.0, f"phase 25 ({name}): every field the plain "
                f"version's values (max |got - want| {err})")
        w_, f = params.shape[0], grid.n_fine
        n_bytes = 4 * (w_ * (5 * f + 5) + 4 * w_ + (f + 1))
        b_ms, b_by = bound(n_bytes, 0)
        k_ms = devtime.graph_ms(kernel)
        p_ms = devtime.graph_ms(plain, launches=5)
        k_us, p_us = devtime.enqueue_us(kernel), devtime.enqueue_us(
            plain, calls=20)
        # a segment of 10 DE steps with the spans on: one launch for
        # every mcmctof.logp call
        logp = problem.make_log_prob_fn(observed)
        state = sampler.init_state(
            p0, logp, generator=torch.Generator(dev).manual_seed(2),
            eval_generator=torch.Generator().manual_seed(3))
        launches = counts_rates.launches
        with profiling.spans() as rec:
            sampler.run_mcmc(state, 10, logp, move="de")
        torch.cuda.synchronize()
        n_logp = rec.summary()["mcmctof.logp"]["calls"]
        n_launched = counts_rates.launches - launches
        require(n_launched == n_logp, f"phase 25 ({name}): {n_launched} "
                f"launches in {n_logp} mcmctof.logp calls")
        out[name] = {"shape": [w_, f], "max_abs_err": err,
                     "kernel_ms": k_ms, "plain_ms": p_ms,
                     "bound_ms": b_ms, "enqueue_us": k_us,
                     "plain_enqueue_us": p_us, "segment_logp_calls": n_logp,
                     "segment_launches": n_launched}
        log(f"phase 25 ({smi}): {name} rates ({w_}, F = {f}, truncated "
            f"{spec.truncated}, {spec.moment_closure}): max |got - want| "
            f"{err} over every field; kernel {k_ms:.5f} ms, plain stage {p_ms:.5f} ms "
            f"(device), bound {b_ms:.5f} ms ({b_by}, {n_bytes} B), "
            f"enqueue {k_us:.1f} us (plain {p_us:.1f} us); a segment of 10 "
            f"DE steps, spans on: {n_launched} launches, {n_logp} "
            f"mcmctof.logp calls")
    return out


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
    k4_second_call(e0, rk4, bins, kern, "phase 4")
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


def simult_problem(spec, likelihood, dev):
    return simult.SimultFitProblem(spec, n_runs=N_RUNS,
                                   likelihood=likelihood, device=dev)


def onebd_problem(spec, likelihood, dev):
    return onebd.OneBDProblem(spec, n_runs=ONEBD_RUNS, likelihood=likelihood,
                              device=dev)


def fit(spec, likelihood, dev, truth, n_warm, n_timed, smi, label,
        max_bad=0, make_problem=simult_problem):
    """Full-width DE fit through the entry points; returns walker-steps/s,
    the acceptance, and the launch counts of the fit beside its number of
    log-prob evaluations: every count is set to 0 once the data are
    synthesised and read when the chain has run."""
    prob = make_problem(spec, likelihood, dev)
    obs = data_io.synthesize_observed(9, prob, truth)
    logp_fn = prob.make_log_prob_fn(obs)
    evals = [0]

    def logp(thetas, generator):
        evals[0] += 1
        return logp_fn(thetas, generator)

    reset_counts()
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
    used = read_counts()
    used["log_prob_evaluations"] = evals[0]
    return rate, acc, used


def add_counts(*used):
    """Launch counts of several fits, summed."""
    return {name: sum(u[name] for u in used) for name in used[0]}


def reset_counts():
    for fn in (poisson, tof_hist_segments, cuda_hist.weighted_histogram,
               cuda_transport.transport_moments, counts_rates):
        fn.launches = 0
    tof_hist_segments.backward_launches = 0


def read_counts():
    return {"poisson": poisson.launches,
            "tof_hist": tof_hist_segments.launches,
            "K2-bwd": tof_hist_segments.backward_launches,
            "weighted_hist": cuda_hist.weighted_histogram.launches,
            "transport_moments": cuda_transport.transport_moments.launches,
            "counts_rates": counts_rates.launches}


def gpu_vs_cpu_mc(problem, cpu_problem, thetas, gen):
    """Spectra of the GPU and CPU forwards from the same initial energies
    (and, with a background, the same background seed): max relative L1
    over (walker, run)."""
    spectra = []
    params, _, _ = problem.split_theta(thetas)
    e0 = problem.forward.sample_beam_energies(params, gen)
    for prob, e in ((problem, e0), (cpu_problem, e0.cpu())):
        fwd = prob.forward
        _, scales, bg_levels = prob.split_theta(thetas.to(e.device))
        grid = fwd.energy_weight_grid(e)
        background = (None if bg_levels is None else fwd.background(
            bg_levels, torch.Generator().manual_seed(12)))
        spectra.append(fwd.spectra(*fwd.lattice(grid, e.mean(-1)), scales,
                                   background).cpu())
    gpu, cpu = spectra
    require(bool(torch.all(torch.isfinite(gpu))), "finite mc spectra")
    return ((gpu - cpu).abs().sum(-1) / cpu.abs().sum(-1)).max().item()


def gpu_vs_cpu_seeded(problem, cpu_problem, thetas, seed):
    """Spectra of the GPU and CPU forwards with the same host seed (the
    counts and the background draw from the same Philox stream on both;
    'expected' draws nothing): max relative L1 over (walker, run)."""
    gpu = problem.run_spectra(thetas,
                              torch.Generator().manual_seed(seed)).cpu()
    cpu = cpu_problem.run_spectra(thetas.cpu(),
                                  torch.Generator().manual_seed(seed))
    require(bool(torch.all(torch.isfinite(gpu))), "finite spectra")
    return ((gpu - cpu).abs().sum(-1) / cpu.abs().sum(-1)).max().item()


def phase_simult_defaults(dev, smi, truth, p0, rate, acc, launches):
    """Phase 9: simultFit's default mc estimator (table, e0grid, F = 256)
    and the 'expected' estimator: GPU vs CPU on 8 walkers, a short fit."""
    spec_mc = simult.default_spec(N_DRAWS)
    spec_ev = simult.default_spec(N_DRAWS, sampling="expected")
    require((spec_mc.sampling, spec_mc.transport, spec_mc.xs_mode,
             spec_mc.e0_grid_fine) == ("mc", "table", "e0grid", 256),
            "simult.default_spec() is mc on the table through the e0grid")
    small = p0[:8]
    rel = gpu_vs_cpu_mc(simult_problem(spec_mc, "poisson", dev),
                        simult_problem(spec_mc, "poisson", "cpu"), small,
                        torch.Generator().manual_seed(6))
    log(f"phase 9a: simultFit mc default (table, e0grid) GPU vs CPU "
        f"spectra on 8 walkers x {N_RUNS} runs, same initial energies: max "
        f"rel L1 {rel:.2e}")
    require(rel < 1e-4, "mc default GPU forward vs CPU forward")
    rel = gpu_vs_cpu_seeded(simult_problem(spec_ev, "poisson", dev),
                            simult_problem(spec_ev, "poisson", "cpu"),
                            small, 4)
    log(f"phase 9a: simultFit 'expected' GPU vs CPU spectra on 8 walkers x "
        f"{N_RUNS} runs: max rel L1 {rel:.2e}")
    require(rel < 1e-4, "'expected' GPU forward vs CPU forward")
    for name, spec, steps in (("mc_default", spec_mc,
                               (SHORT_WARM, SHORT_TIMED)),
                              ("expected", spec_ev, (N_WARM, N_TIMED))):
        # as on the counts path, a grid cell of the A contraction can be
        # negative and round to -1 draws: the faithful likelihood of such
        # a walker is -inf (at most 2% of the starts)
        key = f"{name}_reference"
        rate[key], acc[key], launches[f"simult_{name}"] = fit(
            spec, "reference", dev, truth, *steps, smi,
            f"phase 9b (simultFit, {name})", max_bad=N_WALKERS // 50)
        log(f"phase 9b: launches during the simultFit {name} fit: "
            f"{launches[f'simult_{name}']}")
        require(launches[f"simult_{name}"]["tof_hist"] > 0,
                f"K2 launched on the simultFit {name} path")
        require(launches[f"simult_{name}"]["poisson"] == 0,
                f"K1 not launched on the simultFit {name} path")


def phase_onebd(dev, smi, rate, acc, launches):
    """Phase 10: the csi_oneBD fits.  Returns what the kernels line says
    of K1 and K2 at the oneBD shapes."""
    half = N_WALKERS // 2
    truth = data_io.ONEBD_TRUTH
    t0 = time.perf_counter()
    spec_hc = onebd.default_spec(N_DRAWS, hardcore=True, sampling="counts")
    build_s = time.perf_counter() - t0
    tab = spec_hc.e0_grid_table
    require((spec_hc.ed_binning.n, spec_hc.x_binning.n, spec_hc.e0_grid_fine,
             spec_hc.a_dtype) == (400, 20, 1024, "bfloat16")
            and tab.a_matrix.shape == (4096, 8000),
            "the hardcore counts preset: 400 x 20 grid, F = 1024, bf16 A")
    log(f"phase 10: the hardcore A operator {tab.a_matrix.shape} "
        f"({tab.a_matrix.nbytes / 1e6:.0f} MB float32) built on the host in "
        f"{build_s:.1f} s")
    problem = onebd_problem(spec_hc, "poisson", dev)
    forward = problem.forward
    observed = data_io.synthesize_observed(9, problem, truth)
    p0 = problem.initial_walkers_from_observed(
        torch.Generator(dev).manual_seed(1), N_WALKERS, observed)
    params, scales, bg = problem.split_theta(p0[:half])

    # K1 on the background's rates: (128, 3, 25), each row 25 equal rates
    levels = torch.tensor(BG_LEVELS, device=dev)[
        torch.arange(half * ONEBD_RUNS, device=dev) % len(BG_LEVELS)]
    lam_bg = levels.reshape(half, ONEBD_RUNS, 1).expand(
        -1, -1, forward.win.n_pad).contiguous()
    kern = poisson(lam_bg, (31, 32))
    plain = plain_poisson.poisson_ptrs(lam_bg, (31, 32))
    same = (kern == plain).double().mean().item()
    k1_bg_err = (kern - plain).abs().max().item()
    require(bool(torch.all(kern[lam_bg == 0] == 0)), "K1: rate 0 draws 0")
    require(same == 1.0 and k1_bg_err == 0,
            "K1 == plain on the background's rates, every draw")
    for level in BG_LEVELS[1:]:
        pick = lam_bg == level
        z = poisson_z(kern[pick], lam_bg[pick])
        log(f"phase 10a: K1 on background rates {tuple(lam_bg.shape)}: "
            f"level {level:g}: z=({z[0]:+.2f}, {z[1]:+.2f})")
        require(max(map(abs, z)) < 5, f"K1 z-scores at level {level}")
    log(f"phase 10a: K1 vs plain on the background's rates: equal="
        f"{same:.6f}, max|diff|={k1_bg_err:g}, rate 0 -> 0")

    # K1 on the hardcore cell rates, (128) x 3 x 1026
    rates = forward.counts_rates(params)
    require(rates.lam.shape == (half, 1026), "hardcore rates (128, 1026)")
    lam_c = rates.lam[:, None].expand(-1, ONEBD_RUNS, -1).contiguous()
    kern = poisson(rates.lam, (33, 34), n_runs=ONEBD_RUNS)
    plain = plain_poisson.poisson_ptrs(lam_c, (33, 34))
    same = (kern == plain).double().mean().item()
    k1_cells_err = (kern - plain).abs().max().item()
    zk = poisson_z(kern, lam_c)
    log(f"phase 10a: K1 vs plain on the hardcore cell rates "
        f"{tuple(lam_c.shape)}: z=({zk[0]:+.2f}, {zk[1]:+.2f}) "
        f"equal={same:.6f} max|diff|={k1_cells_err:g}")
    require(max(map(abs, zk)) < 5 and same == 1.0 and k1_cells_err == 0,
            "K1 == plain on the hardcore cell rates, every draw")

    # K2 with one segment on the hardcore lattice (128, 3, 20, 400)
    grids, e0_means = forward.grid_and_mean(params,
                                            torch.Generator().manual_seed(3))
    base, draws = forward.lattice(grids, e0_means)
    require(base.shape == (half, ONEBD_RUNS, 20, 400)
            and forward.zt.shape == (400, 1), "hardcore lattice, K = 1")
    k2_err = phase_tof(dev, base, draws, forward, "phase 10b")

    def k1_bg_call():
        return poisson(lam_bg, (5, 6))

    def k1_cells_call():
        return poisson(rates.lam, (5, 6), n_runs=ONEBD_RUNS)

    def k2_call():
        return tof_hist_segments(base, draws, forward.zt, forward.zw,
                                 forward.win)

    floor_ms = devtime.launch_floor_ms(dev)
    ms = devtime.graphs_in_turns({"k1_bg": k1_bg_call,
                                  "k1_cells": k1_cells_call,
                                  "k2": k2_call})
    win = forward.win
    vals = base[..., None] + forward.zt
    k2_in = ((vals >= win.lo[:, None, None, None])
             & (vals <= win.hi[:, None, None, None])).sum().item()
    del vals
    bounds = {
        "k1_bg": bound(8 * lam_bg.numel(), 130 * lam_bg.numel()),
        "k1_cells": bound(4 * (rates.lam.numel() + lam_c.numel()),
                          130 * lam_c.numel()),
        "k2": bound(4 * (2 * base.numel() + 2 * forward.zt.numel()
                         + half * ONEBD_RUNS * win.n_pad),
                    4 * base.numel() + 5 * k2_in),
    }
    plain_ms = {
        "k1_bg": cuda_ms(lambda: plain_poisson.poisson_ptrs(lam_bg, (5, 6)),
                         reps=10),
        "k1_cells": cuda_ms(lambda: plain_poisson.poisson_ptrs(lam_c, (5, 6)),
                            reps=10),
        "k2": cuda_ms(lambda: tof_hist_segments_plain(
            base, draws, forward.zt, forward.zw, win)),
    }
    library_ms = {"k1_bg": devtime.graph_ms(lambda: torch.poisson(lam_bg)),
                  "k1_cells": devtime.graph_ms(lambda: torch.poisson(lam_c)),
                  "k2": None}
    shapes = {"k1_bg": tuple(lam_bg.shape), "k1_cells": tuple(lam_c.shape),
              "k2": tuple(base.shape)}
    for name in ms:
        lib = library_ms[name]
        log(f"phase 10c ({smi}): {name} {shapes[name]}: kernel "
            f"{ms[name]:.5f} ms, plain {plain_ms[name]:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.5f} ms'}, bound "
            f"{bounds[name][0]:.5f} ms ({bounds[name][1]}), launch floor "
            f"{floor_ms:.5f} ms")
    log(f"phase 10c: K2 in-range share {k2_in / base.numel():.4f}")

    # GPU vs CPU forwards on 8 walkers at full width
    small = p0[:8]
    spec_f32 = dataclasses.replace(spec_hc, a_dtype="float32")
    for name, sp in (("bfloat16 A", spec_hc), ("float32 A", spec_f32)):
        rel = gpu_vs_cpu_seeded(onebd_problem(sp, "poisson", dev),
                                onebd_problem(sp, "poisson", "cpu"), small, 4)
        log(f"phase 10d: oneBD hardcore counts ({name}) GPU vs CPU spectra "
            f"on 8 walkers x {ONEBD_RUNS} runs: max rel L1 {rel:.2e}")
        require(rel < 1e-3, f"oneBD hardcore counts ({name}) GPU vs CPU")
    spec_mc = onebd.default_spec(N_DRAWS)
    require((spec_mc.ed_binning.n, spec_mc.x_binning.n, spec_mc.e0_grid_fine,
             spec_mc.sampling) == (100, 10, 512, "mc"),
            "the default oneBD preset: mc, 100 x 10 grid, F = 512")
    mc_gpu = onebd_problem(spec_mc, "poisson", dev)
    obs_mc = data_io.synthesize_observed(9, mc_gpu, truth)
    p0_mc = mc_gpu.initial_walkers_from_observed(
        torch.Generator(dev).manual_seed(1), 8, obs_mc)
    rel = gpu_vs_cpu_mc(mc_gpu, onebd_problem(spec_mc, "poisson", "cpu"),
                        p0_mc, torch.Generator().manual_seed(6))
    log(f"phase 10d: oneBD mc default GPU vs CPU spectra on 8 walkers x "
        f"{ONEBD_RUNS} runs, same initial energies: max rel L1 {rel:.2e}")
    require(rel < 1e-4, "oneBD mc default GPU forward vs CPU forward")
    del mc_gpu, problem, forward

    # the slice's path at full width: the hardcore counts fit
    used = {}
    for likelihood in ("reference", "poisson"):
        key = f"onebd_hardcore_counts_{likelihood}"
        rate[key], acc[key], used[likelihood] = fit(
            spec_hc, likelihood, dev, truth, ONEBD_WARM, ONEBD_TIMED, smi,
            "phase 10e (oneBD, hardcore counts)",
            max_bad=0 if likelihood == "poisson" else N_WALKERS // 50,
            make_problem=onebd_problem)
        n_evals = used[likelihood]["log_prob_evaluations"]
        log(f"phase 10e: launches during the {likelihood} fit: "
            f"{used[likelihood]}")
        require(used[likelihood]["poisson"] == 2 * n_evals
                and used[likelihood]["tof_hist"] == n_evals
                and used[likelihood]["counts_rates"] == n_evals,
                "K1 launched twice, K2 and the rate kernel once per "
                "log-prob evaluation")
    launches["onebd_hardcore_counts"] = add_counts(*used.values())

    key = "onebd_mc_default_reference"
    rate[key], acc[key], launches["onebd_mc_default"] = fit(
        spec_mc, "reference", dev, truth, SHORT_WARM, SHORT_TIMED, smi,
        "phase 10f (oneBD, mc default)", max_bad=N_WALKERS // 50,
        make_problem=onebd_problem)
    log(f"phase 10f: launches during the oneBD mc fit: "
        f"{launches['onebd_mc_default']}")
    n_evals = launches["onebd_mc_default"]["log_prob_evaluations"]
    require(launches["onebd_mc_default"]["poisson"] == n_evals
            and launches["onebd_mc_default"]["tof_hist"] == n_evals,
            "K1 (background) and K2 launched once per evaluation")

    return {
        "a_build_seconds": build_s,
        "poisson": [
            {"shape": list(shapes[n]), "what": what, "ms": ms[n],
             "plain_ms": plain_ms[n], "library_ms": library_ms[n],
             "bound_ms": bounds[n][0], "bound_by": bounds[n][1],
             "launch_floor_ms": floor_ms, "max_abs_err": err}
            for n, what, err in (("k1_bg", "background", k1_bg_err),
                                 ("k1_cells", "hardcore cell counts",
                                  k1_cells_err))],
        "tof_hist": [
            {"shape": list(shapes["k2"]), "what": "hardcore lattice, K = 1",
             "ms": ms["k2"], "plain_ms": plain_ms["k2"], "library_ms": None,
             "bound_ms": bounds["k2"][0], "bound_by": bounds["k2"][1],
             "launch_floor_ms": floor_ms, "max_abs_err": k2_err}],
    }


def phase_determinism(dev, p0):
    """Phase 12: the moment sums of mc on the table, twice on the card
    and once on the CPU, on one half-step's initial energies."""
    half = N_WALKERS // 2
    spec = simult.default_spec(N_DRAWS)
    fwd = simult_problem(spec, "poisson", dev).forward
    e0 = fwd.sample_beam_energies(p0[:half, :4],
                                  torch.Generator().manual_seed(21))
    first = e0grid.fine_cell_moments(fwd.e0grid, e0)
    again = e0grid.fine_cell_moments(fwd.e0grid, e0)
    cpu_fwd = simult_problem(spec, "poisson", "cpu").forward
    on_cpu = e0grid.fine_cell_moments(cpu_fwd.e0grid, e0.cpu())
    log(f"phase 12: fine-cell moments {tuple(first.shape)} of "
        f"{tuple(e0.shape)} energies: two calls equal "
        f"{torch.equal(first, again)}, equal to the CPU's "
        f"{torch.equal(first.cpu(), on_cpu)}")
    require(torch.equal(first, again), "fine-cell moments: two calls equal")
    require(torch.equal(first.cpu(), on_cpu),
            "fine-cell moments: the card's equal the CPU's bit for bit")
    del first, again, on_cpu, cpu_fwd

    spec_t = simult.default_spec(N_DRAWS, xs_mode="taylor")
    fwd_t = simult_problem(spec_t, "poisson", dev).forward
    rows = e0.reshape(-1, N_DRAWS)
    n_x, mbins = spec_t.x_binning.n, fwd_t.moment_bins
    first = cuda_transport.energy_moments(fwd_t.transport, rows, n_x, mbins)
    again = cuda_transport.energy_moments(fwd_t.transport, rows, n_x, mbins)
    cpu_t = simult_problem(spec_t, "poisson", "cpu").forward
    on_cpu = cuda_transport.energy_moments(cpu_t.transport, rows[:16].cpu(),
                                           n_x, cpu_t.moment_bins)
    log(f"phase 12: table 'taylor' moment channels {tuple(first.shape)}: "
        f"two calls equal {torch.equal(first, again)}, the first 16 rows "
        f"equal to the CPU's {torch.equal(first[:16].cpu(), on_cpu)}")
    require(torch.equal(first, again), "moment channels: two calls equal")
    require(torch.equal(first[:16].cpu(), on_cpu),
            "moment channels: the card's equal the CPU's bit for bit")
    del first, again, on_cpu, e0, rows
    torch.cuda.empty_cache()


class _Tee(io.TextIOBase):
    """Standard output, kept: what a CLI prints is shown and read back."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, text):
        self.buf.write(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def run_cli(module, argv, where, label):
    """One in-process run of a CLI in ``where``; returns (result dict,
    printed text, forward evaluations, launch counts), the counts set to 0
    just before it and read just after.  A forward evaluation is a call
    of the problem's ``run_spectra``: one per log-prob evaluation, and one
    when the CLI synthesises its data."""
    evals = [0]
    run_spectra = problem_mod.JointFitProblem.run_spectra

    def counted(self, *args, **kwargs):
        evals[0] += 1
        return run_spectra(self, *args, **kwargs)

    cwd = os.getcwd()
    tee = _Tee(sys.stdout)
    problem_mod.JointFitProblem.run_spectra = counted
    os.chdir(where)
    reset_counts()
    try:
        with contextlib.redirect_stdout(tee):
            out = module.main(argv)
        torch.cuda.synchronize()
        used = read_counts()
    finally:
        os.chdir(cwd)
        problem_mod.JointFitProblem.run_spectra = run_spectra
    log(f"{label}: {evals[0]} forward evaluations; launches {used}")
    return out, tee.buf.getvalue(), evals[0], used


CLI_FULL = ["-nWalkers", str(N_WALKERS), "-nDrawsPerEval", str(N_DRAWS),
            "-move", "de", "-batch", "1", "-nBurninSteps", "4",
            "-segment", "4"]
CLI_RUNS = {
    # name: (module, flags, dimension, K1 launches per evaluation)
    "simult_counts_poisson": (cli_simult, ["-sampling", "counts",
                                           "-likelihood", "poisson"], 8, 1),
    "simult_mc_default": (cli_simult, [], 8, 0),
    "onebd_hardcore_counts": (cli_onebd, ["-hardcore", "1", "-sampling",
                                          "counts"], 9, 2),
}


def phase_cli(smi, tmp, rate, launches):
    """Phase 13: the command-line drivers at full width on the card."""
    for name, (module, flags, n_dim, k1_per_eval) in CLI_RUNS.items():
        where = tmp / name
        where.mkdir()
        label = f"phase 13 ({name})"
        out, text, evals, used = run_cli(
            module, CLI_FULL + flags + ["-nMainSteps", "8"], where, label)
        q = out["quantiles"]
        require(len(q) == n_dim and all(np.all(np.isfinite(v))
                                        for v in q.values()),
                f"{label}: finite quantiles")
        chain, probs, d, w, s = chain_io.read_chain_text(
            str(where / "mainchain.dat"))
        require(chain.shape == (8, N_WALKERS, n_dim),
                f"{label}: mainchain.dat parses to (8, 256, {n_dim})")
        rate_lines = [json.loads(line) for line in text.splitlines()
                      if line.startswith('{"walker_steps_per_sec"')]
        require(len(rate_lines) == 1 and rate_lines[0][
            "walker_steps_per_sec"] == out["walker_steps_per_sec"],
            f"{label}: the CLI printed its walker-steps/s")
        require(used["tof_hist"] == evals and evals >= 2 + 2 * 12,
                f"{label}: K2 launched once per forward evaluation")
        require(used["poisson"] == k1_per_eval * evals,
                f"{label}: K1 launched {k1_per_eval} times per evaluation")
        require(used["weighted_hist"] == used["transport_moments"] == 0
                and used["K2-bwd"] == 0,
                f"{label}: K3, K4 and K2's backward are off the CLI's path")
        rate[f"cli_{name}"] = out["walker_steps_per_sec"]
        launches[f"cli_{name}"] = dict(used, forward_evaluations=evals)
        log(f"{label} ({smi}): {out['walker_steps_per_sec']:.1f} "
            f"walker-steps/s (the CLI's own line: 12 steps x {N_WALKERS} "
            f"walkers over its phases, chain text and checkpoints "
            f"included); main-chain log-probs finite "
            f"{np.isfinite(probs).mean():.4f}")

    where = tmp / "subprocess"
    where.mkdir()
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "mcmctoffitting_tpu_torch.cli.simult_fit",
         "-debug", "1", "-batch", "1"], cwd=where, env=env,
        capture_output=True, text=True, timeout=600)
    log(f"phase 13: python -m mcmctoffitting_tpu_torch.cli.simult_fit "
        f"-debug 1 -batch 1: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s; last line "
        f"{proc.stdout.strip().splitlines()[-1:]}")
    require(proc.returncode == 0,
            f"the CLI subprocess exits 0 ({proc.stderr[-2000:]})")


def phase_resume(tmp):
    """Phase 14: 4 + 4 main steps through -resume equal phase 13's 8."""
    for name in ("simult_counts_poisson", "simult_mc_default"):
        module, flags, _, _ = CLI_RUNS[name]
        where = tmp / f"{name}_resumed"
        where.mkdir()
        label = f"phase 14 ({name})"
        run_cli(module, CLI_FULL + flags + ["-nMainSteps", "4"], where,
                label + ", burn-in 4 + main 4")
        _, text, _, _ = run_cli(
            module, CLI_FULL + flags + ["-nMainSteps", "4", "-resume",
                                        "main.ckpt.npz"], where,
            label + ", -resume for 4 more")
        require("resumed from main.ckpt.npz at step 8" in text
                and "fingerprint does not match" not in text
                and "no torch generator states" not in text,
                f"{label}: resumed at step 8 with its own generators")
        whole = (tmp / name / "mainchain.dat").read_bytes()
        resumed = (where / "mainchain.dat").read_bytes()
        log(f"{label}: resumed mainchain.dat ({len(resumed)} bytes) equals "
            f"the uninterrupted one byte for byte: {resumed == whole}")
        require(resumed == whole,
                f"{label}: resumed main chain byte-identical")


def k2_bwd_bound(base, zt, n_pad, n_in):
    """K2 backward's bound: base and the cotangent read once, the gradient
    written once (and the tables); per sample an addition and two
    compares, per in-window sample the subtraction, scaling, floor, clamp,
    product and sum."""
    n_samples = base.numel() * zt.shape[1]
    n_rows = base.numel() // (base.shape[-2] * base.shape[-1])
    return bound(4 * (2 * base.numel() + n_rows * n_pad + 2 * zt.numel()),
                 3 * n_samples + 6 * n_in)


def k2_in_window(base, zt, win):
    """Samples of the lattice in their run's window."""
    vals = base[..., None] + zt
    lo = win.lo[:, None, None, None]
    hi = win.hi[:, None, None, None]
    return ((vals >= lo) & (vals <= hi)).sum().item()


def phase_tof_backward(dev, smi, base_s, draws_s, fwd_s):
    """Phase 15: K2's backward at both fits' lattices (256 walkers), each
    served by its kernel with K fixed at compile time (K = 10, K = 1), and
    the general kernel at simultFit's lattice with its first three
    segments (K = 3).  Returns the kernels line's entry."""
    spec_hc = onebd.default_spec(N_DRAWS, hardcore=True, sampling="counts")
    prob_hc = onebd_problem(spec_hc, "poisson", dev)
    obs = data_io.synthesize_observed(9, prob_hc, data_io.ONEBD_TRUTH)
    p0 = prob_hc.initial_walkers_from_observed(
        torch.Generator(dev).manual_seed(1), N_WALKERS, obs)
    fwd_o = prob_hc.forward
    grids, e0_means = fwd_o.grid_and_mean(prob_hc.split_theta(p0)[0],
                                          torch.Generator().manual_seed(3))
    base_o, draws_o = fwd_o.lattice(grids, e0_means)
    cases = {"simult": (base_s, draws_s, fwd_s.zt, fwd_s.zw, fwd_s.win),
             "onebd_hardcore": (base_o, draws_o, fwd_o.zt, fwd_o.zw,
                                fwd_o.win),
             "general_k3": (base_s, draws_s, fwd_s.zt[:, :3].contiguous(),
                            fwd_s.zw[:, :3].contiguous(), fwd_s.win)}
    rng = np.random.default_rng(15)
    floor_ms = devtime.launch_floor_ms(dev)
    out = {}
    for name, (base, draws, zt, zw, win) in cases.items():
        variant = tof_hist_backward_variant(zt.shape[1])
        require(variant == {10: "K = 10", 1: "K = 1"}.get(zt.shape[1],
                                                           "general"),
                f"phase 15 ({name}): K2 backward variant {variant}")
        gbar = torch.as_tensor(rng.standard_normal(
            base.shape[:-2] + (win.n_pad,)).astype(np.float32), device=dev)
        label = (f"phase 15 ({name}, {tuple(base.shape)}, K = "
                 f"{zt.shape[1]}, kernel {variant})")
        got = tof_hist_segments_backward(gbar, base, zt, zw, win)
        again = tof_hist_segments_backward(gbar, base, zt, zw, win)
        exact = tof_hist_segments_bwd_plain(gbar, base, zt, zw, win,
                                            torch.float64)
        tol = 1e-6 * zw.abs().sum(1).max().item() * gbar.abs().max().item()
        err64 = (got.double() - exact).abs().max().item()
        d = draws.detach().clone().requires_grad_(True)
        plain_out = tof_hist_segments_plain(base, d, zt, zw, win)
        want, = torch.autograd.grad(plain_out, d, gbar, retain_graph=True)
        err = (got - want).abs().max().item()
        log(f"{label}: backward kernel vs the float64 gather max|diff| "
            f"{err64:.3g}, vs the plain autograd {err:.3g} (tolerance "
            f"{tol:.3g}); a second call equal: {torch.equal(got, again)}")
        require(err64 <= tol and err <= tol,
                f"{label}: K2 backward vs plain within {tol:.3g}")
        require(torch.equal(got, again), f"{label}: K2 backward the same "
                "on every call")

        # np.histogram edge cases, exact: v == hi -> the last bin's
        # cotangent, v == lo -> the first's, outside and NaN -> nothing
        e_base = torch.full_like(base[:1], 1.0e4)
        e_zt = torch.zeros_like(zt)
        e_zw = torch.zeros_like(zw)
        e_zw[:6, 0] = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
        for r in range(base.shape[1]):
            lo, hi = win.lo[r].item(), win.hi[r].item()
            e_base[0, r, 0, :6] = torch.tensor(
                [hi, hi + 0.5, lo, lo - 0.5, float("nan"), lo + 1.5])
        e_g = torch.arange(1.0, 1.0 + base.shape[1] * win.n_pad,
                           device=dev).reshape(1, base.shape[1], win.n_pad)
        e_got = tof_hist_segments_backward(e_g, e_base, e_zt, e_zw, win)
        require(torch.equal(e_got, tof_hist_segments_bwd_plain(
            e_g, e_base, e_zt, e_zw, win)), f"{label}: K2 backward "
            "np.histogram edge cases")
        require(bool(e_got[0, :, 0, 0].eq(
            e_g[0, torch.arange(base.shape[1]), win.nb1.long()]).all()),
            f"{label}: v == hi takes the last bin's cotangent")
        log(f"{label}: backward edge cases exact (v == hi, v == lo, "
            "outside, NaN)")

        def bwd_call():
            return tof_hist_segments_backward(gbar, base, zt, zw, win)

        def fwd_call():
            return tof_hist_segments(base, draws, zt, zw, win)

        def plain_bwd():
            return torch.autograd.grad(plain_out, d, gbar,
                                       retain_graph=True)

        ms = devtime.graphs_in_turns({"bwd": bwd_call, "fwd": fwd_call})
        enq = {"bwd": devtime.enqueue_us(bwd_call),
               "fwd": devtime.enqueue_us(fwd_call)}
        plain_ms = cuda_ms(plain_bwd)
        n_in = k2_in_window(base, zt, win)
        b_ms, b_by = k2_bwd_bound(base, zt, win.n_pad, n_in)
        f_ms, f_by = bound(4 * (2 * base.numel() + 2 * zt.numel()
                                + base.shape[0] * base.shape[1] * win.n_pad),
                           4 * base.numel() * zt.shape[1] + 5 * n_in)
        log(f"{label} ({smi}): backward kernel {ms['bwd']:.5f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}), enqueue {enq['bwd']:.1f} us, plain "
            f"(autograd of the plain version) {plain_ms:.4f} ms, library "
            f"none; forward kernel {ms['fwd']:.5f} ms, bound {f_ms:.5f} ms "
            f"({f_by}), enqueue {enq['fwd']:.1f} us; launch floor "
            f"{floor_ms:.5f} ms; in-window share "
            f"{n_in / (base.numel() * zt.shape[1]):.4f}")
        out[name] = {"shape": list(base.shape), "k": zt.shape[1],
                     "variant": variant, "ms": ms["bwd"], "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": None, "enqueue_us": enq["bwd"],
                     "launch_floor_ms": floor_ms,
                     "max_abs_err": max(err64, err),
                     "forward_ms": ms["fwd"], "forward_bound_ms": f_ms,
                     "forward_enqueue_us": enq["fwd"]}
        del got, again, exact, want, plain_out, d
    del base_o, draws_o, prob_hc, fwd_o
    torch.cuda.empty_cache()
    return out


def grad_problems(dev):
    """The differentiable configuration of both fits ('expected', rint
    off, the corrected likelihood; oneBD with the background's
    expectation): name -> (make_problem(device), truth)."""
    spec_s = dataclasses.replace(
        simult.default_spec(N_DRAWS, sampling="expected"), rint_draws=False)
    spec_o = dataclasses.replace(
        onebd.default_spec(N_DRAWS, sampling="expected"), rint_draws=False,
        bg_mode="expected")
    truth_s = np.concatenate([simult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
    return {
        "simult": (lambda d: simult_problem(spec_s, "poisson", d), truth_s),
        "onebd": (lambda d: onebd_problem(spec_o, "poisson", d),
                  data_io.ONEBD_TRUTH)}


def share_grid(gpu_problem, cpu_problem):
    """Make ``gpu_problem``'s forward use the CPU forward's float32 grid
    and e0 means (the values; the gradient is still the card's own, of
    its own grid stage): what is left between the two gradients is what
    the card computes after the grid stage, kernel K2 forward and backward
    among it, and the grid stage's float64 backward."""
    fwd_g, fwd_c = gpu_problem.forward, cpu_problem.forward
    own = fwd_g.grid_and_mean

    def grid_and_mean(params, generator):
        grids, means = own(params, generator)
        with torch.no_grad():
            c_grids, c_means = fwd_c.grid_and_mean(params.cpu(), generator)
        return (grids + (c_grids.to(grids.device) - grids).detach(),
                means + (c_means.to(means.device) - means).detach())

    fwd_g.grid_and_mean = grid_and_mean


def phase_gradient(dev):
    """Phase 16: the log-prob's gradient on 8 chains, card vs CPU, at the
    first 8 points of the fit's initial-walker cloud, where the CLI's
    chains start.  The float32 'expected' grid carries an error of ~1e-4
    of its peak in every cell (on both devices, independently; half the
    cells of a grid are off by more than 1e-3 of their own value), which
    the likelihood's gradient weights by obs / rate: against the float64
    gradient the float32 one is off by a median 3e-5 and up to several
    percent (perf/gradient_precision.py).  So the card is held to the CPU
    at 1e-3 with the grid stage's values shared, and the whole gradient is
    printed beside it."""
    rel = {}
    for name, (make, truth) in grad_problems(dev).items():
        cpu = make("cpu")
        obs = data_io.synthesize_observed(9, cpu, truth)
        thetas = cpu.initial_walkers_from_observed(
            torch.Generator().manual_seed(1), 8, obs)
        shared = make(dev)
        share_grid(shared, cpu)
        grads = {}
        for tag, prob in (("cpu", cpu), ("card", make(dev)),
                          ("card_shared_grid", shared)):
            x = thetas.to(prob.device).requires_grad_(True)
            lp = prob.make_log_prob_fn(obs)(x, torch.Generator())
            g, = torch.autograd.grad(lp.sum(), x)
            require(bool(torch.isfinite(lp).all()
                         and torch.isfinite(g).all()),
                    f"phase 16 ({name}, {tag}): finite log-probs, gradients")
            grads[tag] = g.cpu().double()
        for tag in ("card", "card_shared_grid"):
            r = ((grads[tag] - grads["cpu"]).norm(dim=1)
                 / grads["cpu"].norm(dim=1))
            rel[f"{name}_{tag}"] = r.tolist()
            what = (" with the CPU grid stage values" if "shared" in tag
                    else "")
            log(f"phase 16 ({name}): log-prob gradient on 8 chains, the card"
                f"{what} vs the CPU: relative L2 per chain "
                f"{' '.join(f'{v:.2e}' for v in r.tolist())}")
        require(max(rel[f"{name}_card_shared_grid"]) <= 1e-3,
                f"phase 16 ({name}): gradient GPU vs CPU, grid values shared")
    return rel


GRAD_CLI = ["-nChains", str(N_WALKERS), "-nDrawsPerEval", str(N_DRAWS),
            "-nBurninSteps", str(GRAD_WARM), "-nMainSteps", str(GRAD_MAIN),
            "-maxDepth", str(GRAD_DEPTH), "-expectedForward", "-likelihood",
            "poisson", "-batch", "1"]
GRAD_RUNS = {
    # name: (module, flags, dimension)
    "simult_nuts": (cli_simult, ["-sampler", "nuts"], 8),
    "simult_hmc": (cli_simult, ["-sampler", "hmc"], 8),
    "onebd_nuts": (cli_onebd, ["-sampler", "nuts", "-deterministicBG"], 9),
}


def phase_gradient_cli(smi, tmp, rate, launches):
    """Phase 17: the gradient samplers through the CLIs at full width."""
    for name, (module, flags, n_dim) in GRAD_RUNS.items():
        where = tmp / f"grad_{name}"
        where.mkdir()
        label = f"phase 17 ({name})"
        out, text, evals, used = run_cli(module, GRAD_CLI + flags, where,
                                         label)
        q = out["quantiles"]
        require(len(q) == n_dim and all(np.all(np.isfinite(v))
                                        for v in q.values()),
                f"{label}: finite quantiles")
        chain, probs, _, _, _ = chain_io.read_chain_text(
            str(where / "mainchain.dat"))
        require(chain.shape == (GRAD_MAIN, N_WALKERS, n_dim),
                f"{label}: mainchain.dat parses to ({GRAD_MAIN}, "
                f"{N_WALKERS}, {n_dim})")
        rate_lines = [json.loads(line) for line in text.splitlines()
                      if line.startswith('{"walker_steps_per_sec"')]
        require(len(rate_lines) == 1 and rate_lines[0][
            "walker_steps_per_sec"] == out["walker_steps_per_sec"],
            f"{label}: the CLI printed its walker-steps/s")
        sampler_name = flags[1]
        stats = [line for line in text.splitlines()
                 if line.startswith(f"{sampler_name}: step_size")]
        grad_lines = [line for line in text.splitlines()
                      if " gradient evaluations of " in line]
        require(len(stats) == 1 and len(grad_lines) == 1,
                f"{label}: the sampler's statistics printed")
        if sampler_name == "nuts":
            require("mean tree depth" in stats[0]
                    and "divergences" in stats[0],
                    f"{label}: divergences and mean tree depth printed")
        n_grad = int(grad_lines[0].split()[1])
        # one K2 forward and one backward per gradient evaluation; the
        # synthetic data take one more forward, without a gradient
        require(used["K2-bwd"] == n_grad and used["tof_hist"] == n_grad + 1
                and evals == n_grad + 1,
                f"{label}: K2 forward and backward once per gradient "
                f"evaluation ({used}, {n_grad} evaluations)")
        require(used["poisson"] == used["weighted_hist"]
                == used["transport_moments"] == 0,
                f"{label}: K1, K3 and K4 are off the gradient path")
        elapsed = rate_lines[0]["elapsed_s"]
        rate[f"cli_{name}"] = out["walker_steps_per_sec"]
        rate[f"cli_{name}_grad_evals_per_s"] = n_grad / elapsed
        launches[f"cli_{name}"] = dict(used, forward_evaluations=evals,
                                       gradient_evaluations=n_grad)
        log(f"{label} ({smi}): {out['walker_steps_per_sec']:.1f} "
            f"walker-steps/s (the CLI's own line: {GRAD_WARM + GRAD_MAIN} "
            f"steps x {N_WALKERS} chains), {n_grad} gradient evaluations in "
            f"{elapsed:.2f} s ({n_grad / elapsed:.1f} per second); "
            f"{stats[0]}; main-chain log-probs finite "
            f"{np.isfinite(probs).mean():.4f}")


# --- phase 18: the posterior-predictive slice ----------------------------

PPC_CHUNK = ppc_mod.PPC_CHUNK
PPC_RUNS = {
    # name: (-model, phase 13's chain, -nChainEntries, -nSamplesFromTOF)
    "ppc_simult": ("simult", "simult_mc_default", 100, 50_000),
    "ppc_onebd": ("onebd", "onebd_hardcore_counts", 100, 50_000),
    # the reference's generatePPC size (utilities/ppcTools.py:283)
    "ppc_simult_reference": ("simult", "simult_mc_default", 500, N_DRAWS),
}
PPC_CORE_DRAWS = 8
PPC_WARM_REPEATS = 5


def ppc_with_energies(problem, thetas, e_runs, e_grid, seed):
    """``PPCSampler.generate`` of the rows of ``thetas`` (n, D) in order,
    the beam draws replaced by the given initial energies on the problem's
    device: e_runs (n, R, N) for the spectra, e_grid (n, 1, N) for the
    weight grids; the background draws from the host seed ``seed``."""
    dev = problem.device

    def energies(params, generator, n_runs=None, n=None):
        return (e_grid if n_runs == 1 else e_runs).to(dev)

    problem.forward.sample_beam_energies = energies
    ppc = ppc_mod.PPCSampler(problem, thetas[None], n_steps_to_include=1)
    ppc.draw_thetas = lambda generator, n, cut=None: thetas
    return ppc.generate(torch.Generator().manual_seed(seed), thetas.shape[0])


def phase_ppc_core(dev, truth_simult):
    """Phase 18a: PPCSampler.generate's batched forward, the card against
    the CPU on 8 draws at full width (the simultFit default, mc on the
    table, and the oneBD default), the same thetas and initial energies on
    both; the oneBD background as phase 10a holds it."""
    out = {}
    for name, make, truth in (
            ("simult", lambda d: simult_problem(
                simult.default_spec(N_DRAWS), "reference", d), truth_simult),
            ("onebd", lambda d: onebd_problem(
                onebd.default_spec(N_DRAWS), "reference", d),
             data_io.ONEBD_TRUTH)):
        card, cpu = make(dev), make("cpu")
        obs = data_io.synthesize_observed(9, card, truth)
        thetas = card.initial_walkers_from_observed(
            torch.Generator(dev).manual_seed(1), PPC_CORE_DRAWS, obs)
        params = card.shared_params(thetas)
        gen = torch.Generator().manual_seed(2)
        e_runs = card.forward.sample_beam_energies(params, gen)
        e_grid = card.forward.sample_beam_energies(params, gen, n_runs=1)
        thetas = thetas.cpu().numpy()
        reset_counts()
        got = ppc_with_energies(card, thetas, e_runs, e_grid, 3)
        torch.cuda.synchronize()
        used = read_counts()
        want = ppc_with_energies(cpu, thetas, e_runs.cpu(), e_grid.cpu(), 3)

        def rel_l1(a, b):
            a = a.reshape(PPC_CORE_DRAWS, -1)
            b = b.reshape(PPC_CORE_DRAWS, -1)
            return float((np.abs(a - b).sum(-1) / np.abs(b).sum(-1)).max())

        rel = max(rel_l1(g, w) for g, w in zip(got.tof_spectra,
                                               want.tof_spectra))
        rel_grid = rel_l1(got.neutron_spectra, want.neutron_spectra)
        log(f"phase 18a ({name}): PPC GPU vs CPU on {PPC_CORE_DRAWS} draws "
            f"x {card.n_runs} runs x {N_DRAWS} initial energies: spectra "
            f"max rel L1 {rel:.2e}, weight grids {rel_grid:.2e}; "
            f"launches {used}")
        require(all(np.isfinite(s).all() for s in got.tof_spectra)
                and np.isfinite(got.neutron_spectra).all(),
                f"phase 18a ({name}): finite PPC spectra and grids")
        require(rel <= 1e-4 and rel_grid <= 1e-4,
                f"phase 18a ({name}): PPC GPU vs CPU within 1e-4 rel L1")
        require(used["tof_hist"] == 1
                and used["poisson"] == (1 if name == "onebd" else 0)
                and used["weighted_hist"] == used["transport_moments"] == 0,
                f"phase 18a ({name}): K2 once, K1 once on oneBD, K3/K4 never")
        if name == "onebd":
            # the background itself: K1 on the card, its plain version on
            # the CPU, one host seed: every draw equal (phase 10a)
            _, _, levels = card.split_theta(torch.as_tensor(thetas,
                                                            device=dev))
            bg = [p.forward.background(levels.to(p.device),
                                       torch.Generator().manual_seed(4))
                  .cpu() for p in (card, cpu)]
            bg_equal = bool(torch.equal(*bg))
            log(f"phase 18a (onebd): background {tuple(bg[0].shape)}, K1 "
                f"vs plain, one seed: every draw equal {bg_equal}")
            require(bg_equal, "phase 18a: oneBD background draws equal")
        out[name] = {"spectra_rel_l1": rel, "grids_rel_l1": rel_grid}
        del card, cpu
    return out


def warm_generate_s(model, chain_path, n_entries, n_samples, dev):
    """Seconds of each of PPC_WARM_REPEATS ``PPCSampler.generate`` calls
    after the CLI's own (cold) one: the CLI's problem, chain tail, draw
    count and seed, each call ending with its spectra on the host."""
    chain, probs, *_ = chain_io.read_chain_text(str(chain_path))
    spec = (simult.default_spec(n_samples) if model == "simult"
            else onebd.default_spec(n_samples))
    problem = (simult_problem if model == "simult"
               else onebd_problem)(spec, "reference", dev)
    sampler = ppc_mod.PPCSampler(problem, chain, probs)
    times = []
    for _ in range(PPC_WARM_REPEATS):
        t0 = time.perf_counter()
        sampler.generate(torch.Generator().manual_seed(0), n_entries)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def phase_ppc_cli(smi, tmp, rate, launches, dev):
    """Phase 18b: cli.ppc on phase 13's chains at the CLI defaults for
    both models and at the reference's size for simultFit."""
    out = {}
    for name, (model, chain_of, n_entries, n_samples) in PPC_RUNS.items():
        where = tmp / name
        where.mkdir()
        label = f"phase 18b ({name})"
        argv = ["-chainFilename", str(tmp / chain_of / "mainchain.dat"),
                "-model", model, "-nChainEntries", str(n_entries),
                "-nSamplesFromTOF", str(n_samples)]
        t0 = time.perf_counter()
        res, text, _, used = run_cli(cli_ppc, argv, where, label)
        cli_s = time.perf_counter() - t0
        spec = (simult.default_spec(n_samples) if model == "simult"
                else onebd.default_spec(n_samples))
        windows = (simult_problem(spec, "reference", "cpu")
                   if model == "simult"
                   else onebd_problem(spec, "reference", "cpu")).windows
        n_runs = len(windows)
        for run, win in enumerate(windows):
            bands = np.loadtxt(where / f"ppc_run{run}_bands.txt")
            require(bands.shape == (3, win.n_bins)
                    and np.isfinite(bands).all()
                    and np.all(bands[0] <= bands[1])
                    and np.all(bands[1] <= bands[2]),
                    f"{label}: run {run} bands (3, {win.n_bins}), finite, "
                    "q16 <= q50 <= q84")
        n_en = len(spec.en_centers())
        si, sp = (where / "ppc_sdef.txt").read_text().splitlines()
        require(si.startswith("si100 a") and len(si.split()) == 2 + n_en
                and sp.startswith("sp100") and len(sp.split()) == 1 + n_en,
                f"{label}: SDEF card with one si and sp entry per energy")
        require("wrote ppc_sdef.txt" in text
                and ("wrote PPC plots" in text or
                     "plotting skipped: matplotlib is not installed" in text),
                f"{label}: the CLI's lines")
        chunks = -(-n_entries // PPC_CHUNK)
        require(used["tof_hist"] == chunks
                and used["poisson"] == (chunks if model == "onebd" else 0)
                and used["weighted_hist"] == used["transport_moments"]
                == used["K2-bwd"] == 0,
                f"{label}: K2 once per chunk of draws, K1 once per chunk "
                f"on oneBD, K3/K4 never ({used}, {chunks} chunks)")
        draws_per_s = n_entries / res["generate_s"]
        warm = warm_generate_s(model, tmp / chain_of / "mainchain.dat",
                               n_entries, n_samples, dev)
        warm_s = float(np.median(warm))
        rate[f"{name}_draws_per_s"] = draws_per_s
        rate[f"{name}_warm_draws_per_s"] = n_entries / warm_s
        launches[f"cli_{name}"] = dict(used, chunks=chunks)
        out[name] = {"draws": n_entries, "draws_per_eval": n_samples,
                     "runs": n_runs, "generate_s": res["generate_s"],
                     "draws_per_s": draws_per_s, "cli_s": cli_s,
                     "warm_generate_s": warm,
                     "warm_draws_per_s": n_entries / warm_s}
        log(f"{label} ({smi}): {n_entries} posterior draws x {n_runs} runs "
            f"x {n_samples} draws per eval in {res['generate_s']:.4f} s "
            f"(the CLI's one cold call) -> {draws_per_s:.1f} PPC draws/s, "
            f"{res['generate_s'] / n_runs:.4f} s per run; the whole CLI "
            f"(problem, chain, bands, card) {cli_s:.3f} s; "
            f"{PPC_WARM_REPEATS} warm calls: median {warm_s:.4f} s -> "
            f"{n_entries / warm_s:.1f} PPC draws/s (range "
            f"{n_entries / max(warm):.1f}-{n_entries / min(warm):.1f})")
    return out


def phase_plot_chain(tmp):
    """Phase 18c: cli.plot_chain on phase 13's simultFit chain."""
    where = tmp / "plot_chain"
    where.mkdir()
    res, text, _, _ = run_cli(
        cli_plot_chain, ["-filename",
                         str(tmp / "simult_mc_default" / "mainchain.dat")],
        where, "phase 18c (plot_chain)")
    drew = "wrote plots with prefix chain_" in text
    require(res == {"n_steps": 8, "n_walkers": N_WALKERS, "n_params": 8}
            and "diagnostics:" in text
            and (drew or text.count(
                "plotting skipped: matplotlib is not installed") == 1),
            "phase 18c: plot_chain prints the diagnostics, and the plots or "
            "the missing-matplotlib line")
    log(f"phase 18c: plot_chain printed the diagnostics; "
        + ("wrote its plots" if drew else "matplotlib is not installed"))


def phase_profile():
    """Phase 18d (last): one short simultFit counts CLI run with -profile
    DIR in a subprocess; its trace names the tof_hist kernel."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        env = dict(os.environ,
                   PYTHONPATH=str(Path(__file__).resolve().parent))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "mcmctoffitting_tpu_torch.cli.simult_fit",
             "-sampling", "counts", "-likelihood", "poisson",
             "-nBurninSteps", "2", "-nMainSteps", "2", "-segment", "2",
             "-batch", "1", "-profile", "trace_dir"], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=600)
        require(proc.returncode == 0,
                f"phase 18d: -profile run exits 0 ({proc.stderr[-2000:]})")
        trace = Path(tmp) / "trace_dir" / "trace.json"
        require(trace.exists(), "phase 18d: the trace file exists")
        events = json.loads(trace.read_text())["traceEvents"]
        kernels = [e for e in events
                   if str(e.get("cat", "")).lower() == "kernel"
                   and "tof_hist" in e.get("name", "")]
        log(f"phase 18d: -profile trace_dir: exit 0 in "
            f"{time.perf_counter() - t0:.1f} s, {trace.stat().st_size} "
            f"bytes, {len(events)} events, {len(kernels)} tof_hist kernel "
            f"events; 'profiler trace written to trace_dir' printed: "
            f"{'profiler trace written to trace_dir' in proc.stdout}")
        require(kernels and "profiler trace written to trace_dir"
                in proc.stdout, "phase 18d: the trace names tof_hist")
    return len(kernels)


# --- phases 19-21: the remaining forward models ---------------------------

SIMPLE_CLI = {
    # model: walkers at the CLI's widths
    "v0": 50, "v1": 100, "v2": 100, "v2.5": 100,
}
SIMPLE_RUNS = tuple(f"simple_{m}" for m in SIMPLE_CLI)
SIMPLE_STEPS = 20
SIMPLE_SEED_W = 8                     # walkers of the card-vs-CPU check
TEMPLATE_FIT = ["-nWalkers", "500", "-nBurnin", "200", "-doML"]
CSI_PPC_DRAWS, CSI_PPC_N = 100, 50_000   # cli.ppc's defaults


def simple_setup(model, n_draws, dev):
    """(spec, standoff, problem, observed) as cli.simple_tof builds them
    (the observed histogram of 10k samples at the truth)."""
    spec, standoff, problem = cli_simple.build_problem(model, n_draws, dev)
    truth = torch.as_tensor(
        np.asarray(cli_simple.MODEL_CONFIGS[model]["truth"])[None],
        dtype=torch.float32, device=dev)
    tofs, _, _, _ = simple.sample_tof(torch.Generator().manual_seed(19),
                                      truth, spec, standoff)
    w = spec.window
    observed, _ = np.histogram(tofs[0, :10_000].cpu().numpy(), w.n_bins,
                               w.range)
    return spec, standoff, problem, observed.astype(np.float32)


def k3_row(dev, values, weights, n_bins, lo, hi, label):
    """K3 against its plain version at one shape (within 1e-6 of each
    row's total, the same bits on a second call), its device time beside
    its bound and the plain version's time."""
    kern = cuda_hist.weighted_histogram(values, lo, hi, n_bins, weights)
    plain = cuda_hist.weighted_histogram_plain(values, lo, hi, n_bins,
                                               weights)
    err = (kern - plain).abs()
    rel = (err / plain.sum(-1, keepdim=True).clamp_min(1e-30)).max().item()
    again = cuda_hist.weighted_histogram(values, lo, hi, n_bins, weights)
    require(rel <= 1e-6, f"{label}: K3 within 1e-6 of each row's total")
    require(torch.equal(kern, again), f"{label}: K3 the same on every call")
    blocks = ctypes.c_longlong()
    cuda_build.check(cuda_build.load_library().lib
                     .mcmctof_weighted_hist_blocks(
                         values.shape[0], values.shape[1], n_bins, dev.index,
                         ctypes.byref(blocks)), "weighted_hist grid")
    require(blocks.value > values.shape[0],
            f"{label}: rows shared by blocks (the float64 parts path)")

    def call():
        return cuda_hist.weighted_histogram(values, lo, hi, n_bins, weights)

    in_range = ((values >= lo) & (values <= hi)).sum().item()
    b_ms, b_by = bound(4 * (2 * values.numel() + values.shape[0] * n_bins),
                       2 * values.numel() + 5 * in_range)
    row = {"shape": tuple(values.shape), "bins": n_bins,
           "max_abs_err": err.max().item(), "rel_err": rel,
           "blocks": blocks.value, "ms": devtime.graph_ms(call),
           "plain_ms": cuda_ms(lambda: cuda_hist.weighted_histogram_plain(
               values, lo, hi, n_bins, weights), reps=10),
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "enqueue_us": devtime.enqueue_us(call)}
    log(f"{label}: K3 vs plain on {row['shape']}, {n_bins} bins, "
        f"{blocks.value} blocks: max|diff| {row['max_abs_err']:g} ({rel:.2e} "
        f"of the row total), the same on a second call; kernel "
        f"{row['ms']:.5f} ms, plain {row['plain_ms']:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}), enqueue {row['enqueue_us']:.1f} us")
    return row


def phase_simple(dev, smi, tmp, rate, launches):
    """Phase 19: the simple family.  K3 on one half-step's samples of v2
    (50 walkers x 200k, XS weights, 50 bins) and of v0 (25 x 200k, 25
    bins); the card against the CPU for v0-v2.5 on 8 walkers with the
    same draws; then cli.simple_tof at the CLI's widths."""
    out = {"k3": {}, "gpu_vs_cpu": {}, "cli": {}}
    for model, half in (("v2", 50), ("v0", 25)):
        spec, standoff, problem, _ = simple_setup(model, N_DRAWS, dev)
        cfg = cli_simple.MODEL_CONFIGS[model]
        thetas = (torch.as_tensor(cfg["truth"], dtype=torch.float32,
                                  device=dev)
                  * (1 + 0.01 * torch.randn(
                      (half, len(cfg["truth"])),
                      generator=torch.Generator(dev).manual_seed(2),
                      device=dev)))
        tofs, weights, _, _ = simple.sample_tof(
            torch.Generator().manual_seed(3), thetas, spec, standoff)
        weights = torch.ones_like(tofs) if weights is None else weights
        w = spec.window
        out["k3"][model] = k3_row(dev, tofs.contiguous(),
                                  weights.contiguous(), w.n_bins, w.lo,
                                  w.hi, f"phase 19a ({model}, {smi})")
        del tofs, weights

    for model in SIMPLE_CLI:
        spec, standoff, card, observed = simple_setup(model, N_DRAWS, dev)
        cpu = simple.SimpleProblem(spec, standoff, card.param_lo,
                                   card.param_hi, device="cpu")
        cfg = cli_simple.MODEL_CONFIGS[model]
        thetas = torch.as_tensor(cfg["truth"], dtype=torch.float32) * (
            1 + 0.01 * torch.randn((SIMPLE_SEED_W, len(cfg["truth"])),
                                   generator=torch.Generator().manual_seed(4)))
        u, z = simple.draw_simple(spec, SIMPLE_SEED_W,
                                  torch.Generator().manual_seed(5), "cpu")
        x = u * spec.geometry.cell_length
        reset_counts()
        got = card.log_prob_from_draws(
            thetas.to(dev), x.to(dev), z.to(dev),
            torch.as_tensor(observed, device=dev)).cpu()
        torch.cuda.synchronize()
        used = read_counts()
        want = cpu.log_prob_from_draws(thetas, x, z,
                                       torch.as_tensor(observed))
        fin = torch.isfinite(want)
        rel = ((got - want).abs() / want.abs()).where(fin, 0.0).max().item()
        log(f"phase 19b ({model}): log-probs card vs CPU on "
            f"{SIMPLE_SEED_W} walkers x {N_DRAWS} draws, the same draws: "
            f"max rel {rel:.2e}; finite {int(fin.sum())} of "
            f"{SIMPLE_SEED_W}; launches {used}")
        require(torch.equal(fin, torch.isfinite(got)) and rel <= 1e-5,
                f"phase 19b ({model}): card vs CPU within 1e-5 relative")
        require(used["weighted_hist"] == 1 and used["tof_hist"] ==
                used["poisson"] == used["transport_moments"] == 0,
                f"phase 19b ({model}): one K3 launch per evaluation")
        out["gpu_vs_cpu"][model] = rel
        del card, cpu, x, z

    for model, n_walkers in SIMPLE_CLI.items():
        where = tmp / f"simple_{model}"
        where.mkdir()
        label = f"phase 19c (simple_tof {model})"
        evals = [0]
        log_prob = simple.SimpleProblem.log_prob

        def counted(self, *args, **kwargs):
            evals[0] += 1
            return log_prob(self, *args, **kwargs)

        simple.SimpleProblem.log_prob = counted
        try:
            res, text, _, used = run_cli(
                cli_simple, ["--model", model, "--nWalkers", str(n_walkers),
                             "--nSteps", str(SIMPLE_STEPS), "--nDraws",
                             str(N_DRAWS)], where, label)
        finally:
            simple.SimpleProblem.log_prob = log_prob
        evals = evals[0]
        n_dim = cli_simple.MODEL_CONFIGS[model]["n_dim"]
        require(all(np.isfinite(v).all() for v in res["quantiles"].values())
                and len(res["quantiles"]) == n_dim,
                f"{label}: finite quantiles")
        rate_lines = [json.loads(line) for line in text.splitlines()
                      if line.startswith('{"walker_steps_per_sec"')]
        require(len(rate_lines) == 1 and rate_lines[0][
            "walker_steps_per_sec"] == res["walker_steps_per_sec"],
            f"{label}: the CLI printed its walker-steps/s")
        require(evals >= 1 + 2 * SIMPLE_STEPS
                and used["weighted_hist"] == evals
                and used["poisson"] == used["tof_hist"]
                == used["transport_moments"] == used["K2-bwd"] == 0,
                f"{label}: K3 once per log-prob evaluation, K1, K2, K4 "
                f"never ({used}, {evals} evaluations)")
        rate[f"cli_simple_{model}"] = res["walker_steps_per_sec"]
        launches[f"cli_simple_{model}"] = dict(
            used, log_prob_evaluations=evals)
        out["cli"][model] = {
            "walkers": n_walkers, "steps": SIMPLE_STEPS,
            "walker_steps_per_s": res["walker_steps_per_sec"],
            "acceptance": res["acceptance"],
            "initial_nonfinite": res["initial_nonfinite"],
            "log_prob_evaluations": evals}
        log(f"{label} ({smi}): {n_walkers} walkers x {SIMPLE_STEPS} steps x "
            f"{N_DRAWS} draws: {res['walker_steps_per_sec']:.1f} "
            f"walker-steps/s (the CLI's own line, its initial evaluation "
            f"included); acceptance {res['acceptance']:.3f}; initial "
            f"log-probs non-finite {res['initial_nonfinite']} of "
            f"{n_walkers}; {evals} evaluations")
    return out


def k4_check_tiled(e0, rk4, bins, label):
    """The depth-tiled K4 against its plain version on (R, N) initial
    energies, phase 4's criteria: bins equal on >= 99.99% of (sample,
    depth) pairs, moments within 1e-5 of each row's total, per channel
    against the float64 sums.  The plain energies go 8 rows at a time."""
    kern, e_kern = cuda_transport.transport_moments(e0, rk4, bins,
                                                    energies_out=True)
    n = e0.shape[1]
    equal, bits, counts_equal, ratio, rel, max_err = 0, 0, True, 0.0, 0.0, 0.0
    for start in range(0, e0.shape[0], 8):
        rows = slice(start, start + 8)
        e_plain = stopping.rk4_transport(rk4, e0[rows])
        equal += (in_range_bins(e_kern[rows], bins)
                  == in_range_bins(e_plain, bins)).sum().item()
        bits += (e_kern[rows] == e_plain).sum().item()
        plain = cuda_transport.energy_moments(
            lambda e: e[:, None], e_plain.reshape(-1, n), 1,
            bins).reshape(kern[rows].shape)
        err = (kern[rows] - plain).abs()
        total = plain[:, :, 0].sum(dim=(-2, -1))[:, None, None, None]
        rel = max(rel, (err / total.clamp_min(1.0)).max().item())
        max_err = max(max_err, err.max().item())
        del e_plain, plain
        for r in range(start, min(start + 8, e0.shape[0]), 2):
            c_eq, ratio_r = cuda_transport.moment_check(
                kern[r:r + 2], e_kern[r:r + 2], bins)
            counts_equal, ratio = counts_equal and c_eq, max(ratio, ratio_r)
    share, bit_share = equal / e_kern.numel(), bits / e_kern.numel()
    in_range = (kern[:, :, 0].sum().item())
    del e_kern
    tile = cuda_transport.tile_spans(len(rk4.h), bins.n_bins)
    log(f"{label}: K4 (depth tiles of {tile}) vs plain on "
        f"{tuple(e0.shape)}, M = {len(rk4.h)}, Be = {bins.n_bins}, "
        f"{rk4.n_substeps} substeps: bins equal on "
        f"{share:.6f} of (sample, depth) pairs, energies bitwise equal on "
        f"{bit_share:.6f}; moments max|diff| {max_err:g} ({rel:.2e} of the "
        f"row total); counts equal {counts_equal}, d-channels at "
        f"{ratio:.3f} of their tolerance")
    require(share >= 0.9999, f"{label}: K4 bins equal on >= 99.99% of pairs")
    require(rel <= 1e-5, f"{label}: K4 moments within 1e-5 of the row total")
    require(counts_equal, f"{label}: K4 count channel exact")
    require(ratio <= 1.0, f"{label}: K4 d-channels within their steps")
    k4_second_call(e0, rk4, bins, kern, label)
    return max_err, in_range


def k4_second_call(e0, rk4, bins, first, label):
    """A second K4 call on the same energies gives the same bits in every
    channel: the blocks' sums meet in int64 and are rounded once."""
    again = cuda_transport.transport_moments(e0, rk4, bins)
    same = torch.equal(again, first)
    log(f"{label}: a second K4 call on {tuple(e0.shape)}: every channel "
        f"the same bits {same}")
    require(same, f"{label}: K4 the same bits on a second call")


def k4_bound(e0, rk4, bins, in_range_pairs):
    """K4's roofline bound and issue floor (phase 6's operation counts)."""
    pairs = e0.numel() * len(rk4.h)
    k4_ops = 2 * pairs + 14 * in_range_pairs
    b_ms, b_by = bound(4 * (e0.numel() + e0.shape[0] * len(rk4.h) * 4
                            * bins.n_bins),
                       44 * rk4.n_substeps * pairs + k4_ops)
    instr = ((4 * (5 + LOGF_INSTR + DIV_INSTR) + 16) * rk4.n_substeps * pairs
             + k4_ops)
    return b_ms, b_by, 1e3 * instr / INSTR_RATE


def phase_templates(dev, smi, tmp, rate, launches):
    """Phase 20: the depth-tiled K4 at the templates' (128, 200k), M = 100,
    Be = 150; generate_templates card vs CPU and its launches; K2 at the
    templates' lattice; cli.template_fit at 500 walkers x 200 steps with
    -doML."""
    spec = templates.default_spec(N_DRAWS)
    fwd = templates.template_forward(spec, device=dev)
    e0, e_lo = templates.draw_template_energies(
        spec, torch.Generator().manual_seed(20), 4, dev)
    rows = e0.reshape(-1, N_DRAWS).contiguous()           # (128, N)
    k4_err, in_range = k4_check_tiled(rows, fwd.rk4, fwd.moment_bins,
                                      "phase 20a")

    def k4_call():
        return cuda_transport.transport_moments(rows, fwd.rk4,
                                                fwd.moment_bins)

    b_ms, b_by, floor_ms = k4_bound(rows, fwd.rk4, fwd.moment_bins, in_range)
    k4 = {"shape": tuple(rows.shape), "depths": len(fwd.rk4.h),
          "bins": fwd.moment_bins.n_bins, "substeps": fwd.rk4.n_substeps,
          "tile_spans": cuda_transport.tile_spans(len(fwd.rk4.h),
                                                  fwd.moment_bins.n_bins),
          "max_abs_err": k4_err,
          "ms": devtime.queued_ms(k4_call, launches=3),
          "plain_ms": cuda_ms(lambda: cuda_transport.transport_moments_plain(
              rows, fwd.rk4, fwd.moment_bins), reps=1, warmup=0),
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "issue_floor_ms": floor_ms}
    log(f"phase 20a ({smi}): K4 {k4['shape']} M = 100, Be = 150: kernel "
        f"{k4['ms']:.4f} ms, plain {k4['plain_ms']:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), instruction-issue floor {floor_ms:.4f} ms")

    # K2 with one segment on the templates' (32, 4, 100, 150) lattices
    grids = fwd.energy_weight_grid(e0)
    base, draws = fwd.lattice(grids, e_lo[:, None].expand(e0.shape[:2]))
    base, draws = base.contiguous(), draws.contiguous()
    k2_err = phase_tof(dev, base, draws, fwd, label="phase 20b")

    def k2_call():
        return tof_hist_segments(base, draws, fwd.zt, fwd.zw, fwd.win)

    k2_in = k2_in_window(base, fwd.zt, fwd.win)
    b2_ms, b2_by = bound(4 * (2 * base.numel() + 2 * fwd.zt.numel()
                              + base.shape[0] * base.shape[1]
                              * fwd.win.n_pad),
                         4 * base.numel() + 5 * k2_in)
    k2 = {"shape": tuple(base.shape), "segments": 1, "max_abs_err": k2_err,
          "ms": devtime.graph_ms(k2_call),
          "plain_ms": cuda_ms(lambda: tof_hist_segments_plain(
              base, draws, fwd.zt, fwd.zw, fwd.win)),
          "bound_ms": b2_ms, "bound_by": b2_by, "library_ms": None}
    log(f"phase 20b ({smi}): K2 {k2['shape']}, K = 1: kernel "
        f"{k2['ms']:.5f} ms, plain {k2['plain_ms']:.4f} ms, bound "
        f"{b2_ms:.5f} ms ({b2_by})")
    del grids, base, draws

    # the whole generation on the card against the CPU, one slice x 4 runs
    got = templates.templates_from_energies(fwd, e0[:1], e_lo[:1]).cpu()
    cpu_fwd = templates.template_forward(spec, device="cpu")
    want = templates.templates_from_energies(cpu_fwd, e0[:1].cpu(),
                                             e_lo[:1].cpu())
    rel = ((got - want).abs().sum(-1) / want.abs().sum(-1)).max().item()
    log(f"phase 20c: templates card vs CPU on 4 rows x {N_DRAWS} uniform "
        f"energies: max rel L1 {rel:.2e}")
    require(bool(torch.isfinite(got).all()) and rel <= 1e-4,
            "phase 20c: templates card vs CPU within 1e-4 relative L1")
    del cpu_fwd, rows, e0
    torch.cuda.empty_cache()
    times = []
    for _ in range(3):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        made = templates.generate_templates(
            torch.Generator().manual_seed(21), spec, device=dev)
        times.append(time.perf_counter() - t0)
        used = read_counts()
        require(used["transport_moments"] == 1 and used["tof_hist"] == 1
                and used["poisson"] == used["weighted_hist"] == 0,
                f"phase 20c: K4 once and K2 once for the 128 templates "
                f"({used})")
    require(all(np.isfinite(t).all() for t in made),
            "phase 20c: finite templates")
    log(f"phase 20c ({smi}): generate_templates (4 runs x 32 slices x "
        f"{N_DRAWS}) in {times[0]:.4f} s (first call), then "
        f"{times[1]:.4f}, {times[2]:.4f} s; launches {used}")

    where = tmp / "template_fit"
    where.mkdir()
    label = "phase 20d (template_fit)"
    res, text, _, used = run_cli(cli_template, TEMPLATE_FIT, where, label)
    require(used["transport_moments"] == 1 and used["tof_hist"] == 1
            and used["poisson"] == used["weighted_hist"] == 0,
            f"{label}: K4 and K2 once, for the templates ({used})")
    require(np.isfinite(res["scales_median"]).all()
            and np.isfinite(res["coeffs_median"]).all(),
            f"{label}: finite medians")
    ml = res["ml"]
    require(ml["nll"] <= ml["nll_start"] + 1e-6 * abs(ml["nll_start"]),
            f"{label}: the ML fit no worse than its start")
    written = templates.load_templates_csv(str(where / "templates.csv"), 4)
    require(all(np.array_equal(a.astype(np.float32), b)
                for a, b in zip(written, res["templates"])),
            f"{label}: the CSV cache reads back equal to the templates")
    rate_lines = [json.loads(line) for line in text.splitlines()
                  if line.startswith('{"walker_steps_per_sec"')]
    require(len(rate_lines) == 1, f"{label}: the CLI printed its rate")
    rate["cli_template_fit"] = res["walker_steps_per_sec"]
    launches["cli_template_fit"] = used
    log(f"{label} ({smi}): 500 walkers x 200 steps: "
        f"{res['walker_steps_per_sec']:.1f} walker-steps/s (the CLI's own "
        f"line); templates generated in {res['generate_s']:.3f} s; SLSQP "
        f"nll {ml['nll']:.6g} from {ml['nll_start']:.6g} at the start "
        f"(success {ml['success']}), scales {np.round(ml['x'][:3], 4)} "
        f"(synthesis 1.1, 0.6, 1.5); posterior median scales "
        f"{np.round(res['scales_median'], 4)}")
    return {"k4": k4, "k2": k2, "gpu_vs_cpu_rel_l1": rel,
            "generate_s": times, "template_fit": {
                "walker_steps_per_s": res["walker_steps_per_sec"],
                "generate_s": res["generate_s"],
                "ml_scales": ml["x"][:3].tolist(), "ml_nll": ml["nll"],
                "ml_nll_start": ml["nll_start"]}}


def skewnorm_chain(path):
    """A synthetic 4-parameter skew-normal (ppcTools-era) chain, emcee
    text, 60 steps x 16 walkers around (900 keV, 0.05, 1, 1e4)."""
    rng = np.random.default_rng(21)
    center = np.array([900.0, 0.05, 1.0, 1e4])
    scales = np.array([10.0, 0.005, 0.2, 500.0])
    chain = center + scales * rng.standard_normal((60, 16, 4))
    chain_io.append_chain_text(str(path), chain,
                               -500.0 + rng.standard_normal((60, 16)))


def phase_csi2016(dev, smi, tmp, rate, launches):
    """Phase 21: the csi2016 PPC.  PPCSampler.generate card vs CPU on 8
    draws with the same energies; then cli.ppc -model csi2016 at the CLI
    defaults on a synthetic skew-normal chain."""
    card = csi2016.Csi2016Problem(csi2016.default_spec(CSI_PPC_N), device=dev)
    cpu = csi2016.Csi2016Problem(csi2016.default_spec(CSI_PPC_N),
                                 device="cpu")
    thetas = np.array([900.0, 0.05, 1.0, 1e4], np.float32) * (
        1 + 0.01 * np.random.default_rng(22).standard_normal(
            (PPC_CORE_DRAWS, 4)).astype(np.float32))
    t = torch.as_tensor(thetas, device=dev)
    gen = torch.Generator().manual_seed(23)
    e_runs = card.forward.sample_beam_energies(t, gen)
    e_grid = card.forward.sample_beam_energies(t, gen, n_runs=1)
    # K4's input at the PPC's shape: a chunk of the CLI's 100 draws x (4
    # runs + 1 weight grid) rows of 50k energies (one tile: M = 20, Be =
    # 100)
    t100 = t[torch.arange(CSI_PPC_DRAWS, device=dev) % PPC_CORE_DRAWS]
    rows = card.forward.sample_beam_energies(t100, gen, n_runs=5).reshape(
        -1, CSI_PPC_N).contiguous()
    reset_counts()
    got = ppc_with_energies(card, thetas, e_runs, e_grid, 3)
    torch.cuda.synchronize()
    used = read_counts()
    want = ppc_with_energies(cpu, thetas, e_runs.cpu(), e_grid.cpu(), 3)

    def rel_l1(a, b):
        a, b = a.reshape(PPC_CORE_DRAWS, -1), b.reshape(PPC_CORE_DRAWS, -1)
        return float((np.abs(a - b).sum(-1) / np.abs(b).sum(-1)).max())

    rel = max(rel_l1(g, w) for g, w in zip(got.tof_spectra,
                                           want.tof_spectra))
    rel_grid = rel_l1(got.neutron_spectra, want.neutron_spectra)
    log(f"phase 21a: csi2016 PPC card vs CPU on {PPC_CORE_DRAWS} draws x 4 "
        f"runs x {CSI_PPC_N} energies: spectra max rel L1 {rel:.2e}, "
        f"weight grids {rel_grid:.2e}; launches {used}")
    require(rel <= 1e-4 and rel_grid <= 1e-4,
            "phase 21a: csi2016 PPC card vs CPU within 1e-4 rel L1")
    require(used["transport_moments"] == 1 and used["tof_hist"] == 1
            and used["poisson"] == used["weighted_hist"] == 0,
            "phase 21a: K4 and K2 once per chunk, K1 and K3 never")
    fwd = card.forward
    k4_err, in_range = k4_check_tiled(rows, fwd.rk4, fwd.moment_bins,
                                      "phase 21a")

    def k4_call():
        return cuda_transport.transport_moments(rows, fwd.rk4,
                                                fwd.moment_bins)

    b_ms, b_by, floor_ms = k4_bound(rows, fwd.rk4, fwd.moment_bins, in_range)
    k4 = {"shape": tuple(rows.shape), "depths": len(fwd.rk4.h),
          "bins": fwd.moment_bins.n_bins, "substeps": fwd.rk4.n_substeps,
          "tile_spans": cuda_transport.tile_spans(len(fwd.rk4.h),
                                                  fwd.moment_bins.n_bins),
          "max_abs_err": k4_err,
          "ms": devtime.queued_ms(k4_call, launches=10),
          "plain_ms": cuda_ms(lambda: cuda_transport.transport_moments_plain(
              rows, fwd.rk4, fwd.moment_bins), reps=2, warmup=1),
          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
          "issue_floor_ms": floor_ms}
    log(f"phase 21a ({smi}): K4 {k4['shape']} M = 20, Be = 100: kernel "
        f"{k4['ms']:.4f} ms, plain {k4['plain_ms']:.1f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), instruction-issue floor {floor_ms:.4f} ms")
    del card, cpu, e_runs, e_grid, rows

    chain_path = tmp / "old_campaign.dat"
    skewnorm_chain(chain_path)
    where = tmp / "ppc_csi2016"
    where.mkdir()
    label = "phase 21b (ppc csi2016)"
    argv = ["-chainFilename", str(chain_path), "-model", "csi2016",
            "-nChainEntries", str(CSI_PPC_DRAWS), "-nSamplesFromTOF",
            str(CSI_PPC_N)]
    res, text, _, used = run_cli(cli_ppc, argv, where, label)
    spec = csi2016.default_spec(CSI_PPC_N)
    windows = csi2016.Csi2016Problem(spec, device="cpu").windows
    for run, win in enumerate(windows):
        bands = np.loadtxt(where / f"ppc_run{run}_bands.txt")
        require(bands.shape == (3, win.n_bins) and np.isfinite(bands).all()
                and np.all(bands[0] <= bands[1])
                and np.all(bands[1] <= bands[2]),
                f"{label}: run {run} bands (3, {win.n_bins}), finite, "
                f"ordered")
    n_en = len(spec.en_centers())
    si, sp = (where / "ppc_sdef.txt").read_text().splitlines()
    require(si.startswith("si100 a") and len(si.split()) == 2 + n_en
            and sp.startswith("sp100") and len(sp.split()) == 1 + n_en,
            f"{label}: SDEF card with one si and sp entry per energy")
    chunks = -(-CSI_PPC_DRAWS // PPC_CHUNK)
    require(used["transport_moments"] == chunks and used["tof_hist"] == chunks
            and used["poisson"] == used["weighted_hist"] == 0,
            f"{label}: K4 and K2 once per chunk, K1 and K3 never ({used})")
    chain, probs, *_ = chain_io.read_chain_text(str(chain_path))
    sampler = ppc_mod.PPCSampler(
        csi2016.Csi2016Problem(spec, device=dev), chain, probs)
    warm = []
    for _ in range(PPC_WARM_REPEATS):
        t0 = time.perf_counter()
        sampler.generate(torch.Generator().manual_seed(0), CSI_PPC_DRAWS)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    warm_s = float(np.median(warm))
    rate["ppc_csi2016_draws_per_s"] = CSI_PPC_DRAWS / res["generate_s"]
    rate["ppc_csi2016_warm_draws_per_s"] = CSI_PPC_DRAWS / warm_s
    launches["cli_ppc_csi2016"] = dict(used, chunks=chunks)
    log(f"{label} ({smi}): {CSI_PPC_DRAWS} posterior draws x 4 runs x "
        f"{CSI_PPC_N} in {res['generate_s']:.4f} s (the CLI's one cold "
        f"call) -> {CSI_PPC_DRAWS / res['generate_s']:.1f} PPC draws/s; "
        f"{PPC_WARM_REPEATS} warm calls: median {warm_s:.4f} s -> "
        f"{CSI_PPC_DRAWS / warm_s:.1f} PPC draws/s (range "
        f"{CSI_PPC_DRAWS / max(warm):.1f}-{CSI_PPC_DRAWS / min(warm):.1f})")
    return {"gpu_vs_cpu": {"spectra_rel_l1": rel, "grids_rel_l1": rel_grid},
            "generate_s": res["generate_s"], "warm_generate_s": warm,
            "k4": k4}


# --- phase 24: posterior parity with the JAX package ----------------------

PARITY_DIR = Path(__file__).resolve().parent / "perf" / "parity"


def parity_launches(name, used, label, evals=1):
    """The case's kernels (``parity.CASES`` or ``PT_CASES``) launched, the
    others not; K2 (K3 where no K2 is on the path) at least once per
    evaluation (``evals``: the chain's, its initial refreshes aside), and
    oneBD counts launches K1 twice per evaluation (cell counts and
    background)."""
    on_path = (parity.CASES.get(name) or parity.PT_CASES[name])["kernels"]
    main = "tof_hist" if "tof_hist" in on_path else "weighted_hist"
    require(used[main] >= evals,
            f"{label}: {main} once per evaluation on {name}'s path ({used})")
    for kernel, n in used.items():
        if kernel in on_path:
            require(n > 0, f"{label}: {kernel} launched on {name}'s path")
        else:
            require(n == 0, f"{label}: {kernel} not launched on {name}'s "
                    f"path ({n})")
    if name == "onebd_hardcore_counts":
        require(used["poisson"] == 2 * used["tof_hist"],
                f"{label}: K1 twice per oneBD evaluation ({used})")
    elif "poisson" in on_path:
        require(used["poisson"] == used["tof_hist"],
                f"{label}: K1 once per evaluation ({used})")


def density_gates(dens) -> str:
    """A density check's gates as text."""
    if "chi2_dof" not in dens:
        return (f"spread {dens['spread_nats']:.4f} nats (< "
                f"{dens['spread_tol_nats']}), gradient rel L2 max "
                f"{dens['grad_rel_l2_max']:.3e} (< {dens['grad_tol']}), "
                f"median {dens['grad_rel_l2_median']:.3e} (< "
                f"{dens['grad_median_tol']})")
    sh = dens["neg_inf"]
    return (f"spread {dens['spread_nats']:.4f} nats (< "
            f"{dens['spread_gate_nats']:.4f}), chi2/dof "
            f"{dens['chi2_dof']:.4f} (<= {dens['chi2_dof_max']:.4f}), noise "
            f"{dens['noise_nats']:.4f}, {dens['n_finite']} thetas compared; "
            f"-inf share JAX {sh['ref_share']:.4f} / port "
            f"{sh['port_share']:.4f} (z {sh['z_pooled']:+.2f}, per theta "
            f"{sh['z_per_theta']:.2f}, < {parity.Z_SE_MAX})")


def parity_chain(name, ref, problem, smi, launches):
    """24b: the port's DE chain of a case at the JAX chain's walkers and
    steps, its dz table against the JAX chain's summary (z_se on the
    batch-median SE; the tool's printed beside it)."""
    reset_counts()
    t0 = time.perf_counter()
    pos, acc = parity.run_port_chain(ref, problem, seed=24)
    seconds = time.perf_counter() - t0
    used = read_counts()
    ch = ref.meta["chain"]
    parity_launches(name, used, "phase 24b",
                    evals=2 * (ch["burnin"] + ch["main"]) + 1)
    launches[f"parity_chain_{name}"] = used
    table = parity.dz_table(ch["summary"], pos, ref.names)
    table.update(acceptance=acc, ref_acceptance=ch["acceptance"],
                 seconds=seconds, walkers=ch["walkers"],
                 burnin=ch["burnin"], main=ch["main"])
    log(f"phase 24b ({smi}): {name} DE chain, {ch['walkers']} walkers x "
        f"{ch['burnin']} + {ch['main']} steps: worst |dz| "
        f"{table['worst_dz']:.4f}, worst |z_se| {table['worst_z_se']:.3f} "
        f"(the tool's SE: {table['worst_z_se_tool']:.3f}), min ESS port "
        f"{table['min_port_ess']:.0f} / JAX {table['min_ref_ess']:.0f}, "
        f"acceptance {acc:.3f} / {ch['acceptance']:.3f}, {seconds:.1f} s, "
        f"launches {used} -> {table['verdict']}")
    for line in parity.format_dz(table).splitlines():
        log(f"  {line}")
    require(table["verdict"] == "PASS",
            f"phase 24b: {name} chain parity with the JAX package")
    return table


def parity_evidence(dev, smi, launches):
    """24c: one port seed of PT ``-model tof`` (the reference's cut of the
    CLI's steps) on the JAX package's data: its ln Z within 4 noise of the
    JAX seeds' mean, the noise from the JAX seeds' spread (one seed of
    the port has none of its own), and its cold chain's dz table against
    the JAX seeds' pooled cold chains."""
    name = "pt_shifting_gaussian_tof"
    ref = parity.load_reference(PARITY_DIR / f"{name}.npz")
    meta = ref.meta
    jax_ln_z = [r["ln_z"] for r in meta["runs"]]
    reset_counts()
    ln_z, d_ln_z, cold, _, seconds = parity.run_port_pt(
        meta, ref.observed, dev, seed=24)
    used = read_counts()
    parity_launches(name, used, "phase 24c",
                    evals=2 * (meta["burnin"] + meta["steps"]) + 1)
    launches[f"parity_{name}"] = used
    ev = parity.evidence_parity(jax_ln_z, [ln_z],
                                port_var=np.var(jax_ln_z, ddof=1))
    table = parity.dz_table(meta["cold_summary"], cold, ref.names)
    log(f"phase 24c ({smi}): {name}, {meta['temps']} temps x "
        f"{meta['walkers']} walkers x {meta['burnin']} + {meta['steps']} "
        f"steps: ln Z port {ln_z:.4f} (+- {d_ln_z:.4f} trapezoid halving) "
        f"vs JAX {ev['ref_mean']:.4f} (sd {ev['ref_sd']:.4f} over "
        f"{len(jax_ln_z)} seeds): {ev['z']:+.2f} noise (< "
        f"{parity.LN_Z_SIGMAS}) -> {ev['verdict']}; cold chain worst |dz| "
        f"{table['worst_dz']:.4f}, worst |z_se| {table['worst_z_se']:.3f} "
        f"-> {table['verdict']}; {seconds:.1f} s, launches {used}")
    for line in parity.format_dz(table, ("JAX", "port")).splitlines():
        log(f"  {line}")
    require(ev["verdict"] == "PASS",
            f"phase 24c: {name} ln Z against the JAX package's seeds")
    require(table["verdict"] == "PASS",
            f"phase 24c: {name} cold chain against the JAX package's")
    return {"evidence": ev, "cold_chain": table, "seconds": seconds,
            "ln_z": ln_z, "d_ln_z": d_ln_z}


def phase_parity(dev, smi, launches):
    """24a: the same-theta density parity of every case of
    ``parity.CASES`` against the JAX package's values
    (perf/parity/<case>.npz, made on the CPU by
    perf/parity_reference.py), the -inf shares beside it; 24b: the port's
    DE chains of the chain cases at the JAX chains' walkers and steps,
    gated by dz and z_se; 24c: PT
    ``-model tof``'s ln Z and cold chain against the JAX seeds'.  A gate
    that does not pass fails the script."""
    out = {}
    for name in parity.CASES:
        ref = parity.load_reference(PARITY_DIR / f"{name}.npz")
        problem = parity.build_problem(ref.meta, dev)
        reset_counts()
        t0 = time.perf_counter()
        dens = parity.density_check(ref, problem, seed=24)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        used = read_counts()
        parity_launches(name, used, "phase 24a")
        launches[f"parity_{name}"] = used
        row = {k: v for k, v in dens.items() if not k.startswith("port_")}
        row["seconds"] = seconds
        log(f"phase 24a ({smi}): {name} at {dens['n_thetas']} JAX thetas: "
            f"{density_gates(dens)}, offset {dens['mean_offset_nats']:+.3f} "
            f"nats, correlations {dens['correlations']}, {seconds:.2f} s, "
            f"launches {used} -> {dens['verdict']}")
        require(dens["verdict"] == "PASS",
                f"phase 24a: {name} density parity with the JAX package")
        out[name] = {"density": row}
        if name in parity.DE_CHAIN_CASES:
            out[name]["chain"] = parity_chain(name, ref, problem, smi,
                                              launches)
        del problem
        torch.cuda.empty_cache()
    out["pt_shifting_gaussian_tof"] = parity_evidence(dev, smi, launches)
    return out


# --- phase 23: walker sharding over torch.distributed ranks ---------------

SHARD_STEPS = 20                     # 23c: DE steps of the two-rank fit
SHARD_PT_STEPS = 5                   # 23d: PT steps of -model tof
SHARD_RANKS = 2
SHARD_DEADLINE_S = 600.0
# contract A on the card: tests/test_sharding.py's tolerances
POS_RTOL, LP_RTOL = 2e-5, 2e-4


def shard_setup(dev):
    """23b-c: the slice at full width (simultFit counts, 4 runs, 200k
    draws, corrected likelihood): problem, log-prob, initial walkers."""
    spec = simult.default_spec(n_samples=N_DRAWS, sampling="counts")
    prob = simult.SimultFitProblem(spec, n_runs=N_RUNS, likelihood="poisson",
                                   device=dev)
    truth = np.concatenate([simult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])
    obs = data_io.synthesize_observed(9, prob, truth)
    p0 = prob.initial_walkers_from_observed(
        torch.Generator(dev).manual_seed(1), N_WALKERS, obs)
    return prob, prob.make_log_prob_fn(obs), p0


def shard_fit(logp, p0, dev):
    """23c: SHARD_STEPS DE steps from p0 with fixed seeds; returns the
    initial log-probs, the chain (positions, log-probs), its final state
    and the walker-steps/s of the steps (host clock, synchronised)."""
    state = sampler.init_state(p0, logp,
                               generator=torch.Generator(dev).manual_seed(2),
                               eval_generator=torch.Generator()
                               .manual_seed(3))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chain = sampler.run_mcmc(state, SHARD_STEPS, logp, move="de")
    torch.cuda.synchronize()
    rate = SHARD_STEPS * N_WALKERS / (time.perf_counter() - t0)
    return state.log_probs, chain, rate


def shard_pt(loglike, logprior, p0, dev, loglike_batch=None):
    """23d: SHARD_PT_STEPS tempered steps of -model tof from p0."""
    chain = sampler.sample_pt(
        p0, SHARD_PT_STEPS, loglike, logprior, stochastic=True,
        generator=torch.Generator(dev).manual_seed(4),
        eval_generator=torch.Generator().manual_seed(5),
        loglike_batch=loglike_batch)
    return chain.positions, chain.log_like, chain.log_prior


def shard_rank():
    """One of two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
    GPU): 23c, the sharded full-width fit with K1 and K2 counted on this
    rank's shard, the log-probs of a half-ensemble and contract C; 23d,
    sharded PT."""
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    mesh = parallel.make_mesh(dev)
    prob, logp, p0 = shard_setup(dev)
    sharded = parallel.make_sharded_logp_batch(logp, mesh,
                                               by_row=prob.draws_by_row)
    half = sharded(p0[::2].contiguous(), torch.Generator().manual_seed(6))
    reset_counts()
    lp0, chain, rate = shard_fit(sharded, p0, dev)
    torch.cuda.synchronize()
    used = read_counts()
    # contract C: every rank holds the same positions
    every = parallel_mesh.all_gather_rows(chain.state.positions[None], mesh)
    same = all(torch.equal(every[0], p) for p in every[1:])
    out = {"rank": mesh.rank, "half_log_probs": half.cpu(),
           "initial_log_probs": lp0.cpu(), "positions": chain.positions.cpu(),
           "log_probs": chain.log_probs.cpu(), "same_on_ranks": same,
           "launches": used, "rate": rate,
           "evaluations": 2 * SHARD_STEPS + 1}
    del prob, logp, sharded, chain
    torch.cuda.empty_cache()
    _, _, loglike, logprior, p_pt = cli_sg.tof_pt_setup(0, PT_T, PT_W, dev)
    batch = parallel.make_sharded_pt_batch(loglike, mesh, n_temps=PT_T,
                                           by_row=True)
    out["pt"] = [t.cpu() for t in shard_pt(loglike, logprior, p_pt, dev,
                                           batch)]
    return out


def contract_a(got, want, rtol, label):
    """Contract A on the card: the same non-finite entries, the finite ones
    within ``rtol``; returns (bitwise, max |d|)."""
    got, want = got.double(), want.double()
    fin = torch.isfinite(want)
    require(torch.equal(fin, torch.isfinite(got))
            and torch.equal(got[~fin], want[~fin]),
            f"{label}: the same non-finite entries")
    d = (got[fin] - want[fin]).abs()
    require(bool(torch.all(d <= rtol * want[fin].abs())),
            f"{label}: within rtol {rtol} (max |d| {d.max().item():g})")
    return bool(torch.equal(got, want)), d.max().item() if d.numel() else 0.0


def phase_sharding_k1(dev, smi, rates_w, k1_phase6_ms):
    """23a: K1 with a counter offset at the slice's (256) x 4 x 514 rates:
    the second half alone with offset 128 x 4 x 514 equals the second half
    of the full launch; offset 0 is the launch without one; a shard of
    every rung with blocks; the kernel against its plain version at an
    offset; device times with offset 0 and with an offset, in turns."""
    w, c = rates_w.shape
    half, per = w // 2, N_RUNS * c
    full = poisson(rates_w, (7, 8), n_runs=N_RUNS)
    second = poisson(rates_w[half:].contiguous(), (7, 8), n_runs=N_RUNS,
                     offset=half * per)
    require(torch.equal(second, full[half:]),
            "23a: the second half alone, offset by the first, == the second "
            "half of the full launch")
    require(torch.equal(poisson(rates_w, (7, 8), n_runs=N_RUNS, offset=0),
                        full), "23a: offset 0 == the launch without one")
    words = torch.tensor([7, 8], dtype=torch.int64, device=dev)
    require(torch.equal(poisson(rates_w[half:].contiguous(), words,
                                n_runs=N_RUNS, offset=half * per),
                        full[half:]), "23a: offset with the seed tensor")
    t, n, m = 8, w // 8, w // 16        # rank 1's half of every rung
    rows = rates_w.reshape(t, n, c)[:, m:].reshape(t * m, c).contiguous()
    blocked = poisson(rows, (7, 8), n_runs=N_RUNS, offset=m * per,
                      blocks=(m * per, n * per))
    require(torch.equal(blocked.reshape(t, m, N_RUNS, c),
                        full.reshape(t, n, N_RUNS, c)[:, m:]),
            "23a: a shard of every rung (blocks) == its rows of the launch")
    lam = rates_w[half:, None].expand(-1, N_RUNS, -1).contiguous()
    plain = plain_poisson.poisson_ptrs(lam, (7, 8), offset=half * per)
    same = (second == plain).double().mean().item()
    err = (second - plain).abs().max().item()
    zk, zp = poisson_z(second, lam), poisson_z(plain, lam)
    require(same >= 0.999 and max(map(abs, zk + zp)) < 5,
            "23a: K1 == plain at an offset")
    rates_h = rates_w[half:].contiguous()
    ms = devtime.graphs_in_turns({
        "offset 0": lambda: poisson(rates_h, (5, 6), n_runs=N_RUNS),
        "offset": lambda: poisson(rates_h, (5, 6), n_runs=N_RUNS,
                                  offset=half * per)})
    log(f"phase 23a ({smi}): K1 with a counter offset: rows [{half}, {w}) "
        f"of {tuple(full.shape)} alone equal the full launch's, offset 0 the "
        f"launch without one, a shard of every rung its rows (torch.equal); "
        f"kernel vs plain at the offset: equal={same:.6f} max|diff|={err:g}"
        f" z=({zk[0]:+.2f}, {zk[1]:+.2f}); device ms at ({half}) x {N_RUNS} "
        f"x {c}: offset 0 {ms['offset 0']:.5f}, offset {ms['offset']:.5f} "
        f"(in turns), phase 6's K1 at this shape {k1_phase6_ms:.5f}")
    return {"max_abs_err": err, "equal_share": same,
            "ms_offset_0": ms["offset 0"], "ms_offset": ms["offset"]}


def phase_sharding(dev, smi, tmp, rates_w, k1_phase6_ms):
    """Phase 23: walker sharding over torch.distributed ranks on the one
    card: (a) K1's counter offset; (b) a one-rank NCCL group at full
    width; (c) two gloo ranks sharing cuda:0, 20 DE steps; (d) sharded PT;
    (e) the CLI's -mesh cap."""
    out = {"k1": phase_sharding_k1(dev, smi, rates_w, k1_phase6_ms)}

    # (b) the production backend's path: a one-rank NCCL group
    prob, logp, p0 = shard_setup(dev)
    parallel_dist.initialize(f"127.0.0.1:{parallel_launch.free_port()}", 1,
                             0, device=dev, timeout_s=SHARD_DEADLINE_S)
    try:
        mesh = parallel.make_mesh(dev)
        sharded = parallel.make_sharded_logp_batch(logp, mesh,
                                                   by_row=prob.draws_by_row)
        for rows in (p0, p0[::2].contiguous()):
            got = sharded(rows, torch.Generator().manual_seed(6))
            want = logp(rows, torch.Generator().manual_seed(6))
            require(torch.equal(got, want),
                    f"23b: one NCCL rank == the plain evaluator on "
                    f"{rows.shape[0]} walkers, bit for bit")
        backend = torch.distributed.get_backend()
    finally:
        torch.distributed.destroy_process_group()
    log(f"phase 23b: a one-rank {backend} group at full width ({N_WALKERS} "
        f"and {N_WALKERS // 2} walkers x {N_RUNS} runs x {N_DRAWS} draws, "
        f"counts): make_sharded_logp_batch == the plain evaluator, bit for "
        f"bit")

    # (c), (d): the one-process references, then two gloo ranks
    half = logp(p0[::2].contiguous(), torch.Generator().manual_seed(6))
    lp0, chain, rate_one = shard_fit(logp, p0, dev)
    del prob, logp
    _, _, loglike, logprior, p_pt = cli_sg.tof_pt_setup(0, PT_T, PT_W, dev)
    pt_ref = shard_pt(loglike, logprior, p_pt, dev)
    del loglike, logprior, p_pt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = parallel_launch.launch(shard_rank, SHARD_RANKS, backend="gloo",
                                   timeout_s=SHARD_DEADLINE_S)
    wall = time.perf_counter() - t0
    res = {"bitwise": {}, "max_abs_diff": {}}
    for r in ranks:
        for name, got, want, rtol in (
                ("half_log_probs", r["half_log_probs"], half, LP_RTOL),
                ("initial_log_probs", r["initial_log_probs"], lp0, LP_RTOL),
                ("positions", r["positions"], chain.positions, POS_RTOL),
                ("log_probs", r["log_probs"], chain.log_probs, LP_RTOL)):
            bit, d = contract_a(got, want.cpu(), rtol,
                                f"23c rank {r['rank']} {name}")
            res["bitwise"][f"{name}_rank{r['rank']}"] = bit
            res["max_abs_diff"][f"{name}_rank{r['rank']}"] = d
        require(r["same_on_ranks"], "23c: contract C, every rank holds the "
                "same positions")
        used = r["launches"]
        require(used["poisson"] == used["tof_hist"] == r["evaluations"]
                and used["weighted_hist"] == used["transport_moments"] == 0,
                f"23c rank {r['rank']}: K1 and K2 once per sharded "
                f"evaluation on its shard ({used})")
        for name, got, want in zip(("positions", "log_like", "log_prior"),
                                   r["pt"], pt_ref):
            bit, d = contract_a(got, want.cpu(),
                                POS_RTOL if name == "positions" else LP_RTOL,
                                f"23d rank {r['rank']} {name}")
            res["bitwise"][f"pt_{name}_rank{r['rank']}"] = bit
            res["max_abs_diff"][f"pt_{name}_rank{r['rank']}"] = d
    res.update(launches_per_rank=[r["launches"] for r in ranks],
               evaluations_per_rank=ranks[0]["evaluations"],
               rate_two_ranks_one_card=[r["rate"] for r in ranks],
               rate_one_process=rate_one, ranks_wall_s=wall)
    log(f"phase 23c ({smi}): two gloo ranks sharing cuda:0, {SHARD_STEPS} "
        f"DE steps at {N_WALKERS} walkers x {N_RUNS} runs x {N_DRAWS} "
        f"draws (each rank {N_WALKERS // 2 // SHARD_RANKS} walkers of every "
        f"half-ensemble): contract A against one process (positions rtol "
        f"{POS_RTOL}, log-probs rtol {LP_RTOL}) held; bitwise "
        f"{res['bitwise']}; max |d| {res['max_abs_diff']}; contract C held; "
        f"launches per rank {res['launches_per_rank']} over "
        f"{res['evaluations_per_rank']} evaluations; "
        f"{np.round(res['rate_two_ranks_one_card'], 1).tolist()} "
        f"walker-steps/s (two ranks sharing one card; not a scaling figure)"
        f", one process {rate_one:.1f}; the ranks' wall clock {wall:.1f} s")
    log(f"phase 23d ({smi}): make_sharded_pt_batch over the two ranks, "
        f"-model tof ({PT_T} temps x {PT_W} walkers, 2 runs, 50k draws, "
        f"{SHARD_PT_STEPS} steps): contract A against the unsharded "
        f"sample_pt held")
    out.update(res)

    # (e) -mesh 2 on a one-GPU host: capped to one GPU, the -mesh 1 chain
    flags = CLI_FULL + ["-sampling", "counts", "-likelihood", "poisson",
                        "-nMainSteps", "4"]
    chains = {}
    for mesh_n in ("2", "1"):
        where = tmp / f"mesh{mesh_n}"
        where.mkdir()
        _, text, _, used = run_cli(cli_simult, flags + ["-mesh", mesh_n],
                                   where, f"phase 23e (-mesh {mesh_n})")
        chains[mesh_n] = (where / "mainchain.dat").read_bytes()
        if mesh_n == "2":
            n_gpus = torch.cuda.device_count()
            require(n_gpus > 1 or f"-mesh 2 capped at the {n_gpus} GPU(s)"
                    in text, "23e: -mesh 2 says it is capped at one GPU")
    require(chains["2"] == chains["1"],
            "23e: the -mesh 2 chain (one GPU) == the -mesh 1 chain")
    log(f"phase 23e: cli.simult_fit -mesh 2 on {torch.cuda.device_count()} "
        f"GPU(s): capped, says so, and writes the -mesh 1 mainchain.dat "
        f"byte for byte ({len(chains['1'])} bytes)")
    return out


# --- phase 22: parallel tempering -----------------------------------------

PT_T, PT_W = 20, 100                 # the CLI's -nTemps, -ptWalkers
# 22b: the analytic branch's PT burn-in and steps, half the CLI's defaults
# (1000 + 10000) to keep the script's time
PT_SG_BURN, PT_SG_STEPS = 500, 5000
PT_TOF_BURN, PT_TOF_STEPS = 20, 60   # -model tof at full width, depth cut
PT_PROFILE_STEPS = 3


def _quadratic(theta):
    """A log-density whose every operation is elementwise and in a fixed
    order, so the card and the CPU compute the same bits."""
    x, y, z = theta[..., 0], theta[..., 1], theta[..., 2]
    return -0.5 * (((x - 0.3) * (x - 0.3) + y * y) + 4.0 * z * z)


def _box(theta):
    return torch.where(torch.all(theta.abs() < 2.5, dim=-1), 0.0, -torch.inf)


def phase_pt_cores(dev):
    """Phase 22a: the tempered stretch and DE cores and the exchange core at
    the CLI's widths (20 x 100 x 3), the same draws on the card and the
    CPU: positions, log-likelihoods, log-priors, accept masks and swap
    counts equal."""
    rng = np.random.default_rng(221)
    n_half = PT_W // 2
    pos0 = rng.normal(0.0, 1.0, (PT_T, PT_W, 3)).astype(np.float32)
    betas = sampler.default_beta_ladder(PT_T).astype(np.float32)
    draws = {
        "u": rng.random((PT_T, n_half), np.float32),
        "j": rng.integers(0, n_half, (PT_T, n_half)),
        "j2": rng.integers(0, n_half - 1, (PT_T, n_half)),
        "g": (0.97 * (1 + 0.1 * rng.standard_normal((PT_T, n_half)))
              ).astype(np.float32),
        "log_u": np.log(rng.random((PT_T, n_half))).astype(np.float32),
        "perms": np.stack([rng.permutation(PT_W) for _ in range(PT_T - 1)]),
        "log_u_x": np.log(rng.random((PT_T - 1, PT_W))).astype(np.float32),
    }

    def run(where):
        t = {k: torch.tensor(v, device=where) for k, v in draws.items()}
        pos = torch.tensor(pos0, device=where)     # a copy: updated in place
        ll, lp = _quadratic(pos), _box(pos)
        b = torch.as_tensor(betas, device=where)

        def evaluate(prop):
            return _quadratic(prop), _box(prop)

        acc = [sampler.tempered_stretch_core(
            pos, ll, lp, b, 0, t["u"], t["j"], t["log_u"], evaluate)]
        j2 = (t["j"] + 1 + t["j2"]) % n_half
        acc.append(sampler.tempered_de_core(pos, ll, lp, b, 1, t["g"],
                                            t["j"], j2, t["log_u"],
                                            evaluate))
        swaps = sampler.replica_exchange_core(pos, ll, lp, b, t["perms"],
                                              t["log_u_x"])
        return [v.cpu() for v in (pos, ll, lp, *acc, swaps)]

    card, cpu = run(dev), run("cpu")
    names = ("positions", "log-likelihoods", "log-priors",
             "stretch accepts", "DE accepts", "swap accepts")
    equal = {n: torch.equal(a, b) for n, a, b in zip(names, card, cpu)}
    n_swaps = card[-1].sum(1)
    log(f"phase 22a: tempered stretch, DE and exchange cores at ({PT_T}, "
        f"{PT_W}, 3), the same draws, card vs CPU equal: {equal}; accepts "
        f"{int(card[3].sum())} + {int(card[4].sum())} of "
        f"{2 * PT_T * n_half}, swaps per pair {n_swaps.tolist()}")
    require(all(equal.values()), f"22a: cores card vs CPU {equal}")
    require(torch.equal(n_swaps, cpu[-1].sum(1)), "22a: n_swaps_accepted")
    return {"equal": equal, "swaps": n_swaps.tolist()}


def k12_at_pt_shapes(dev, smi, forward, thetas, n_runs):
    """K1 and K2 at one tempered half-update of -model tof (T x W/2 walkers
    x n_runs): each against its plain version (K1 draw for draw, K2 as
    phase 3 holds it), their device times in turns, bounds, plain and
    library times; the kernels line's rows at these shapes."""
    params = thetas[:, :4]
    rates = forward.counts_rates(params).lam                 # (N, F + 2)
    lam = rates[:, None].expand(-1, n_runs, -1).contiguous()
    kern = poisson(rates, (41, 42), n_runs=n_runs)
    plain = plain_poisson.poisson_ptrs(lam, (41, 42))
    k1_err = (kern - plain).abs().max().item()
    same = (kern == plain).double().mean().item()
    require(same >= 0.999, "22c: K1 == plain at the PT shape")
    grids, e0_means = forward.grid_and_mean(params,
                                            torch.Generator().manual_seed(43))
    base, draws = forward.lattice(grids, e0_means)
    base, draws = base.contiguous(), draws.contiguous()
    k2_err = phase_tof(dev, base, draws, forward, "phase 22c")
    zt, zw, win = forward.zt, forward.zw, forward.win
    calls = {"poisson": lambda: poisson(rates, (5, 6), n_runs=n_runs),
             "tof_hist": lambda: tof_hist_segments(base, draws, zt, zw, win)}
    ms = devtime.graphs_in_turns(calls)
    vals = base[..., None] + zt
    k2_in = ((vals >= win.lo[:, None, None, None])
             & (vals <= win.hi[:, None, None, None])).sum().item()
    del vals
    rows = {
        "poisson": {
            "shape": list(lam.shape), "max_abs_err": k1_err,
            "equal_share": same, "ms": ms["poisson"],
            "plain_ms": cuda_ms(lambda: plain_poisson.poisson_ptrs(
                lam, (5, 6)), reps=10),
            "library_ms": devtime.graph_ms(lambda: torch.poisson(lam)),
            **dict(zip(("bound_ms", "bound_by"), bound(
                4 * (rates.numel() + lam.numel()), 130 * lam.numel())))},
        "tof_hist": {
            "shape": list(base.shape), "max_abs_err": k2_err,
            "ms": ms["tof_hist"],
            "plain_ms": cuda_ms(lambda: tof_hist_segments_plain(
                base, draws, zt, zw, win)),
            "library_ms": None,
            **dict(zip(("bound_ms", "bound_by"), bound(
                4 * (2 * base.numel() + 2 * zt.numel()
                     + base.shape[0] * n_runs * win.n_pad),
                4 * base.numel() * zt.shape[1] + 5 * k2_in)))},
    }
    for name, row in rows.items():
        lib = row["library_ms"]
        log(f"phase 22c ({smi}): {name} {tuple(row['shape'])} (one tempered "
            f"half-update): kernel {row['ms']:.5f} ms, plain "
            f"{row['plain_ms']:.4f} ms, library "
            f"{'none' if lib is None else f'{lib:.5f} ms'}, bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), max|diff| "
            f"{row['max_abs_err']:g}")
    return rows


def phase_pt(dev, smi, tmp, rate, launches):
    """Phase 22: parallel tempering.  (a) the cores card vs CPU; (b)
    cli.shifting_gaussian at its defaults but the PT depth; (c) -model tof at full width;
    (d) compat.emcee.PTSampler on the card."""
    out = {"cores": phase_pt_cores(dev)}

    label = "phase 22b (shifting_gaussian, analytic, PT depth cut)"
    where = tmp / "pt_analytic"
    where.mkdir()
    res, _, _, used = run_cli(cli_sg, ["-ptBurnin", str(PT_SG_BURN),
                                       "-ptSteps", str(PT_SG_STEPS)],
                              where, label)
    swaps = res["pt_swap_acceptance"]
    sigma, mid = res["pt"]["sigma"], 5 * res["pt"]["m"] + res["pt"]["b"]
    ln_z, d_ln_z = res["pt_ln_evidence"]
    log(f"{label} ({smi}): {PT_T} temps x {PT_W} walkers, {PT_SG_BURN} + "
        f"{PT_SG_STEPS} steps thin 10: {res['pt_walker_steps_per_sec']:.1f} PT "
        f"walker-steps/s; ensemble (100 walkers x 500 steps) "
        f"{res['ensemble_walker_steps_per_sec']:.1f} walker-steps/s; swap "
        f"acceptance per rung {np.round(swaps, 4).tolist()}; ln Z = "
        f"{ln_z:.4f} +- {d_ln_z:.4f}; cold medians sigma {sigma:.4f}, "
        f"5m + b {mid:.4f}")
    require(len(swaps) == PT_T - 1 and all(0.0 < a < 1.0 for a in swaps),
            f"{label}: every rung's swap acceptance in (0, 1)")
    require(abs(sigma - 0.4) < 0.2 and abs(mid - 3.5) < 0.25,
            f"{label}: cold medians near the truth")
    require(np.isfinite(ln_z) and 0.0 <= d_ln_z < 1.0,
            f"{label}: ln Z finite with an error below 1")
    require(not any(used.values()), f"{label}: no kernel launched ({used})")
    rate["cli_pt_analytic"] = res["pt_walker_steps_per_sec"]
    rate["cli_pt_analytic_ensemble"] = res["ensemble_walker_steps_per_sec"]
    launches["cli_pt_analytic"] = used
    out["analytic"] = {k: res[k] for k in (
        "pt_walker_steps_per_sec", "ensemble_walker_steps_per_sec",
        "pt_swap_acceptance", "pt_ln_evidence", "pt", "ensemble")}

    label = "phase 22c (shifting_gaussian -model tof)"
    where = tmp / "pt_tof"
    where.mkdir()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    res, _, evals, used = run_cli(
        cli_sg, ["-model", "tof", "-ptBurnin", str(PT_TOF_BURN),
                 "-ptSteps", str(PT_TOF_STEPS)], where, label)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    halves = 2 * (PT_TOF_BURN + PT_TOF_STEPS)
    # the forward runs once for the synthetic data and once for the
    # initial walkers; every other evaluation is a half-update's
    per_half = {k: (used[k] - 2) / halves for k in ("poisson", "tof_hist")}
    ms_per_step = 1e3 * PT_T * PT_W / res["pt_walker_steps_per_sec"]
    problem, _, loglike, logprior, p0 = cli_sg.tof_pt_setup(0, PT_T, PT_W,
                                                            dev)
    state = sampler.init_pt_state(
        p0, loglike, logprior, generator=torch.Generator(dev).manual_seed(1),
        eval_generator=torch.Generator().manual_seed(2))
    step = sampler.make_pt_step(loglike, logprior,
                                sampler.default_beta_ladder(PT_T))
    k12 = k12_at_pt_shapes(dev, smi, problem.forward,
                           p0.reshape(-1, problem.n_dim)[: PT_T * PT_W // 2],
                           problem.n_runs)
    holder = [state]

    def one_step():
        holder[0] = step(holder[0])[0]

    dev_ms, host_ms = devtime.profiler_call_ms(one_step, PT_PROFILE_STEPS)
    # the analytic branch's step at its widths, profiled the same way (here,
    # after every timed CLI run of the phase)
    data = sg_model.generate_data(torch.Generator(dev).manual_seed(3), 500,
                                  *cli_sg.TRUTH)
    sg_ll, sg_lp = sg_model.make_pt_fns(data, numeric=True)
    p_sg = torch.as_tensor(cli_sg.TRUTH, device=dev) + 1e-3 * torch.randn(
        (PT_T, PT_W, 3), generator=torch.Generator(dev).manual_seed(4),
        device=dev)
    sg_step = sampler.make_pt_step(lambda th, g: sg_ll(th),
                                   lambda th, g: sg_lp(th),
                                   sampler.default_beta_ladder(PT_T))
    sg_holder = [sampler.init_pt_state(
        p_sg, lambda th, g: sg_ll(th), lambda th, g: sg_lp(th),
        generator=torch.Generator(dev).manual_seed(5),
        eval_generator=torch.Generator().manual_seed(6))]

    def one_sg_step():
        sg_holder[0] = sg_step(sg_holder[0])[0]

    sg_dev_ms, sg_host_ms = devtime.profiler_call_ms(one_sg_step, 20)
    log(f"phase 22b ({smi}): the analytic step profiled: device "
        f"{sg_dev_ms:.3f} ms per step of {sg_host_ms:.3f} ms "
        f"(torch.profiler, 20 steps; the CLI's clock "
        f"{1e3 * PT_T * PT_W / rate['cli_pt_analytic']:.3f} ms)")
    out["analytic"].update(device_ms_per_step=sg_dev_ms,
                           profiled_host_ms_per_step=sg_host_ms)
    span, swaps = res["beamE_span_keV"], res["swap_acceptance"]
    log(f"{label} ({smi}): {PT_T} temps x {PT_W} walkers x 2 runs x 50k "
        f"draws, {PT_TOF_BURN} + {PT_TOF_STEPS} steps (depth cut): "
        f"{res['pt_walker_steps_per_sec']:.1f} PT walker-steps/s "
        f"({ms_per_step:.3f} ms per step, the CLI's clock); device "
        f"{dev_ms:.3f} ms per step of {host_ms:.3f} ms (torch.profiler, "
        f"{PT_PROFILE_STEPS} steps); {evals} forward evaluations, K1 "
        f"{per_half['poisson']:g} and K2 {per_half['tof_hist']:g} launches "
        f"per half-update; peak device memory {peak_gb:.3f} GB; initial "
        f"log-likelihoods finite on {res['initial_finite_fraction']:.4f}; "
        f"beamE span {span:.2f} keV; swap acceptance "
        f"{np.round(swaps, 4).tolist()}; ln Z {res['pt_ln_evidence']}")
    require(evals == halves + 2 and per_half["poisson"] == 1
            and per_half["tof_hist"] == 1 and used["weighted_hist"]
            == used["transport_moments"] == used["K2-bwd"] == 0,
            f"{label}: K1 and K2 once per half-update ({used}, {evals} "
            f"evaluations)")
    require(res["initial_finite_fraction"] >= 0.98,
            f"{label}: initial log-likelihoods finite on >= 98%")
    require(np.isfinite(span), f"{label}: finite cold-chain beamE span")
    require(len(swaps) == PT_T - 1 and all(0.0 <= a <= 1.0 for a in swaps),
            f"{label}: swap acceptances in [0, 1]")
    rate["cli_pt_tof"] = res["pt_walker_steps_per_sec"]
    launches["cli_pt_tof"] = dict(used, log_like_evaluations=evals - 1,
                                  half_updates=halves)
    for name in k12:
        k12[name]["launches_per_half_update"] = per_half[name]
    out["k12"] = k12
    out["tof"] = {"pt_walker_steps_per_sec": res["pt_walker_steps_per_sec"],
                  "ms_per_step": ms_per_step, "device_ms_per_step": dev_ms,
                  "profiled_host_ms_per_step": host_ms,
                  "launches_per_half_update": per_half,
                  "peak_memory_gb": peak_gb,
                  "initial_finite_fraction": res["initial_finite_fraction"],
                  "beamE_span_keV": span, "swap_acceptance": swaps,
                  "pt_ln_evidence": res["pt_ln_evidence"]}
    del problem, state, holder, p0, sg_holder

    # 22d: the emcee shim with a torch log-likelihood on the card
    n_t, n_w, n_dim = 8, 32, 2
    pt_shim = emcee_shim.PTSampler(
        n_t, n_w, n_dim, lambda p: -0.5 * torch.sum(p * p, dim=-1),
        lambda p: torch.zeros(p.shape[0], device=p.device), seed=4)
    p0 = 1e-3 * np.random.default_rng(5).standard_normal((n_t, n_w, n_dim))
    for p, lnp, lnl in pt_shim.sample(p0, iterations=20):
        pass
    pt_shim.reset()
    for p, lnp, lnl in pt_shim.sample(p, lnprob0=lnp, lnlike0=lnl,
                                      iterations=40, thin=2):
        pass
    shapes = (pt_shim.chain.shape, pt_shim.lnlikelihood.shape)
    log(f"phase 22d: compat.emcee.PTSampler on {pt_shim.device}, backend "
        f"{pt_shim.backend}: sample -> reset -> sample, chain {shapes[0]}, "
        f"lnlikelihood {shapes[1]}, swap acceptance "
        f"{np.round(pt_shim.tswap_acceptance_fraction, 3).tolist()}")
    require(pt_shim.backend == "torch" and pt_shim.device.type == "cuda"
            and shapes == ((n_t, n_w, 20, n_dim), (n_t, n_w, 20)),
            "22d: PTSampler's chain (T, W, S, D) and lnlikelihood (T, W, S) "
            "on the card")
    require(bool(np.all(np.isfinite(pt_shim.lnlikelihood))),
            "22d: finite log-likelihoods")
    out["shim"] = {"chain": list(shapes[0]),
                   "lnlikelihood": list(shapes[1])}
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False "
                         "(this smoke test needs an NVIDIA GPU)")
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    script_t0 = time.perf_counter()
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
    rates_out = phase_counts_rates(dev, smi)

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
    used = {}
    for likelihood in ("reference", "poisson"):
        # the faithful likelihood is -inf where a Poisson-drawn grid cell
        # rounds to -1 draws and leaves a negative model bin (floor ->
        # gammaln(0)); the JAX package does the same (ROADMAP Queue 3)
        (rate[f"counts_{likelihood}"], acc[f"counts_{likelihood}"],
         used[likelihood]) = fit(
            spec, likelihood, dev, truth, N_WARM, N_TIMED, smi, "phase 7b",
            max_bad=0 if likelihood == "poisson" else N_WALKERS // 50)
    launches["counts"] = add_counts(*used.values())
    log(f"phase 7b: launches during the counts fits: {launches['counts']}")
    require(launches["counts"]["poisson"] > 0
            and launches["counts"]["tof_hist"] > 0,
            "K1 and K2 launched on the counts path")
    require(launches["counts"]["counts_rates"]
            == launches["counts"]["log_prob_evaluations"],
            "the rate kernel launched once per evaluation")

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

    for likelihood in ("reference", "poisson"):
        (rate[f"mc_taylor_{likelihood}"], acc[f"mc_taylor_{likelihood}"],
         used[likelihood]) = fit(spec_mc, likelihood, dev, truth, MC_WARM,
                                 MC_TIMED, smi, "phase 8b (mc, taylor)")
    launches["mc_taylor"] = add_counts(*used.values())
    log(f"phase 8b: launches during the mc 'taylor' fits: "
        f"{launches['mc_taylor']}")
    require(launches["mc_taylor"]["transport_moments"] > 0
            and launches["mc_taylor"]["tof_hist"] > 0,
            "K4 and K2 launched on the mc 'taylor' path")

    (rate["mc_exact_poisson"], acc["mc_exact_poisson"],
     launches["mc_exact"]) = fit(
        spec_ex, "poisson", dev, truth, EXACT_WARM, EXACT_TIMED, smi,
        "phase 8c (mc, exact)")
    log(f"phase 8c: launches during the mc 'exact' fit: "
        f"{launches['mc_exact']}")
    require(launches["mc_exact"]["weighted_hist"] > 0
            and launches["mc_exact"]["tof_hist"] > 0,
            "K3 and K2 launched on the mc 'exact' path")

    # phases 9-10: the default estimators of simultFit, then oneBD
    torch.cuda.empty_cache()
    phase_simult_defaults(dev, smi, truth, p0, rate, acc, launches)
    torch.cuda.empty_cache()
    at_onebd = phase_onebd(dev, smi, rate, acc, launches)

    # phases 12-14: deterministic moment sums, the command-line drivers,
    # exact resume (before phase 11: see there)
    torch.cuda.empty_cache()
    phase_determinism(dev, p0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        phase_cli(smi, Path(tmp), rate, launches)
        phase_resume(Path(tmp))
        # phase 18 (before phase 11 too): the posterior-predictive slice on
        # phase 13's chains
        torch.cuda.empty_cache()
        ppc_core = phase_ppc_core(dev, truth)
        ppc_cli = phase_ppc_cli(smi, Path(tmp), rate, launches,
                                dev)
        phase_plot_chain(Path(tmp))

    # phases 15-17: K2's backward, the log-prob's gradient, the gradient
    # samplers through the CLIs (before phase 11 too)
    torch.cuda.empty_cache()
    k2_bwd = phase_tof_backward(dev, smi, base, draws, forward)
    grad_rel = phase_gradient(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_grad_") as tmp:
        phase_gradient_cli(smi, Path(tmp), rate, launches)

    # phases 19-21: the simple family, the templates, the csi2016 PPC
    # (before phase 11 too)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_models_") as tmp:
        torch.cuda.empty_cache()
        simple_out = phase_simple(dev, smi, Path(tmp), rate, launches)
        torch.cuda.empty_cache()
        templates_out = phase_templates(dev, smi, Path(tmp), rate, launches)
        torch.cuda.empty_cache()
        csi_out = phase_csi2016(dev, smi, Path(tmp), rate, launches)

    # phase 24: posterior parity with the JAX package (before phase 11
    # and phase 22's profiler too: its chains are host-bound)
    torch.cuda.empty_cache()
    t24 = time.perf_counter()
    parity_out = phase_parity(dev, smi, launches)
    parity_out["seconds"] = time.perf_counter() - t24
    log(f"phase 24 ({smi}): {parity_out['seconds']:.1f} s")

    # phase 23: walker sharding over torch.distributed ranks (before phase
    # 11 too, and before phase 22's profiler: its one-process reference
    # fit is timed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shard_") as tmp:
        torch.cuda.empty_cache()
        shard_out = phase_sharding(dev, smi, Path(tmp), rates.lam,
                                   times["poisson"][0])

    # phase 22: parallel tempering (before phase 11 too; its profile of
    # the tempered step is the first profiler of the process)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pt_") as tmp:
        torch.cuda.empty_cache()
        pt_out = phase_pt(dev, smi, Path(tmp), rate, launches)

    # phase 11: the second cross-check of phase 6's device times, the kernel
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
    log(f"phase 11 ({smi}): torch.profiler's kernel durations: K1 "
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
        log(f"phase 11: {name}: graph {times[name][0]:.5f} ms / profiler "
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
    extra_shapes = {
        "poisson": {"at_pt_tof_shape": pt_out["k12"]["poisson"],
                    # phase 23: the counter offset, and the launches on
                    # each rank's shard of the two-rank fit
                    "at_offset": shard_out["k1"],
                    "launches_sharded_per_rank": [
                        u["poisson"] for u in
                        shard_out["launches_per_rank"]]},
        "weighted_hist": {"at_simple_shapes": simple_out["k3"]},
        "tof_hist": {"at_templates_shape": templates_out["k2"],
                     "at_pt_tof_shape": pt_out["k12"]["tof_hist"],
                     "launches_sharded_per_rank": [
                         u["tof_hist"] for u in
                         shard_out["launches_per_rank"]]},
        "transport_moments": {
            "at_templates_shape": templates_out["k4"],
            "at_csi2016_ppc_shape": csi_out["k4"]},
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
            "single_call_ms": single.get(name),
            # K1 and K2 at the oneBD shapes (phase 10), each with its own
            # error, times and bound; their launches on that path
            "at_onebd_shapes": at_onebd.get(name),
            "launches_onebd_hardcore_counts":
                launches["onebd_hardcore_counts"][name],
            # launches during each command-line run of phases 13, 17, 18
            "launches_cli": {run: launches[f"cli_{run}"][name]
                             for run in (*CLI_RUNS, *GRAD_RUNS,
                                         *PPC_RUNS, *SIMPLE_RUNS,
                                         "template_fit", "ppc_csi2016",
                                         "pt_analytic", "pt_tof")},
            # phase 24: launches on each parity case's path (density, then
            # the counts chains)
            "launches_parity": {
                case: launches[case][name] for case in launches
                if case.startswith("parity_")},
            # the remaining forward models (phases 19-21): each kernel at
            # its shapes there, with its own error, times and bound
            **extra_shapes.get(name, {})})
    # K2's backward: its time, bound and error at simultFit's lattice, the
    # oneBD hardcore lattice beside it; its launches on this slice's main
    # path, the gradient samplers' CLI runs
    bwd = k2_bwd["simult"]
    kernels.append({
        "name": "K2-bwd", "route": "cuda",
        "source": "mcmctoffitting_tpu_torch/csrc/tof_hist.cu",
        "replaces": "mcmctoffitting_tpu/ops/pallas_tof.py:246",
        "launches": launches["cli_simult_nuts"]["K2-bwd"],
        "max_abs_err": bwd["max_abs_err"], "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "library_ms": None,
        "enqueue_us": bwd["enqueue_us"],
        "launch_floor_ms": bwd["launch_floor_ms"],
        "shape": bwd["shape"], "variant": bwd["variant"],
        "forward_ms": bwd["forward_ms"],
        "at_onebd_shapes": k2_bwd["onebd_hardcore"],
        "at_general_k": k2_bwd["general_k3"],
        "launches_gradient_cli": {run: launches[f"cli_{run}"]["K2-bwd"]
                                  for run in GRAD_RUNS},
        "gradient_evaluations_cli": {
            run: launches[f"cli_{run}"]["gradient_evaluations"]
            for run in GRAD_RUNS},
        "gradient_gpu_vs_cpu_rel_l2": grad_rel,
        "launches_parity": launches["parity_simult_expected"]["K2-bwd"]})
    # the rate stage's kernel: no TPU original (the JAX package leaves the
    # stage to XLA, which fuses it); its launches on the counts paths of
    # phases 7b and 10e, each beside that path's log-prob evaluations, and
    # its error at simultFit's shapes in phase 25
    kernels.append({
        "name": "counts_rates", "route": "cuda",
        "source": "mcmctoffitting_tpu_torch/csrc/counts_rates.cu",
        "replaces": None, "launches": launches["counts"]["counts_rates"],
        "log_prob_evaluations": launches["counts"]["log_prob_evaluations"],
        "launches_onebd_hardcore_counts":
            launches["onebd_hardcore_counts"]["counts_rates"],
        "log_prob_evaluations_onebd_hardcore_counts":
            launches["onebd_hardcore_counts"]["log_prob_evaluations"],
        "max_abs_err": rates_out["simultfit"]["max_abs_err"],
        "ms": rates_out["simultfit"]["kernel_ms"],
        "plain_ms": rates_out["simultfit"]["plain_ms"],
        "bound_ms": rates_out["simultfit"]["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "enqueue_us": rates_out["simultfit"]["enqueue_us"],
        "shape": rates_out["simultfit"]["shape"],
        "at_onebd_shapes": rates_out["onebd_hardcore"]})
    # phase 18d, last: -profile in a subprocess of its own
    profile_kernels = phase_profile()
    script_s = time.perf_counter() - script_t0
    log(f"chip_smoke ({smi}): every phase in {script_s:.1f} s, phase 24 "
        f"{parity_out['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels, "script_seconds": script_s,
                      "walker_steps_per_s": rate,
                      "acceptance": acc, "launches_by_path": launches,
                      "onebd_a_build_seconds": at_onebd["a_build_seconds"],
                      "ppc": {"gpu_vs_cpu": ppc_core, "cli": ppc_cli,
                              "profile_tof_hist_kernel_events":
                              profile_kernels},
                      "simple": {"gpu_vs_cpu_rel": simple_out["gpu_vs_cpu"],
                                 "cli": simple_out["cli"]},
                      "templates": {
                          k: v for k, v in templates_out.items()
                          if k not in ("k4", "k2")},
                      "csi2016_ppc": {k: v for k, v in csi_out.items()
                                      if k != "k4"},
                      "parallel_tempering": {
                          k: v for k, v in pt_out.items() if k != "k12"},
                      "sharding": {k: v for k, v in shard_out.items()
                                   if k != "k1"},
                      "posterior_parity": parity_out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
