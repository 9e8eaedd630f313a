"""Shared plumbing of the two flagship command-line fits: the flags, the
phase loop, checkpoints with exact resume, the gradient samplers' path
(``-sampler nuts|hmc``) and the reports.

Port of ``mcmctoffitting_tpu/cli/_driver.py``.  Both drivers stream chain
segments to the emcee text file, checkpoint after each phase and report
walker-steps/s, with the JAX package's flags, defaults, printed lines and
file names.  Randomness comes from torch generators seeded from ``-seed``
(:func:`seeded_generator`, one stream per use): the moves' generator on
the device, the host generator that seeds the log-prob's draws, and one
each for the synthetic data, the initial walkers and the likelihood check.
Flags that only chose a TPU/XLA schedule or the JAX PRNG (``-runAxis``,
``-prng``) are accepted with a note.  ``-mesh N`` shards the ensemble's
walkers over N ranks (``parallel/``): N GPUs, capped at the GPUs there
are, or with ``-device cpu`` N gloo ranks; the CLI starts them as
processes of their own (``parallel/launch.py``), or, with the MCMCTOF_*
variables set, joins the ranks started on several hosts.  Rank 0 alone
writes the chains and checkpoints and prints.  ``-profile DIR`` traces the
sampling phases with ``torch.profiler`` (``utils/profiling.py``).  The
figures need matplotlib; without it each prints the line that says so
(:func:`draw_figure`), and any other plotting error fails the run.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..models.forward import resolve_device
from ..ops.likelihoods import poisson_binned_terms, poisson_logpmf_terms
from ..parallel import (distributed, launch, make_mesh,
                        make_sharded_logp_batch)
from ..sampler import (BoxLogitTransform, EnsembleState, hmc_sample,
                       init_state, nuts_sample, run_mcmc)
from ..utils import chain_io, plotting, profiling
from ..utils.diagnostics import (chain_summary, format_summary,
                                 integrated_autocorr_time)

# -seed streams (seeded_generator)
STREAM_WALKERS, STREAM_MOVES, STREAM_CHECK, STREAM_EVAL, STREAM_DATA = (
    1, 2, 3, 4, 99)


def seeded_generator(seed: int, stream: int, device="cpu") -> torch.Generator:
    """A generator on ``device`` seeded from (``seed``, ``stream``) through
    numpy's SeedSequence, so that streams of one seed are independent."""
    word = np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(word) >> 1)


def stream_seed(seed: int, stream: int) -> int:
    """An integer seed for the stream (``utils.data_io`` takes one)."""
    return int(np.random.SeedSequence([seed, stream]).generate_state(
        1, np.uint32)[0])


def posterior_fingerprint(problem, observed) -> np.ndarray:
    """Digest identifying the posterior a checkpoint was sampled from.

    The JAX package's bytes, field for field: the model family and
    dimension, the draw count, the likelihood-shaping modes of the spec,
    the likelihood, the forward binnings, the fine-grid size and the
    observed histograms.  Returned as a uint8 array so it rides the .npz
    checkpoint extras.
    """
    h = hashlib.sha256()
    h.update(type(problem).__name__.encode())
    h.update(np.int64(problem.n_dim).tobytes())
    h.update(np.int64(problem.spec.n_samples).tobytes())
    h.update(problem.spec.sampling.encode())
    h.update(problem.spec.xs_mode.encode())
    h.update(problem.spec.bg_mode.encode())
    h.update(problem.spec.e0_mean_mode.encode())
    h.update(problem.spec.moment_closure.encode())
    h.update(problem.spec.a_dtype.encode())
    h.update(getattr(problem, "likelihood", "reference").encode())
    for b in (problem.spec.ed_binning, problem.spec.x_binning):
        h.update(np.float64([b.lo, b.hi, b.n]).tobytes())
    h.update(np.int64(problem.spec.e0_grid_fine).tobytes())
    for o in observed:
        h.update(np.ascontiguousarray(np.asarray(o, np.float64)).tobytes())
    return np.frombuffer(h.digest(), np.uint8).copy()


def check_likelihood_eval(problem, observed, generator: torch.Generator, *,
                          prefix: str = "", batch: bool = False) -> float:
    """Verbose per-bin likelihood table at the guess point: per-bin
    obs/model/loglike of the ACTIVE likelihood per run, the run totals and
    the total, which is returned (the number the sampler sees at this
    theta, less the flat in-box prior).  Without ``batch``, each run's
    observed-vs-model overlay goes to ``{prefix}likelihoodCheck_run{r}.png``
    (:func:`draw_figure`)."""
    theta = torch.as_tensor(
        np.asarray(problem.guess_theta(observed), np.float32),
        device=problem.device)
    spectra = problem.run_spectra(theta[None], generator)[0]
    spectra = spectra.double().cpu().numpy()
    terms_fn = (poisson_binned_terms
                if getattr(problem, "likelihood", "reference") == "reference"
                else poisson_logpmf_terms)
    with np.printoptions(precision=4, suppress=True):
        print(f"checkLikelihoodEval at guess theta = {theta.cpu().numpy()}")
    total = 0.0
    for run, (win, obs) in enumerate(zip(problem.windows, observed)):
        model = spectra[run, :win.n_bins]
        obs = np.asarray(obs, np.float64)
        terms = terms_fn(torch.as_tensor(model, dtype=torch.float32),
                         torch.as_tensor(obs, dtype=torch.float32))
        terms = terms.double().numpy()
        for b in range(len(obs)):
            print(f"run {run} bin {b}: obs {obs[b]:9.1f}  "
                  f"model {model[b]:10.2f}  loglike {terms[b]:12.4f}")
        run_total = float(terms.sum())
        total += run_total
        print(f"run {run} likelihood: {run_total:.4f}")
        if not batch:
            draw_figure(lambda: plotting.model_overlay_plot(
                obs, model, f"{prefix}likelihoodCheck_run{run}.png"))
    print(f"total likelihood is {total:.4f}")
    return total


def draw_figure(draw: Callable[[], object]) -> bool:
    """Run ``draw``; where matplotlib is not installed, print the one line
    that says so and return False.  Any other error, an ``ImportError``
    of another module included, propagates."""
    try:
        draw()
    except ImportError as e:
        if (e.name or "").split(".")[0] != "matplotlib":
            raise
        print(f"plotting skipped: matplotlib is not installed ({e})")
        return False
    return True


def profiled(profile_dir: str):
    """``torch.profiler`` over a block for ``-profile DIR`` (its Chrome
    trace written into DIR), or nothing without the flag."""
    if not profile_dir:
        return contextlib.nullcontext()
    return profiling.trace(profile_dir)


def load_resume_state(path, problem, observed, logp_batch, *, seed: int):
    """Load a checkpoint for -resume, re-evaluating log-probs if the
    posterior fingerprint differs from this invocation's.

    A checkpoint of the port restores both generators where it was
    written; one of the JAX package (a threefry key, no generator states)
    or of another device type keeps its positions, log-probs, step and
    fingerprint, and both generators are seeded from ``seed`` as a fresh
    run seeds them.
    """
    if not os.path.exists(path):
        sys.exit(f"error: -resume checkpoint not found: {path}")
    try:
        ckpt = chain_io.load_checkpoint(path)
    except Exception as e:
        sys.exit(f"error: could not load -resume checkpoint {path}: {e}")
    device = problem.device
    if (ckpt.generator_state is not None
            and ckpt.generator_device == device.type):
        generator = torch.Generator(device=device)
        generator.set_state(ckpt.generator_state)
        eval_generator = torch.Generator()
        eval_generator.set_state(ckpt.eval_generator_state)
    else:
        why = ("the JAX package's threefry stream cannot be continued in "
               "torch" if ckpt.generator_state is None else
               f"its generators were saved on {ckpt.generator_device}")
        print(f"note: checkpoint {path} holds no torch generator states for "
              f"{device.type} ({why}); seeding both generators from -seed "
              f"{seed}")
        generator = seeded_generator(seed, STREAM_MOVES, device)
        eval_generator = seeded_generator(seed, STREAM_EVAL)
    state = EnsembleState(
        torch.as_tensor(ckpt.positions, device=device),
        torch.as_tensor(ckpt.log_probs, device=device), generator,
        eval_generator, ckpt.step)
    fp = posterior_fingerprint(problem, observed)
    old = ckpt.extra.get("posterior_fp")
    if old is None or not np.array_equal(np.asarray(old, np.uint8), fp):
        print("WARNING: checkpoint posterior fingerprint does not match "
              "this invocation (different data, -nDrawsPerEval or run "
              "count?); re-evaluating log-probs at the restored positions")
        state = init_state(state.positions, logp_batch,
                           generator=state.generator,
                           eval_generator=state.eval_generator)
    return state


class _Fetch:
    """One segment's chain on its way to the host: positions, log-probs
    and acceptance counts packed into one tensor and copied in one
    transfer, asynchronously on a GPU (pinned memory, an event)."""

    def __init__(self, chain):
        self.shape = tuple(chain.positions.shape)
        packed = torch.cat([chain.positions.reshape(-1),
                            chain.log_probs.reshape(-1),
                            chain.n_accepted.to(torch.float32)])
        self.done = None
        if packed.is_cuda:
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.done = torch.cuda.Event()
            self.done.record()
        else:
            self.host = packed

    def result(self):
        """(positions (S, W, D), log_probs (S, W), accepted moves) as
        numpy arrays and a float."""
        if self.done is not None:
            self.done.synchronize()
        s, w, d = self.shape
        flat = self.host.numpy()
        positions = flat[: s * w * d].reshape(s, w, d)
        log_probs = flat[s * w * d: s * w * (d + 1)].reshape(s, w)
        return positions, log_probs, float(flat[s * w * (d + 1):].sum())


def run_phases(state, phases, logp_batch, *, segment: int, prefix: str,
               fingerprint=None, adaptive_phase: str | None = None,
               tau_factor: float = 50.0, tau_rtol: float = 0.02,
               move: str = "stretch", write: bool = True):
    """Drive the sampler through (name, chain_path, n_steps, truncate)
    phases, streaming chain text per segment and checkpointing per phase.

    Each segment of ``segment`` steps is enqueued as one ``run_mcmc``, with
    no synchronisation inside it; its chain then goes to the host in one
    transfer, which is read (and appended to the text file, with the
    progress line) after the next segment has been enqueued.
    ``adaptive_phase`` names a phase whose ``n_steps`` is a CAP: sampling
    stops once every parameter's integrated autocorrelation time tau
    satisfies S >= tau_factor * tau and the tau estimate moved < tau_rtol
    between consecutive checks (first check after max(80, 2 * segment)
    steps, then at 1.2x backoff), as in the JAX package.  Without
    ``write`` (a rank other than 0) no chain text, checkpoint or
    diagnostics are written; the segments, the tau checks and the stop
    decision are the same on every rank (their positions are).

    Returns (final_state, total_steps, elapsed_s).
    """
    # the authoritative walker count is the state's (a resumed checkpoint
    # may carry a different ensemble size than this invocation's flags)
    n_walkers = int(state.positions.shape[0])
    extra = None if fingerprint is None else {"posterior_fp": fingerprint}
    t0 = time.time()
    total_steps = 0
    for phase, path, n_steps, truncate in phases:
        if truncate and write:
            open(path, "w").close()
        adaptive = phase == adaptive_phase
        pos_acc: list[np.ndarray] = []
        tau_prev = None
        next_check = max(80, 2 * segment)
        done = 0
        phase_accepted = 0.0
        pending = None   # (fetch, steps done) of an unwritten segment
        total_done0 = total_steps

        def flush(pend):
            nonlocal phase_accepted
            fetch, done_s = pend
            positions, log_probs, n_acc = fetch.result()
            if write:
                chain_io.append_chain_text(path, positions, log_probs)
            phase_accepted += n_acc
            rate = (done_s + total_done0) * n_walkers / (time.time() - t0)
            acc = phase_accepted / (done_s * n_walkers)
            print(f"{phase}: step {done_s}/{n_steps} "
                  f"({rate:.1f} walker-steps/s, acc {acc:.2f})", flush=True)
            if adaptive:
                pos_acc.append(positions)

        # a fully computed segment is never lost: an interrupt still
        # writes the pending one
        try:
            while done < n_steps:
                seg = min(segment, n_steps - done)
                chain = run_mcmc(state, seg, logp_batch, move=move)
                state = chain.state
                prev, pending = pending, None
                done += seg
                total_steps += seg
                fetch = _Fetch(chain)
                if prev is not None:
                    flush(prev)   # while the device runs this segment
                pending = (fetch, done)
                if adaptive:
                    if done < next_check:   # between backoff points
                        continue
                    flush(pending)      # the tau check needs this segment
                    pending = None
                    next_check = max(done + seg, int(1.2 * done))
                    tau = integrated_autocorr_time(np.concatenate(pos_acc))
                    tau_max = float(tau.max())
                    stable = tau_prev is not None and bool(
                        np.all(np.abs(tau - tau_prev) <= tau_rtol * tau))
                    print(f"{phase}: tau_max {tau_max:.1f} "
                          f"(S/tau {done / tau_max:.1f}, need "
                          f">= {tau_factor:.0f}"
                          f"{', tau stable' if stable else ''})", flush=True)
                    if done >= tau_factor * tau_max and stable:
                        print(f"{phase}: converged at step {done} "
                              f"(S >= {tau_factor:.0f} tau and tau drift "
                              f"< {100 * tau_rtol:.0f}%)", flush=True)
                        break
                    tau_prev = tau
        finally:
            if pending is not None:   # final or interrupted segment
                flush(pending)
                pending = None
        if write:
            chain_io.save_checkpoint(
                prefix + f"{phase.replace('-', '')}.ckpt.npz", state,
                extra=extra)
            _print_diagnostics(phase, path)
    return state, total_steps, time.time() - t0


def report_quantiles(flat, names):
    """Print the shared 16/50/84 quantile table; return {name: [med, +s,
    -s]} (the dict both flagship CLIs return)."""
    q = np.percentile(flat, [16, 50, 84], axis=0)
    print("MCMC result (median +sigma -sigma):")
    result = {}
    for d, name in enumerate(names):
        med, lo_, hi_ = q[1, d], q[1, d] - q[0, d], q[2, d] - q[1, d]
        print(f"  {name} = {med:.4g} +{hi_:.3g} -{lo_:.3g}")
        result[name] = [float(med), float(hi_), float(lo_)]
    return result


def _print_diagnostics(phase: str, chain_path: str) -> None:
    """End-of-phase convergence report (tau / ESS / split R-hat) from the
    streamed chain file; skipped for chains too short to window."""
    try:
        chain, _, _, _, n_steps = chain_io.read_chain_text(chain_path)
        if n_steps < 8:
            return
        print(f"{phase}: {format_summary(chain_summary(chain))}", flush=True)
    except Exception as e:  # diagnostics must never kill a finished fit
        print(f"{phase}: diagnostics skipped ({e})", flush=True)


def add_common_flags(p, refs: dict) -> None:
    """Flags both flagship CLIs share: every flag of the JAX package's
    parser, with its defaults, and ``-device``.  ``refs`` holds the
    per-driver reference citations and per-mode defaults quoted in the
    help strings (``check_eval``, ``nthreads``, ``mpi``,
    ``fine_defaults``)."""
    p.add_argument("-device", choices=["cuda", "cpu"], default="cuda",
                   help="where the fit runs: the GPU (default; without one "
                        "the fit stops with an error) or the CPU, which "
                        "runs the kernels' plain PyTorch versions")
    p.add_argument("-debug", choices=[0, 1], default=0, type=int)
    p.add_argument("-quitEarly", choices=[0, 1], default=0, type=int)
    p.add_argument("-checkLikelihoodEval", choices=[0, 1], default=0,
                   type=int,
                   help="print the per-bin likelihood table at the guess "
                        "point and exit (the reference's "
                        f"checkLikelihoodEval, {refs['check_eval']})")
    p.add_argument("-batch", choices=[0, 1], default=0, type=int,
                   help="suppress plots")
    p.add_argument("-forceCustomPDF", choices=[0, 1], default=0, type=int,
                   help="accepted for surface parity and ignored")
    p.add_argument("-nDrawsPerEval", default=200_000, type=int)
    p.add_argument("-nBurninSteps", default=400, type=int)
    p.add_argument("-nMainSteps", default=100, type=int)
    p.add_argument("-nWalkers", default=256, type=int)
    p.add_argument("-outputPrefix", default="", type=str)
    p.add_argument("-seed", default=0, type=int)
    p.add_argument("-mesh", default=0, type=int,
                   help="max devices for walker sharding (0 = all GPUs): "
                        "one rank per GPU, or with -device cpu this many "
                        "gloo ranks on the CPU")
    p.add_argument("-chunkWalkers", default=0, type=int,
                   help="eval walkers in chunks of this size (memory cap)")
    p.add_argument("-segment", default=50, type=int,
                   help="steps per device->host chain flush; "
                        "-convergeMain's first tau check sits at "
                        "max(80, 2*segment) steps")
    p.add_argument("-convergeMain", type=int, choices=[0, 1], nargs="?",
                   const=1, default=0,
                   help="treat -nMainSteps as a CAP and stop the main "
                        "phase early once S >= tauFactor * tau for every "
                        "parameter with a stable tau estimate")
    p.add_argument("-tauFactor", default=50.0, type=float,
                   help="chain-length multiple of the integrated "
                        "autocorrelation time required by -convergeMain")
    p.add_argument("-move", choices=["stretch", "de", "mixed"],
                   default="de",
                   help="ensemble proposal: 'de' (ter Braak DE-MC, "
                        "default), 'stretch' (emcee's) or 'mixed'")
    p.add_argument("-resume", default="", type=str,
                   help="resume the MAIN phase from a .ckpt.npz checkpoint "
                        "(skips burn-in; exact continuation of a checkpoint "
                        "of this package, generators included; one of the "
                        "JAX package keeps its walkers and log-probs and "
                        "seeds the generators from -seed)")
    p.add_argument("-runAxis", choices=["auto", "sequential", "batched"],
                   default=None,
                   help="the JAX package's multi-run XLA schedule; "
                        "accepted, no effect here")
    p.add_argument("-gridMode", choices=["e0grid", "taylor"],
                   default="e0grid",
                   help="e0grid (default): static e0-space preimage grid; "
                        "taylor: per-sample table lookup + per-slice "
                        "moments")
    p.add_argument("-expectedForward", action="store_true",
                   help="closed-form expected forward model; alias for "
                        "-sampling expected")
    p.add_argument("-sampling", choices=["mc", "counts", "expected"],
                   default="mc",
                   help="mc: per-sample Monte Carlo (reference semantics); "
                        "counts: Poissonized Rao-Blackwell MC; expected: "
                        "closed-form limit")
    p.add_argument("-likelihood", choices=["reference", "poisson"],
                   default="reference",
                   help="reference: the faithful int()-cast form; poisson: "
                        "the correct Poisson logpmf")
    p.add_argument("-sampler", choices=["ensemble", "nuts", "hmc"],
                   default="ensemble",
                   help="ensemble: Goodman-Weare stretch (reference "
                        "semantics).  nuts / hmc: GRADIENT-based sampling "
                        "of the differentiable configuration — requires "
                        "-expectedForward -likelihood poisson (oneBD also "
                        "-deterministicBG); impossible in the reference "
                        "(MC + sawtooth likelihood).  Writes the same "
                        "chain format")
    p.add_argument("-nChains", default=4, type=int,
                   help="parallel chains for -sampler nuts/hmc "
                        "(batched on the device; -nWalkers governs "
                        "ensemble mode)")
    p.add_argument("-maxDepth", default=8, type=int,
                   help="NUTS maximum tree doublings per step")
    p.add_argument("-momentClosure", choices=["exact", "cell"],
                   default="exact",
                   help="counts/expected forward only: exact 4-row ndtr "
                        "chain, or the 2-row chain + within-cell closure")
    p.add_argument("-fineGrid", default=0, type=int,
                   help="override the e0-preimage fine-grid size F "
                        f"(default: per-mode — {refs['fine_defaults']})")
    p.add_argument("-aDtype", choices=["float32", "bfloat16"],
                   default=None,
                   help="dtype of the static e0grid A operator (default "
                        "per preset: bfloat16 for -hardcore counts)")
    p.add_argument("-nThreads", default=0, type=int,
                   help="accepted for surface parity and ignored "
                        f"(reference {refs['nthreads']})")
    p.add_argument("-mpi", default=0, type=int,
                   help="accepted for surface parity and ignored "
                        f"(reference {refs['mpi']})")
    p.add_argument("-profile", default="", type=str, metavar="DIR",
                   help="trace the sampling phases with torch.profiler "
                        "(CPU and CUDA activities) into DIR/"
                        f"{profiling.TRACE_FILE}, a Chrome trace "
                        "(utils/profiling.py)")
    p.add_argument("-prng", choices=["threefry2x32", "rbg"], default=None,
                   help="the JAX package's PRNG implementation; accepted, "
                        "no effect here")


def mesh_ranks(args, n_walkers: int) -> int:
    """How many local ranks ``-mesh`` asks this invocation to start: 1
    where it runs the fit itself (one device; a gradient sampler; or it is
    already a rank).  On CUDA, N (0: every GPU) capped at the GPUs there
    are, as the JAX CLI caps at ``jax.devices()``; on the CPU, N gloo
    ranks.  Then, as the JAX CLI does, the largest count that divides the
    half-ensemble, with a warning when that idles ranks."""
    if args.sampler != "ensemble" or _in_multirank_run():
        if args.mesh > 1 and args.sampler != "ensemble":
            print(f"note: -mesh {args.mesh} shards the ensemble sampler's "
                  f"walkers; -sampler {args.sampler} runs on one device")
        return 1
    if resolve_device(args.device).type == "cuda":
        n_gpus = torch.cuda.device_count()
        n = min(args.mesh, n_gpus) if args.mesh else n_gpus
        if args.mesh > n_gpus:
            print(f"note: -mesh {args.mesh} capped at the {n_gpus} GPU(s) "
                  "of this host")
    else:
        n = max(args.mesh, 1)
    n_fit = n
    while n_fit > 1 and (n_walkers // 2) % n_fit:
        n_fit -= 1
    if n_fit < n:
        # loud: silently running -nWalkers 1022 on 1 of 8 GPUs is a huge
        # slowdown
        per = (n_walkers // 2 // n_fit) * 2 * n
        print(f"WARNING: half-ensemble ({n_walkers}/2 walkers) does not "
              f"divide across {n} devices; using {n_fit} and idling "
              f"{n - n_fit} — pick a walker count divisible by 2*{n} (e.g. "
              f"-nWalkers {max(per, 2 * n)}) to use the full mesh")
    return n_fit


def _in_multirank_run() -> bool:
    """This process is a rank: of ranks this CLI started, or of a run
    started on several hosts with the MCMCTOF_* variables."""
    return (torch.distributed.is_available()
            and torch.distributed.is_initialized()) or (
        distributed.ENV_NUM_PROCESSES in os.environ)


def run_ranks(main: Callable, argv, args, n_ranks: int):
    """``main(argv)`` in ``n_ranks`` local ranks (``parallel/launch.py``:
    NCCL, one GPU each, or gloo on the CPU); returns rank 0's result."""
    backend = "nccl" if args.device == "cuda" else "gloo"
    print(f"-mesh {args.mesh}: {n_ranks} ranks ({backend}), walker axis "
          "sharded", flush=True)
    argv = sys.argv[1:] if argv is None else list(argv)
    return launch.launch(main, n_ranks, (argv,), backend=backend,
                         timeout_s=None)[0]


def common_setup(args):
    """(device, mesh) of the fit: this rank's device and its walker mesh,
    or the device and None outside a multi-rank run; notes for the flags
    that have no effect here.  A rank joins the MCMCTOF_* runtime if it
    is not in one yet; ranks other than 0 print nothing (their standard
    output goes to os.devnull)."""
    if args.runAxis is not None:
        print(f"note: -runAxis {args.runAxis} has no effect here (it picks "
              "an XLA schedule of the JAX package)")
    if args.prng is not None:
        print(f"note: -prng {args.prng} has no effect here (the port draws "
              "from torch generators and Philox)")
    device = resolve_device(args.device)
    if args.sampler != "ensemble" or not _in_multirank_run():
        return device, None
    if not torch.distributed.is_initialized():
        distributed.initialize(device=device)
    mesh = make_mesh(device if device.type == "cpu" else None)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    else:           # the CPU's cores shared out among its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")
    return mesh.device, mesh


def resolve_sampling(args):
    """(sampling, fine_grid) from the flag pair."""
    sampling = "expected" if args.expectedForward else args.sampling
    return sampling, args.fineGrid or None


def build_logp_batch(logp, args, mesh=None, *, by_row: bool = False):
    """Walker-batch evaluator: sharded over ``mesh`` where there is one
    (``parallel.make_sharded_logp_batch``; ``by_row``: contract A of its
    docstring, else B), else local.  ``-chunkWalkers`` evaluates (each
    shard's) batch in chunks of that many walkers; unsharded, each chunk
    draws its own seeds from the host generator."""
    chunk = args.chunkWalkers
    if mesh is not None:
        print(f"walker axis sharded over {mesh.size} ranks")
        return make_sharded_logp_batch(logp, mesh, chunk=chunk or None,
                                       by_row=by_row)
    if not chunk:
        return logp

    def logp_batch(thetas, generator):
        return torch.cat([logp(thetas[i:i + chunk], generator)
                          for i in range(0, thetas.shape[0], chunk)])

    return logp_batch


def resolve_gradient_spec(args, spec):
    """Validate and finalise the spec for ``-sampler nuts|hmc``.

    Gradient-based sampling needs the differentiable configuration: the
    closed-form expected forward (the MC estimators re-draw per eval), the
    corrected Poisson logpmf (the reference's int()-cast sawtooth has zero
    gradient almost everywhere), the background's expectation for oneBD,
    and ``rint_draws`` off (rint has zero gradient).  The first three are
    the user's choices and are required, with the JAX package's messages;
    rint has no flag and is turned off here with a note.
    """
    import dataclasses

    if args.sampler == "ensemble":
        return spec
    if spec.sampling != "expected":
        sys.exit(f"error: -sampler {args.sampler} requires the closed-form "
                 "forward (-expectedForward / -sampling expected) — the "
                 "gradient flows only through it; the MC estimators "
                 "re-draw per eval")
    if args.likelihood != "poisson":
        sys.exit(f"error: -sampler {args.sampler} requires -likelihood "
                 "poisson (the reference's int()-cast likelihood has zero "
                 "gradient almost everywhere)")
    if args.resume:
        sys.exit(f"error: -resume is not supported with -sampler "
                 f"{args.sampler} (ensemble checkpoints only)")
    if spec.bg_mode != "expected" and getattr(args, "deterministicBG",
                                              True) is False:
        sys.exit(f"error: -sampler {args.sampler} requires "
                 "-deterministicBG (the per-eval Poisson background draw "
                 "is discrete)")
    print(f"-sampler {args.sampler}: rint draw rounding disabled "
          "(zero-gradient op; the forward stays the exact closed form)")
    return dataclasses.replace(spec, rint_draws=False)


def run_gradient_sampler(args, problem, observed, *, names):
    """``-sampler nuts|hmc``: gradient-based sampling of the flagship
    posterior (see :func:`resolve_gradient_spec`), ``-nChains`` chains
    batched on the device, each gradient one backward through the
    'expected' forward (kernel K2's backward on the card).

    Chains run in box-logit coordinates (``sampler/transforms.py``: the
    prior box's faces at infinity, O(1) per-dimension scale) from the
    problem's initial-walker law; NUTS also adapts a diagonal metric during
    warm-up (``-nBurninSteps``, 10 with ``-debug``).  The main chain lands
    in ``mainchain.dat`` in the ensemble path's format, then the
    diagnostics, the quantiles and the rate line, (warm-up + main steps) x
    chains over the sampling's wall clock, as in the JAX package.
    """
    device = problem.device
    logp_full = problem.make_log_prob_fn(observed)
    # the differentiable configuration draws nothing from it
    eval_generator = seeded_generator(args.seed, STREAM_EVAL)
    n_chains = args.nChains
    tr = BoxLogitTransform(problem.param_lo, problem.param_hi, device=device)
    logp_u = tr.wrap_logp(lambda theta: logp_full(theta, eval_generator))
    cloud = problem.initial_walkers_from_observed(
        seeded_generator(args.seed, STREAM_WALKERS, device),
        max(256, n_chains), observed)
    n_warmup = 10 if args.debug else args.nBurninSteps
    n_steps = 10 if args.debug else args.nMainSteps
    p0 = tr.to_u(cloud[:n_chains])
    print(f"{args.sampler}: {n_chains} chains x {n_warmup} warmup "
          f"+ {n_steps} steps (box-logit coordinates)")
    generator = seeded_generator(args.seed, STREAM_MOVES, device)
    t0 = time.time()
    with profiled(args.profile):
        if args.sampler == "nuts":
            chain = nuts_sample(generator, p0, n_steps, logp_u,
                                n_warmup=n_warmup, max_depth=args.maxDepth)
            accept = chain.accept_stat
            n_div = int(torch.sum(chain.diverging))
            extra = (f"nuts: step_size {chain.step_size:.4g}, mean tree "
                     f"depth {float(torch.mean(chain.tree_depth.float())):.1f}"
                     f", divergences {n_div}/{accept.numel()}")
        else:
            chain = hmc_sample(generator, p0, n_steps, logp_u,
                               n_warmup=n_warmup)
            accept = chain.accept_prob
            extra = f"hmc: step_size {chain.step_size:.4g}"
        positions = tr.to_theta(chain.positions).cpu().numpy()
        log_probs = chain.log_probs.cpu().numpy()
    elapsed = time.time() - t0
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    print(f"{extra}, mean accept stat {float(torch.mean(accept)):.2f}")
    print(f"{args.sampler}: {chain.n_grad_evals} gradient evaluations of "
          f"{chain.n_chain_grads} chain gradients in {elapsed:.2f} s "
          f"({chain.n_grad_evals / elapsed:.1f} per second)")

    path = args.outputPrefix + "mainchain.dat"
    open(path, "w").close()
    chain_io.append_chain_text(path, positions, log_probs)
    _print_diagnostics("main", path)
    result = report_quantiles(positions.reshape(-1, len(names)), names)
    rate = (n_warmup + n_steps) * n_chains / elapsed
    print(json.dumps({"walker_steps_per_sec": rate, "elapsed_s": elapsed}))
    return {"quantiles": result, "walker_steps_per_sec": rate}


def fit_phases(args, problem, observed, logp_batch, *, n_walkers: int,
               burnin_steps: int, main_steps: int, names, mesh=None):
    """Everything after the set-up that both drivers share: a fresh start
    (initial walkers, initial log-probs) or ``-resume``, the phases, the
    quantile table of the main chain and the rate line.  Returns the
    CLI's result dict.  In a multi-rank run (``mesh``) every rank samples
    (and reads the ``-resume`` checkpoint); rank 0 alone writes and
    reports, and the other ranks return None."""
    prefix = args.outputPrefix
    burnin_path = prefix + "burninchain.dat"
    main_path = prefix + "mainchain.dat"
    fingerprint = posterior_fingerprint(problem, observed)
    if args.resume:
        state = load_resume_state(args.resume, problem, observed, logp_batch,
                                  seed=args.seed)
        print(f"resumed from {args.resume} at step {state.step}")
        phases = (("main", main_path, main_steps, False),)
    else:
        p0 = problem.initial_walkers_from_observed(
            seeded_generator(args.seed, STREAM_WALKERS, problem.device),
            n_walkers, observed)
        state = init_state(
            p0, logp_batch,
            generator=seeded_generator(args.seed, STREAM_MOVES,
                                       problem.device),
            eval_generator=seeded_generator(args.seed, STREAM_EVAL))
        phases = (("burn-in", burnin_path, burnin_steps, True),
                  ("main", main_path, main_steps, True))

    primary = mesh is None or mesh.rank == 0
    with profiled(args.profile if primary else ""):
        state, total_steps, elapsed = run_phases(
            state, phases, logp_batch, segment=args.segment, prefix=prefix,
            fingerprint=fingerprint,
            adaptive_phase="main" if args.convergeMain else None,
            tau_factor=args.tauFactor, move=args.move, write=primary)
    if not primary:
        return None
    if args.profile:
        print(f"profiler trace written to {args.profile}")
    main_chain, _, n_params, _, _ = chain_io.read_chain_text(main_path)
    result = report_quantiles(main_chain.reshape(-1, n_params), names)

    rate = total_steps * int(state.positions.shape[0]) / elapsed
    print(json.dumps({"walker_steps_per_sec": rate, "elapsed_s": elapsed}))
    if not args.batch:
        draw_figure(lambda: plotting.trace_plot(
            main_chain, names, prefix + "runSampleChainsOut.png"))
    return {"quantiles": result, "walker_steps_per_sec": rate}
