"""The port's command-line drivers (mcmctoffitting_tpu_torch.cli) against
the JAX package's, on the CPU at a small size (<= 16 walkers, 8k draws,
F = 128, 2 runs for simultFit).

* ``posterior_fingerprint``: the same SHA-256 bytes in both packages for
  the problems both CLIs build from the same flags.
* The slice as a whole: both packages' CLIs read one TSV written from the
  JAX package's synthetic observed arrays and print the same
  ``-checkLikelihoodEval`` total (closed-form forward, corrected
  likelihood), within 1e-4 relative.
* A checkpoint written by the JAX CLI resumes in the port's CLI, its
  log-probs kept.
* The simple family and the template unfolding: ``cli.simple_tof
  --debug`` for each model and ``cli.template_fit --debug -doML`` (pinned
  to the synthesis truth) on the CPU at reduced sizes.
* The parser surface: every flag of the JAX parsers parses, ``-mesh 2``
  (the last slice, now ported) runs its ranks, the TPU-schedule flags print a
  note, ``-quitEarly`` stops after set-up, ``-shiftTOF`` shifts as the
  JAX CLI does, ``-chunkWalkers`` with 'expected' equals the unchunked
  fit, and the default device is the GPU.
* Post-processing: ``-profile DIR`` writes a trace on both fit CLIs;
  ``cli.ppc`` writes the JAX CLI's file set from one chain (and, for
  ``-model csi2016``, from a skew-normal chain); ``cli.plot_chain``
  prints the JAX CLI's lines; the figures of the fit CLIs are drawn, or
  without matplotlib one line says so, and any other plotting error
  fails.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.cli import _driver as jdriver
from mcmctoffitting_tpu.cli import csi_onebd as jcli_onebd
from mcmctoffitting_tpu.cli import plot_chain as jcli_plot_chain
from mcmctoffitting_tpu.cli import ppc as jcli_ppc
from mcmctoffitting_tpu.cli import simult_fit as jcli_simult
from mcmctoffitting_tpu.models import onebd as jonebd
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.utils import chain_io as jchain_io
from mcmctoffitting_tpu.utils import data_io as jdata_io
from mcmctoffitting_tpu_torch.cli import _driver as tdriver
from mcmctoffitting_tpu_torch.cli import csi_onebd as tcli_onebd
from mcmctoffitting_tpu_torch.cli import plot_chain as tcli_plot_chain
from mcmctoffitting_tpu_torch.cli import ppc as tcli_ppc
from mcmctoffitting_tpu_torch.cli import simult_fit as tcli_simult
from mcmctoffitting_tpu_torch.models import onebd as tonebd
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.utils import chain_io as tchain_io

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SMALL = ["-nDrawsPerEval", "8000", "-fineGrid", "128", "-batch", "1"]
SIMULT = ["-nRuns", "2"] + SMALL


def _jax_problem(model, argv):
    """The problem the JAX CLI builds from ``argv`` (its main(), up to
    the problem)."""
    if model == "simult":
        args = jcli_simult.build_parser().parse_args(argv)
        sampling, fine_grid = jdriver.resolve_sampling(args)
        n_draws = 5000 if args.debug else args.nDrawsPerEval
        spec = jsimult.default_spec(
            n_samples=n_draws, fine_grid=fine_grid,
            xs_mode="e0grid" if sampling != "mc" else args.gridMode,
            sampling=sampling)
    else:
        args = jcli_onebd.build_parser().parse_args(argv)
        sampling, fine_grid = jdriver.resolve_sampling(args)
        n_draws = args.nDrawsPerEval
        if args.quickish:
            n_draws = 100_000
        if args.qnd:
            n_draws = 60_000
        spec = jonebd.default_spec(
            n_samples=n_draws, hardcore=args.hardcore, fine_grid=fine_grid,
            xs_mode="e0grid" if sampling != "mc" else args.gridMode,
            sampling=sampling)
        if args.deterministicBG:
            spec = dataclasses.replace(spec, bg_mode="expected")
    if args.momentClosure != "exact" or args.aDtype:
        spec = dataclasses.replace(spec, moment_closure=args.momentClosure,
                                   a_dtype=args.aDtype or spec.a_dtype)
    if model == "simult":
        return jsimult.SimultFitProblem(spec, n_runs=args.nRuns,
                                        likelihood=args.likelihood)
    return jonebd.OneBDProblem(spec, n_runs=3, likelihood=args.likelihood)


def _port_problem(model, argv):
    cli = tcli_simult if model == "simult" else tcli_onebd
    return cli.build_problem(cli.build_parser().parse_args(argv), "cpu")


FINGERPRINT_CASES = [
    ("simult", ["-sampling", "counts"]),
    ("simult", []),                                   # mc, e0grid
    ("simult", ["-expectedForward", "-likelihood", "poisson"]),
    ("simult", ["-gridMode", "taylor", "-nRuns", "3"]),
    ("onebd", ["-sampling", "counts"]),
    ("onebd", []),
    ("onebd", ["-sampling", "expected"]),
    ("onebd", ["-deterministicBG"]),
    ("onebd", ["-hardcore"]),
    ("onebd", ["-hardcore", "-sampling", "counts", "-deterministicBG"]),
    ("onebd", ["-qnd", "-momentClosure", "cell", "-sampling", "counts"]),
    ("onebd", ["-hardcore", "-sampling", "counts", "-aDtype", "float32"]),
]


@pytest.mark.parametrize("model,argv", FINGERPRINT_CASES,
                         ids=[f"{m}:{' '.join(a) or 'default'}"
                              for m, a in FINGERPRINT_CASES])
def test_posterior_fingerprint_same_bytes(model, argv, monkeypatch):
    """The e0-grid operators are replaced by a marker on both sides: the
    fingerprint reads no table (tests/test_torch_e0grid.py holds the
    operators equal)."""
    import mcmctoffitting_tpu.ops.e0grid as je0grid
    for mod in (je0grid, tsimult, tonebd):
        monkeypatch.setattr(mod, "cached_e0_grid_table",
                            lambda *a: ("operator",) + a[3:])
    argv = ["-nDrawsPerEval", "8000"] + argv
    jprob, tprob = _jax_problem(model, argv), _port_problem(model, argv)
    rng = np.random.default_rng(len(argv))
    observed = tuple(rng.poisson(50.0, w.n_bins).astype(float)
                     for w in tprob.windows)
    got = tdriver.posterior_fingerprint(tprob, observed)
    want = jdriver.posterior_fingerprint(jprob, observed)
    assert got.dtype == np.uint8 and got.shape == (32,)
    assert got.tobytes() == want.tobytes()
    # a different draw count or data give another digest
    other = tuple(o + 1.0 for o in observed)
    assert not np.array_equal(
        tdriver.posterior_fingerprint(tprob, other), got)


def _write_tsv(path, jproblem, truth, edges, seed):
    """The JAX package's synthetic observed arrays placed into a TAC time
    axis (as tests/test_tsv_e2e.py does) and written with its writer."""
    counts = np.random.default_rng(seed).poisson(
        3.0, (len(edges), len(jproblem.windows))).astype(float)
    observed = jdata_io.synthesize_observed(jax.random.PRNGKey(seed),
                                            jproblem, truth)
    for run, w in enumerate(jproblem.windows):
        mask = (edges >= w.lo) & (edges < w.hi)
        assert mask.sum() == w.n_bins
        counts[mask, run] = np.asarray(observed[run])
    jdata_io.write_multi_standoff_tof_data(str(path), edges, counts)


SIMULT_EXPECTED = SIMULT + ["-expectedForward", "-likelihood", "poisson"]
ONEBD_EXPECTED = SMALL + ["-expectedForward", "-likelihood", "poisson",
                          "-deterministicBG"]


@pytest.fixture(scope="module")
def simult_tsv(tmp_path_factory):
    path = tmp_path_factory.mktemp("tsv") / "multistandoff.dat"
    _write_tsv(path, _jax_problem("simult", SIMULT_EXPECTED),
               np.array([1878.4, 850.0, 170.0, 0.5, 5e3, 5e3]),
               np.arange(100.0, 300.0, 1.0), 0)
    return str(path)


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_check_likelihood_eval_totals_agree(model, simult_tsv,
                                            tmp_path, monkeypatch, capsys):
    """The slice as a whole on one data file: each package's CLI reads
    it, builds its forward and prints its per-bin table; the totals agree
    to 1e-4 relative (the 'expected' spectra agree to 1e-5 of the peak).
    Both sum float32 terms, each holding lgamma(obs + 1) to float32
    rounding: at the campaign's ~5000 counts a bin that alone is ~0.01
    apart per run between the two lgamma implementations, on totals of a
    few hundred.  The data are therefore synthesised at a tenth of the
    campaign's norms (peaks of ~500 counts), where the bound measures the
    forward model."""
    monkeypatch.chdir(tmp_path)
    if model == "simult":
        argv = SIMULT_EXPECTED + ["-datafile", simult_tsv]
        jmain, tmain = jcli_simult.main, tcli_simult.main
    else:
        path = tmp_path / "oneBD_mcmcInputData.dat"
        _write_tsv(path, _jax_problem("onebd", ONEBD_EXPECTED),
                   np.array([1300.0, 80.0, 0.6, 5e3, 5e3, 5e3,
                             20.0, 20.0, 20.0]),
                   np.arange(40.0, 260.0, 4.0), 1)
        argv = ONEBD_EXPECTED + ["-inputDataFilename", str(path)]
        jmain, tmain = jcli_onebd.main, tcli_onebd.main
    argv = argv + ["-checkLikelihoodEval", "1"]
    want = jmain(argv)
    jax_out = capsys.readouterr().out
    got = tmain(argv + ["-device", "cpu"])
    port_out = capsys.readouterr().out
    assert got["status"] == want["status"] == "checkLikelihoodEval"
    total_j, total_t = want["total_loglike"], got["total_loglike"]
    assert np.isfinite(total_t)
    assert abs(total_t - total_j) <= 1e-4 * abs(total_j), (total_t, total_j)
    # the same table: one line per bin of every run, then the total
    for out in (jax_out, port_out):
        assert "total likelihood is" in out
    assert (port_out.count(" bin ") == jax_out.count(" bin ")
            == sum(w.n_bins for w in _port_problem(
                model, argv[:-2]).windows))


def test_jax_checkpoint_resumes_in_the_port(simult_tsv, tmp_path,
                                            monkeypatch, capsys):
    """A main.ckpt.npz of the JAX package on the same data file and flags:
    the port keeps its positions and log-probs as they are, seeds its
    generators from -seed with a note, and samples on from them.  The
    checkpoint is what the JAX CLI writes at the end of a phase (its
    run_phases: ``save_checkpoint`` of the sampler state with the
    posterior fingerprint), taken from its sampler's ``init_state``; a
    JAX CLI run would spend ~40 s compiling its sampler on the CPU."""
    from mcmctoffitting_tpu.sampler import init_state, make_logp_batch
    monkeypatch.chdir(tmp_path)
    argv = SIMULT_EXPECTED + ["-datafile", simult_tsv, "-nWalkers", "8",
                              "-segment", "2"]
    jprob = _jax_problem("simult", argv)
    tof = jdata_io.read_multi_standoff_tof_data(simult_tsv, 2)
    observed = tuple(jdata_io.select_window(tof, i, w.lo, w.hi)[0]
                     for i, w in enumerate(jprob.windows))
    key = jax.random.PRNGKey(0)
    jstate = init_state(
        jax.random.fold_in(key, 2),
        jprob.initial_walkers_from_observed(jax.random.fold_in(key, 1), 8,
                                            observed),
        make_logp_batch(jprob.make_log_prob_fn(observed)))
    jchain_io.save_checkpoint(
        "main.ckpt.npz", jstate._replace(step=jax.numpy.asarray(4)),
        extra={"posterior_fp": jdriver.posterior_fingerprint(jprob,
                                                             observed)})
    ckpt_j = np.load("main.ckpt.npz")
    assert "key" in ckpt_j.files and "generator_state" not in ckpt_j.files
    assert np.all(np.isfinite(ckpt_j["log_probs"]))

    args = tcli_simult.build_parser().parse_args(argv + ["-device", "cpu"])
    problem = tcli_simult.build_problem(args, "cpu")
    logp = problem.make_log_prob_fn(observed)
    state = tdriver.load_resume_state("main.ckpt.npz", problem, observed,
                                      logp, seed=0)
    out = capsys.readouterr().out
    assert "threefry" in out and "fingerprint does not match" not in out
    np.testing.assert_array_equal(state.log_probs.numpy(),
                                  ckpt_j["log_probs"])
    np.testing.assert_array_equal(state.positions.numpy(),
                                  ckpt_j["positions"])
    assert state.step == 4
    # the stored log-probs are the port's at those positions, up to the
    # float32 summation order
    np.testing.assert_allclose(logp(state.positions, torch.Generator()),
                               ckpt_j["log_probs"], rtol=1e-5)

    res = tcli_simult.main(argv + ["-device", "cpu", "-nMainSteps", "2",
                                   "-resume", "main.ckpt.npz"])
    out = capsys.readouterr().out
    assert "resumed from main.ckpt.npz at step 4" in out
    assert "fingerprint does not match" not in out
    chain, _, n_params, n_walkers, n_steps = tchain_io.read_chain_text(
        "mainchain.dat")
    assert (n_steps, n_walkers, n_params) == (2, 8, 6)
    assert all(np.isfinite(v[0]) for v in res["quantiles"].values())
    np.testing.assert_array_equal(
        jchain_io.read_chain_text("mainchain.dat")[0], chain)
    assert tchain_io.load_checkpoint("main.ckpt.npz").step == 6


# --- the parser surface ------------------------------------------------------

def _flags(parser):
    return {s for act in parser._actions for s in act.option_strings}


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_every_jax_flag_parses(model):
    """The port's parser has every flag of the JAX parser (and -device),
    and the JAX package's reference-style command lines parse
    (tests/test_cli_surfaces.py)."""
    jcli, tcli = ((jcli_simult, tcli_simult) if model == "simult"
                  else (jcli_onebd, tcli_onebd))
    jp, tp = jcli.build_parser(), tcli.build_parser()
    assert _flags(tp) == _flags(jp) | {"-device"}
    if model == "simult":
        argv = ["-nRuns", "4", "-mpi", "0", "-debug", "1", "-nThreads", "3",
                "-datafile", "multistandoff.dat", "-quitEarly", "0",
                "-batch", "1", "-forceCustomPDF", "0", "-nDrawsPerEval",
                "200000", "-nBurninSteps", "400", "-nMainSteps", "100"]
    else:
        argv = ["-run", "0", "-inputDataFilename", "x.dat", "-mpi", "0",
                "-debug", "1", "-nThreads", "5", "-quitEarly", "1",
                "-batch", "0", "-forceCustomPDF", "0", "-nDrawsPerEval",
                "200000", "-nBurninSteps", "400", "-nMainSteps", "100",
                "-outputPrefix", "", "-nWalkers", "256", "-qnd", "0",
                "-quickish", "1", "-hardcore", "0", "-shiftTOF", "2"]
    argv += ["-sampling", "counts", "-likelihood", "poisson", "-move",
             "mixed", "-convergeMain", "-tauFactor", "8", "-segment", "5",
             "-seed", "3", "-chunkWalkers", "4", "-gridMode", "taylor",
             "-momentClosure", "cell", "-fineGrid", "64", "-aDtype",
             "bfloat16", "-mesh", "1", "-resume", "x.ckpt.npz",
             "-nChains", "2", "-maxDepth", "3", "-runAxis", "batched",
             "-prng", "rbg", "-checkLikelihoodEval", "0"]
    got, want = vars(tp.parse_args(argv)), vars(jp.parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    for bad in (["-nRuns", "9"], ["-sampling", "nope"], ["-device", "tpu"]):
        if model == "onebd" and bad[0] == "-nRuns":
            continue
        with pytest.raises(SystemExit):
            tp.parse_args(bad)
    # the defaults the JAX CLI documents, -runAxis aside (None: no note)
    defaults = vars(tp.parse_args([]))
    jdefaults = vars(jp.parse_args([]))
    assert defaults.pop("device") == "cuda" and defaults.pop(
        "runAxis") is None
    jdefaults.pop("runAxis")
    assert defaults == jdefaults


@pytest.mark.parametrize("argv,slice_", [(["-mesh", "2"], "slice 8")])
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_later_slices_raise_not_ported(model, argv, slice_, tmp_path):
    """No slice is left to port: ``-mesh 2`` (slice 8, more than one GPU)
    no longer raises; on the CPU it starts two gloo ranks, which run the
    set-up to ``-quitEarly``, and rank 0 alone prints (the CLI as a
    subprocess with a 120 s limit; its ranks exit with it)."""
    module = (tcli_simult if model == "simult" else tcli_onebd).__name__
    proc = subprocess.run(
        [sys.executable, "-m", module, *argv, *SMALL, "-device", "cpu",
         "-quitEarly", "1"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NotImplementedError" not in proc.stderr
    assert slice_ not in proc.stdout + proc.stderr
    assert "-mesh 2: 2 ranks (gloo), walker axis sharded" in proc.stdout
    assert proc.stdout.count("quitEarly: setup complete") == 1


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_quit_early_and_schedule_notes(model, tmp_path, monkeypatch, capsys):
    """-runAxis and -prng are accepted with a note; -nThreads, -mpi and
    -forceCustomPDF silently; -quitEarly stops after set-up and writes no
    file."""
    monkeypatch.chdir(tmp_path)
    cli = tcli_simult if model == "simult" else tcli_onebd
    out = cli.main(SMALL + ["-device", "cpu", "-quitEarly", "1",
                            "-runAxis", "sequential", "-prng", "rbg",
                            "-nThreads", "4", "-mpi", "1",
                            "-forceCustomPDF", "1", "-mesh", "1"])
    assert out == {"status": "quitEarly"}
    text = capsys.readouterr().out
    assert "-runAxis sequential has no effect here" in text
    assert "-prng rbg has no effect here" in text
    assert "quitEarly: setup complete" in text
    assert "nThreads" not in text and "mpi" not in text
    assert not list(tmp_path.iterdir())


def test_default_device_is_the_gpu(monkeypatch):
    """Without a GPU the default -device cuda raises; it never falls back
    to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cli in (tcli_simult, tcli_onebd):
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            cli.main(SMALL + ["-quitEarly", "1"])


@pytest.mark.parametrize("shift", [-2, -1, 0, 1, 2])
def test_shift_tof_matches_the_jax_semantics(shift, tmp_path):
    """-shiftTOF relabels count rows against the time axis before window
    selection (the JAX CLI, cli/csi_onebd.py:104-112): counts slide by
    whole bins."""
    edges = np.arange(40.0, 260.0, 4.0)
    counts = np.column_stack([np.arange(len(edges)) + 100 * r
                              for r in range(3)]).astype(float)
    path = str(tmp_path / "data.tsv")
    jdata_io.write_multi_standoff_tof_data(path, edges, counts)
    problem = _port_problem("onebd", SMALL)
    got = tcli_onebd.observed_from_file(path, problem, shift)
    # the JAX CLI's lines, verbatim
    tof_data = jdata_io.read_multi_standoff_tof_data(path, 3)
    if shift > 0:
        e = tof_data[:-shift, 0]
        tof_data = tof_data[shift:].copy()
        tof_data[:, 0] = e
    elif shift < 0:
        e = tof_data[-shift:, 0]
        tof_data = tof_data[:shift].copy()
        tof_data[:, 0] = e
    for r, w in enumerate(problem.windows):
        want, _ = jdata_io.select_window(tof_data, r, w.lo, w.hi)
        np.testing.assert_array_equal(got[r], want)
        base, _ = jdata_io.select_window(
            jdata_io.read_multi_standoff_tof_data(path, 3), r, w.lo, w.hi)
        np.testing.assert_array_equal(got[r], base + shift)


def test_chunk_walkers_equals_the_unchunked_fit(tmp_path, monkeypatch):
    """'expected' draws nothing, so evaluating the walkers in chunks of 4
    gives the unchunked chain, byte for byte."""
    argv = SIMULT + ["-device", "cpu", "-expectedForward", "-nWalkers",
                     "16", "-nBurninSteps", "2", "-nMainSteps", "3",
                     "-segment", "2"]
    chains = []
    for extra in ([], ["-chunkWalkers", "4"]):
        d = tmp_path / (extra[-1] if extra else "whole")
        d.mkdir()
        monkeypatch.chdir(d)
        tcli_simult.main(argv + extra)
        chains.append((d / "mainchain.dat").read_bytes())
    assert chains[0] == chains[1] and chains[0].count(b"\n") == 3 * 16



def test_converge_main_checks_tau_on_the_jax_schedule(tmp_path, monkeypatch,
                                                      capsys):
    """-convergeMain: -nMainSteps is a cap; tau is checked first at
    max(80, 2 * segment) steps, then at max(done + segment, 1.2 done), and
    the phase stops once S >= tauFactor * tau with a stable tau."""
    monkeypatch.chdir(tmp_path)
    out = tcli_simult.main(SIMULT + [
        "-device", "cpu", "-expectedForward", "-likelihood", "poisson",
        "-nWalkers", "16", "-nBurninSteps", "2", "-nMainSteps", "160",
        "-segment", "20", "-convergeMain", "-tauFactor", "2"])
    lines = capsys.readouterr().out.splitlines()
    checked_at = [int(prev.split("step ")[1].split("/")[0])
                  for prev, line in zip(lines, lines[1:])
                  if line.startswith("main: tau_max")]
    assert checked_at[:3] == [80, 100, 120]
    n_steps = tchain_io.read_chain_text("mainchain.dat")[4]
    stopped = [int(line.split("at step ")[1].split()[0]) for line in lines
               if line.startswith("main: converged at step")]
    assert n_steps == (stopped[0] if stopped else 160)
    assert np.isfinite(out["walker_steps_per_sec"])


# --- post-processing: -profile, cli.ppc, cli.plot_chain, the figures -------

DEBUG = ["-device", "cpu", "-debug", "1", "-batch", "1",
         "-nDrawsPerEval", "4000", "-fineGrid", "64"]


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_profile_writes_a_trace(model, tmp_path, monkeypatch, capsys):
    """-profile DIR: the sampling phases under torch.profiler, a Chrome
    trace in DIR and the JAX CLI's line."""
    import json
    monkeypatch.chdir(tmp_path)
    cli = tcli_simult if model == "simult" else tcli_onebd
    extra = ["-nRuns", "2"] if model == "simult" else []
    cli.main(DEBUG + extra + ["-profile", "trace_dir"])
    assert "profiler trace written to trace_dir" in capsys.readouterr().out
    trace = json.loads((tmp_path / "trace_dir" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("scatter_add" in n for n in names)   # the fine-cell moments


def test_profiling_helpers(tmp_path):
    """utils/profiling.py: ``trace`` writes a Chrome trace of the block,
    ``Throughput`` counts walker-steps per second, ``time_fn`` times the
    first call apart from the steady state."""
    import json
    import time

    from mcmctoffitting_tpu_torch.utils import profiling
    with profiling.trace(str(tmp_path / "t")) as where:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert where == str(tmp_path / "t")
    events = json.loads((tmp_path / "t" / profiling.TRACE_FILE).read_text())
    assert any("mm" in e.get("name", "") for e in events["traceEvents"])
    meter = profiling.Throughput(n_walkers=8)
    time.sleep(0.01)
    assert meter.update(5) > 0 and meter.steps == 5
    calls = []
    out = profiling.time_fn(lambda x: calls.append(x) or torch.ones(3), 2,
                            n_iters=4)
    assert set(out) == {"first_s", "steady_s"} and len(calls) == 5
    assert out["first_s"] >= 0 and out["steady_s"] >= 0


def _fake_chain(path, n_steps=10, n_walkers=8, n_params=6, seed=0):
    """A simultFit-like chain near the guess point, written as emcee
    text."""
    rng = np.random.default_rng(seed)
    center = np.array([1878.4, 850.0, 170.0, 0.5, 5e4, 5e4])[:n_params]
    scales = np.array([5.0, 20.0, 10.0, 0.05, 2e3, 2e3])[:n_params]
    chain = center + scales * rng.standard_normal(
        (n_steps, n_walkers, n_params))
    probs = -1000.0 + rng.standard_normal((n_steps, n_walkers))
    tchain_io.append_chain_text(str(path), chain, probs)
    return str(path)


def test_ppc_cli_writes_the_jax_file_set(tmp_path, monkeypatch, capsys):
    """The same flags on one chain: the port's CLI (-device cpu) writes
    the JAX CLI's files, (3, n_bins) bands and an SDEF card of one entry
    per neutron energy, and prints its lines."""
    chain = _fake_chain(tmp_path / "mainchain.dat")
    argv = ["-chainFilename", chain, "-nRuns", "2", "-nSamplesFromTOF",
            "4000", "-nChainEntries", "4"]
    files = {}
    for name, main, extra in (("jax", jcli_ppc.main, []),
                              ("port", tcli_ppc.main, ["-device", "cpu"])):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        out = main(argv + extra)
        files[name] = sorted(os.listdir(where))
        text = capsys.readouterr().out
        assert "chain: 10 steps x 8 walkers x 6 params" in text
        assert "wrote ppc_sdef.txt" in text and "wrote PPC plots" in text
    assert files["port"] == files["jax"]
    assert {"ppc_run0_bands.txt", "ppc_run1_bands.txt", "ppc_sdef.txt",
            "ppc_corner.png"} <= set(files["port"])
    windows = _port_problem("simult", ["-nRuns", "2"]).windows
    for run, win in enumerate(windows):
        bands = np.loadtxt(tmp_path / "port" / f"ppc_run{run}_bands.txt")
        assert bands.shape == (3, win.n_bins) and np.isfinite(bands).all()
        assert np.all(bands[0] <= bands[1]) and np.all(bands[1] <= bands[2])
    si, sp = (tmp_path / "port" / "ppc_sdef.txt").read_text().splitlines()
    n_en = tsimult.default_spec(4000).ed_binning.n
    assert si.startswith("si100 a") and len(si.split()) == 2 + n_en
    assert sp.startswith("sp100") and len(sp.split()) == 1 + n_en
    assert out["sdef"] == {"si": si, "sp": sp} and out["n_draws"] == 4


def test_ppc_cli_refusals(tmp_path, monkeypatch):
    """A missing chain file is the JAX CLI's one-line error, for every
    model (-model csi2016 is ported and reaches the same check); the
    default device is the GPU."""
    monkeypatch.chdir(tmp_path)
    for model in ("simult", "onebd", "csi2016"):
        with pytest.raises(SystemExit, match="chain file not found"):
            tcli_ppc.main(["-chainFilename", "missing.dat", "-model", model,
                           "-device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        tcli_ppc.main(["-chainFilename", "missing.dat"])


def test_plot_chain_prints_the_jax_lines(tmp_path, monkeypatch, capsys):
    """The same chain: the same summary lines (the port's diagnostics are
    the JAX package's) and the same figure files."""
    chain = _fake_chain(tmp_path / "chain.dat", n_steps=12, n_params=2)
    files, texts = {}, {}
    for name, main in (("jax", jcli_plot_chain.main),
                       ("port", tcli_plot_chain.main)):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        out = main(["-filename", chain, "-paramNames", "beamE,eLoss"])
        texts[name] = capsys.readouterr().out
        files[name] = sorted(os.listdir(where))
        assert out == {"n_steps": 12, "n_walkers": 8, "n_params": 2}
    assert texts["port"] == texts["jax"]
    assert "diagnostics:" in texts["port"]
    assert "wrote plots with prefix chain_" in texts["port"]
    assert files["port"] == files["jax"] and "chain_corner.png" in files[
        "port"]


def test_fit_figures_or_the_missing_matplotlib_line(tmp_path, monkeypatch,
                                                    capsys):
    """Without -batch the fit CLIs draw the -checkLikelihoodEval overlay
    of every run and the trace plot after a fit; without matplotlib each
    figure prints the one line that names it and the run goes on."""
    import sys
    monkeypatch.chdir(tmp_path)
    argv = ["-device", "cpu", "-debug", "1", "-nRuns", "2",
            "-nDrawsPerEval", "4000", "-fineGrid", "64"]
    tcli_simult.main(argv + ["-checkLikelihoodEval", "1"])
    tcli_simult.main(argv)
    assert {"likelihoodCheck_run0.png", "likelihoodCheck_run1.png",
            "runSampleChainsOut.png"} <= set(os.listdir(tmp_path))
    assert "plotting skipped" not in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    where = tmp_path / "no_matplotlib"
    where.mkdir()
    monkeypatch.chdir(where)
    tcli_simult.main(argv + ["-checkLikelihoodEval", "1"])
    tcli_simult.main(argv)
    text = capsys.readouterr().out
    assert text.count("plotting skipped: matplotlib is not installed") == 3
    assert not [f for f in os.listdir(where) if f.endswith(".png")]


def test_other_plotting_errors_fail_the_run(tmp_path, monkeypatch):
    """Only matplotlib's ImportError is caught: another module's, or any
    other error of a figure, propagates."""
    def missing_other():
        raise ModuleNotFoundError("No module named 'scipy'", name="scipy")

    def broken():
        raise ValueError("bad figure")

    monkeypatch.chdir(tmp_path)
    assert tdriver.draw_figure(lambda: None) is True
    with pytest.raises(ModuleNotFoundError, match="scipy"):
        tdriver.draw_figure(missing_other)
    with pytest.raises(ValueError, match="bad figure"):
        tdriver.draw_figure(broken)
    # a fit's figure that fails stops the fit
    monkeypatch.setattr(tdriver.plotting, "trace_plot",
                        lambda *a, **k: broken())
    with pytest.raises(ValueError, match="bad figure"):
        tcli_simult.main(["-device", "cpu", "-debug", "1", "-nRuns", "1",
                          "-nDrawsPerEval", "2000", "-fineGrid", "64",
                          "-nBurninSteps", "2", "-nMainSteps", "2"])


# --- the simple family and the template unfolding (their CLIs) -----------

from mcmctoffitting_tpu.cli import simple_tof as jcli_simple  # noqa: E402
from mcmctoffitting_tpu.cli import template_fit as jcli_template  # noqa: E402
from mcmctoffitting_tpu_torch.cli import (  # noqa: E402
    simple_tof as tcli_simple, template_fit as tcli_template)


def test_simple_and_template_parsers_have_the_jax_flags():
    """The flags of the JAX CLIs (their parsers are built inside main(), so
    the flag names are listed here), and -device (cuda)."""
    import inspect
    for jcli, tcli in ((jcli_simple, tcli_simple),
                       (jcli_template, tcli_template)):
        tp = tcli.build_parser()
        for flag in _flags(tp) - {"-h", "--help", "-device"}:
            assert f'"{flag}"' in inspect.getsource(jcli.main), flag
        assert vars(tp.parse_args([]))["device"] == "cuda"
    assert tcli_simple.MODEL_CONFIGS == jcli_simple.MODEL_CONFIGS
    assert set(vars(tcli_simple.build_parser().parse_args([]))) == {
        "model", "datafile", "nDraws", "nWalkers", "nSteps", "seed",
        "debug", "outputPrefix", "minimizeSeed", "device"}
    assert set(vars(tcli_template.build_parser().parse_args([]))) == {
        "filename", "templateFile", "nDraws", "nWalkers", "nBurnin", "seed",
        "debug", "outputPrefix", "doML", "device"}


@pytest.mark.parametrize("model", ["v0", "v1", "v2", "v2.5"])
def test_simple_tof_debug_on_the_cpu(model, tmp_path, monkeypatch, capsys):
    """--debug at reduced draws (16 walkers, 4 steps, 4000 draws): the JAX
    CLI's lines, mainchain.dat of (4, 16, D), finite quantiles, one batched
    log-prob evaluation per half-step (plus the initial one and its
    refresh rounds); v1 also seeds from the TNC fit."""
    from mcmctoffitting_tpu_torch.models import simple as tsimple
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli_simple, "DEBUG_SIZES", (16, 4, 4000))
    evals = [0]
    log_prob = tsimple.SimpleProblem.log_prob

    def counted(self, *args, **kwargs):
        evals[0] += 1
        return log_prob(self, *args, **kwargs)

    monkeypatch.setattr(tsimple.SimpleProblem, "log_prob", counted)
    extra = ["--minimizeSeed"] if model == "v1" else []
    out = tcli_simple.main(["--model", model, "--debug", "-device", "cpu"]
                           + extra)
    text = capsys.readouterr().out
    n_dim = tcli_simple.MODEL_CONFIGS[model]["n_dim"]
    assert "synthesized fake data at truth" in text
    assert "MCMC result (median +sigma -sigma vs truth):" in text
    assert '{"walker_steps_per_sec": ' in text
    assert ("TNC seed: nll" in text) == (model == "v1")
    chain, probs, n_params, n_walkers, n_steps = \
        tchain_io.read_chain_text("mainchain.dat")
    assert (n_steps, n_walkers, n_params) == (4, 16, n_dim)
    assert all(np.isfinite(v).all() for v in out["quantiles"].values())
    assert 0 <= out["initial_nonfinite"] <= 16
    if model != "v1":
        assert 2 * 4 + 1 <= evals[0] <= 2 * 4 + 9


def test_template_fit_debug_with_ml_on_the_cpu(tmp_path, monkeypatch,
                                               capsys):
    """--debug -doML at reduced sizes (1000 draws, 16 walkers, 6 steps).
    The ML fit is pinned to the synthesis truth, not to the JAX CLI's
    output: the synthetic data are built from the guess coefficients and
    the scales (1.1, 0.6, 1.5), so the start point is the truth; the fit
    ends inside the bounds, no worse than its start, with the scales
    within 20% of the truth (the tolerance of the JAX package's own
    SLSQP test).  A second run reads the CSV cache back, equal to what the
    first wrote."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tcli_template, "DEBUG_SIZES", (1000, 16, 6))
    out = tcli_template.main(["--debug", "-doML", "-device", "cpu"])
    text = capsys.readouterr().out
    assert "generating templates (4 standoffs x 32 slices)..." in text
    assert "SLSQP ML fit: nll" in text
    assert "optimized coefficients that will be used:" in text
    ml = out["ml"]
    x = ml["x"]
    assert np.all(x[:3] >= [0.8, 0.25, 1.3]) and np.all(x[:3] <= [2.0, 1.0,
                                                                   1.9])
    assert np.all(x[3:] >= 0.0) and np.all(x[3:] <= 25_000.0)
    assert ml["nll"] <= ml["nll_start"] + 1e-6 * abs(ml["nll_start"])
    np.testing.assert_allclose(x[:3], [1.1, 0.6, 1.5], rtol=0.2)
    assert np.isfinite(out["scales_median"]).all()
    chain, _, n_params, n_walkers, _ = tchain_io.read_chain_text(
        "tmpl_burninchain.dat")
    assert (n_params, n_walkers) == (35, 16)
    from mcmctoffitting_tpu_torch.models import templates as tT
    written = tT.load_templates_csv("templates.csv", 4)
    again = tcli_template.main(["--debug", "-device", "cpu"])
    assert "loading templates from templates.csv" in capsys.readouterr().out
    for a, b in zip(out["observed"], again["observed"]):
        np.testing.assert_array_equal(a, b)
    assert [t.shape[0] for t in written] == [32] * 4


def test_ppc_cli_csi2016_writes_the_jax_file_set(tmp_path, monkeypatch,
                                                 capsys):
    """-model csi2016 on a 4-parameter skew-normal chain: the JAX CLI's
    files and lines, bands (3, n_bins) finite and ordered."""
    rng = np.random.default_rng(5)
    center = np.array([900.0, 0.05, 1.0, 1e4])
    scales = np.array([10.0, 0.005, 0.2, 500.0])
    chain = center + scales * rng.standard_normal((10, 8, 4))
    probs = -500.0 + rng.standard_normal((10, 8))
    path = str(tmp_path / "old_campaign.dat")
    tchain_io.append_chain_text(path, chain, probs)
    argv = ["-chainFilename", path, "-model", "csi2016", "-nRuns", "2",
            "-nSamplesFromTOF", "2000", "-nChainEntries", "3"]
    files = {}
    for name, main, extra in (("jax", jcli_ppc.main, []),
                              ("port", tcli_ppc.main, ["-device", "cpu"])):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        main(argv + extra)
        files[name] = sorted(os.listdir(where))
        assert "wrote ppc_sdef.txt" in capsys.readouterr().out
    assert files["port"] == files["jax"]
    from mcmctoffitting_tpu_torch.models import csi2016 as tcsi
    windows = tcsi.Csi2016Problem(tcsi.default_spec(2000), n_runs=2,
                                  device="cpu").windows
    for run, win in enumerate(windows):
        bands = np.loadtxt(tmp_path / "port" / f"ppc_run{run}_bands.txt")
        assert bands.shape == (3, win.n_bins) and np.isfinite(bands).all()
        assert np.all(bands[0] <= bands[1]) and np.all(bands[1] <= bands[2])
