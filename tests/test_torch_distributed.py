"""The port's multi-process runtime (mcmctoffitting_tpu_torch.parallel:
``distributed``, ``launch``) on the CPU over gloo: the counterparts of
tests/test_distributed.py and tests/test_sharded_fullfit.py, and the port's
sharded evaluator against the JAX package's.

* ``initialize`` reads the MCMCTOF_* variables and picks NCCL for a CUDA
  device, gloo for the CPU (``init_process_group`` monkeypatched);
* a 2-process dryrun: one sharded DE step, the same on both ranks;
* the global-mesh helpers on 2 ranks; ``launch`` kills every rank when one
  fails, and at its deadline;
* ``cli.simult_fit -device cpu -mesh 2``: burn-in -> checkpoint ->
  ``-resume`` -> main gives the uninterrupted ``-mesh 2`` chain byte for
  byte, and with counts or 'expected' the ``-mesh 1`` chain too (each CLI
  run a subprocess with a 120 s limit; its ranks exit with it);
* the JAX package's ``make_sharded_logp_batch`` on the 8-device CPU mesh of
  tests/conftest.py and the port's over 2 gloo ranks give the same
  'expected' log-probs of numpy-seeded thetas, the JAX package's observed
  arrays injected, within the tolerance of the port's other 'expected'
  parity tests (|d lp| <= 1e-5 x sum_bins |obs ln model| + model,
  tests/test_torch_mc_table.py::test_expected_parity).

JAX is imported inside the tests that need it: the ranks import this
module.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.parallel import (distributed, launch,
                                               make_mesh,
                                               make_sharded_logp_batch,
                                               replicate)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 120.0


def test_initialize_reads_the_env_and_picks_the_backend(monkeypatch):
    monkeypatch.setenv("MCMCTOF_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("MCMCTOF_NUM_PROCESSES", "2")
    monkeypatch.setenv("MCMCTOF_PROCESS_ID", "1")
    seen = []

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        seen.append((backend, init_method, world_size, rank))

    monkeypatch.setattr(dist, "init_process_group", fake_init)
    distributed.initialize()
    distributed.initialize(device="cpu")
    distributed.initialize("127.0.0.1:99", 4, 3, device="cuda:1",
                           backend="gloo")
    assert seen == [("nccl", "tcp://10.0.0.1:1234", 2, 1),
                    ("gloo", "tcp://10.0.0.1:1234", 2, 1),
                    ("gloo", "tcp://127.0.0.1:99", 4, 3)]
    monkeypatch.delenv("MCMCTOF_PROCESS_ID")
    with pytest.raises(ValueError, match="MCMCTOF_PROCESS_ID"):
        distributed.initialize(device="cpu")


def test_dryrun_two_processes():
    positions, log_probs = zip(*launch.dryrun(2, 16, timeout_s=DEADLINE_S))
    assert positions[0].shape == (16, 6)
    np.testing.assert_array_equal(positions[0], positions[1])
    np.testing.assert_array_equal(log_probs[0], log_probs[1])
    assert np.isfinite(log_probs[0]).all()


def _helpers_rank():
    mesh = distributed.global_mesh(devices="cpu")
    host = np.arange(24, dtype=np.float32).reshape(8, 3)
    own = torch.full((2,), float(mesh.rank))
    return {"size": mesh.size, "rank": mesh.rank,
            "shard": distributed.shard_walkers(host, mesh).numpy(),
            "global": distributed.make_global_array(host, mesh).numpy(),
            "tree": distributed.replicate_global({"a": host, "b": 3}, mesh),
            "replicated": replicate((own, [own + 1.0]), mesh)}


def test_global_mesh_helpers():
    """On 2 ranks: shard_walkers gives each rank its rows, the replicated
    forms all of them, and ``replicate`` broadcasts rank 0's values."""
    out = launch.launch(_helpers_rank, 2, backend="gloo",
                        timeout_s=DEADLINE_S)
    host = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r, o in enumerate(out):
        assert (o["size"], o["rank"]) == (2, r)
        np.testing.assert_array_equal(o["shard"], host[4 * r:4 * r + 4])
        np.testing.assert_array_equal(o["global"], host)
        np.testing.assert_array_equal(o["tree"]["a"], host)
        assert o["tree"]["b"] == 3
        own, (plus,) = o["replicated"]
        np.testing.assert_array_equal(own, [0.0, 0.0])
        np.testing.assert_array_equal(plus, [1.0, 1.0])


def _fail_on_rank_1():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.barrier()                        # rank 0 waits for a peer gone


def _sleep_rank():
    time.sleep(300)


def test_launch_kills_every_rank_when_one_fails():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        launch.launch(_fail_on_rank_1, 2, backend="gloo",
                      timeout_s=DEADLINE_S)
    with pytest.raises(RuntimeError, match="deadline"):
        launch.launch(_sleep_rank, 2, backend="gloo", timeout_s=15.0)
    assert time.monotonic() - t0 < DEADLINE_S


CLI = ["-device", "cpu", "-nWalkers", "16", "-nRuns", "2", "-nDrawsPerEval",
       "8000", "-fineGrid", "128", "-batch", "1", "-segment", "4",
       "-likelihood", "poisson", "-nBurninSteps", "4"]


def _cli(where: Path, *flags):
    where.mkdir(exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "mcmctoffitting_tpu_torch.cli.simult_fit",
         *CLI, *flags], cwd=where, capture_output=True, text=True,
        timeout=DEADLINE_S, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


@pytest.mark.parametrize("sampling", ["counts", "expected"])
def test_sharded_cli_resumes_exactly_and_equals_one_rank(tmp_path,
                                                         sampling):
    flags = ("-sampling", sampling)
    text = _cli(tmp_path / "whole", *flags, "-mesh", "2", "-nMainSteps", "8")
    assert "2 ranks (gloo), walker axis sharded" in text
    assert "walker axis sharded over 2 ranks" in text
    assert text.count('{"walker_steps_per_sec"') == 1      # rank 0 alone
    whole = (tmp_path / "whole" / "mainchain.dat").read_bytes()
    _cli(tmp_path / "parts", *flags, "-mesh", "2", "-nMainSteps", "4")
    assert (tmp_path / "parts" / "main.ckpt.npz").exists()
    text = _cli(tmp_path / "parts", *flags, "-mesh", "2", "-nMainSteps", "4",
                "-resume", "main.ckpt.npz")
    assert "resumed from main.ckpt.npz at step 8" in text
    assert (tmp_path / "parts" / "mainchain.dat").read_bytes() == whole
    _cli(tmp_path / "one", *flags, "-mesh", "1", "-nMainSteps", "8")
    assert (tmp_path / "one" / "mainchain.dat").read_bytes() == whole


def _expected_problem():
    spec = dataclasses.replace(
        tsimult.default_spec(8000, fine_grid=128, sampling="expected"),
        rint_draws=False)
    return tsimult.SimultFitProblem(spec, n_runs=2, likelihood="poisson",
                                    device="cpu")


def _expected_rank(observed, thetas):
    mesh = make_mesh("cpu")
    problem = _expected_problem()
    logp = make_sharded_logp_batch(problem.make_log_prob_fn(observed), mesh,
                                   by_row=problem.draws_by_row)
    return logp(torch.as_tensor(thetas), torch.Generator().manual_seed(0))


def test_sharded_log_probs_match_the_jax_package():
    import jax

    from mcmctoffitting_tpu.models import simult as jsimult
    from mcmctoffitting_tpu.parallel import (make_mesh as jmake_mesh,
                                             make_sharded_logp_batch as
                                             jsharded)
    from mcmctoffitting_tpu.utils import data_io as jdata_io

    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    spec = dataclasses.replace(
        jsimult.default_spec(8000, fine_grid=128, sampling="expected"),
        rint_draws=False)
    jproblem = jsimult.SimultFitProblem(spec, n_runs=2, likelihood="poisson")
    truth = np.concatenate([jsimult.GUESS_SHARED, np.full(2, 5.0e4)])
    observed = tuple(np.asarray(o, np.float64) for o in
                     jdata_io.synthesize_observed(jax.random.PRNGKey(5),
                                                  jproblem, truth))
    spread = np.concatenate([jsimult.AGITATORS_SHARED, 0.05 * truth[4:]])
    thetas = (truth + spread * np.random.default_rng(6).standard_normal(
        (16, truth.size))).astype(np.float32)
    want = np.asarray(jsharded(jproblem.make_log_prob_fn(observed),
                               jmake_mesh(jax.devices()[:8]))(
        thetas, jax.random.split(jax.random.PRNGKey(7), 16)))
    got = launch.launch(_expected_rank, 2, (observed, thetas),
                        backend="gloo", timeout_s=DEADLINE_S)
    np.testing.assert_array_equal(got[0], got[1])
    got = got[0].numpy()
    ok = np.isfinite(want)
    assert ok.sum() >= 8 and np.array_equal(ok, np.isfinite(got))
    problem = _expected_problem()
    spectra = problem.run_spectra(torch.as_tensor(thetas),
                                  torch.Generator()).numpy()
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(s[:, :o.size], 1e-3)))
                       + s[:, :o.size], -1)
                for o, s in zip(observed, spectra.transpose(1, 0, 2)))
    assert np.all(np.abs(got[ok] - want[ok]) <= 1e-5 * scale[ok]), (got,
                                                                    want)
