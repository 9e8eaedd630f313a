"""Exact resume of the port's command-line fits, and the deterministic
moment sums that make it possible, on the CPU at a small size (16
walkers, 8k draws, F = 128, 2 runs for simultFit).

* N steps, then ``-resume main.ckpt.npz`` for N more, write the same
  ``mainchain.dat`` bytes as 2N steps in one run, for the counts, the
  'expected' and the mc (table, e0grid) estimators; a checkpoint of
  another posterior is re-evaluated, with the JAX package's warning.
* ``fine_cell_moments`` and ``energy_moments`` sum in int64 fixed point:
  each sum is the float64 sum of its float32 terms rounded to float32, up
  to one float32 step, and the sums do not depend on the order of the
  samples.  (Their agreement with the JAX package is held in
  tests/test_torch_mc_table.py and tests/test_torch_transport.py.)

The same checks on the card are ``cuda`` tests in tests/test_torch_cuda.py.
"""
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.cli import csi_onebd, simult_fit
from mcmctoffitting_tpu_torch.models import simult
from mcmctoffitting_tpu_torch.ops import cuda_transport, e0grid
from mcmctoffitting_tpu_torch.ops.fixed_point import (channel_shifts,
                                                      fixed_point_shift)
from mcmctoffitting_tpu_torch.utils import chain_io

torch.set_num_threads(1)

SMALL = ["-device", "cpu", "-nDrawsPerEval", "8000", "-fineGrid", "128",
         "-batch", "1", "-nWalkers", "16", "-nBurninSteps", "2",
         "-segment", "2"]
CASES = {
    "simult-counts": (simult_fit, ["-nRuns", "2", "-sampling", "counts"]),
    "simult-expected": (simult_fit, ["-nRuns", "2", "-expectedForward",
                                     "-likelihood", "poisson"]),
    "simult-mc": (simult_fit, ["-nRuns", "2"]),
    "onebd-mc": (csi_onebd, ["-move", "mixed"]),
}


def _run(cli, argv, where, monkeypatch):
    where.mkdir(exist_ok=True)
    monkeypatch.chdir(where)
    return cli.main(argv)


@pytest.mark.parametrize("case", list(CASES))
def test_resume_continues_exactly(case, tmp_path, monkeypatch, capsys):
    cli, flags = CASES[case]
    argv = SMALL + flags
    _run(cli, argv + ["-nMainSteps", "4"], tmp_path / "a", monkeypatch)
    b = tmp_path / "b"
    _run(cli, argv + ["-nMainSteps", "2"], b, monkeypatch)
    capsys.readouterr()
    _run(cli, argv + ["-nMainSteps", "2", "-resume", "main.ckpt.npz"], b,
         monkeypatch)
    out = capsys.readouterr().out
    assert "resumed from main.ckpt.npz at step 4" in out
    assert "fingerprint does not match" not in out
    assert "no torch generator states" not in out
    whole = (tmp_path / "a" / "mainchain.dat").read_bytes()
    assert (b / "mainchain.dat").read_bytes() == whole
    assert chain_io.read_chain_text(str(b / "mainchain.dat"))[4] == 4
    ckpt_a = chain_io.load_checkpoint(str(tmp_path / "a" / "main.ckpt.npz"))
    ckpt_b = chain_io.load_checkpoint(str(b / "main.ckpt.npz"))
    assert ckpt_a.step == ckpt_b.step == 6
    np.testing.assert_array_equal(ckpt_a.log_probs, ckpt_b.log_probs)
    assert torch.equal(ckpt_a.generator_state, ckpt_b.generator_state)
    assert torch.equal(ckpt_a.eval_generator_state,
                       ckpt_b.eval_generator_state)


def test_other_posterior_is_reevaluated(tmp_path, monkeypatch, capsys):
    """A checkpoint sampled at another draw count keeps its walkers and
    generators, and its log-probs are evaluated anew (step counter reset,
    as the JAX package's init_state does)."""
    argv = SMALL + ["-nRuns", "2", "-sampling", "counts"]
    _run(simult_fit, argv + ["-nMainSteps", "2"], tmp_path, monkeypatch)
    stored = chain_io.load_checkpoint("main.ckpt.npz")
    capsys.readouterr()
    argv[argv.index("8000")] = "6000"
    simult_fit.main(argv + ["-nMainSteps", "2", "-resume", "main.ckpt.npz"])
    out = capsys.readouterr().out
    assert ("WARNING: checkpoint posterior fingerprint does not match this "
            "invocation (different data, -nDrawsPerEval or run count?); "
            "re-evaluating log-probs at the restored positions") in out
    assert "resumed from main.ckpt.npz at step 0" in out
    chain, probs, _, _, n_steps = chain_io.read_chain_text("mainchain.dat")
    assert n_steps == 4
    np.testing.assert_allclose(chain[1], stored.positions, rtol=1e-7)


# --- the fixed-point moment sums -------------------------------------------

def test_fixed_point_shift():
    assert fixed_point_shift(200_000, 1.0) == 43
    assert fixed_point_shift(1, 1.0) == 61
    assert channel_shifts(4096, (1.0, 0.5, 0.25, 0.125)) == (49, 50, 51, 52)
    for n in (1, 7, 4096, 200_000, 10 ** 7):
        assert n * 2.0 ** fixed_point_shift(n, 1.0) <= 2.0 ** 61
        assert n * 2.0 ** (fixed_point_shift(n, 1.0) + 1) > 2.0 ** 61


def _within_one_step(got, terms, idx, n_bins, shifts, chan_dim):
    """Each float32 sum against the float64 sum of its float32 terms
    rounded to float32: one float32 step of that sum, plus the 2^-(s+1)
    per term of the rounding to the fixed-point grid."""
    n_chan = len(shifts)
    want = torch.zeros((terms.shape[0], n_chan, n_bins), dtype=torch.float64)
    count = torch.zeros_like(want)
    for k in range(n_chan):
        want[:, k].scatter_add_(-1, idx, terms[..., k].double())
        count[:, k].scatter_add_(-1, idx, torch.ones_like(terms[..., k],
                                                          dtype=torch.float64))
    want32 = want.float()
    step = torch.as_tensor(np.spacing(np.abs(want32.numpy())))
    quant = count * torch.tensor([2.0 ** -(s + 1) for s in shifts],
                                 dtype=torch.float64)[:, None]
    got = got.movedim(chan_dim, 1).double()
    assert torch.all((got - want32.double()).abs() <= step + quant)
    return (got != want32.double()).double().mean().item()


@pytest.fixture
def simult_grid():
    spec = simult.default_spec(4096, fine_grid=128)
    return simult.SimultFitProblem(spec, n_runs=2, device="cpu").forward


def _energies(seed, shape=(6, 4096)):
    rng = np.random.default_rng(seed)
    e = (2050.0 - 150.0 * np.exp(0.5 * rng.standard_normal(shape)))
    e[0, :3] = [-5.0, np.nan, 2500.0]           # out of range, NaN, beyond
    return torch.as_tensor(e.astype(np.float32))


def test_fine_cell_moments_fixed_point(simult_grid):
    """~500 samples a cell, enough for float32 sums in another order to
    differ in their last bits."""
    grid = simult_grid.e0grid
    e = _energies(0, (2, 1 << 16))
    got = e0grid.fine_cell_moments(grid, e)             # (rows, 4, F)
    in_range = (e >= grid.e0_lo) & (e <= grid.e0_hi)
    u = torch.floor((e - grid.e0_lo) * (grid.n_fine / (grid.e0_hi
                                                       - grid.e0_lo)))
    idx = torch.clamp(torch.where(in_range, u, 0.0), 0,
                      grid.n_fine - 1).long()
    t = torch.where(in_range, (e - grid.t_ref) * (1.0 / grid.t_scale), 0.0)
    base = in_range.float()
    terms = torch.stack([base, base * t, base * t * t, base * t * t * t], -1)
    shifts = channel_shifts(e.shape[-1], e0grid.MOMENT_BOUNDS)
    _within_one_step(got, terms, idx, grid.n_fine, shifts, 1)
    # counts exact; NaN and out-of-range energies dropped
    assert torch.equal(got[:, 0].sum(-1), in_range.sum(-1).float())
    assert bool(torch.isfinite(got).all())
    # the order of the samples does not matter, bit for bit
    perm = torch.randperm(e.shape[-1], generator=torch.Generator()
                          .manual_seed(1))
    assert torch.equal(e0grid.fine_cell_moments(grid, e[:, perm]), got)


def test_energy_moments_fixed_point(monkeypatch):
    """The moment channels of mc 'taylor' on the table."""
    spec = simult.default_spec(2048, xs_mode="taylor")
    fwd = simult.SimultFitProblem(spec, n_runs=2, device="cpu").forward
    bins, n_x = fwd.moment_bins, spec.x_binning.n
    e0 = _energies(1, (3, 1 << 14))
    got = cuda_transport.energy_moments(fwd.transport, e0, n_x, bins)
    e = fwd.transport(e0)                                # (R, M, N)
    idx, chans = cuda_transport.moment_channels(e, bins)
    shifts = channel_shifts(e0.shape[-1], cuda_transport.MOMENT_BOUNDS)
    _within_one_step(got.reshape(-1, 4, bins.n_bins),
                     chans.reshape(-1, e.shape[-1], 4),
                     idx.reshape(-1, e.shape[-1]), bins.n_bins, shifts, 1)
    # another order of the samples, and chunks of them: the same bits
    perm = torch.randperm(e0.shape[-1], generator=torch.Generator()
                          .manual_seed(2))
    assert torch.equal(cuda_transport.energy_moments(
        fwd.transport, e0[:, perm], n_x, bins), got)
    monkeypatch.setattr(cuda_transport, "_PLAIN_CHUNK", 3 * n_x * 1000)
    assert torch.equal(
        cuda_transport.energy_moments(fwd.transport, e0, n_x, bins), got)
