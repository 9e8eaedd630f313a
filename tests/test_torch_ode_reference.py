"""The benchmark's plain reference of the mc estimator on the ODE path
(``portbench/reference/mc.py``, ``ode.py``) against the port, on the CPU
at small sizes (at most 8k draws and 16 walkers).

(a) The reference's RK4 constants and Taylor coefficients are the
    program's tables, equal as float64 and float32 values: both are the
    same host arithmetic of the same published inputs.
(b) Its transported energies are ``ops/stopping.py::rk4_transport``'s
    bit for bit (the same float32 operations in the same order on the
    same device), and its moment histograms ``transport_moments_plain``'s:
    the counts equal, the d channels within one float32 ulp of the sum
    plus what the plain version's int64 fixed point drops (half a step of
    2^-s a sample, s from ``ops/fixed_point.py``), since the reference
    sums the same float32 channel values in float64 and rounds once.
(c) Its log-prob is the program's at the same proposals and seed words:
    the grids and e0 means bit for bit, and the log-prob bit for bit with
    the program's plain K2 summing in float64 as the card's K2 does
    (exact fixed point, rounded once); with the plain K2 summing in
    float32, as it does on the CPU, within 0.1 nats (each bin of the
    TOF histogram can move by a few float32 ulps, ~1e-6 of it, and the
    log-likelihood moves by ~1e-6 of the 5e4 counts of a run).
(d) ``reference/mc.py`` loads nothing of the program and no JAX.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.config import (SIMULTFIT_ED_BINNING,
                                             SIMULTFIT_X_BINNING)
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import cuda_tof, cuda_transport
from mcmctoffitting_tpu_torch.ops import fixed_point
from mcmctoffitting_tpu_torch.ops import stopping as tstopping
from portbench.plan import ROOT
from portbench.reference import mc, ode
from portbench.reference.poisson import seed_words

torch.set_num_threads(1)
N_DRAWS = 4096
CONFIG = {"model": "simult", "n_runs": 2, "n_samples": N_DRAWS}
TRAFFIC = {"transport": "rk4", "xs_mode": "taylor"}
TRUTH = np.array([1878.4, 850.0, 170.0, 0.5, 5e4, 5e4], np.float32)
SPREAD = np.array([10.0, 50.0, 20.0, 0.1, 7500.0, 7500.0], np.float32)


@pytest.fixture(scope="module")
def camp():
    return mc.campaign(CONFIG, TRAFFIC)


@pytest.fixture(scope="module")
def problem():
    spec = tsimult.default_spec(N_DRAWS, sampling="mc", transport="rk4",
                                xs_mode="taylor")
    return tsimult.SimultFitProblem(spec, 2, "poisson", device="cpu")


def _e0(shape, seed):
    """Initial energies: mostly in the eD histogram's reach, some above
    it, and a tail that stops at the floor inside the cell."""
    rng = np.random.default_rng(seed)
    e0 = rng.uniform(450.0, 1400.0, shape)
    e0.reshape(-1)[::97] = rng.uniform(15.0, 200.0, e0.size)[::97]
    return torch.as_tensor(e0.astype(np.float32))


# --- (a) ---------------------------------------------------------------

def test_rk4_constants_and_taylor_coefficients_are_the_programs(camp,
                                                                 problem):
    got = camp.rk4
    want = tstopping.rk4_constants(tstopping.d2_gas_stopping(mc.RHO),
                                   SIMULTFIT_X_BINNING.centers, 1)
    assert (got.a, got.p, got.q, got.floor, got.substeps) == (
        want.a, want.p, want.q, want.energy_floor, want.n_substeps)
    assert (got.h, got.half_h, got.sixth_h) == (want.h, want.half_h,
                                                 want.sixth_h)
    assert tuple(problem.forward.rk4) == tuple(want)
    taylor = tforward.taylor_coeffs(problem.spec)
    np.testing.assert_array_equal(camp.taylor, taylor)
    np.testing.assert_array_equal(camp.taylor.astype(np.float32),
                                  problem.forward.taylor.numpy())
    assert (camp.ed.lo, camp.ed.hi, camp.ed.n) == (
        SIMULTFIT_ED_BINNING.lo, SIMULTFIT_ED_BINNING.hi,
        SIMULTFIT_ED_BINNING.n)


# --- (b) ---------------------------------------------------------------

def test_transported_energies_are_the_programs_bit_for_bit(camp, problem):
    e0 = _e0((6, N_DRAWS), 1)
    got = ode.transport(camp.rk4, e0)
    want = tstopping.rk4_transport(problem.forward.rk4, e0)
    assert got.shape == (6, 10, N_DRAWS)
    assert torch.equal(got, want)
    assert torch.any(got == camp.rk4.floor) and torch.any(got > 1200.0)


def test_moment_histograms_agree_with_the_plain_kernel(camp, problem):
    e0 = _e0((6, N_DRAWS), 2)
    ref = mc.Reference(camp, None, "cpu")
    got = ref.moments(e0).double()
    want = cuda_transport.transport_moments_plain(
        e0, problem.forward.rk4, problem.forward.moment_bins).double()
    assert got.shape == want.shape == (6, 10, 4, 50)
    assert torch.equal(got[:, :, 0], want[:, :, 0])
    assert got[:, :, 0].sum() > 0.5 * 6 * 10 * N_DRAWS
    ulp = torch.abs(want).float().nextafter(torch.tensor(np.inf)).double() \
        - torch.abs(want)
    shifts = fixed_point.channel_shifts(N_DRAWS,
                                        cuda_transport.MOMENT_BOUNDS)
    dropped = torch.tensor([N_DRAWS * 2.0 ** -(s + 1) for s in shifts],
                           dtype=torch.float64)[:, None]
    assert torch.all(torch.abs(got - want) <= ulp + dropped)


# --- (c) ---------------------------------------------------------------

def _observed(camp):
    ref = mc.Reference(camp, None, "cpu")
    spectra = ref.spectra(torch.as_tensor(TRUTH)[None],
                          torch.Generator().manual_seed(3))[0].double()
    rng = np.random.default_rng(4)
    return [rng.poisson(np.maximum(spectra[r, :w.n_bins].numpy(), 0.0))
            .astype(np.float64) for r, w in enumerate(camp.windows)]


def _proposals(n=16):
    rng = np.random.default_rng(5)
    return torch.as_tensor(TRUTH + 0.3 * SPREAD * rng.standard_normal(
        (n, TRUTH.size)).astype(np.float32))


def test_grids_and_e0_means_are_the_programs_bit_for_bit(camp, problem):
    params = _proposals()[:, :4]
    gen_p, gen_r = (torch.Generator().manual_seed(11) for _ in range(2))
    want_grid, want_mean = problem.forward.grid_and_mean(params, gen_p)
    ref = mc.Reference(camp, None, "cpu")
    got_grid, got_mean = ref.grid_and_mean(params, gen_r)
    assert torch.equal(got_grid, want_grid)
    assert torch.equal(got_mean, want_mean)
    # the same host words drawn: the generators stand together after
    assert seed_words(gen_p) == seed_words(gen_r)


def test_the_reference_log_prob_is_the_programs(camp, problem, monkeypatch):
    obs = _observed(camp)
    ref = mc.Reference(camp, obs, "cpu")
    logp = problem.make_log_prob_fn(obs)
    thetas = _proposals()
    thetas[3, 0] = 1800.0                      # outside the prior box
    want = ref.log_prob(thetas, torch.Generator().manual_seed(11))
    assert torch.isneginf(want[3]) and torch.all(torch.isfinite(
        want[torch.arange(16) != 3]))
    got = logp(thetas, torch.Generator().manual_seed(11))
    gap = (got - want)[torch.isfinite(want)].abs()
    assert torch.isneginf(got[3]) and float(gap.max()) < 0.1

    def exact_sums(base, draws, zt, zw, win):
        return cuda_tof.tof_hist_segments_plain(base, draws, zt, zw, win,
                                                torch.float64).float()

    monkeypatch.setattr(tforward, "tof_hist_segments", exact_sums)
    got = logp(thetas, torch.Generator().manual_seed(11))
    assert torch.equal(got, want)


# --- (d) ---------------------------------------------------------------

def test_the_mc_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, '.'); "
            "from portbench.reference import mc, ode; "
            "print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    names = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "mcmctoffitting_tpu",
                        "mcmctoffitting_tpu_torch"}
