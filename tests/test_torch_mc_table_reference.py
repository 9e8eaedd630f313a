"""The benchmark's plain reference of the mc estimator on the stopping
table through the e0grid operator (``portbench/reference/mc_table.py``,
the simultFit CLI's default) against the port, on the CPU at small sizes
(at most 8k draws and 16 walkers).

(a) The reference's operator A at F = 256 is the program's e0grid
    operator: the same float32 matrix and the same float64 constants of
    its fine cells, both the same host arithmetic of the same stopping
    table.
(b) Its fine-cell moments agree with ``ops/e0grid.py::fine_cell_moments``:
    the counts equal, each other channel within one float32 ulp of the
    sum plus what the program's int64 fixed point drops (half a step of
    2^-s a sample, s from ``ops/fixed_point.py``), since the reference
    sums the same float32 channel values in float64 and rounds once.
(c) Its log-prob is the program's at the same proposals and seed words:
    the grids and e0 means bit for bit (the same draws, the same moments,
    the same dense product on the CPU), and the log-prob bit for bit with
    the program's plain K2 summing in float64 as the card's K2 does
    (exact fixed point, rounded once); with the plain K2 summing in
    float32, as it does on the CPU, within ``TOLERANCE`` nats: each bin of
    the TOF histogram can move by a few float32 ulps, ~1e-6 of it, and
    the log-likelihood moves by ~1e-6 of the 5e4 counts of a run.
(d) ``reference/mc_table.py`` loads nothing of the program and no JAX.
(e) Both of the check's controls (``portbench/control_mc_table.py``)
    move the log-prob past ``TOLERANCE`` at this size: the products in
    TF32 (emulated here, where the flag reaches no CPU product, by
    rounding both operands to TF32's 10-bit mantissa, as the card's
    tensor cores do) and the fine-cell moments rounded to bfloat16.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import cuda_tof, e0grid, fixed_point
from portbench import control_mc_table
from portbench.plan import ROOT
from portbench.reference import mc_table
from portbench.reference.poisson import seed_words

torch.set_num_threads(1)
N_DRAWS = 8000
CONFIG = {"model": "simult", "n_runs": 2, "n_samples": N_DRAWS}
TRAFFIC = {"transport": "table", "xs_mode": "e0grid", "fine_grid": None}
TRUTH = np.array([1878.4, 850.0, 170.0, 0.5, 5e4, 5e4], np.float32)
SPREAD = np.array([10.0, 50.0, 20.0, 0.1, 7500.0, 7500.0], np.float32)
TOLERANCE = 0.1


@pytest.fixture(scope="module")
def camp():
    return mc_table.campaign(CONFIG, TRAFFIC)


@pytest.fixture(scope="module")
def problem():
    spec = tsimult.default_spec(N_DRAWS)
    return tsimult.SimultFitProblem(spec, 2, "poisson", device="cpu")


# --- (a) ---------------------------------------------------------------

def test_the_operator_is_the_programs_at_f_256(camp, problem):
    op, grid = camp.operator, problem.forward.e0grid
    assert problem.spec.e0_grid_fine == op.n_fine == grid.n_fine == 256
    assert (op.e0_lo, op.e0_hi, op.t_ref, op.t_scale) == (
        grid.e0_lo, grid.e0_hi, grid.t_ref, grid.t_scale)
    assert (op.n_x, op.n_ed) == (grid.n_x, grid.n_ed) == (10, 50)
    assert op.a_matrix.dtype == np.float32
    np.testing.assert_array_equal(op.a_matrix, grid.a_matrix.numpy())
    assert mc_table.campaign(CONFIG, dict(TRAFFIC, fine_grid=128)) \
        .operator.n_fine == 128


def test_the_campaign_refuses_another_path():
    with pytest.raises(ValueError, match="transport 'table'"):
        mc_table.campaign(CONFIG, {"transport": "rk4", "xs_mode": "taylor"})
    with pytest.raises(ValueError, match="simultFit"):
        mc_table.campaign(dict(CONFIG, model="onebd"), TRAFFIC)


# --- (b) ---------------------------------------------------------------

def _e0(op, shape, seed):
    """Initial energies over the fine cells' range and a little past it
    at both ends, its two edges exactly, and NaN."""
    rng = np.random.default_rng(seed)
    span = op.e0_hi - op.e0_lo
    e0 = rng.uniform(op.e0_lo - 0.05 * span, op.e0_hi + 0.05 * span, shape)
    e0 = torch.as_tensor(e0.astype(np.float32))
    e0[0, ::61] = float("nan")
    e0[1, :3] = torch.tensor([op.e0_lo, op.e0_hi, op.e0_hi],
                             dtype=torch.float32)
    return e0


def test_fine_cell_moments_agree_with_the_programs(camp, problem):
    e0 = _e0(camp.operator, (6, N_DRAWS), 1)
    ref = mc_table.Reference(camp, None, "cpu")
    got = ref.fine_moments(e0).double()
    want = e0grid.fine_cell_moments(problem.forward.e0grid, e0).double()
    assert got.shape == want.shape == (6, 4, 256)
    assert torch.equal(got[:, 0], want[:, 0])
    inside = (e0 >= camp.operator.e0_lo) & (e0 <= camp.operator.e0_hi)
    assert torch.equal(got[:, 0].sum(-1), inside.sum(-1).double())
    assert 0 < int(inside.sum()) < e0.numel()
    ulp = torch.abs(want).float().nextafter(torch.tensor(np.inf)).double() \
        - torch.abs(want)
    shifts = fixed_point.channel_shifts(N_DRAWS, e0grid.MOMENT_BOUNDS)
    dropped = torch.tensor([N_DRAWS * 2.0 ** -(s + 1) for s in shifts],
                           dtype=torch.float64)[:, None]
    assert torch.all(torch.abs(got - want) <= ulp + dropped)


# --- (c) ---------------------------------------------------------------

def _observed(camp):
    ref = mc_table.Reference(camp, None, "cpu")
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
    ref = mc_table.Reference(camp, None, "cpu")
    got_grid, got_mean = ref.grid_and_mean(params, gen_r)
    assert got_grid.shape == (16, 2, 10, 50)
    assert torch.equal(got_grid, want_grid)
    assert torch.equal(got_mean, want_mean)
    # the same host words drawn: the generators stand together after
    assert seed_words(gen_p) == seed_words(gen_r)


def _exact_sums(base, draws, zt, zw, win):
    return cuda_tof.tof_hist_segments_plain(base, draws, zt, zw, win,
                                            torch.float64).float()


def test_the_reference_log_prob_is_the_programs(camp, problem, monkeypatch):
    obs = _observed(camp)
    ref = mc_table.Reference(camp, obs, "cpu")
    logp = problem.make_log_prob_fn(obs)
    thetas = _proposals()
    thetas[3, 0] = 1800.0                      # outside the prior box
    want = ref.log_prob(thetas, torch.Generator().manual_seed(11))
    assert torch.isneginf(want[3]) and torch.all(torch.isfinite(
        want[torch.arange(16) != 3]))
    got = logp(thetas, torch.Generator().manual_seed(11))
    gap = (got - want)[torch.isfinite(want)].abs()
    assert torch.isneginf(got[3]) and float(gap.max()) < TOLERANCE

    monkeypatch.setattr(tforward, "tof_hist_segments", _exact_sums)
    got = logp(thetas, torch.Generator().manual_seed(11))
    assert torch.equal(got, want)


# --- (d) ---------------------------------------------------------------

def test_the_mc_table_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, '.'); "
            "from portbench.reference import mc_table; "
            "print(json.dumps(sorted({n.split('.')[0] "
            "for n in sys.modules})))")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    names = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "torch" in names
    assert not names & {"jax", "jaxlib", "flax", "mcmctoffitting_tpu",
                        "mcmctoffitting_tpu_torch"}


# --- (e) ---------------------------------------------------------------

def _tf32(x):
    """float32 -> the nearest value with TF32's 10-bit mantissa (ties
    away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _emulated_tf32(camp, observed, device):
    ref = control_mc_table.tf32_reference(camp, observed, device)
    assert ref.tf32
    plain = ref.matmul
    ref.matmul = lambda rows, mat: plain(_tf32(rows), _tf32(mat))
    return ref


@pytest.mark.parametrize("control", ["tf32", "moments_bf16"])
def test_each_control_moves_the_log_prob_past_the_tolerance(camp, control):
    assert set(control_mc_table.CONTROLS) == {"tf32", "moments_bf16"}
    make = (_emulated_tf32 if control == "tf32"
            else control_mc_table.CONTROLS[control])
    obs = _observed(camp)
    thetas = _proposals()
    want = mc_table.Reference(camp, obs, "cpu").log_prob(
        thetas, torch.Generator().manual_seed(11))
    got = make(camp, obs, "cpu").log_prob(
        thetas, torch.Generator().manual_seed(11))
    assert torch.all(torch.isfinite(want)) and torch.all(torch.isfinite(got))
    gaps = (got - want).abs()
    assert float(torch.quantile(gaps, 0.9)) > TOLERANCE
