"""The counts estimator's rate stage as one kernel (``ops/cuda_rates.py``,
``csrc/counts_rates.cu``) against its plain version, ``counts_lambdas``.

On the CPU: the wrapper's dispatch (the CPU takes the plain version as it
is, a float64 grid and parameters with a gradient included; a device that
is neither the CPU nor CUDA is refused), its argument checks and the
layout of the kernel's output buffer.  Marked ``cuda`` and skipped without
a GPU: the kernel against the plain version on the same card, bit for bit,
at the presets' shapes, with edge cases, and whole log-probs; a float64
grid and parameters with a gradient refused there.
On a machine with one (this file imports no jax), run:

    python -m pytest --noconftest -m cuda tests/test_torch_counts_rates.py
"""
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.constants import onebd_consts
from mcmctoffitting_tpu_torch.models import forward as forward_mod
from mcmctoffitting_tpu_torch.models import onebd, simult
from mcmctoffitting_tpu_torch.ops import cuda_rates
from mcmctoffitting_tpu_torch.ops.cuda_rates import counts_rates
from mcmctoffitting_tpu_torch.ops.e0grid import (CountsRates, E0Grid,
                                                 counts_lambdas)
from mcmctoffitting_tpu_torch.utils import data_io

N_SAMPLES = 8000
CASES = [(truncated, closure) for truncated in (True, False)
         for closure in ("exact", "cell")]
# the walker balls of the two presets: (beamE, eLoss, scale, s)
BALLS = {"simult": (np.array([1878.4, 850.0, 170.0, 0.5]),
                    np.array([10.0, 50.0, 20.0, 0.1])),
         "onebd": (None, np.array([0.0, 50.0, 10.0, 0.05]))}
# rows the kernel must take as the plain version does: scale <= 0, s <= 0,
# beamE < eLoss, s wide enough to saturate ndtr at both tails and narrow
# enough to saturate it within a few cells, e0 above and below the grid,
# NaN in each parameter, an infinite beam energy
EDGE_ROWS = [[1878.4, 850.0, 0.0, 0.5], [1878.4, 850.0, -5.0, 0.5],
             [1878.4, 850.0, 170.0, 0.0], [1878.4, 850.0, 170.0, -0.1],
             [800.0, 850.0, 170.0, 0.5], [1878.4, 850.0, 170.0, 8.0],
             [1878.4, 850.0, 170.0, 40.0], [1878.4, 850.0, 170.0, 1e-3],
             [9000.0, 850.0, 170.0, 0.5], [900.0, 850.0, 10.0, 0.5],
             [np.nan, 850.0, 170.0, 0.5], [1878.4, np.nan, 170.0, 0.5],
             [1878.4, 850.0, np.nan, 0.5], [1878.4, 850.0, 170.0, np.nan],
             [np.inf, 850.0, 170.0, 0.5]]


def _small_grid(dtype=torch.float32):
    spec = simult.default_spec(N_SAMPLES, sampling="counts", fine_grid=128)
    grid = E0Grid(spec.e0_grid_table, device="cpu")
    return grid if dtype == torch.float32 else grid.float64()


def _params(n, dtype=torch.float32, seed=0):
    centre, width = BALLS["simult"]
    rng = np.random.default_rng(seed)
    return torch.as_tensor(centre + width * rng.standard_normal((n, 4)),
                           dtype=dtype)


def _plain(grid, params, n_samples, truncated, closure):
    return counts_lambdas(grid, params[:, 0], params[:, 1], params[:, 2],
                          params[:, 3], n_samples, truncated, closure)


def _bits(t):
    """int32 bits with every NaN made the same NaN (torch.equal never
    finds NaN equal; the bits also tell -0.0 from 0.0)."""
    return torch.where(torch.isnan(t), torch.full_like(t, float("nan")),
                       t).contiguous().view(torch.int32)


def assert_same_bits(got: CountsRates, want: CountsRates):
    for name, g, w in zip(CountsRates._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        gb, wb = _bits(g), _bits(w)
        if not torch.equal(gb, wb):
            diff = (gb.long() - wb.long()).abs()
            raise AssertionError(
                f"{name}: {int((diff > 0).sum())} of {diff.numel()} values "
                f"differ, at most {int(diff.max())} ulps")


# --- on the CPU: dispatch, argument checks, layout --------------------------

@pytest.mark.parametrize("truncated,closure", CASES)
@pytest.mark.parametrize("kind", ["cpu", "float64", "grad"])
def test_plain_inputs_take_counts_lambdas_unchanged(kind, truncated,
                                                    closure):
    """On the CPU, the float64 copy of a grid and parameters with a
    gradient too (which the card refuses): ``counts_lambdas`` as it is,
    and the kernel never launches."""
    dtype = torch.float64 if kind == "float64" else torch.float32
    grid = _small_grid(dtype)
    params = _params(6, dtype)
    if kind == "grad":
        params.requires_grad_(True)
    launches = counts_rates.launches
    got = counts_rates(grid, params, N_SAMPLES, truncated, closure)
    want = _plain(grid, params, N_SAMPLES, truncated, closure)
    assert counts_rates.launches == launches
    assert_same_bits(tuple(t.detach() for t in got),
                     tuple(t.detach() for t in want))
    if kind == "grad":
        assert got.lam.requires_grad


def test_a_device_neither_cpu_nor_cuda_is_refused():
    """No plain fallback off the CPU: the meta device has no kernel."""
    spec = simult.default_spec(N_SAMPLES, sampling="counts", fine_grid=128)
    grid = E0Grid(spec.e0_grid_table, device="meta")
    launches = counts_rates.launches
    with pytest.raises(ValueError, match="no kernel"):
        counts_rates(grid, torch.zeros((3, 4), device="meta"), N_SAMPLES,
                     True, "exact")
    assert counts_rates.launches == launches


@pytest.mark.parametrize("n_cols", [4, 8])
def test_reads_the_first_four_columns_of_any_row_stride(n_cols):
    """(W, P) parameters, P >= 4, a view of wider walkers included: the
    first four columns, whatever the rest hold."""
    grid = _small_grid()
    wide = torch.cat([_params(5), torch.full((5, 4), 7.0)], dim=1)
    params = wide[:, :n_cols]
    got = counts_rates(grid, params, N_SAMPLES, True, "exact")
    want = _plain(grid, wide[:, :4].contiguous(), N_SAMPLES, True, "exact")
    assert_same_bits(got, want)


@pytest.mark.parametrize("params,error", [
    (torch.zeros(4), ValueError),
    (torch.zeros((3, 3)), ValueError),
    (torch.zeros((2, 3, 4)), ValueError),
    (torch.zeros((3, 4), dtype=torch.float64), TypeError),
    (torch.zeros((3, 4), dtype=torch.float16), TypeError),
    (torch.zeros((3, 4), device="meta"), ValueError),
])
def test_argument_checks(params, error):
    with pytest.raises(error):
        counts_rates(_small_grid(), params, N_SAMPLES, True, "exact")


def test_unknown_closure_is_refused():
    with pytest.raises(ValueError, match="closure"):
        counts_rates(_small_grid(), _params(2), N_SAMPLES, True, "linear")


@pytest.mark.parametrize("n_walkers,n_fine", [(1, 512), (128, 1024),
                                              (3, 7), (0, 16)])
def test_output_buffer_layout(n_walkers, n_fine):
    """The kernel's buffer as views: lam (W, F+2) first and contiguous (K1
    reads it so), then m (W, 4, F), then the three (W,) means, tiling the
    buffer in that order."""
    w, f = n_walkers, n_fine
    buffer = torch.arange(w * (5 * f + 5), dtype=torch.float32)
    rates = cuda_rates.rates_views(buffer, w, f)
    assert rates.lam.shape == (w, f + 2) and rates.lam.is_contiguous()
    assert rates.m.shape == (w, 4, f) and rates.m.is_contiguous()
    for t in rates[2:]:
        assert t.shape == (w,)
    assert all(t.dtype == torch.float32 for t in rates)
    flat = torch.cat([t.reshape(-1) for t in rates])
    assert torch.equal(flat, buffer)


def test_plain_rates_have_the_kernels_shapes():
    """The plain version's fields have the shapes and dtypes of the
    kernel's views, and lam is contiguous there too."""
    rates = counts_rates(_small_grid(), _params(3), N_SAMPLES, True, "exact")
    assert rates.lam.shape == (3, 130) and rates.lam.is_contiguous()
    assert rates.m.shape == (3, 4, 128)
    assert all(t.shape == (3,) for t in rates[2:])
    assert all(t.dtype == torch.float32 for t in rates)


def test_forward_takes_its_rates_from_the_wrapper(monkeypatch):
    """TofForward.counts_rates: one call of the wrapper on the forward's
    grid and spec, with the walkers' shared columns as they are."""
    spec = simult.default_spec(N_SAMPLES, sampling="counts", fine_grid=128)
    problem = simult.SimultFitProblem(spec, n_runs=4, device="cpu")
    thetas = torch.cat([_params(4), torch.full((4, 4), 5e4)], dim=1)
    calls = []

    def recording(grid, params, *args):
        calls.append((grid, params, args))
        return counts_rates(grid, params, *args)

    monkeypatch.setattr(forward_mod, "counts_rates", recording)
    params = problem.shared_params(thetas)
    got = problem.forward.counts_rates(params)
    assert len(calls) == 1 and calls[0][0] is problem.forward.e0grid
    assert calls[0][1] is params and calls[0][2] == (
        spec.n_samples, spec.truncated, spec.moment_closure)
    want = _plain(problem.forward.e0grid, thetas[:, :4].contiguous(),
                  spec.n_samples, spec.truncated, spec.moment_closure)
    assert_same_bits(got, want)


# --- on the card ------------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def _preset_spec(model):
    if model == "simult":
        return simult.default_spec(200_000, sampling="counts")
    return onebd.default_spec(200_000, hardcore=True, sampling="counts")


def _ball(model, n, seed):
    centre, width = BALLS[model]
    if centre is None:                    # oneBD: the fixed beam energy
        centre = np.concatenate([[onebd_consts.beam_reference_energy],
                                 data_io.ONEBD_TRUTH[:3]])
    rng = np.random.default_rng(seed)
    return (centre + width * rng.standard_normal((n, 4))).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("truncated,closure", CASES)
@pytest.mark.parametrize("n_walkers", [128, 1])
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_kernel_equals_counts_lambdas_bit_for_bit(dev, model, n_walkers,
                                                  truncated, closure):
    """F = 512 (simultFit) and 1,024 (oneBD hardcore), θ from the preset's
    walker ball with the edge rows, every field the plain version's bits
    on the same card; one launch a call."""
    grid = E0Grid(_preset_spec(model).e0_grid_table, device=dev)
    rows = np.concatenate([_ball(model, n_walkers, seed=n_walkers),
                           np.asarray(EDGE_ROWS, np.float32)])
    params = torch.as_tensor(rows, device=dev)
    for p in (params[:n_walkers], params):
        launches = counts_rates.launches
        got = counts_rates(grid, p, 200_000, truncated, closure)
        assert counts_rates.launches == launches + 1
        want = _plain(grid, p, 200_000, truncated, closure)
        torch.cuda.synchronize()
        assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("truncated,closure", CASES)
def test_kernel_beyond_48_kb_of_shared_memory(dev, truncated, closure):
    """F = 4,096: the edges' ndtr take 64 KB of shared memory in the exact
    closure, which the launch has to ask for; the bits as the plain
    version's."""
    spec = simult.default_spec(200_000, sampling="counts", fine_grid=4096)
    grid = E0Grid(spec.e0_grid_table, device=dev)
    params = torch.as_tensor(_ball("simult", 8, seed=8), device=dev)
    got = counts_rates(grid, params, 200_000, truncated, closure)
    want = _plain(grid, params, 200_000, truncated, closure)
    assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,error", [("float64", TypeError),
                                        ("grad", ValueError)])
def test_kernel_refuses_float64_and_gradients(dev, kind, error):
    """On the card, a float64 grid and parameters that need a gradient are
    refused, not run through the plain version's operations; nothing
    launches."""
    grid = E0Grid(_preset_spec("simult").e0_grid_table, device=dev)
    params = torch.as_tensor(_ball("simult", 4, seed=4), device=dev)
    if kind == "float64":
        grid, params = grid.float64(), params.double()
    else:
        params.requires_grad_(True)
    launches = counts_rates.launches
    with pytest.raises(error):
        counts_rates(grid, params, 200_000, True, "exact")
    assert counts_rates.launches == launches


@pytest.mark.cuda
def test_kernel_reads_strided_params_and_empty_batches(dev):
    """Parameters as a column view of wider walkers (simultFit's (W, 8)),
    and W = 0."""
    grid = E0Grid(_preset_spec("simult").e0_grid_table, device=dev)
    wide = torch.as_tensor(np.concatenate(
        [_ball("simult", 64, seed=5), np.full((64, 4), 5e4, np.float32)],
        axis=1), device=dev)
    got = counts_rates(grid, wide[:, :4], 200_000, True, "exact")
    want = _plain(grid, wide[:, :4], 200_000, True, "exact")
    assert_same_bits(got, want)
    empty = counts_rates(grid, wide[:0], 200_000, True, "exact")
    assert empty.lam.shape == (0, 514) and empty.m.shape == (0, 4, 512)


def _problem(model, dev):
    spec = _preset_spec(model)
    if model == "simult":
        problem = simult.SimultFitProblem(spec, n_runs=4,
                                          likelihood="poisson", device=dev)
        truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5e4)])
    else:
        problem = onebd.OneBDProblem(spec, n_runs=3, likelihood="poisson",
                                     device=dev)
        truth = data_io.ONEBD_TRUTH
    observed = data_io.synthesize_observed(9, problem, truth)
    thetas = problem.initial_walkers_from_observed(
        torch.Generator(dev).manual_seed(1), 128, observed)
    return problem, problem.observed_runs(observed), thetas


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_log_prob_equals_the_plain_rates_bit_for_bit(dev, model,
                                                     monkeypatch):
    """One half-step's log-prob of each preset at a fixed seed: the kernel
    launched once, and the log-probs those of the same evaluation with the
    rates from counts_lambdas (each a problem's first evaluation at its
    shape, which runs eagerly, not from a captured graph)."""
    problem, obs, thetas = _problem(model, dev)
    launches = counts_rates.launches
    got = problem.log_prob(thetas, torch.Generator().manual_seed(7), obs)
    assert counts_rates.launches == launches + 1
    monkeypatch.setattr(forward_mod, "counts_rates", _plain)
    problem, obs, thetas = _problem(model, dev)
    want = problem.log_prob(thetas, torch.Generator().manual_seed(7), obs)
    assert counts_rates.launches == launches + 1
    assert torch.isfinite(want).float().mean().item() > 0.9
    assert torch.equal(_bits(got), _bits(want))
