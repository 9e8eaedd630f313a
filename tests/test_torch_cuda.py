"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no GPU.  On a machine with
one (and without jax, which tests/conftest.py imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the forward model's full shapes.
"""
import ctypes

import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.config import SIMULTFIT_X_BINNING
from mcmctoffitting_tpu_torch.constants import (TofWindow, tof_windows,
                                                tof_windows_onebd)
from mcmctoffitting_tpu_torch.ops import cuda_hist, cuda_transport
from mcmctoffitting_tpu_torch.ops.cuda_build import load_library
from mcmctoffitting_tpu_torch.ops import poisson as plain_poisson
from mcmctoffitting_tpu_torch.ops import stopping
from mcmctoffitting_tpu_torch.ops.cuda_poisson import philox_cuda, poisson
from mcmctoffitting_tpu_torch.ops.cuda_tof import (tof_hist_segments,
                                                   tof_hist_segments_plain)
from mcmctoffitting_tpu_torch.ops.histogram import window_constants

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda", 0)


def test_philox_known_answers(dev):
    m = 0xFFFFFFFF
    words = np.array([[0, 0, 0, 0, 0, 0], [m] * 6,
                      [0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344,
                       0xa4093822, 0x299f31d0]], np.uint32)
    got = philox_cuda(torch.as_tensor(words.view(np.int32), device=dev))
    want = np.array([[0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8],
                     [0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd],
                     [0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1]],
                    np.uint32)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32), want)


def test_poisson_kernel_matches_plain(dev):
    lam = torch.as_tensor(np.geomspace(1e-3, 3e5, 1 << 16).astype(
        np.float32), device=dev)
    got = poisson(lam, (11, 12))
    want = plain_poisson.poisson_ptrs(lam, (11, 12))
    torch.cuda.synchronize()
    assert (got == want).float().mean().item() >= 0.999


def test_tof_kernel_matches_plain(dev):
    windows = tuple(tof_windows[n] for n in ("mid", "close", "close", "far"))
    rng = np.random.default_rng(0)
    shape = (8, len(windows), 10, 50)
    base = torch.as_tensor(rng.uniform(120, 270, shape).astype(np.float32),
                           device=dev)
    draws = torch.as_tensor(rng.uniform(0, 50, shape).astype(np.float32),
                            device=dev)
    zt = torch.as_tensor(rng.uniform(-6, 6, (50, 10)).astype(np.float32),
                         device=dev)
    zw = torch.as_tensor(rng.uniform(0, 1, (50, 10)).astype(np.float32),
                         device=dev)
    win = window_constants(windows, device=dev)
    got = tof_hist_segments(base, draws, zt, zw, win)
    want = tof_hist_segments_plain(base, draws, zt, zw, win)
    total = (draws[..., None] * zw).sum(dim=(-3, -2, -1)).max().item()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * total)


def _k2_inputs(rng, dev, shape, windows, k=10):
    """Random lattice (base, draws) of ``shape`` = (..., R, M, Be), tables
    (Be, k) and the window constants, on ``dev``."""
    def t(a):
        return torch.as_tensor(a.astype(np.float32), device=dev)

    be = shape[-1]
    return (t(rng.uniform(120, 270, shape)), t(rng.uniform(0, 50, shape)),
            t(rng.uniform(-6, 6, (be, k))), t(rng.uniform(0, 1, (be, k))),
            window_constants(windows, device=dev))


def _k2_check(base, draws, zt, zw, win, tol=1e-6):
    """Kernel vs plain within ``tol`` of the row's total weight: both sum
    float32 weights in their own order (1e-6 at the ~70 weights per bin of
    the lattice; more where thousands meet in one bin)."""
    got = tof_hist_segments(base, draws, zt, zw, win)
    want = tof_hist_segments_plain(base, draws, zt, zw, win)
    total = (draws[..., None] * zw).sum(dim=(-3, -2, -1))[..., None]
    assert got.shape == want.shape
    assert torch.all((got - want).abs() <= tol * total)
    return got


SIMULT_WINDOWS = tuple(tof_windows[n] for n in ("mid", "close", "close",
                                                "far"))


@pytest.mark.parametrize("case", ["one_row", "rows_4096", "one_bin",
                                  "bins_300", "bins_over_the_fast_cap",
                                  "all_outside", "zero_draws", "nan_base",
                                  "few_cells"])
def test_tof_kernel_edge_cases(dev, case):
    rng = np.random.default_rng(5)
    windows, shape, k = SIMULT_WINDOWS, (3, 4, 10, 50), 10
    if case == "one_row":
        windows, shape = (tof_windows["mid"],), (1, 10, 50)
    elif case == "rows_4096":
        shape = (1024, 4, 10, 50)
    elif case == "one_bin":
        windows = (TofWindow(100.0, 300.0, 1),) * 2
        shape = (3, 2, 10, 50)
    elif case == "bins_300":
        windows = (TofWindow(130.0, 260.0, 300), TofWindow(175.0, 225.0, 50))
        shape = (3, 2, 10, 50)
    elif case == "bins_over_the_fast_cap":
        windows = (TofWindow(130.0, 260.0, 40_000),
                   TofWindow(175.0, 225.0, 50))
        shape = (3, 2, 10, 50)
    elif case == "few_cells":          # fewer cells than threads per row
        shape, k = (5, 4, 3, 7), 3
    base, draws, zt, zw, win = _k2_inputs(rng, dev, shape, windows, k)
    # the C library picks the kernel: the fast one while its histogram and
    # tables fit a block's shared memory, else the general one
    plan = load_library().lib.mcmctof_tof_hist_plan(
        shape[-2] * shape[-1], k, win.n_pad)
    assert (plan == 0) == (case == "bins_over_the_fast_cap")
    if case == "all_outside":
        base += 1000.0
    elif case == "zero_draws":
        draws.zero_()
    elif case == "nan_base":
        base[..., ::3] = float("nan")
    got = _k2_check(base, draws, zt, zw, win,
                    tol=1e-5 if case == "one_bin" else 1e-6)
    if plan:
        # the fast kernel sums in fixed point: the same on every call, and
        # every bin the float32 nearest to its exact sum (half an ulp), up
        # to the 2^-39 of the row's total dropped of each sample
        assert torch.equal(got, tof_hist_segments(base, draws, zt, zw, win))
        exact = tof_hist_segments_plain(base, draws, zt, zw, win,
                                        torch.float64)
        total = (draws[..., None] * zw).sum(dim=(-3, -2, -1))[..., None]
        n_samples = shape[-2] * shape[-1] * k
        assert torch.all((got.double() - exact).abs()
                         <= 6e-8 * exact.abs()
                         + n_samples * 2.0 ** -39 * total)
    if case in ("all_outside", "zero_draws"):
        assert torch.count_nonzero(got) == 0
    if case == "one_bin":
        total = (draws[..., None] * zw).sum(dim=(-3, -2, -1))
        torch.testing.assert_close(got[..., 0], total, rtol=1e-5, atol=0)


def test_tof_kernel_bins_above_the_opt_in_threshold(dev):
    """More bins than 48 KB of shared memory hold: the fast kernel opts in
    to more, and still sums exactly."""
    rng = np.random.default_rng(6)
    windows = (TofWindow(130.0, 260.0, 8000), TofWindow(175.0, 225.0, 50))
    base, draws, zt, zw, win = _k2_inputs(rng, dev, (3, 2, 10, 50), windows)
    plan = load_library().lib.mcmctof_tof_hist_plan(500, 10, 8000)
    assert plan > 48 * 1024
    got = _k2_check(base, draws, zt, zw, win)
    assert torch.equal(got, tof_hist_segments(base, draws, zt, zw, win))


K1_EDGE_RATES = [0.0, float("nan"), -3.0, 9.999, 10.0, 1.0e7]


@pytest.mark.parametrize("n", [1, 255, 256, 257, 100_003])
def test_poisson_kernel_edge_rates_and_lengths(dev, n):
    """The branch boundary, rates that draw 0, a huge rate, and lengths
    that are not a multiple of the block: every draw equals the plain
    version's (same stream, same formulas)."""
    lam = torch.tensor(K1_EDGE_RATES, device=dev).repeat(-(-n // 6))[:n]
    lam = lam.contiguous()
    got = poisson(lam, (21, 22))
    want = plain_poisson.poisson_ptrs(lam, (21, 22))
    assert (got == want).double().mean().item() >= 0.999
    dead = ~(lam > 0)
    assert torch.count_nonzero(got[dead]) == 0
    assert torch.all(got == torch.floor(got)) and torch.all(got >= 0)


def test_poisson_kernel_empty_and_forms(dev):
    assert poisson(torch.empty((0, 7), device=dev), (1, 2)).shape == (0, 7)
    assert poisson(torch.empty((0, 7), device=dev), (1, 2),
                   n_runs=3).shape == (0, 3, 7)
    lam = torch.as_tensor(np.geomspace(1e-3, 3e4, 16 * 130).astype(
        np.float32), device=dev).reshape(16, 130)
    want = poisson(lam[:, None].expand(-1, 4, -1).contiguous(), (3, 4))
    assert torch.equal(poisson(lam, (3, 4), n_runs=4), want)
    words = torch.tensor([3, 4], dtype=torch.int64, device=dev)
    assert torch.equal(poisson(lam, words, n_runs=4), want)
    with pytest.raises(ValueError, match="seed on"):
        poisson(lam, words.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        poisson(lam.t(), (3, 4))


@pytest.mark.parametrize("n_runs", [None, 4])
def test_poisson_kernel_offset_draws_the_rows_of_the_whole_launch(dev,
                                                                  n_runs):
    """K1 with a counter offset: rows [r0, r0 + n) drawn alone equal those
    rows of the whole launch bit for bit (seed by value and in device
    memory); offset 0 is the launch without one; the kernel equals its
    plain version at an offset."""
    lam = torch.as_tensor(np.geomspace(1e-3, 3e4, 64 * 130).astype(
        np.float32), device=dev).reshape(64, 130)
    per_row = (n_runs or 1) * 130
    whole = poisson(lam, (5, 6), n_runs)
    assert torch.equal(poisson(lam, (5, 6), n_runs, offset=0), whole)
    words = torch.tensor([5, 6], dtype=torch.int64, device=dev)
    for r0, n in ((32, 32), (7, 9), (63, 1)):
        part = lam[r0:r0 + n].contiguous()
        for seed in ((5, 6), words):
            assert torch.equal(
                poisson(part, seed, n_runs, offset=r0 * per_row),
                whole[r0:r0 + n])
        plain = plain_poisson.poisson_ptrs(
            part if n_runs is None else
            part[:, None].expand(-1, n_runs, -1), (5, 6),
            offset=r0 * per_row)
        assert (plain == whole[r0:r0 + n]).double().mean().item() >= 0.999


def test_poisson_kernel_blocks_draw_a_shard_of_every_rung(dev):
    """K1 with blocks: walkers [r m, (r + 1) m) of each of T rungs of n,
    one launch, equal those rows of the whole (T n) launch."""
    t, n, m, c = 5, 16, 4, 130
    lam = torch.as_tensor(np.geomspace(1e-3, 3e4, t * n * c).astype(
        np.float32), device=dev).reshape(t * n, c)
    whole = poisson(lam, (3, 8), n_runs=2).reshape(t, n, 2, c)
    e = 2 * c
    for r in range(n // m):
        rows = lam.reshape(t, n, c)[:, r * m:(r + 1) * m].reshape(t * m, c)
        got = poisson(rows.contiguous(), (3, 8), n_runs=2, offset=r * m * e,
                      blocks=(m * e, n * e))
        assert torch.equal(got.reshape(t, m, 2, c),
                           whole[:, r * m:(r + 1) * m])


def test_poisson_and_tof_kernels_replay_in_a_cuda_graph(dev):
    rng = np.random.default_rng(7)
    base, draws, zt, zw, win = _k2_inputs(rng, dev, (8, 4, 10, 50),
                                          SIMULT_WINDOWS)
    lam = torch.as_tensor(rng.uniform(0, 40, (8, 130)).astype(np.float32),
                          device=dev)
    want_hist = tof_hist_segments(base, draws, zt, zw, win)
    seed = torch.zeros(2, dtype=torch.int64, device=dev)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        counts = poisson(lam, seed, n_runs=4)
        hist = tof_hist_segments(base, draws, zt, zw, win)
    for words in ((1, 2), (3, 4)):
        seed.copy_(torch.tensor(words, dtype=torch.int64))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(counts, poisson(lam, words, n_runs=4))
        assert torch.equal(hist, want_hist)


def test_weighted_hist_kernel_matches_plain(dev):
    rng = np.random.default_rng(1)
    v = torch.as_tensor(rng.uniform(150, 1250, (64, 10, 5000)).astype(
        np.float32), device=dev)
    w = torch.as_tensor(rng.uniform(0, 40, v.shape).astype(np.float32),
                        device=dev)
    for n_valid in (None, 4321):
        got = cuda_hist.weighted_histogram(v, 200.0, 1200.0, 50, w, n_valid)
        want = cuda_hist.weighted_histogram_plain(v, 200.0, 1200.0, 50, w,
                                                  n_valid)
        total = w[..., :n_valid].sum(-1, keepdim=True)
        assert torch.all((got - want).abs() <= 1e-6 * total)
        assert torch.equal(got, cuda_hist.weighted_histogram(
            v, 200.0, 1200.0, 50, w, n_valid))
    edge = torch.tensor([[1200.0, 200.0, 1199.99, 1200.01, 199.9,
                          float("nan")]], device=dev)
    got = cuda_hist.weighted_histogram(edge, 200.0, 1200.0, 50,
                                       torch.ones_like(edge))
    want = torch.zeros((1, 50), device=dev)
    want[0, 0], want[0, 49] = 1.0, 2.0
    assert torch.equal(got, want)


def test_transport_moments_kernel_matches_plain(dev):
    rng = np.random.default_rng(2)
    e0 = rng.uniform(450.0, 1250.0, (16, 20000))
    e0[:, ::97] = rng.uniform(15.0, 200.0, (16, e0[:, ::97].shape[1]))
    e0 = torch.as_tensor(e0.astype(np.float32), device=dev)
    c = stopping.rk4_constants(stopping.d2_gas_stopping(),
                               SIMULTFIT_X_BINNING.centers, 1)
    bins = cuda_transport.MomentBins(200.0, 1200.0, 50)
    got, e_kern = cuda_transport.transport_moments(e0, c, bins,
                                                   energies_out=True)
    want = cuda_transport.transport_moments_plain(e0, c, bins)
    e_plain = stopping.rk4_transport(c, e0)
    same = (cuda_transport.moment_channels(e_kern, bins)[0]
            == cuda_transport.moment_channels(e_plain, bins)[0])
    assert same.double().mean().item() >= 0.9999
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * 20000)
    assert torch.equal(cuda_transport.transport_moments(e0, c, bins), got)


def _k4_inputs(case):
    """(R, N) initial energies for one K4 edge case, from a seed."""
    rng = np.random.default_rng(3)
    if case == "one_bin":          # every sample in one eD bin at each depth
        return rng.uniform(709.0, 711.0, (2, 30_000))
    if case == "ragged_n":         # N not a multiple of a block's round
        return rng.uniform(450.0, 1250.0, (33, 3 * 512 + 77))
    if case == "one_row":          # one row spread over many blocks
        return rng.uniform(450.0, 1250.0, (1, 200_000))
    if case == "many_rows":        # many short rows per block
        return rng.uniform(450.0, 1250.0, (300, 1000))
    e0 = rng.uniform(15.0, 260.0, (8, 5000))   # at and below the floor
    e0[:, ::7] = 20.0
    e0[:, 1::11] = np.nan
    e0[:, 2::13] = -5.0
    e0[:, 3::17] = np.inf
    return e0


@pytest.mark.parametrize("case", ["one_bin", "ragged_n", "one_row",
                                  "many_rows", "floor_and_nan"])
def test_transport_moments_kernel_edge_cases(dev, case):
    e0 = torch.as_tensor(_k4_inputs(case).astype(np.float32), device=dev)
    c = stopping.rk4_constants(stopping.d2_gas_stopping(),
                               SIMULTFIT_X_BINNING.centers, 1)
    bins = cuda_transport.MomentBins(200.0, 1200.0, 50)
    got, e_kern = cuda_transport.transport_moments(e0, c, bins,
                                                   energies_out=True)
    want = cuda_transport.transport_moments_plain(e0, c, bins)
    # the transported energies bit for bit (NaN where the plain has NaN)
    torch.testing.assert_close(e_kern, stopping.rk4_transport(c, e0),
                               rtol=0, atol=0, equal_nan=True)
    total = want[:, :, 0].sum(dim=(-2, -1))[:, None, None, None]
    assert torch.all((got - want).abs() <= 1e-5 * total.clamp_min(1.0))
    # per channel, against the float64 sums of the channels of the
    # kernel's energies: the counts exactly, d, d^2, d^3 within their
    # fixed-point steps
    counts_equal, ratio = cuda_transport.moment_check(got, e_kern, bins)
    assert counts_equal and ratio <= 1.0


@pytest.mark.parametrize("row_len, n_valid, n_bins", [
    (5000, 5000, 50),      # all weight in one bin
    (5001, 4999, 50),      # rows not 16-byte aligned: 4-byte loads
    (5000, 4097, 50),      # a valid length inside a quad
    (5000, 1, 50),
    (5000, 0, 50),
    (4000, 4000, 800),     # the most bins the kernel takes
])
def test_weighted_hist_kernel_edge_cases(dev, row_len, n_valid, n_bins):
    rng = np.random.default_rng(4)
    if n_bins == 50 and row_len == n_valid == 5000:
        v = np.full((7, row_len), 777.0)
    else:
        v = rng.uniform(150, 1250, (7, row_len))
    w = rng.uniform(0, 40, v.shape)
    v = torch.as_tensor(v.astype(np.float32), device=dev)
    w = torch.as_tensor(w.astype(np.float32), device=dev)
    got = cuda_hist.weighted_histogram(v, 200.0, 1200.0, n_bins, w, n_valid)
    want = cuda_hist.weighted_histogram_plain(v, 200.0, 1200.0, n_bins, w,
                                              n_valid)
    total = w[:, :n_valid].sum(-1, keepdim=True)
    assert torch.all((got - want).abs() <= 1e-6 * total)
    # the blocks' sums are added in a fixed order: the same on every call
    assert torch.equal(got, cuda_hist.weighted_histogram(v, 200.0, 1200.0,
                                                         n_bins, w, n_valid))


def test_weighted_hist_kernel_refuses_too_many_bins(dev):
    v = torch.zeros((1, 16), device=dev)
    max_bins = load_library().lib.mcmctof_weighted_hist_max_bins()
    assert max_bins == 800
    cuda_hist.weighted_histogram(v, 0.0, 1.0, max_bins, v)
    with pytest.raises(ValueError, match="bins"):
        cuda_hist.weighted_histogram(v, 0.0, 1.0, max_bins + 1, v)


ONEBD_WINDOWS = tuple(tof_windows_onebd[n] for n in ("close", "mid", "far"))


@pytest.mark.parametrize("shape", [(8, 3, 10, 100), (16, 3, 20, 400)])
def test_tof_kernel_with_one_segment(dev, shape):
    """K2 as the oneBD 'expo' stage launches it: one segment (zt zeros, zw
    ones), every lattice cell one sample, 25 bins of 4 ns, so bins far more
    crowded than simultFit's.  Against the plain histogram of the lattice
    as it is (1e-6 of the row's total), each bin the float32 nearest to the
    float64 sum of its weights, and the same on every call."""
    rng = np.random.default_rng(7)
    base = torch.as_tensor(rng.uniform(70, 230, shape).astype(np.float32),
                           device=dev)
    draws = torch.as_tensor(np.rint(rng.uniform(0, 400, shape)).astype(
        np.float32), device=dev)
    zt = torch.zeros((shape[-1], 1), device=dev)
    zw = torch.ones((shape[-1], 1), device=dev)
    win = window_constants(ONEBD_WINDOWS, device=dev)
    got = _k2_check(base, draws, zt, zw, win)
    assert got.shape == shape[:2] + (25,)
    from mcmctoffitting_tpu_torch.ops.histogram import (
        weighted_histogram_multi_window)
    exact = weighted_histogram_multi_window(
        base.reshape(shape[:2] + (-1,)), win,
        draws.reshape(shape[:2] + (-1,)), torch.float64)
    # the float32 nearest to the exact sum, up to the 2^-39 of the row's
    # total that the fixed point drops of each of the row's samples
    total = draws.double().sum(dim=(-2, -1))[..., None]
    n_samples = shape[-2] * shape[-1]
    assert torch.all((got.double() - exact).abs()
                     <= 6e-8 * exact + n_samples * 2.0 ** -39 * total)
    assert torch.equal(got, tof_hist_segments(base, draws, zt, zw, win))


def test_poisson_kernel_on_background_rates(dev):
    """K1 on (W, R, 25) rates, each row 25 equal rates, as the oneBD
    background draws them: rate 0 (and below) gives 0, both branches
    (inversion below 10, PTRS from 10 on) agree with the plain version and
    have the rate's mean and variance."""
    levels = torch.tensor([0.0, -2.0, 0.5, 9.99, 10.0, 1000.0], device=dev)
    lam = levels[None, :, None].expand(2048, -1, 25).contiguous()
    got = poisson(lam, (21, 22))
    want = plain_poisson.poisson_ptrs(lam, (21, 22))
    assert (got == want).float().mean().item() >= 0.999
    assert torch.all(got[:, :2] == 0)
    for k, rate in enumerate(levels.tolist()[2:], start=2):
        x = got[:, k].double().reshape(-1)
        m = x.numel()
        z_mean = (x.mean() - rate) / np.sqrt(rate / m)
        z_var = (x.var() - rate) / np.sqrt((rate + 2 * rate * rate) / m)
        assert abs(z_mean) < 5 and abs(z_var) < 5, (rate, z_mean, z_var)


def test_moment_sums_deterministic_and_equal_to_cpu(dev):
    """The mc fine-cell moments (table, e0grid) and the table 'taylor'
    moment channels sum in int64 fixed point: two calls on the card give
    the same bits, and the CPU's on the same energies."""
    from mcmctoffitting_tpu_torch.models import simult
    from mcmctoffitting_tpu_torch.ops.e0grid import fine_cell_moments
    problem = simult.SimultFitProblem(simult.default_spec(20_000),
                                      n_runs=4, device=dev)
    params = torch.tensor([[1878.4, 850.0, 170.0, 0.5]] * 8, device=dev)
    e0 = problem.forward.sample_beam_energies(
        params, torch.Generator().manual_seed(1))          # (8, 4, 20k)
    grid = problem.forward.e0grid
    first = fine_cell_moments(grid, e0)
    assert torch.equal(first, fine_cell_moments(grid, e0))
    cpu_grid = simult.SimultFitProblem(simult.default_spec(20_000),
                                       n_runs=4, device="cpu").forward.e0grid
    assert torch.equal(first.cpu(), fine_cell_moments(cpu_grid, e0.cpu()))

    spec = simult.default_spec(20_000, xs_mode="taylor")
    fwd = simult.SimultFitProblem(spec, n_runs=4, device=dev).forward
    cpu_fwd = simult.SimultFitProblem(spec, n_runs=4, device="cpu").forward
    rows = e0.reshape(-1, e0.shape[-1])
    n_x = spec.x_binning.n
    got = cuda_transport.energy_moments(fwd.transport, rows, n_x,
                                        fwd.moment_bins)
    assert torch.equal(got, cuda_transport.energy_moments(
        fwd.transport, rows, n_x, fwd.moment_bins))
    assert torch.equal(got.cpu(), cuda_transport.energy_moments(
        cpu_fwd.transport, rows.cpu(), n_x, cpu_fwd.moment_bins))


@pytest.mark.parametrize("flags", [["-sampling", "counts"], []],
                         ids=["counts", "mc_default"])
def test_cli_resume_exact_on_the_card(dev, flags, tmp_path, monkeypatch):
    """simultFit on the card: 4 main steps equal 2 main steps, then
    -resume for 2 more, byte for byte in mainchain.dat."""
    from mcmctoffitting_tpu_torch.cli import simult_fit
    argv = ["-nRuns", "2", "-nDrawsPerEval", "20000", "-nWalkers", "32",
            "-nBurninSteps", "2", "-segment", "2", "-batch", "1"] + flags
    chains = {}
    for name, steps in (("a", [["-nMainSteps", "4"]]),
                        ("b", [["-nMainSteps", "2"],
                               ["-nMainSteps", "2", "-resume",
                                "main.ckpt.npz"]])):
        where = tmp_path / name
        where.mkdir()
        monkeypatch.chdir(where)
        for extra in steps:
            simult_fit.main(argv + extra)
        chains[name] = (where / "mainchain.dat").read_bytes()
    assert chains["a"] == chains["b"]
    assert chains["a"].count(b"\n") == 4 * 32


def _k2_bwd_check(gbar, base, zt, zw, win):
    """The backward kernel against the float64 gather of the cotangent,
    within 1e-6 of sum_k |zw| max|gbar|, and against the autograd of the
    plain version; the same bits on a second call."""
    from mcmctoffitting_tpu_torch.ops.cuda_tof import (
        tof_hist_segments_backward, tof_hist_segments_bwd_plain)
    got = tof_hist_segments_backward(gbar, base, zt, zw, win)
    exact = tof_hist_segments_bwd_plain(gbar, base, zt, zw, win,
                                        torch.float64)
    bound = 1e-6 * zw.abs().sum(1).max().item() * gbar.abs().max().item()
    assert torch.all((got.double() - exact).abs() <= bound)
    d = torch.zeros_like(base).requires_grad_(True)
    plain = tof_hist_segments_plain(base, d, zt, zw, win)
    want, = torch.autograd.grad(plain, d, gbar)
    assert torch.all((got - want).abs() <= bound)
    assert torch.equal(got, tof_hist_segments_backward(gbar, base, zt, zw,
                                                       win))
    return got


@pytest.mark.parametrize("case", ["simult", "onebd", "one_row", "few_cells",
                                  "bins_over_the_stage_cap"])
def test_tof_backward_kernel_matches_plain(dev, case):
    """K2's backward (``tof_hist_bwd``) at both fits' lattices and at the
    edges of its launch: one row, fewer cells than a warp, a window too
    wide to stage its cotangent in shared memory."""
    rng = np.random.default_rng(8)
    windows, shape, k = SIMULT_WINDOWS, (8, 4, 10, 50), 10
    if case == "onebd":
        windows, shape, k = ONEBD_WINDOWS, (8, 3, 20, 400), 1
    elif case == "one_row":
        windows, shape = (tof_windows["mid"],), (1, 10, 50)
    elif case == "few_cells":
        shape, k = (5, 4, 3, 7), 3
    elif case == "bins_over_the_stage_cap":
        windows = (TofWindow(130.0, 260.0, 60_000),
                   TofWindow(175.0, 225.0, 50))
        shape = (3, 2, 10, 50)
    base, _, zt, zw, win = _k2_inputs(rng, dev, shape, windows, k)
    gbar = torch.as_tensor(rng.standard_normal(
        shape[:-2] + (win.n_pad,)).astype(np.float32), device=dev)
    got = _k2_bwd_check(gbar, base, zt, zw, win)
    assert torch.count_nonzero(got) > 0


def test_tof_backward_kernel_edge_cases_exact(dev):
    """v == hi -> the last bin's cotangent, v == lo -> the first's, just
    outside and NaN -> nothing: exactly the plain version's values."""
    from mcmctoffitting_tpu_torch.ops.cuda_tof import (
        tof_hist_segments_backward, tof_hist_segments_bwd_plain)
    win = window_constants(SIMULT_WINDOWS, device=dev)
    base = torch.full((1, 4, 10, 50), 1000.0, device=dev)
    zt = torch.zeros((50, 10), device=dev)
    zw = torch.zeros((50, 10), device=dev)
    zw[:6, 0] = torch.tensor([1.0, 2.0, 4.0, 8.0, 16.0, 32.0])
    for r in range(4):
        lo, hi = win.lo[r].item(), win.hi[r].item()
        base[0, r, 0, :6] = torch.tensor([hi, hi + 0.5, lo, lo - 0.5,
                                          float("nan"), lo + 1.5])
    gbar = torch.arange(1.0, 1.0 + 4 * win.n_pad, device=dev).reshape(
        1, 4, win.n_pad)
    got = tof_hist_segments_backward(gbar, base, zt, zw, win)
    want = tof_hist_segments_bwd_plain(gbar, base, zt, zw, win)
    assert torch.equal(got, want)
    nb1 = win.nb1.long()
    assert torch.equal(got[0, :, 0, 0], gbar[0, torch.arange(4), nb1])
    assert torch.equal(got[0, :, 0, 2], 4.0 * gbar[0, :, 0])
    assert not got[0, :, 0, [1, 3, 4]].any()


def test_tof_autograd_function_on_the_card(dev):
    """A CUDA input that needs a gradient goes through TofHistSegments:
    one forward and one backward launch, the kernel's forward values, and
    the draws' gradient of the backward kernel."""
    from mcmctoffitting_tpu_torch.ops.cuda_tof import (
        tof_hist_segments_backward)
    rng = np.random.default_rng(9)
    base, draws, zt, zw, win = _k2_inputs(rng, dev, (4, 4, 10, 50),
                                          SIMULT_WINDOWS)
    want = tof_hist_segments(base, draws, zt, zw, win)
    fwd0 = tof_hist_segments.launches
    bwd0 = tof_hist_segments.backward_launches
    d = draws.clone().requires_grad_(True)
    out = tof_hist_segments(base, d, zt, zw, win)
    gbar = torch.randn(out.shape, device=dev)
    grad, = torch.autograd.grad(out, d, gbar)
    assert torch.equal(out.detach(), want)
    assert torch.equal(grad, tof_hist_segments_backward(gbar, base, zt, zw,
                                                        win))
    assert tof_hist_segments.launches - fwd0 == 1
    assert tof_hist_segments.backward_launches - bwd0 == 2


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_log_prob_gradient_gpu_vs_cpu(dev, model):
    """The gradient of the differentiable log-prob ('expected', corrected
    likelihood, no rint; oneBD with the background's expectation) on the
    card against the CPU's at the fit's initial walkers, per chain within
    1e-3 relative L2 with the float32 grid stage's values shared (each
    device's float32 grid is off by ~1e-4 of its peak, which the
    likelihood's gradient can weigh up to percents: perf/
    gradient_precision.py), with K2's forward and backward launched once
    each."""
    import dataclasses

    from mcmctoffitting_tpu_torch.models import onebd, simult
    from mcmctoffitting_tpu_torch.utils import data_io
    if model == "simult":
        spec = dataclasses.replace(simult.default_spec(
            200_000, sampling="expected"), rint_draws=False)
        make = lambda d: simult.SimultFitProblem(  # noqa: E731
            spec, n_runs=4, likelihood="poisson", device=d)
        truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5e4)])
    else:
        spec = dataclasses.replace(onebd.default_spec(
            200_000, sampling="expected"), rint_draws=False,
            bg_mode="expected")
        make = lambda d: onebd.OneBDProblem(  # noqa: E731
            spec, n_runs=3, likelihood="poisson", device=d)
        truth = data_io.ONEBD_TRUTH
    cpu, card = make("cpu"), make(dev)
    fwd_c, own = cpu.forward, card.forward.grid_and_mean

    def shared(params, generator):
        grids, means = own(params, generator)
        c_grids, c_means = fwd_c.grid_and_mean(params.detach().cpu(),
                                               generator)
        return (grids + (c_grids.to(dev) - grids).detach(),
                means + (c_means.to(dev) - means).detach())

    card.forward.grid_and_mean = shared
    obs = data_io.synthesize_observed(0, cpu, truth)
    thetas = cpu.initial_walkers_from_observed(
        torch.Generator().manual_seed(10), 8, obs)
    grads = []
    for prob in (card, cpu):
        x = thetas.to(prob.device).requires_grad_(True)
        fwd0 = tof_hist_segments.launches
        bwd0 = tof_hist_segments.backward_launches
        lp = prob.make_log_prob_fn(obs)(x, torch.Generator())
        g, = torch.autograd.grad(lp.sum(), x)
        if prob is card:
            assert tof_hist_segments.launches - fwd0 == 1
            assert tof_hist_segments.backward_launches - bwd0 == 1
        grads.append(g.cpu().numpy())
    gpu, cpu_g = grads
    rel = np.linalg.norm(gpu - cpu_g, axis=1) / np.linalg.norm(cpu_g, axis=1)
    assert np.all(rel <= 1e-3), rel


def test_nuts_cli_on_the_card(dev, tmp_path, monkeypatch):
    """-sampler nuts on the card at a small size: the chain parses back,
    finite quantiles."""
    from mcmctoffitting_tpu_torch.cli import simult_fit
    from mcmctoffitting_tpu_torch.utils import chain_io
    monkeypatch.chdir(tmp_path)
    out = simult_fit.main(["-debug", "1", "-nRuns", "2", "-batch", "1",
                           "-sampler", "nuts", "-expectedForward",
                           "-likelihood", "poisson", "-nChains", "16",
                           "-maxDepth", "4"])
    assert all(np.all(np.isfinite(v)) for v in out["quantiles"].values())
    chain, _, d, w, s = chain_io.read_chain_text("mainchain.dat")
    assert (s, w, d) == (10, 16, 6)


def _ppc_on(problem, thetas, e_runs, e_grid, seed):
    """``PPCSampler.generate`` of a one-theta-per-row chain with the beam
    draws replaced by the given initial energies (moved to the problem's
    device): e_runs (n, R, N) for the spectra, e_grid (n, 1, N) for the
    weight grids."""
    from mcmctoffitting_tpu_torch.utils.ppc import PPCSampler
    dev = problem.device

    def energies(params, generator, n_runs=None, n=None):
        return (e_grid if n_runs == 1 else e_runs).to(dev)

    problem.forward.sample_beam_energies = energies
    sampler = PPCSampler(problem, thetas[None], n_steps_to_include=1)
    sampler.draw_thetas = lambda generator, n, cut=None: thetas
    return sampler.generate(torch.Generator().manual_seed(seed),
                            thetas.shape[0])


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_ppc_core_gpu_vs_cpu(dev, model):
    """The PPC's batched forward on the card against the CPU's, the same
    thetas and initial energies on both (oneBD: the same background seed,
    kernel K1 against its plain version): every run's spectra and the
    weight grids within 1e-4 relative L1 per row; K2 launched once, K1
    once on oneBD."""
    from mcmctoffitting_tpu_torch.models import onebd, simult
    from mcmctoffitting_tpu_torch.utils import data_io
    n, n_draws = 8, 50_000
    if model == "simult":
        spec = simult.default_spec(n_draws)
        make = lambda d: simult.SimultFitProblem(spec, 4, device=d)  # noqa
        truth = np.concatenate([simult.GUESS_SHARED, np.full(4, 5e4)])
    else:
        spec = onebd.default_spec(n_draws)
        make = lambda d: onebd.OneBDProblem(spec, device=d)  # noqa
        truth = data_io.ONEBD_TRUTH
    card, cpu = make(dev), make("cpu")
    obs = data_io.synthesize_observed(0, cpu, truth)
    thetas = cpu.initial_walkers_from_observed(
        torch.Generator().manual_seed(1), n, obs).numpy()
    params = cpu.shared_params(torch.as_tensor(thetas))
    gen = torch.Generator().manual_seed(2)
    e_runs = cpu.forward.sample_beam_energies(params, gen)
    e_grid = cpu.forward.sample_beam_energies(params, gen, n_runs=1)
    poisson.launches = tof_hist_segments.launches = 0
    got = _ppc_on(card, thetas, e_runs, e_grid, 3)
    torch.cuda.synchronize()
    assert tof_hist_segments.launches == 1
    assert poisson.launches == (1 if model == "onebd" else 0)
    want = _ppc_on(cpu, thetas, e_runs, e_grid, 3)

    def rel_l1(a, b):
        a, b = a.reshape(n, -1), b.reshape(n, -1)
        return (np.abs(a - b).sum(-1) / np.abs(b).sum(-1)).max()

    for g, w in zip(got.tof_spectra, want.tof_spectra):
        assert np.isfinite(g).all() and rel_l1(g, w) <= 1e-4
    assert rel_l1(got.neutron_spectra, want.neutron_spectra) <= 1e-4


def test_ppc_cli_on_the_card(dev, tmp_path, monkeypatch):
    """cli.ppc on the card on a small chain: bands and SDEF card, K2 once
    per chunk of draws, K3 and K4 never."""
    from mcmctoffitting_tpu_torch.cli import ppc
    from mcmctoffitting_tpu_torch.utils import chain_io
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    chain = (np.array([1878.4, 850.0, 170.0, 0.5, 5e4, 5e4, 5e4, 5e4])
             * (1 + 1e-3 * rng.standard_normal((10, 16, 8))))
    chain_io.append_chain_text("chain.dat", chain, -rng.random((10, 16)))
    for fn in (tof_hist_segments, cuda_hist.weighted_histogram,
               cuda_transport.transport_moments):
        fn.launches = 0
    ppc.main(["-chainFilename", "chain.dat", "-nChainEntries", "200"])
    torch.cuda.synchronize()
    assert tof_hist_segments.launches == 2          # 128 + 72 draws
    assert cuda_hist.weighted_histogram.launches == 0
    assert cuda_transport.transport_moments.launches == 0
    bands = np.loadtxt("ppc_run0_bands.txt")
    assert bands.shape == (3, tof_windows["mid"].n_bins)
    assert np.isfinite(bands).all() and np.all(bands[0] <= bands[2])


# --- the remaining forward models: K4 in depth tiles, K3 per walker ------

@pytest.mark.parametrize("n_x, n_bins, n_sub", [(100, 150, 4), (65, 50, 1),
                                                (101, 3000, 1)])
def test_transport_moments_kernel_in_depth_tiles(dev, n_x, n_bins, n_sub):
    """The depth-tiled kernel (the templates' M = 100 x Be = 150, more
    depths than one launch holds, and a histogram of one depth near the
    shared-memory limit): the transported energies bit for bit, the
    moments within 1e-5 of each row's total, per channel against the
    float64 sums, every channel the same bits on a second call; a span too
    wide for shared memory is refused."""
    from mcmctoffitting_tpu_torch.config import Binning
    assert 0 < cuda_transport.tile_spans(n_x, n_bins) < n_x
    rng = np.random.default_rng(5)
    e0 = rng.uniform(400.0, 1200.0, (9, 4000))
    e0[:, ::53] = rng.uniform(15.0, 300.0, e0[:, ::53].shape)
    e0 = torch.as_tensor(e0.astype(np.float32), device=dev)
    c = stopping.rk4_constants(stopping.d2_gas_stopping(),
                               Binning(0.0, 2.86, n_x).centers, n_sub)
    bins = cuda_transport.MomentBins(200.0, 1700.0, n_bins)
    got, e_kern = cuda_transport.transport_moments(e0, c, bins,
                                                   energies_out=True)
    torch.testing.assert_close(e_kern, stopping.rk4_transport(c, e0),
                               rtol=0, atol=0)
    want = cuda_transport.transport_moments_plain(e0, c, bins)
    total = want[:, :, 0].sum(dim=(-2, -1))[:, None, None, None]
    assert torch.all((got - want).abs() <= 1e-5 * total.clamp_min(1.0))
    counts_equal, ratio = cuda_transport.moment_check(got, e_kern, bins)
    assert counts_equal and ratio <= 1.0
    # a second call: every channel the same bits (the blocks' sums meet in
    # int64 and are rounded to float32 once)
    assert torch.equal(cuda_transport.transport_moments(e0, c, bins), got)
    assert cuda_transport.tile_spans(10, 60_000) == 0
    with pytest.raises(ValueError, match="cannot take"):
        cuda_transport.transport_moments(
            e0, c, cuda_transport.MomentBins(200.0, 1700.0, 60_000))


@pytest.mark.parametrize("n_bins, weighted", [(25, False), (50, True)])
def test_weighted_hist_kernel_at_the_simple_family_shape(dev, n_bins,
                                                         weighted):
    """K3 on one half-step of the simple family: 50 rows of 200k TOF
    values (v0: 25 bins, no weights; v2: 50 bins, cross-section weights),
    rows that blocks share: within 1e-6 of each row's total, the same on a
    second call."""
    rng = np.random.default_rng(6)
    v = torch.as_tensor(rng.normal(190.0, 9.0, (50, 200_000)).astype(
        np.float32), device=dev)
    w = (torch.as_tensor(rng.uniform(20.0, 40.0, v.shape).astype(np.float32),
                         device=dev) if weighted else torch.ones_like(v))
    hi = 200.0 if n_bins == 25 else 225.0
    blocks = ctypes.c_longlong()
    load_library().lib.mcmctof_weighted_hist_blocks(
        50, 200_000, n_bins, dev.index, ctypes.byref(blocks))
    assert blocks.value > 50      # the float64 parts path: rows split
    got = cuda_hist.weighted_histogram(v, 175.0, hi, n_bins, w)
    want = cuda_hist.weighted_histogram_plain(v, 175.0, hi, n_bins, w)
    total = want.sum(-1, keepdim=True)
    assert torch.all((got - want).abs() <= 1e-6 * total)
    assert torch.equal(got, cuda_hist.weighted_histogram(v, 175.0, hi,
                                                         n_bins, w))
