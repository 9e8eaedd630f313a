"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no GPU.  On a machine with
one (and without jax, which tests/conftest.py imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the forward model's full shapes.
"""
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu_torch.config import SIMULTFIT_X_BINNING
from mcmctoffitting_tpu_torch.constants import TofWindow, tof_windows
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
