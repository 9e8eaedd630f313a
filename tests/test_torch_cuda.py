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
from mcmctoffitting_tpu_torch.constants import tof_windows
from mcmctoffitting_tpu_torch.ops import cuda_hist, cuda_transport
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
