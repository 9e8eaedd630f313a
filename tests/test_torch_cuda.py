"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where there is no GPU.  On a machine with
one (and without jax, which tests/conftest.py imports), run:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at the forward model's full shapes.
"""
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.constants import tof_windows
from mcmctoffitting_tpu_torch.ops import poisson as plain_poisson
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
