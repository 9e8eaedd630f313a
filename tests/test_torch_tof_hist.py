"""Port of kernel K2's plain version (ops/cuda_tof.py) vs the JAX package,
on the cases of tests/test_pallas_tof.py: the f64 np.histogram oracle,
v == hi, out-of-range values, padding bins, and all four simult windows.

Tolerances: vs the JAX package's float32 weighted_histogram_multi_window,
rtol 1e-5 plus atol 1e-5 x the row's total weight (summation order); vs
the interpret-mode Pallas kernel, rtol 2^-8 — that kernel rounds every
weight once to bf16 (2^-9 relative), the port sums float32 weights.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.constants import TofWindow, tof_windows
from mcmctoffitting_tpu.ops.histogram import (
    weighted_histogram_multi_window as j_multi_window)
from mcmctoffitting_tpu.ops.pallas_tof import make_tof_hist_segments
from mcmctoffitting_tpu_torch.ops.cuda_tof import (tof_hist_segments,
                                                   tof_hist_segments_plain)
from mcmctoffitting_tpu_torch.ops.histogram import (
    histogram_density, weighted_histogram_multi_window, window_constants)

torch.set_num_threads(1)

WINDOWS = (TofWindow(175.0, 225.0, 50), TofWindow(130.0, 175.0, 45),
           TofWindow(190.0, 260.0, 70))
SIMULT = tuple(tof_windows[n] for n in ("mid", "close", "close", "far"))


def _problem(seed, windows, m, be, k, w_batch=None):
    rng = np.random.default_rng(seed)
    shape = (len(windows), m, be)
    if w_batch is not None:
        shape = (w_batch,) + shape
    base = rng.uniform(120.0, 270.0, shape).astype(np.float32)
    draws = rng.uniform(0.0, 50.0, shape).astype(np.float32)
    zt = rng.uniform(-6.0, 6.0, (be, k)).astype(np.float32)
    zw = rng.uniform(0.0, 1.0, (be, k)).astype(np.float32)
    return base, draws, zt, zw


def _plain(base, draws, zt, zw, windows):
    win = window_constants(windows, device="cpu")
    return tof_hist_segments(torch.as_tensor(base), torch.as_tensor(draws),
                             torch.as_tensor(zt), torch.as_tensor(zw),
                             win).numpy()


def _oracle(base, draws, zt, zw, windows):
    """f64 np.histogram over the expanded (M, Be, K) samples, per run."""
    n_pad = max(w.n_bins for w in windows)
    out = np.zeros((len(windows), n_pad))
    for r, win in enumerate(windows):
        v = (base[r][:, :, None] + zt[None]).astype(np.float64).ravel()
        w_ = (draws[r][:, :, None] * zw[None]).astype(np.float64).ravel()
        h, _ = np.histogram(v, bins=win.n_bins, range=(win.lo, win.hi),
                            weights=w_)
        out[r, :win.n_bins] = h
    return out


def _jax_f32(base, draws, zt, zw, windows):
    values = base[..., None] + zt
    weights = draws[..., None] * zw
    return np.asarray(j_multi_window(
        jnp.asarray(values.reshape(len(windows), -1)), windows,
        jnp.asarray(weights.reshape(len(windows), -1))))


CASES = [("pallas_tof", WINDOWS, 7, 23, 5), ("simult", SIMULT, 10, 50, 10)]


@pytest.mark.parametrize("name,windows,m,be,k", CASES)
def test_vs_jax_float32_and_oracle(name, windows, m, be, k):
    base, draws, zt, zw = _problem(0, windows, m, be, k)
    got = _plain(base, draws, zt, zw, windows)
    total = (draws[..., None] * zw).sum(axis=(-3, -2, -1))[:, None]
    np.testing.assert_allclose(got, _jax_f32(base, draws, zt, zw, windows),
                               rtol=1e-5, atol=1e-5 * total.max())
    np.testing.assert_allclose(got, _oracle(base, draws, zt, zw, windows),
                               rtol=1e-5, atol=1e-5 * total.max())


@pytest.mark.parametrize("name,windows,m,be,k", CASES)
def test_vs_interpret_mode_pallas(name, windows, m, be, k):
    base, draws, zt, zw = _problem(1, windows, m, be, k, w_batch=2)
    fn = make_tof_hist_segments(windows, m, be, k, interpret=True)
    want = np.stack([np.asarray(fn(base[i], draws[i], jnp.asarray(zt),
                                   jnp.asarray(zw))) for i in range(2)])
    got = _plain(base, draws, zt, zw, windows)
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8,
                               atol=1e-6 * want.max())


def test_edge_semantics():
    """v == hi lands in the last bin; out-of-range drops; padding bins
    beyond each window's n_bins stay exactly zero."""
    m, be, k = 7, 23, 5
    win = WINDOWS[1]
    base = np.zeros((len(WINDOWS), m, be), np.float32)
    draws = np.zeros_like(base)
    base[1, 0, 0] = win.hi              # exactly the top edge
    base[1, 0, 1] = win.hi + 0.5        # just above: dropped
    base[1, 0, 2] = win.lo              # bottom edge: first bin
    base[1, 0, 3] = win.lo - 0.5        # just below: dropped
    base[0, 0, 4] = np.nan              # NaN: dropped
    draws[1, 0, :4] = 1.0
    draws[0, 0, 4] = 1.0
    zt = np.zeros((be, k), np.float32)
    zw = np.zeros((be, k), np.float32)
    zw[:5, 0] = 1.0                     # one unit-weight segment
    got = _plain(base, draws, zt, zw, WINDOWS)
    want = np.zeros((len(WINDOWS), max(w.n_bins for w in WINDOWS)))
    want[1, win.n_bins - 1] = 1.0
    want[1, 0] = 1.0
    np.testing.assert_array_equal(got, want)


def test_walker_batch_equals_per_walker_rows():
    base, draws, zt, zw = _problem(2, WINDOWS, 7, 23, 5, w_batch=5)
    batched = _plain(base, draws, zt, zw, WINDOWS)
    assert batched.shape == (5, len(WINDOWS), 70)
    for i in range(5):
        np.testing.assert_array_equal(
            batched[i], _plain(base[i], draws[i], zt, zw, WINDOWS))


def test_cpu_dispatch_takes_plain_version():
    base, draws, zt, zw = _problem(3, WINDOWS, 7, 23, 5, w_batch=2)
    win = window_constants(WINDOWS, device="cpu")
    args = [torch.as_tensor(a) for a in (base, draws, zt, zw)]
    before = tof_hist_segments.launches
    np.testing.assert_array_equal(tof_hist_segments(*args, win).numpy(),
                                  tof_hist_segments_plain(*args, win).numpy())
    assert tof_hist_segments.launches == before


def test_wrapper_rejects_bad_arguments():
    base, draws, zt, zw = (torch.as_tensor(a) for a in
                           _problem(4, WINDOWS, 7, 23, 5))
    win = window_constants(WINDOWS, device="cpu")
    with pytest.raises(ValueError):
        tof_hist_segments(base, draws[:, :, :-1], zt, zw, win)
    with pytest.raises(TypeError):
        tof_hist_segments(base.double(), draws, zt, zw, win)
    with pytest.raises(ValueError):
        tof_hist_segments(base.transpose(-1, -2), draws.transpose(-1, -2),
                          zt, zw, win)


def test_wrapper_refusals_by_kind():
    """Wrong dtype of any input, inputs on two devices, a window tensor
    of another length, tables of two shapes: each refused with its own
    error; a bin count of any size is served, not refused."""
    base, draws, zt, zw = (torch.as_tensor(a) for a in
                           _problem(6, WINDOWS, 7, 23, 5))
    win = window_constants(WINDOWS, device="cpu")
    with pytest.raises(TypeError, match="float32"):
        tof_hist_segments(base, draws, zt.double(), zw, win)
    with pytest.raises(TypeError, match="int32"):
        tof_hist_segments(base, draws, zt, zw,
                          win._replace(nb1=win.nb1.long()))
    with pytest.raises(ValueError, match="one device"):
        tof_hist_segments(base, draws.to("meta"), zt, zw, win)
    with pytest.raises(ValueError, match="one device"):
        tof_hist_segments(base, draws, zt, zw,
                          win._replace(scale=win.scale.to("meta")))
    with pytest.raises(ValueError, match="shapes"):
        tof_hist_segments(base, draws, zt, zw[:, :-1].contiguous(), win)
    with pytest.raises(ValueError, match="shapes"):
        tof_hist_segments(base, draws, zt, zw,
                          win._replace(hi=win.hi[:-1]))
    with pytest.raises(ValueError, match="shapes"):
        tof_hist_segments(base[0], draws[0], zt, zw, win)   # no run axis
    with pytest.raises(ValueError, match="no kernel for device"):
        tof_hist_segments(*(t.to("meta") for t in (base, draws, zt, zw)),
                          window_constants(WINDOWS, device="meta"))


@pytest.mark.parametrize("n_bins", [1, 129, 20_000])
def test_any_bin_count_is_served(n_bins):
    """One bin, more than the TPU kernel's 128, more than the fast CUDA
    kernel has shared memory for: against the f64 np.histogram oracle."""
    windows = (TofWindow(130.0, 260.0, n_bins), TofWindow(175.0, 225.0, 50))
    base, draws, zt, zw = _problem(7, windows, 7, 23, 5)
    got = _plain(base, draws, zt, zw, windows)
    assert got.shape == (2, max(n_bins, 50))
    total = (draws[..., None] * zw).sum(axis=(-3, -2, -1)).max()
    np.testing.assert_allclose(got, _oracle(base, draws, zt, zw, windows),
                               rtol=1e-5, atol=1e-5 * total)


def test_empty_walker_batch():
    base, draws, zt, zw = (torch.as_tensor(a) for a in
                           _problem(8, WINDOWS, 7, 23, 5, w_batch=2))
    win = window_constants(WINDOWS, device="cpu")
    got = tof_hist_segments(base[:0], draws[:0], zt, zw, win)
    assert got.shape == (0, len(WINDOWS), 70)


def test_window_constants_are_the_kernel_constants():
    """scale is float32(n_bins / (hi - lo)) exactly as the TPU kernel and
    the JAX histogram fix it (ops/pallas_tof.py:171-174)."""
    win = window_constants(SIMULT, device="cpu")
    for r, w in enumerate(SIMULT):
        assert win.scale[r].item() == float(np.float32(w.n_bins
                                                       / (w.hi - w.lo)))
        assert win.nb1[r].item() == w.n_bins - 1
    assert win.n_pad == 70


def test_multi_window_and_density():
    rng = np.random.default_rng(5)
    values = rng.uniform(100.0, 280.0, (2, 3, 4000)).astype(np.float32)
    weights = rng.uniform(0.0, 2.0, values.shape).astype(np.float32)
    win = window_constants(WINDOWS, device="cpu")
    got = weighted_histogram_multi_window(torch.as_tensor(values), win,
                                          torch.as_tensor(weights)).numpy()
    for i in range(2):
        want = np.asarray(j_multi_window(jnp.asarray(values[i]), WINDOWS,
                                         jnp.asarray(weights[i])))
        np.testing.assert_allclose(got[i], want, rtol=1e-5,
                                   atol=1e-5 * want.sum(-1).max())
    dens = histogram_density(torch.as_tensor(got[0, 0, :50]), 175.0, 225.0)
    np.testing.assert_allclose(dens.sum().item() * 1.0, 1.0, rtol=1e-6)
