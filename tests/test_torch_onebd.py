"""The csi_oneBD joint fit: the port (mcmctoffitting_tpu_torch) against the
JAX package at a small size (the default 100 x 10 grid, F = 64, <= 8000
draws, <= 16 walkers, 3 runs).

(a) ``GaussianTiming`` and the 'expo' stage against the JAX functions.
(b) The attenuation and the bfloat16-A contraction.
(c) The log-prob end to end, deterministic (``sampling='expected'``,
    ``bg_mode='expected'``), both likelihoods, thetas inside and outside
    the prior box; the 'expected' spectra against ``tof_spectra_multi``.
(d) The counts estimator with injected cell counts and injected
    background draws.
(e) ``default_spec`` field by field against the JAX preset, the problem's
    bounds, guesses and initial walkers.
(f) The background in distribution; every preset's log-prob on the CPU;
    short DE fits.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmctoffitting_tpu.ops.e0grid as je0grid
import mcmctoffitting_tpu.ops.poisson as jpoisson
from mcmctoffitting_tpu.models import forward as jforward
from mcmctoffitting_tpu.models import onebd as jonebd
from mcmctoffitting_tpu.ops import timing as jtiming
from mcmctoffitting_tpu_torch import sampler
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import onebd as tonebd
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import e0grid as te0grid
from mcmctoffitting_tpu_torch.ops import timing as ttiming
from mcmctoffitting_tpu_torch.utils import data_io as tdata_io
from test_torch_mc_table import assert_same_spec

torch.set_num_threads(1)

N_DRAWS, N_FINE, N_RUNS = 8000, 64, 3
TRUTH = tdata_io.ONEBD_TRUTH


def _thetas(n=8, seed=0, outside=0):
    """Walkers around the truth; the last ``outside`` of them leave the
    prior box (a negative background, an eLoss above its bound)."""
    rng = np.random.default_rng(seed)
    spread = np.concatenate([[50.0, 10.0, 0.05], 0.05 * TRUTH[3:6],
                             np.full(3, 2.0)])
    t = TRUTH + spread * rng.standard_normal((n, TRUTH.size))
    if outside:
        t[-1, 6] = -1.0
    if outside > 1:
        t[-2, 0] = 2100.0
    return t.astype(np.float32)


def _specs(sampling, **kw):
    jspec = jonebd.default_spec(N_DRAWS, fine_grid=N_FINE, sampling=sampling)
    tspec = tonebd.default_spec(N_DRAWS, fine_grid=N_FINE, sampling=sampling)
    return (dataclasses.replace(jspec, **kw),
            dataclasses.replace(tspec, **kw))


@pytest.fixture(scope="module")
def observed():
    """Observed spectra from the port's own deterministic forward."""
    _, tspec = _specs("expected", bg_mode="expected")
    problem = tonebd.OneBDProblem(tspec, device="cpu")
    return tdata_io.synthesize_observed(0, problem, TRUTH)


# --- (a) timing ---------------------------------------------------------------

def test_gaussian_timing_kernel_and_convolution():
    """The 11 taps bitwise; the 'same' convolution (an odd kernel on even
    and odd row lengths) to 1e-6 of the row's peak, as the float32 matmul
    sums in another order than jnp.convolve."""
    jt, tt = jtiming.GaussianTiming(2.7, 4), ttiming.GaussianTiming(2.7, 4)
    np.testing.assert_array_equal(tt.kernel, jt.kernel)
    assert tt.kernel.shape == (11,)
    np.testing.assert_array_equal(ttiming.GaussianTiming(1.0, 1.0).kernel,
                                  jtiming.GaussianTiming(1.0, 1.0).kernel)
    rng = np.random.default_rng(0)
    for n in (25, 24, 11):
        rows = rng.uniform(0.0, 100.0, (5, n)).astype(np.float32)
        want = np.stack([np.asarray(jt.apply_spreading(jnp.asarray(r)))
                         for r in rows])
        got = tt.apply_spreading(torch.as_tensor(rows)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * rows.max())


def test_zero_degree_expo_stage():
    """The 7 taps bitwise; the 'full' convolution trimmed to the input
    length (causal: bin j reads bins <= j only) to 1e-6 of the peak."""
    np.testing.assert_array_equal(ttiming.zero_degree_expo_kernel(),
                                  jtiming.zero_degree_expo_kernel())
    rng = np.random.default_rng(1)
    for n in (25, 7, 5):
        rows = rng.uniform(0.0, 100.0, (4, n)).astype(np.float32)
        want = np.stack([np.asarray(jtiming.apply_zero_degree_expo(
            jnp.asarray(r))) for r in rows])
        got = ttiming.apply_zero_degree_expo(torch.as_tensor(rows)).numpy()
        assert got.shape == want.shape == rows.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * rows.max())
    mat = ttiming.causal_conv_matrix(ttiming.zero_degree_expo_kernel(), 9)
    assert np.all(np.tril(mat.T) == mat.T)          # y[j] reads x[i <= j]


def test_expo_then_mask_then_timing_order():
    """The TOF stage of runs of unequal width: density normalisation, the
    expo kernel, the padding bins re-zeroed, then the beam-timing 'same'
    convolution, against the JAX functions applied per run in that order,
    on rows whose padding bins are non-zero before the mask."""
    _, tspec = _specs("expected")
    windows = (tonebd.tof_windows_onebd.close,
               dataclasses.replace(tonebd.tof_windows_onebd.mid, hi=180.0,
                                   n_bins=20))
    fwd = tforward.TofForward(tspec, (351.3, 412.3), windows, device="cpu")
    rng = np.random.default_rng(2)
    hist = rng.uniform(1.0, 50.0, (3, 2, 25)).astype(np.float32)
    kernel = jtiming.GaussianTiming(2.7, 4)
    want = np.zeros_like(hist)
    for w, r in itertools.product(range(3), range(2)):
        n = windows[r].n_bins
        row = jtiming.apply_zero_degree_expo(jnp.asarray(hist[w, r]))
        row = row * (np.arange(25) < n)
        want[w, r] = np.asarray(kernel.apply_spreading(row)) * (
            np.arange(25) < n)
    h = torch.as_tensor(hist)
    got = torch.where(fwd.pad_mask, ttiming.apply_same_matrix(h, fwd.expo),
                      0.0)
    got = torch.where(fwd.pad_mask,
                      ttiming.apply_same_matrix(got, fwd.timing), 0.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * hist.max())
    assert np.abs(want[:, 1, 20:]).max() == 0.0
    # without the mask between the two stages the last real bins differ
    unmasked = ttiming.apply_same_matrix(
        ttiming.apply_same_matrix(h, fwd.expo), fwd.timing)
    assert not np.allclose(unmasked[:, 1, :20].numpy(), want[:, 1, :20],
                           rtol=0, atol=1e-3)


# --- (b) attenuation, bfloat16 A ------------------------------------------------

def test_cell_attenuation():
    jspec, tspec = _specs("expected")
    fwd = tonebd.OneBDProblem(tspec, device="cpu").forward
    grid = np.random.default_rng(3).uniform(0.0, 5.0, (2, 10, 100)).astype(
        np.float32)
    want = np.stack([np.asarray(jforward._apply_attenuation(
        jspec, jnp.asarray(g))) for g in grid])
    np.testing.assert_array_equal(fwd.attenuate(torch.as_tensor(grid)),
                                  want)
    assert np.all(want[:, -1] < grid[:, -1])        # deeper, weaker
    plain = dataclasses.replace(tspec, cell_attenuation=False)
    fwd_plain = tonebd.OneBDProblem(plain, device="cpu").forward
    np.testing.assert_array_equal(fwd_plain.attenuate(torch.as_tensor(grid)),
                                  grid)


def test_bfloat16_a_contraction():
    """A rounded to bfloat16 (to nearest even) and kept as float32, moments
    and sum float32: against the JAX contraction to 1e-6 of the grid's
    largest cell (the same products in another order); and it is a
    different grid from the float32 A's."""
    jspec, tspec = _specs("counts", a_dtype="bfloat16")
    grid32 = te0grid.E0Grid(tspec.e0_grid_table, device="cpu")
    grid16 = te0grid.E0Grid(tspec.e0_grid_table, device="cpu",
                            a_dtype="bfloat16")
    assert grid16.a_matrix.dtype == torch.float32
    a_j = np.asarray(jnp.asarray(jspec.e0_grid_table.a_matrix).astype(
        jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(grid16.a_matrix.numpy(), a_j)
    rng = np.random.default_rng(4)
    moments = rng.uniform(-50.0, 100.0, (3, 4, N_FINE)).astype(np.float32)
    want = np.stack([np.asarray(jforward._e0grid_contract(
        jspec, jnp.asarray(m))) for m in moments])
    got = te0grid.contract(grid16, torch.as_tensor(moments)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * np.abs(want).max())
    full = te0grid.contract(grid32, torch.as_tensor(moments)).numpy()
    assert np.abs(full - got).max() > 1e-4 * np.abs(want).max()


def test_e0grid_rejects_unknown_a_dtype():
    """Only float32 and bfloat16 are types of the A operator."""
    _, tspec = _specs("counts")
    with pytest.raises(ValueError, match="a_dtype"):
        te0grid.E0Grid(tspec.e0_grid_table, device="cpu", a_dtype="float16")


# --- (c) deterministic end to end ----------------------------------------------

def _jax_logp_and_spectra(jspec, likelihood, observed, thetas, seed=0):
    jprob = jonebd.OneBDProblem(jspec, n_runs=N_RUNS, likelihood=likelihood)
    jlogp = jprob.make_log_prob_fn(observed)
    keys = jax.random.split(jax.random.PRNGKey(seed), thetas.shape[0])
    fn = jax.jit(jax.vmap(lambda t, k: (jlogp(t, k),
                                        jprob.run_spectra(t, k))))
    lp, spectra = fn(jnp.asarray(thetas), keys)
    return np.asarray(lp), [np.asarray(s) for s in spectra]


def _port_logp_and_spectra(tspec, likelihood, observed, thetas, seed=0):
    tprob = tonebd.OneBDProblem(tspec, n_runs=N_RUNS, likelihood=likelihood,
                                device="cpu")
    t = torch.as_tensor(thetas)
    lp = tprob.make_log_prob_fn(observed)(
        t, torch.Generator().manual_seed(seed))
    spectra = tprob.run_spectra(t, torch.Generator().manual_seed(seed))
    return lp.numpy(), spectra.numpy(), tprob.windows


def _assert_spectra_close(spec_t, spec_j, windows):
    """rtol 1e-5 plus 1e-5 of each run's peak, padding bins exactly 0."""
    for r, win in enumerate(windows):
        want = spec_j[r]
        np.testing.assert_allclose(spec_t[:, r, :win.n_bins], want,
                                   rtol=1e-5, atol=1e-5 * want.max())
        np.testing.assert_array_equal(spec_t[:, r, win.n_bins:], 0.0)


def test_expected_spectra(observed):
    """sampling='expected', bg_mode='expected', rint_draws=False: the
    spectra against the JAX package's ``tof_spectra_multi``."""
    thetas = _thetas(seed=1)
    jspec, tspec = _specs("expected", bg_mode="expected", rint_draws=False)
    _, spec_j = _jax_logp_and_spectra(jspec, "poisson", observed, thetas)
    _, spec_t, windows = _port_logp_and_spectra(tspec, "poisson", observed,
                                                thetas)
    assert spec_t.shape == (8, N_RUNS, 25)
    _assert_spectra_close(spec_t, spec_j, windows)
    # the background sits on top of the scaled spectrum, on the real bins
    assert np.all(spec_t.min(-1) >= thetas[:, 6:] - 1e-3)


@pytest.mark.parametrize("likelihood", ["poisson", "reference"])
def test_log_prob_end_to_end_deterministic(observed, likelihood):
    """The oneBD log-prob with nothing drawn (closed-form moments, the
    background's expectation), rint_draws=False, thetas inside and outside
    the box.  Outside: -inf on both sides.  Inside, the corrected
    likelihood to 1e-5 of its term scale sum|obs log(rate)| + sum(rate);
    the faithful one, a sawtooth in the model, bin by bin where
    floor(model) agrees, within the change of its smooth part plus 1e-6 of
    its terms' magnitudes."""
    from scipy.special import gammaln
    thetas = _thetas(seed=2, outside=2)
    jspec, tspec = _specs("expected", bg_mode="expected", rint_draws=False)
    lp_j, spec_j = _jax_logp_and_spectra(jspec, likelihood, observed, thetas)
    lp_t, spec_t, windows = _port_logp_and_spectra(tspec, likelihood,
                                                   observed, thetas)
    assert np.all(np.isneginf(lp_t[-2:])) and np.all(np.isneginf(lp_j[-2:]))
    assert np.all(np.isfinite(lp_t[:-2])) and np.all(np.isfinite(lp_j[:-2]))
    _assert_spectra_close(spec_t[:-1], [s[:-1] for s in spec_j], windows)
    inside = slice(0, -2)
    if likelihood == "poisson":
        scale = sum(np.sum(np.abs(o * np.log(np.maximum(s, 1e-3))) + s, -1)
                    for o, s in zip(observed, spec_j))
        assert np.all(np.abs(lp_t[inside] - lp_j[inside])
                      <= 1e-5 * scale[inside]), (lp_t, lp_j)
        return
    from mcmctoffitting_tpu.ops import likelihoods as jlike
    from mcmctoffitting_tpu_torch.ops import likelihoods as tlike
    for r, win in enumerate(windows):
        got, want = spec_t[inside, r, :win.n_bins], spec_j[r][inside]
        obs = observed[r].astype(np.float32)
        terms_t = tlike.poisson_binned_terms(torch.as_tensor(got),
                                             torch.as_tensor(obs)).numpy()
        terms_j = np.asarray(jlike.poisson_binned_terms(jnp.asarray(want),
                                                        jnp.asarray(obs)))
        same = np.floor(got) == np.floor(want)
        assert same.mean() > 0.9
        obs_c = np.where(obs == 0, 1.0, obs)
        parts = obs_c * (obs_c + gammaln(np.floor(np.maximum(want, 1.0))
                                         + 1.0)
                         + np.abs(want * np.log(obs_c)))
        bound = (1.01 * np.abs(obs_c * np.log(obs_c) * (got - want))
                 + 1e-6 * parts)
        assert not (same & (np.abs(terms_t - terms_j) > bound)).any(), r


def test_log_prob_deterministic_with_rint(observed):
    """The same with rint_draws=True (the preset): spectra to 1e-3
    relative L1 per walker and run."""
    thetas = _thetas(seed=3)
    jspec, tspec = _specs("expected", bg_mode="expected")
    _, spec_j = _jax_logp_and_spectra(jspec, "poisson", observed, thetas)
    lp_t, spec_t, windows = _port_logp_and_spectra(tspec, "poisson",
                                                   observed, thetas)
    assert np.all(np.isfinite(lp_t))
    for r, win in enumerate(windows):
        got, want = spec_t[:, r, :win.n_bins], spec_j[r]
        rel_l1 = np.abs(got - want).sum(-1) / np.abs(want).sum(-1)
        assert np.all(rel_l1 < 1e-3), (r, rel_l1)


# --- (d) counts with injected draws ---------------------------------------------

def _cell_counts(lam, cells):
    return lam * (1.0 + 0.5 * ((cells % 3) - 1.0) * lam / (1.0 + lam))


def _bg_draws(lam, bins):
    return lam + 3.0 * ((bins % 4) - 1.5)


@pytest.mark.parametrize("a_dtype", ["float32", "bfloat16"])
def test_counts_with_injected_counts_and_background(observed, monkeypatch,
                                                    a_dtype):
    """Both packages' Poisson stage returns the same smooth function of
    its rates, one for the (F + 2) cell rates and another for the
    background's per-bin rates, so everything from the draws on is held:
    the port draws the cells once per walker for all runs (``n_runs``) and
    the background in one call on (W, R, n_pad) rates.  Tolerances of
    test_expected_spectra; also with the bfloat16 A operator."""
    def jax_poisson(key, lam):
        n = lam.shape[-1]
        idx = jnp.arange(n, dtype=lam.dtype)
        return _cell_counts(lam, idx) if n == N_FINE + 2 else _bg_draws(
            lam, idx)

    calls = []

    def port_poisson(lam, seed, n_runs=None, **counters):
        calls.append((tuple(lam.shape), n_runs))
        idx = torch.arange(lam.shape[-1], dtype=lam.dtype)
        if n_runs is None:
            return _bg_draws(lam, idx)
        return _cell_counts(lam, idx)[:, None].expand(-1, n_runs, -1)

    monkeypatch.setattr(jpoisson, "poisson_auto", jax_poisson)
    monkeypatch.setattr(tforward, "poisson", port_poisson)
    thetas = _thetas(seed=4)
    jspec, tspec = _specs("counts", rint_draws=False, a_dtype=a_dtype)
    lp_j, spec_j = _jax_logp_and_spectra(jspec, "poisson", observed, thetas)
    calls.clear()
    lp_t, spec_t, windows = _port_logp_and_spectra(tspec, "poisson",
                                                   observed, thetas)
    assert calls[:2] == [((8, N_FINE + 2), N_RUNS), ((8, N_RUNS, 25), None)]
    _assert_spectra_close(spec_t, spec_j, windows)
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(s, 1e-3))) + s, -1)
                for o, s in zip(observed, spec_j))
    assert np.all(np.isfinite(lp_t))
    assert np.all(np.abs(lp_t - lp_j) <= 1e-5 * scale), (lp_t, lp_j)


def test_background_seed_is_drawn_after_the_grid_seed():
    """Two words of the host generator seed the cell counts, the next two
    the background; without a background the second pair is not drawn."""
    _, tspec = _specs("counts")
    fwd = tonebd.OneBDProblem(tspec, device="cpu").forward
    t = torch.as_tensor(_thetas(2, seed=5))
    params = torch.cat([torch.full((2, 1), 2490.0), t[:, :3]], dim=1)
    seeds = []
    real = tforward.poisson

    def spy(lam, seed, n_runs=None, **counters):
        seeds.append(seed)
        return real(lam, seed, n_runs=n_runs, **counters)

    tforward.poisson, keep = spy, tforward.poisson
    try:
        gen = torch.Generator().manual_seed(11)
        fwd(params, t[:, 3:6], gen, t[:, 6:9])
        after_bg = torch.randint(0, 1 << 32, (1,), generator=gen).item()
        gen = torch.Generator().manual_seed(11)
        fwd(params, t[:, 3:6], gen, None)
        after_none = torch.randint(0, 1 << 32, (1,), generator=gen).item()
    finally:
        tforward.poisson = keep
    words = torch.randint(0, 1 << 32, (5,), dtype=torch.int64,
                          generator=torch.Generator().manual_seed(11))
    assert seeds[0] == (int(words[0]), int(words[1])) == seeds[2]
    assert seeds[1] == (int(words[2]), int(words[3]))
    assert len(seeds) == 3
    assert after_bg == int(words[4]) and after_none == int(words[2])


# --- (e) the preset and the problem ---------------------------------------------

@pytest.mark.parametrize("n_samples", [200_000, 50_000])
@pytest.mark.parametrize("sampling", ["mc", "counts", "expected"])
@pytest.mark.parametrize("hardcore", [False, True])
def test_default_spec_matches_the_jax_preset(hardcore, sampling, n_samples,
                                             monkeypatch):
    """Field by field for every (hardcore, sampling, n_samples); the
    operator build (131 MB at hardcore counts) is replaced by a marker on
    both sides."""
    monkeypatch.setattr(je0grid, "cached_e0_grid_table",
                        lambda *a: ("operator",) + a[3:])
    monkeypatch.setattr(tonebd, "cached_e0_grid_table",
                        lambda *a: ("operator",) + a[3:])
    kw = dict(hardcore=hardcore, sampling=sampling)
    tspec = tonebd.default_spec(n_samples, **kw)
    jspec = jonebd.default_spec(n_samples, **kw)
    assert_same_spec(tspec, jspec)
    assert tspec.e0_grid_table == jspec.e0_grid_table
    assert tspec.a_dtype == ("bfloat16" if hardcore and sampling == "counts"
                             else "float32")
    assert (tspec.ed_binning.n, tspec.x_binning.n) == (
        (400, 20) if hardcore else (100, 10))
    for xs_mode in ("taylor", "exact"):
        got = tonebd.default_spec(n_samples, xs_mode=xs_mode, **kw)
        want = jonebd.default_spec(n_samples, xs_mode=xs_mode, **kw)
        assert_same_spec(got, want)
    assert tonebd.default_spec(n_samples, fine_grid=96,
                               **kw).e0_grid_fine == 96


def test_problem_layout_bounds_and_guesses(observed):
    jspec, tspec = _specs("expected")
    jprob = jonebd.OneBDProblem(jspec)
    tprob = tonebd.OneBDProblem(tspec, device="cpu")
    assert tprob.n_dim == jprob.n_dim == 9 and tprob.n_runs == 3
    assert tprob.standoffs == jprob.standoffs
    assert [(w.lo, w.hi, w.n_bins) for w in tprob.windows] == [
        (w.lo, w.hi, w.n_bins) for w in jprob.windows]
    np.testing.assert_array_equal(tprob.param_lo, jprob.param_lo)
    np.testing.assert_array_equal(tprob.param_hi, jprob.param_hi)
    np.testing.assert_array_equal(tprob.guess_theta(observed),
                                  jprob.guess_theta(observed))
    np.testing.assert_array_equal(
        tprob.guess_theta(observed, (800.0, 90.0, 0.4), 5.0),
        jprob.guess_theta(observed, (800.0, 90.0, 0.4), 5.0))
    t = torch.as_tensor(_thetas(3))
    np.testing.assert_array_equal(
        tprob.shared_params(t).numpy(),
        np.stack([np.asarray(jprob.shared_params(jnp.asarray(row)))
                  for row in t.numpy()]))
    params, scales, bg = tprob.split_theta(t)
    assert torch.equal(scales, t[:, 3:6]) and torch.equal(bg, t[:, 6:9])
    assert torch.all(params[:, 0] == 2490.0)


def test_initial_walkers(observed):
    """guess + agitators * randn, clipped 1e-3 inside the box: the ball's
    centre and widths are the JAX package's (50, 10, 0.05, 0.15 N, 2)."""
    _, tspec = _specs("expected")
    tprob = tonebd.OneBDProblem(tspec, device="cpu")
    p0 = tprob.initial_walkers_from_observed(
        torch.Generator().manual_seed(0), 4000, observed).numpy()
    assert p0.shape == (4000, 9) and p0.dtype == np.float32
    guess = tprob.guess_theta(observed)
    widths = np.concatenate([[50.0, 10.0, 0.05], 0.15 * guess[3:6],
                             [2.0, 2.0, 2.0]])
    np.testing.assert_array_equal(tprob.agitators(guess), widths)
    assert np.all(p0 >= tprob.param_lo + 1e-3 - 1e-6)
    assert np.all(p0 <= tprob.param_hi - 1e-3 + 1e-3)
    z = (p0.mean(0) - guess) / (widths / np.sqrt(4000))
    assert np.all(np.abs(z) < 5), z
    np.testing.assert_allclose(p0.std(0), widths, rtol=0.08)
    # a guess whose ball leaves the box is clipped
    clipped = tprob.initial_walkers_from_observed(
        torch.Generator().manual_seed(0), 500, observed, (700.0, 100.0, 0.5),
        1.0).numpy()
    assert clipped[:, 6:].min() == np.float32(1e-3)


# --- (f) background, presets on the CPU, short fits -----------------------------

def test_background_in_distribution():
    """'poisson': per-bin draws with the level's mean and variance
    (z-scores within 5) at levels below and above the sampler's switch at
    10, 0 at level 0 and below, 0 on the padding bins; 'expected': the
    level itself."""
    _, tspec = _specs("counts")
    windows = (tonebd.tof_windows_onebd.close,
               dataclasses.replace(tonebd.tof_windows_onebd.mid, hi=180.0,
                                   n_bins=20), tonebd.tof_windows_onebd.far)
    fwd = tforward.TofForward(tspec, (351.3, 412.3, 444.5), windows,
                              device="cpu")
    levels = torch.tensor([0.0, 0.5, 9.9, 10.0, 30.0, 1000.0, -3.0])
    n = 600
    bg_levels = levels[None, :, None].expand(n, -1, 3).reshape(-1, 3)
    draws = fwd.background(bg_levels, torch.Generator().manual_seed(3))
    assert draws.shape == (n * 7, 3, 25)
    assert torch.all(draws == torch.floor(draws)) and torch.all(draws >= 0)
    assert torch.all(draws[:, 1, 20:] == 0)
    draws = draws.reshape(n, 7, 3, 25).double()
    real = torch.cat([draws[:, :, 0], draws[:, :, 1, :20], draws[:, :, 2]],
                     dim=-1)                                 # (n, 7, 70)
    assert torch.all(real[:, 0] == 0) and torch.all(real[:, 6] == 0)
    for k, lam in enumerate(levels.tolist()[1:6], start=1):
        x = real[:, k].reshape(-1)
        m = x.numel()
        z_mean = (x.mean() - lam) / np.sqrt(lam / m)
        z_var = (x.var() - lam) / np.sqrt((lam + 2 * lam * lam) / m)
        assert abs(z_mean) < 5 and abs(z_var) < 5, (lam, z_mean, z_var)
    another = fwd.background(bg_levels, torch.Generator().manual_seed(4))
    assert not torch.equal(another.reshape(n, 7, 3, 25).double(), draws)
    det = tforward.TofForward(
        dataclasses.replace(tspec, bg_mode="expected"),
        (351.3, 412.3, 444.5), windows, device="cpu")
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    flat = det.background(bg_levels[:7], gen)
    assert torch.equal(gen.get_state(), state)
    assert torch.equal(flat[:, 0], bg_levels[:7, :1].expand(-1, 25))
    assert torch.all(flat[:, 1, 20:] == 0)


@pytest.mark.parametrize("sampling", ["mc", "counts", "expected"])
@pytest.mark.parametrize("hardcore", [False, True])
@pytest.mark.parametrize("likelihood", ["reference", "poisson"])
def test_every_preset_runs_on_the_cpu(hardcore, sampling, likelihood):
    """Each (hardcore, sampling) preset (its operator cut to F = 64, 2048
    draws) builds a problem whose log_prob runs: finite at the truth under
    the corrected likelihood, -inf outside the box, and the model spectra
    are as wide as the windows."""
    spec = tonebd.default_spec(2048, fine_grid=N_FINE, hardcore=hardcore,
                               sampling=sampling)
    problem = tonebd.OneBDProblem(spec, likelihood=likelihood, device="cpu")
    obs = tdata_io.synthesize_observed(1, problem, TRUTH)
    assert [o.shape for o in obs] == [(25,)] * 3
    # scale x a density that sums to 1 / 4 ns, plus 25 bins of background
    assert all(abs(o.sum() - (5e4 / 4 + 25 * 20)) < 1200 for o in obs)
    thetas = torch.as_tensor(np.stack([TRUTH, TRUTH]).astype(np.float32))
    thetas[1, 7] = 1.0e3 + 1.0
    lp = problem.make_log_prob_fn(obs)(thetas,
                                       torch.Generator().manual_seed(2))
    assert lp.shape == (2,) and torch.isneginf(lp[1])
    assert not torch.isnan(lp[0])
    if likelihood == "poisson":
        assert torch.isfinite(lp[0])
    spectra = problem.run_spectra(thetas, torch.Generator().manual_seed(2))
    assert spectra.shape == (2, 3, 25)
    assert torch.all(torch.isfinite(spectra))


@pytest.mark.parametrize("sampling", ["mc", "counts", "expected"])
def test_short_de_fit_on_cpu(sampling):
    spec = tonebd.default_spec(4096, fine_grid=N_FINE, sampling=sampling)
    problem = tonebd.OneBDProblem(spec, likelihood="poisson", device="cpu")
    obs = tdata_io.synthesize_observed(0, problem, TRUTH)
    logp = problem.make_log_prob_fn(obs)
    gen = torch.Generator().manual_seed(1)
    p0 = problem.initial_walkers_from_observed(gen, 16, obs)
    eval_gen = torch.Generator().manual_seed(2)
    assert torch.all(torch.isfinite(logp(p0, eval_gen)))
    state = sampler.init_state(p0, logp, generator=gen,
                               eval_generator=eval_gen)
    chain = sampler.run_mcmc(state, 8, logp, move="de")
    assert chain.positions.shape == (8, 16, 9)
    assert torch.all(torch.isfinite(chain.log_probs))
    acc = chain.acceptance_fraction.float().mean().item()
    assert 0.0 < acc < 1.0


STAGE_CONFIGS = [
    dict(model="onebd", sampling="counts"),
    dict(model="onebd", sampling="counts", hardcore=True),
    dict(model="onebd", sampling="mc"),
    dict(model="onebd", sampling="expected"),
    dict(model="onebd", sampling="mc", xs_mode="exact"),
    dict(model="simult", sampling="mc"),
    dict(model="simult", sampling="mc", xs_mode="taylor"),
    dict(model="simult", sampling="mc", transport="rk4", xs_mode="taylor"),
    dict(model="simult", sampling="expected"),
    dict(model="simult", sampling="counts"),
]


def _stage_problem(model, sampling, hardcore=False, transport="table",
                   xs_mode="e0grid"):
    """(problem, truth) of a preset on the CPU: 2,048 draws, F = N_FINE,
    the corrected likelihood; simultFit with 4 runs at the campaign's
    guess and N = 5e4 a run, oneBD at its synthesis truth."""
    if model == "onebd":
        spec = tonebd.default_spec(2048, fine_grid=N_FINE, hardcore=hardcore,
                                   xs_mode=xs_mode, sampling=sampling)
        return (tonebd.OneBDProblem(spec, likelihood="poisson",
                                    device="cpu"), TRUTH)
    spec = tsimult.default_spec(2048, fine_grid=N_FINE, transport=transport,
                                xs_mode=xs_mode, sampling=sampling)
    truth = np.concatenate([tsimult.GUESS_SHARED, np.full(4, 5.0e4)])
    return (tsimult.SimultFitProblem(spec, n_runs=4, likelihood="poisson",
                                     device="cpu"), truth)


def _stage_spans(spec, background: bool) -> list:
    """The stage spans of one log-prob evaluation, in the forward's
    order."""
    grid = {"counts": ["rates", "k1_cells", "moments", "contract"],
            "expected": ["expected"],
            "mc": ["beam_draw", "energy_grid"]}[spec.sampling]
    names = (["prior"] + grid + ["lattice"]
             + (["background"] if background else [])
             + ["k2", "shape", "likelihood"])
    return ["mcmctof." + n for n in names]


def _energy_grid_spans(spec) -> list:
    """The spans inside ``mcmctof.energy_grid``, in order: the fine-cell
    moments and the A contraction on 'e0grid'; K4 on the ODE path and the
    Taylor contraction on 'taylor'."""
    if spec.sampling != "mc" or spec.xs_mode == "exact":
        return []
    if spec.xs_mode == "e0grid":
        names = ["fine_moments", "contract"]
    else:
        names = (["k4"] if spec.transport == "rk4" else []) + ["taylor"]
    return ["mcmctof." + n for n in names]


@pytest.mark.parametrize("config", STAGE_CONFIGS, ids=lambda c: "-".join(
    str(v) for v in c.values()))
def test_stage_split_composes_to_the_log_prob(config, monkeypatch):
    """The stage spans of real ``problem.log_prob`` calls: with the spans
    on, the log-prob is the one with them off, bit for bit, and each stage
    span of the configuration runs once an evaluation, inside
    ``mcmctof.logp``, in the forward's order."""
    from mcmctoffitting_tpu_torch.utils import profiling
    problem, truth = _stage_problem(**config)
    obs_arrays = tdata_io.synthesize_observed(2, problem, truth)
    obs = problem.observed_runs(obs_arrays)
    p0 = problem.initial_walkers_from_observed(
        torch.Generator().manual_seed(1), 4, obs_arrays)
    want = problem.log_prob(p0, torch.Generator().manual_seed(5), obs)
    with profiling.spans() as rec:
        got = problem.log_prob(p0, torch.Generator().manual_seed(5), obs)
        problem.log_prob(p0, torch.Generator().manual_seed(6), obs)
    assert torch.equal(got, want) and torch.all(torch.isfinite(want))
    expect = _stage_spans(problem.spec, config["model"] == "onebd")
    if config["model"] == "onebd":
        assert "mcmctof.background" in expect
    inner = _energy_grid_spans(problem.spec)
    at = expect.index("mcmctof.energy_grid") + 1 if inner else 0
    by_start = sorted(rec.records, key=lambda r: r.start_ns)
    stages_of = [r.name for r in by_start if r.name != "mcmctof.logp"]
    assert stages_of == (expect[:at] + inner + expect[at:]) * 2
    summary = rec.summary()
    assert summary["mcmctof.logp"]["calls"] == 2
    assert all(summary[n]["calls"] == 2 for n in expect + inner)
    assert {summary[n]["parent"] for n in expect} == {"mcmctof.logp"}
    assert all(summary[n]["parent"] == "mcmctof.energy_grid" for n in inner)
    stages_ms = sum(summary[n]["total_ms"] for n in expect)
    assert stages_ms <= summary["mcmctof.logp"]["total_ms"]


@pytest.mark.parametrize("config", [c for c in STAGE_CONFIGS
                                    if c.get("xs_mode", "e0grid") == "e0grid"
                                    and not c.get("hardcore")],
                         ids=lambda c: "-".join(str(v) for v in c.values()))
def test_fine_cell_moments_counts_the_mc_table_evaluations(config):
    """``fine_cell_moments.calls``: one call an mc evaluation on the
    e0grid operator, none on the counts and expected estimators, which
    take their moments in closed form."""
    problem, truth = _stage_problem(**config)
    obs_arrays = tdata_io.synthesize_observed(2, problem, truth)
    obs = problem.observed_runs(obs_arrays)
    p0 = problem.initial_walkers_from_observed(
        torch.Generator().manual_seed(1), 4, obs_arrays)
    before = te0grid.fine_cell_moments.calls
    lp = problem.log_prob(p0, torch.Generator().manual_seed(5), obs)
    assert torch.all(torch.isfinite(lp))
    calls = te0grid.fine_cell_moments.calls - before
    assert calls == (1 if config["sampling"] == "mc" else 0)
