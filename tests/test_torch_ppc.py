"""The posterior-predictive slice of the port (mcmctoffitting_tpu_torch:
``models/forward.py::tof_spectrum``, ``JointFitProblem.run_spectrum``,
``utils/ppc.py``) against the JAX package, on the CPU at a small size
(<= 8k draws, F = 64, <= 8 PPC draws, 2 simultFit runs).

(a) Deterministic cores, the same numpy inputs on both sides:
    ``tof_spectrum`` / ``run_spectrum`` on 'expected' (oneBD with the
    background's expectation), density-normalised or not, and the mc core
    with the same initial energies injected (weight grid, lattice draws,
    spectrum), rint off, rtol 1e-5 plus 1e-5 of each run's peak; the
    transit-time core ``dtof_from_energies`` against ``_transport_all``
    and its cumulative sum, 1e-5 relative.
(b) The numpy helpers, exactly: ``percentile_bands``,
    ``collapse_neutron_spectrum``, ``rebin`` (equal arrays),
    ``make_sdef_sia_cumulative`` (equal strings), ``export_spectrum_csv``
    (equal bytes).
(c) ``PPCSampler``: the result's shapes against the JAX package's on one
    chain; the ``lnprob_cut`` filter and its error; with mc, the per-bin
    mean of each run's spectra within 3x the relative L1 between two JAX
    runs of other keys (the tolerance calibrates itself); the other
    estimators of the PPC (transit times, initial-energy samples) by
    shape and law.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from scipy.special import ndtr, ndtri

from mcmctoffitting_tpu.constants import masses as jmasses
from mcmctoffitting_tpu.constants import physics as jphysics
from mcmctoffitting_tpu.models import forward as jforward
from mcmctoffitting_tpu.models import onebd as jonebd
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.utils import ppc as jppc
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import onebd as tonebd
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.utils import ppc as tppc

torch.set_num_threads(1)

N_DRAWS, N_FINE, N_WALKERS = 4096, 64, 3
PRESETS = {
    "simult": (jsimult, tsimult, 2,
               np.array([1878.4, 850.0, 170.0, 0.5, 5e4, 4e4]),
               np.array([10.0, 50.0, 20.0, 0.1, 5e3, 4e3])),
    "onebd": (jonebd, tonebd, 3,
              np.array([1300.0, 80.0, 0.6, 5e4, 4e4, 3e4, 20.0, 10.0, 5.0]),
              np.array([50.0, 10.0, 0.05, 5e3, 4e3, 3e3, 2.0, 1.0, 1.0])),
}


def _thetas(model, n=N_WALKERS, seed=0):
    _, _, _, center, spread = PRESETS[model]
    rng = np.random.default_rng(seed)
    return (center + spread * rng.standard_normal((n, center.size))).astype(
        np.float32)


def _problems(model, **replace):
    """The JAX and port problems of one preset, rint off (and the oneBD
    background's expectation), ``replace`` on both specs."""
    jmod, tmod, n_runs, _, _ = PRESETS[model]
    fields = dict(rint_draws=False, bg_mode="expected", **replace)
    sampling = fields.pop("sampling", "mc")
    specs = [dataclasses.replace(
        mod.default_spec(N_DRAWS, fine_grid=N_FINE, sampling=sampling),
        **fields) for mod in (jmod, tmod)]
    jprob = (jsimult.SimultFitProblem(specs[0], n_runs=n_runs)
             if model == "simult" else jonebd.OneBDProblem(specs[0]))
    cls = (tsimult.SimultFitProblem if model == "simult"
           else tonebd.OneBDProblem)
    return jprob, cls(specs[1], n_runs, device="cpu")


def _beam(tprob, thetas):
    return tprob.shared_params(torch.as_tensor(thetas)).numpy()


def _e0_draws(params, seed, n_draws=N_DRAWS, truncated=True):
    """Initial energies (W, N) at each walker's (beamE, eLoss, scale, s),
    by inverse CDF in float64 (truncated to e0 > 0 or not)."""
    rng = np.random.default_rng(seed)
    beam_e, e_loss, scale, s = (params[:, k, None].astype(np.float64)
                                for k in range(4))
    u = rng.uniform(1e-12, 1.0, (params.shape[0], n_draws))
    cdf = ndtr(np.log((beam_e - e_loss) / scale) / s) if truncated else 1.0
    z = ndtri(u * cdf)
    return (beam_e - (e_loss + scale * np.exp(s * z))).astype(np.float32)


def _assert_spectra(got, want, of_peak=1e-5):
    """rtol 1e-5 plus ``of_peak`` of each row's peak."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    peak = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want)
                  <= 1e-5 * np.abs(want) + of_peak * peak), \
        np.abs(got - want).max() / peak.max()


def _jax_tof_spectrum(jprob, theta, run, get_pdf):
    """The JAX package's single-run spectrum with the grid and draws,
    at a (D,) theta (``run_spectrum``'s arguments, ``return_spectra``)."""
    if isinstance(jprob, jsimult.SimultFitProblem):
        params, scale, bg = theta[:4], theta[4 + run], None
    else:
        params = jprob.shared_params(theta)
        scale, bg = theta[3 + run], theta[3 + jprob.n_runs + run]
    return jforward.tof_spectrum(
        jax.random.PRNGKey(run), np.asarray(params, np.float32), jprob.spec,
        jprob.standoffs[run], jprob.windows[run], get_pdf=get_pdf,
        scale=scale, bg_level=bg, return_spectra=True)


def _port_tof_spectrum(tprob, thetas, run, get_pdf):
    params, scales, bg = tprob.split_theta(torch.as_tensor(thetas))
    return tforward.tof_spectrum(
        torch.Generator(), params, tprob.spec, tprob.standoffs[run],
        tprob.windows[run], get_pdf=get_pdf, scale=scales[:, run],
        bg_level=None if bg is None else bg[:, run], return_spectra=True,
        device="cpu")


# --- (a) deterministic cores -------------------------------------------------

@pytest.mark.parametrize("get_pdf", [True, False])
@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_expected_tof_spectrum_and_run_spectrum(model, get_pdf):
    """'expected' draws nothing: ``run_spectrum`` and ``tof_spectrum``
    against the JAX package's at the same thetas, every run.  The grid and
    draws that ``return_spectra`` adds: rtol 1e-5 plus 1e-4 of the grid's
    peak, since the float32 'expected' grid carries an error of ~1e-4 of
    its peak in every cell, on either package (ROADMAP Queue 3; 4.3e-5
    here), which the spectrum's sums over cells average out."""
    jprob, tprob = _problems(model, sampling="expected")
    thetas = _thetas(model, seed=1)
    for run in range(tprob.n_runs):
        got = tprob.run_spectrum(torch.Generator(), torch.as_tensor(thetas),
                                 run, get_pdf=get_pdf).numpy()
        want = np.stack([np.asarray(jprob.run_spectrum(
            jax.random.PRNGKey(0), t, run, get_pdf=get_pdf)) for t in thetas])
        _assert_spectra(got, want)
        spectrum, grid, draws = _port_tof_spectrum(tprob, thetas, run,
                                                   get_pdf)
        _assert_spectra(spectrum.numpy(), want)
        for w, theta in enumerate(thetas):
            _, jgrid, jdraws = _jax_tof_spectrum(jprob, theta, run, get_pdf)
            _assert_spectra(grid[w].numpy().ravel(),
                            np.asarray(jgrid).ravel(), of_peak=1e-4)
            _assert_spectra(draws[w].numpy().ravel(),
                            np.asarray(jdraws).ravel(), of_peak=1e-4)


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_mc_core_with_the_same_initial_energies(model, monkeypatch):
    """mc on the table (e0grid), the same initial energies injected into
    both packages' beam draw: the normalised grid, the lattice draws and
    the spectrum of every run, density-normalised and raw."""
    jprob, tprob = _problems(model)
    thetas = _thetas(model, seed=2)
    e0 = _e0_draws(_beam(tprob, thetas), 2,
                   truncated=tprob.spec.truncated)
    current = {}
    monkeypatch.setattr(jforward, "sample_beam_energies",
                        lambda key, spec, params, n=0: current["e0"])
    monkeypatch.setattr(tforward.TofForward, "sample_beam_energies",
                        lambda self, params, gen, **kw:
                        torch.as_tensor(e0)[:, None])
    for get_pdf in (True, False):
        for run in range(tprob.n_runs):
            spectrum, grid, draws = _port_tof_spectrum(tprob, thetas, run,
                                                       get_pdf)
            run_spec = tprob.run_spectrum(torch.Generator(),
                                          torch.as_tensor(thetas), run,
                                          get_pdf=get_pdf)
            for w, theta in enumerate(thetas):
                current["e0"] = e0[w]
                want = _jax_tof_spectrum(jprob, theta, run, get_pdf)
                _assert_spectra(spectrum[w].numpy(), np.asarray(want[0]))
                _assert_spectra(run_spec[w].numpy(), np.asarray(want[0]))
                _assert_spectra(grid[w].numpy().ravel(),
                                np.asarray(want[1]).ravel())
                _assert_spectra(draws[w].numpy().ravel(),
                                np.asarray(want[2]).ravel())


@pytest.mark.parametrize("model", ["simult", "onebd"])
def test_transit_time_core(model):
    """``dtof_from_energies`` against the JAX package's ``_transport_all``
    and its cumulative transit-time sum (``get_dtof_distribution``'s
    body), 1e-5 relative."""
    jprob, tprob = _problems(model)
    thetas = _thetas(model, seed=3)
    e0 = _e0_draws(_beam(tprob, thetas), 3, n_draws=1000,
                   truncated=tprob.spec.truncated)
    e_at_x, dtof = tppc.dtof_from_energies(tprob.forward, torch.as_tensor(e0))
    x = np.asarray(jprob.spec.x_binning.centers, np.float64)
    dx = np.diff(np.concatenate([[0.0], x]))
    for w in range(e0.shape[0]):
        je = jforward._transport_all(jprob.spec, e0[w])
        v = jphysics.speed_of_light * jax.numpy.sqrt(
            2.0 * je / jmasses.deuteron)
        jt = jax.numpy.cumsum(jax.numpy.asarray(dx, np.float32)[:, None] / v,
                              axis=0)
        np.testing.assert_allclose(e_at_x[w].numpy(), np.asarray(je),
                                   rtol=1e-5)
        np.testing.assert_allclose(dtof[w].numpy(), np.asarray(jt),
                                   rtol=1e-5)


# --- (b) the numpy helpers, exactly ------------------------------------------

def test_percentile_bands_equal():
    stacked = np.random.default_rng(1).normal(100, 10, (37, 50))
    for q in ((16, 50, 84), (2.5, 97.5)):
        np.testing.assert_array_equal(tppc.percentile_bands(stacked, q),
                                      jppc.percentile_bands(stacked, q))


def test_collapse_and_rebin_equal():
    grids = np.random.default_rng(2).uniform(0, 5, (6, 10, 50))
    np.testing.assert_array_equal(tppc.collapse_neutron_spectrum(grids),
                                  jppc.collapse_neutron_spectrum(grids))
    s = np.random.default_rng(3).uniform(0, 9, (2, 3, 17))
    for factor in (1, 2, 3, 5, 17):
        np.testing.assert_array_equal(tppc.rebin(s, factor),
                                      jppc.rebin(s, factor))


def test_sdef_card_equal_strings():
    spec = tsimult.default_spec(N_DRAWS, fine_grid=N_FINE)
    spectrum = np.random.default_rng(4).uniform(0, 1e4, spec.ed_binning.n)
    for number in (100, 7):
        got = tppc.make_sdef_sia_cumulative(spec.en_centers(), spectrum,
                                            number)
        want = jppc.make_sdef_sia_cumulative(
            jsimult.default_spec(N_DRAWS, fine_grid=N_FINE).en_centers(),
            spectrum, number)
        assert got == want


def test_export_spectrum_csv_equal_bytes(tmp_path):
    rng = np.random.default_rng(5)
    centers, spectrum = rng.uniform(0, 4e3, 30), rng.uniform(0, 1e4, 30)
    tppc.export_spectrum_csv(str(tmp_path / "t.csv"), centers, spectrum)
    jppc.export_spectrum_csv(str(tmp_path / "j.csv"), centers, spectrum)
    assert ((tmp_path / "t.csv").read_bytes()
            == (tmp_path / "j.csv").read_bytes())


# --- (c) PPCSampler ----------------------------------------------------------

def _chain(model, n_steps=20, n_walkers=8, seed=0):
    """A chain wandering near the preset's center, and its log-probs."""
    _, _, _, center, spread = PRESETS[model]
    rng = np.random.default_rng(seed)
    chain = center + 0.1 * spread * rng.standard_normal(
        (n_steps, n_walkers, center.size))
    probs = -1000.0 + rng.standard_normal((n_steps, n_walkers))
    return chain, probs


@pytest.fixture(scope="module")
def simult_runs():
    """A chain and its log-probs; the JAX package's PPC with two keys and
    the port's, 8 draws each, mc at 8k draws (the simultFit preset, F = 64,
    2 runs), of a chain that holds one theta: the spread of a mean of 8
    spectra is then the estimator's own, not that of 8 posterior draws."""
    chain, probs = _chain("simult")
    one_theta = np.broadcast_to(chain[:1, :1], chain.shape).copy()
    jspec = jsimult.default_spec(8000, fine_grid=N_FINE)
    tspec = tsimult.default_spec(8000, fine_grid=N_FINE)
    jprob = jsimult.SimultFitProblem(jspec, n_runs=2)
    tprob = tsimult.SimultFitProblem(tspec, n_runs=2, device="cpu")
    jax_runs = [jppc.PPCSampler(jprob, one_theta, probs).generate(
        jax.random.PRNGKey(k), 8) for k in (1, 2)]
    port = tppc.PPCSampler(tprob, one_theta, probs).generate(
        torch.Generator().manual_seed(3), 8)
    return chain, probs, tprob, jax_runs, port


def test_generate_shapes_match_jax(simult_runs):
    _, _, tprob, (jres, _), tres = simult_runs
    assert len(tres.tof_spectra) == len(jres.tof_spectra) == 2
    for got, want in zip(tres.tof_spectra, jres.tof_spectra):
        assert got.shape == want.shape and np.isfinite(got).all()
    assert tres.neutron_spectra.shape == jres.neutron_spectra.shape
    assert tres.thetas.shape == jres.thetas.shape
    assert all(s.dtype == np.float32 for s in tres.tof_spectra)
    # density-normalised spectra: sum x bin width = the run scale, less
    # what the timing convolution spills past the window's edges
    for run, (spectra, win) in enumerate(zip(tres.tof_spectra,
                                             tprob.windows)):
        width = (win.hi - win.lo) / win.n_bins
        mass = spectra.sum(-1) * width / tres.thetas[:, 4 + run]
        assert np.all((mass > 0.9) & (mass < 1.0 + 1e-5)), mass


def test_generate_mean_spectra_match_jax_in_distribution(simult_runs):
    """The per-bin mean of each run's 8 spectra and of the weight grids,
    port vs JAX, within 3x the relative L1 between the JAX package's two
    runs (other keys)."""
    _, _, _, (j1, j2), tres = simult_runs
    for run in range(2):
        a, b, t = (r.tof_spectra[run].mean(0) for r in (j1, j2, tres))
        calib = np.abs(a - b).sum() / np.abs(a).sum()
        got = np.abs(t - a).sum() / np.abs(a).sum()
        assert 0.0 < calib and got <= 3.0 * calib, (run, got, calib)
    a, b, t = (r.neutron_spectra.mean(0) for r in (j1, j2, tres))
    calib = np.abs(a - b).sum() / np.abs(a).sum()
    assert np.abs(t - a).sum() / np.abs(a).sum() <= 3.0 * calib


def test_lnprob_cut_filters_and_raises(simult_runs):
    chain, probs, tprob, _, _ = simult_runs
    probs = probs.copy()
    probs[:, :4] = -1e9          # half the walkers are terrible
    sampler = tppc.PPCSampler(tprob, chain, probs)
    thetas = sampler.draw_thetas(torch.Generator().manual_seed(2), 50,
                                 lnprob_cut=-2000.0)
    good = chain[-50:].reshape(-1, 6)[probs[-50:].reshape(-1) > -2000.0]
    assert thetas.shape == (50, 6)
    for th in thetas:
        assert (np.abs(good - th).sum(axis=1) < 1e-9).any()
    # without a cut the draws come from the whole tail, with replacement
    everything = sampler.draw_thetas(torch.Generator().manual_seed(2), 400)
    assert (everything[:, 4] < good[:, 4].min()).any() or \
        len(np.unique(everything, axis=0)) < 400
    with pytest.raises(ValueError, match="removed every sample"):
        sampler.draw_thetas(torch.Generator(), 5, lnprob_cut=0.0)
    with pytest.raises(ValueError, match="removed every sample"):
        sampler.generate(torch.Generator(), 2, lnprob_cut=0.0)


def test_transit_times_and_initial_energies_of_the_ppc(simult_runs):
    """``get_dtof_distribution`` and ``sample_initial_energy_dist``:
    the JAX package's shapes, transit times increasing along the cell, and
    the initial-energy histograms of the draws' beam law (mean energy
    within 3 standard errors of the lognormal's)."""
    chain, probs, tprob, _, _ = simult_runs
    sampler = tppc.PPCSampler(tprob, chain, probs)
    out = tppc.get_dtof_distribution(torch.Generator().manual_seed(4),
                                     sampler, n_draws=3, n_samples_per=500,
                                     n_tof_bins=20)
    assert out["e_at_x"].shape == out["dtof"].shape == (3, 10, 500)
    assert out["dtof_hist"].shape == (10, 20)
    assert out["thetas"].shape == (3, 6) and out["x_centers"].shape == (10,)
    assert np.all(np.diff(out["dtof"], axis=1) > 0)
    assert out["dtof_hist"].sum() == 3 * 10 * 500
    eb = tprob.spec.ed_binning
    hist = tppc.sample_initial_energy_dist(
        torch.Generator().manual_seed(5), sampler, n_samples=4,
        n_draws_per=4000)
    assert hist.shape == (4, eb.n) and np.all(hist.sum(-1) <= 4000)
    normed = tppc.sample_initial_energy_dist(
        torch.Generator().manual_seed(5), sampler, n_samples=4,
        n_draws_per=4000, normed=True)
    np.testing.assert_allclose(normed.sum(-1), 1.0, rtol=1e-12)
    thetas = sampler.draw_thetas(torch.Generator().manual_seed(5), 4)
    for row, theta in zip(hist, thetas):
        beam_e, e_loss, scale, s = theta[:4]
        # e0 = beamE - eLoss - scale * lognormal(s), truncated at e0 > 0
        rng = np.random.default_rng(0)
        z = rng.standard_normal(400_000)
        e = beam_e - e_loss - scale * np.exp(s * z)
        e = e[(e > 0) & (e >= eb.lo) & (e <= eb.hi)]
        mean = (row * eb.centers).sum() / row.sum()
        assert abs(mean - e.mean()) < 3 * e.std() / np.sqrt(row.sum()) \
            + eb.width, (mean, e.mean())
