"""The port's template unfolding model against the JAX package's, on the
CPU at a small size.

* Template generation: the same uniform initial energies (numpy-seeded)
  through the JAX package's own pieces (``energy_weight_grid``,
  ``cell_tof_lattice``, ``weighted_histogram``, ``histogram_density``,
  the beam-timing spreading: ``template_spectrum``'s body) and through the
  port's batched core, within 1e-5 relative L1 per (slice, run).  The JAX
  side transports with the closed-form dE/dx of kernel K4 (the port's
  transport; ``tests/test_torch_transport.py`` holds it against the full
  Bethe formula).  A reduced grid (10 x 30) keeps the JAX compile short;
  the production grid (100 x 150) runs through ``generate_templates``.
* The CSV cache written by each package and read by the other.
* ``TemplateFitProblem.log_prob`` on the same templates and 16 thetas,
  within 1e-5 relative; the prior's edges; ``build_model_tof``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmctoffitting_tpu.ops.pallas_forward as jpallas_forward
from mcmctoffitting_tpu.config import Binning as JBinning
from mcmctoffitting_tpu.models import forward as jforward
from mcmctoffitting_tpu.models import templates as jT
from mcmctoffitting_tpu.ops import histogram as jhist
from mcmctoffitting_tpu.ops import stopping as jstopping
from mcmctoffitting_tpu_torch.config import Binning
from mcmctoffitting_tpu_torch.models import templates as tT

torch.set_num_threads(1)

N = 3000


def _small(spec, binning_cls):
    return dataclasses.replace(
        spec, ed_binning=binning_cls(200.0, 1700.0, 30),
        x_binning=binning_cls(0.0, spec.geometry.cell_length, 10),
        n_samples=N)


def _closed_form_rk4(monkeypatch):
    a, p, q = jpallas_forward.bethe_closed_form_constants(
        jstopping.d2_gas_stopping(rho=8.565e-5))
    rk4 = jstopping.rk4_transport

    def closed_form(dedx_fn, e0, x_eval, n_substeps=4):
        return rk4(lambda e: -(a / e) * (p + q * jnp.log(e)), e0, x_eval,
                   n_substeps=n_substeps)

    monkeypatch.setattr(jforward, "rk4_transport", closed_form)


def test_templates_match_the_jax_package(monkeypatch):
    """Two slices in each of the four runs, the same energies on both
    sides."""
    _closed_form_rk4(monkeypatch)
    jspec = _small(jT.default_spec(), JBinning)
    tspec = _small(tT.default_spec(), Binning)
    slices = (3, 17)
    rng = np.random.default_rng(0)
    lo = jT.TEMPLATE_BOUNDS[list(slices)].astype(np.float32)
    hi = jT.TEMPLATE_BOUNDS[[s + 1 for s in slices]].astype(np.float32)
    e0 = (lo[:, None, None] + rng.uniform(0.0, 1.0, (2, 4, N))
          * (hi - lo)[:, None, None]).astype(np.float32)
    fwd = tT.template_forward(tspec, device="cpu")
    got = tT.templates_from_energies(fwd, torch.as_tensor(e0),
                                     torch.as_tensor(lo)).numpy()

    def jax_template(e, e_lo, standoff, window):
        grid = jforward.energy_weight_grid(jspec, e)
        area = jspec.ed_binning.width * jspec.x_binning.width
        draws = jnp.rint(grid / (jnp.sum(grid) * area) * jspec.n_samples)
        base = jforward.cell_tof_lattice(jspec, standoff, e_lo)
        hist = jhist.weighted_histogram(base.reshape(-1), window.lo,
                                        window.hi, window.n_bins,
                                        draws.reshape(-1))
        pdf = jhist.histogram_density(hist, window.lo, window.hi)
        return jspec.beam_timing.apply_spreading(pdf)

    for r, name in enumerate(jT.RUN_LAYOUT):
        standoff = jspec.geometry.standoff(name)
        window = jT.tof_windows[name]
        fn = jax.jit(lambda e, e_lo: jax_template(e, e_lo, standoff,
                                                  window))
        for s in range(2):
            want = np.asarray(fn(jnp.asarray(e0[s, r]), jnp.float32(lo[s])))
            row = got[s, r, :window.n_bins]
            assert np.all(got[s, r, window.n_bins:] == 0)
            l1 = np.abs(row - want).sum() / np.abs(want).sum()
            assert l1 < 1e-5, (name, s, l1)


def test_template_spectrum_properties():
    """One template (the JAX package's ``test_template_spectrum_properties``
    counterpart): finite, non-negative, a density of its window up to the
    timing convolution's edges; a higher-energy slice arrives earlier."""
    spec = _small(tT.default_spec(), Binning)
    win = tT.tof_windows["mid"]
    standoff = spec.geometry.standoff("mid")
    means = []
    for e_lo, e_hi in ((500.0, 525.0), (1000.0, 1025.0)):
        t = tT.template_spectrum(torch.Generator().manual_seed(2), e_lo,
                                 e_hi, spec, standoff, win,
                                 device="cpu").numpy()
        assert t.shape == (win.n_bins,) and np.isfinite(t).all()
        assert (t >= -1e-7).all()
        area = t.sum() * (win.hi - win.lo) / win.n_bins
        assert 0.9 < area < 1.0 + 1e-5
        means.append((t * np.arange(win.n_bins)).sum() / t.sum())
    assert means[1] < means[0]


def test_generate_templates_at_the_production_grid():
    """generate_templates on the 100 x 150 grid (the port's one batched
    forward; a small draw count): 4 runs of (32, n_bins), finite,
    non-negative, each a density of its window up to the timing
    convolution's edge losses; a later slice arrives earlier."""
    spec = tT.default_spec(n_samples=400)
    out = tT.generate_templates(torch.Generator().manual_seed(1), spec,
                                device="cpu")
    windows = tT.TemplateFitProblem(device="cpu").windows
    assert [t.shape for t in out] == [(32, w.n_bins) for w in windows]
    for t, w in zip(out, windows):
        assert np.isfinite(t).all() and (t >= -1e-7).all()
        widths = (w.hi - w.lo) / w.n_bins
        area = t.sum(-1) * widths
        assert np.all((area > 0.9) & (area < 1.0 + 1e-5)), area
    bins = np.arange(out[0].shape[1])
    mean_bin = (out[0] * bins).sum(-1) / out[0].sum(-1)
    assert mean_bin[2] > mean_bin[25]


def test_csv_cache_read_by_the_other_package(tmp_path):
    rng = np.random.default_rng(2)
    tmpl = [rng.random((32, 50)) * 1e-3, rng.random((32, 45)),
            rng.random((32, 45)) * 3.0, rng.random((32, 60))]
    a, b = str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")
    tT.save_templates_csv(a, tmpl)
    jT.save_templates_csv(b, tmpl)
    assert open(a).read() == open(b).read()
    for got, want in zip(jT.load_templates_csv(a, 4), tmpl):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(tT.load_templates_csv(b, 4), tmpl):
        np.testing.assert_array_equal(got, want)


def _problem_inputs(seed=3, w=16):
    rng = np.random.default_rng(seed)
    windows = jT.TemplateFitProblem().windows
    templates = [(rng.random((32, win.n_bins)) * 40).astype(np.float32)
                 for win in windows]
    coeffs = tT.TemplateFitProblem(device="cpu").initial_guess_model()
    observed = [rng.poisson(np.maximum(
        s * coeffs @ t, 0.0)).astype(np.float64)
        for s, t in zip((1.0, 1.1, 0.6, 1.5), templates)]
    guess = np.concatenate([[1.1, 0.6, 1.5], coeffs])
    thetas = (guess * (0.9 + 0.2 * rng.random((w, 35)))).astype(np.float32)
    thetas[:, 3:] = np.minimum(thetas[:, 3:], 24_000.0)
    thetas[1, 1] = 1.2           # run 3's scale above its limit
    thetas[2, 7] = -1.0          # a negative coefficient
    thetas[3, 0] = 0.8           # on a closed edge: inside
    return templates, observed, thetas


def test_log_prob_matches_the_jax_package():
    templates, observed, thetas = _problem_inputs()
    jlogp = jT.TemplateFitProblem(n_runs=4).make_log_prob_fn(observed,
                                                             templates)
    want = np.array([float(jlogp(jnp.asarray(t), jax.random.PRNGKey(0)))
                     for t in thetas])
    tlogp = tT.TemplateFitProblem(device="cpu").make_log_prob_fn(observed,
                                                                 templates)
    got = tlogp(torch.as_tensor(thetas), None).numpy()
    assert np.isneginf(want[[1, 2]]).all() and np.isneginf(got[[1, 2]]).all()
    fin = np.isfinite(want)
    assert fin.sum() == 14 and np.array_equal(fin, np.isfinite(got))
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5)


def test_build_model_tof_and_guess():
    rng = np.random.default_rng(4)
    tmpl = rng.random((32, 50)).astype(np.float32)
    coeffs = rng.random((3, 32)).astype(np.float32)
    got = tT.build_model_tof(2.0, torch.as_tensor(coeffs),
                             torch.as_tensor(tmpl)).numpy()
    for c, g in zip(coeffs, got):
        np.testing.assert_allclose(
            g, np.asarray(jT.build_model_tof(2.0, c, tmpl)), rtol=1e-5)
    np.testing.assert_array_equal(
        tT.TemplateFitProblem(device="cpu").initial_guess_model(),
        jT.TemplateFitProblem().initial_guess_model())
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="CUDA GPU"):
            tT.TemplateFitProblem()
    finally:
        monkey.undo()


def test_slsqp_template_ml_fit_holds_its_bounds_and_start():
    """The port's counterpart of the JAX package's
    ``tests/test_optimize_seed.py::test_slsqp_template_ml_fit_recovers_scales``
    (start at scales (1, 1, 1) and 1.3 x the guess coefficients, noise-free
    data at scales (1.2, 0.7, 1.4)).  In both packages bounded SLSQP stops
    at (the box's projection of) its start point: the ``model < 1`` clamp
    of the template likelihood flattens the objective there (ROADMAP
    Queue 3, a fault of the reference's model that the port shares).
    What holds is asserted: the result is inside the bounds and no worse
    than its start."""
    from mcmctoffitting_tpu_torch.utils.optimize import minimize_nll
    spec = tT.default_spec(n_samples=1000)
    problem = tT.TemplateFitProblem(n_runs=4, device="cpu")
    templates = tT.generate_templates(torch.Generator().manual_seed(0), spec,
                                      device="cpu")
    coeffs = problem.initial_guess_model()
    observed = [s * coeffs @ t for s, t in zip((1.0, 1.2, 0.7, 1.4),
                                               templates)]
    logp = problem.make_log_prob_fn(observed, templates)
    lo = np.concatenate([[lim[0] for lim in tT.SCALE_LIMS], np.zeros(32)])
    hi = np.concatenate([[lim[1] for lim in tT.SCALE_LIMS],
                         np.full(32, tT.COEFF_LIM[1])])
    start = np.clip(np.concatenate([[1.0, 1.0, 1.0], coeffs * 1.3]), lo, hi)

    def nll(x):
        return -float(logp(torch.as_tensor(x[None], dtype=torch.float32),
                           None)[0])

    res = minimize_nll(lambda th, g: logp(th[None], g)[0], start,
                       method="SLSQP", bounds=list(zip(lo, hi)),
                       maxiter=200, device="cpu")
    assert np.all(res.x >= lo) and np.all(res.x <= hi)
    assert np.isfinite(res.fun) and res.fun <= nll(start)
