"""The ported slice as a whole: simultFit in counts mode, stepped by the
ensemble sampler — the port (mcmctoffitting_tpu_torch) vs the JAX package
at a small size (F = 128 fine cells, 8000 draws, 4 runs).

(a) Deterministic parity: the Poisson counts are replaced by their rates
    on both sides, and the batched port log_prob is held against
    jax.vmap(problem.log_prob) on the JAX package's own observed arrays.
(b) Distributional parity of the corrected log-prob at one theta.
(c) A short DE fit on the CPU.
(d) The DE and stretch moves recover an analytic 4-D Gaussian.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln

import mcmctoffitting_tpu.ops.poisson as jpoisson
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.ops import likelihoods as jlike
from mcmctoffitting_tpu.utils import data_io as jdata_io
from mcmctoffitting_tpu_torch import sampler
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import likelihoods as tlike
from mcmctoffitting_tpu_torch.utils import data_io as tdata_io

torch.set_num_threads(1)

N_DRAWS, N_FINE, N_RUNS = 8000, 128, 4
TRUTH = np.concatenate([jsimult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])


def _spec(pkg, **kw):
    spec = pkg.default_spec(N_DRAWS, sampling="counts", fine_grid=N_FINE)
    return dataclasses.replace(spec, **kw)


@pytest.fixture(scope="module")
def jax_observed():
    problem = jsimult.SimultFitProblem(_spec(jsimult), n_runs=N_RUNS)
    return jdata_io.synthesize_observed(jax.random.PRNGKey(0), problem,
                                        TRUTH)


def _thetas(n=8, seed=0):
    rng = np.random.default_rng(seed)
    spread = np.concatenate([jsimult.AGITATORS_SHARED, 0.05 * TRUTH[4:]])
    return (TRUTH + spread * rng.standard_normal((n, TRUTH.size))).astype(
        np.float32)


def _jax_logp_and_spectra(spec, likelihood, observed, thetas, seed):
    problem = jsimult.SimultFitProblem(spec, n_runs=N_RUNS,
                                       likelihood=likelihood)
    logp = problem.make_log_prob_fn(observed)
    keys = jax.random.split(jax.random.PRNGKey(seed), thetas.shape[0])
    fn = jax.jit(jax.vmap(lambda t, k: (logp(t, k),
                                        problem.run_spectra(t, k))))
    lp, spectra = fn(jnp.asarray(thetas), keys)
    return np.asarray(lp), [np.asarray(s) for s in spectra]


def _port_logp_and_spectra(spec, likelihood, observed, thetas, seed):
    problem = tsimult.SimultFitProblem(spec, n_runs=N_RUNS,
                                       likelihood=likelihood, device="cpu")
    logp = problem.make_log_prob_fn(observed)
    t = torch.as_tensor(thetas)
    lp = logp(t, torch.Generator().manual_seed(seed))
    spectra = problem.run_spectra(t, torch.Generator().manual_seed(seed))
    return lp.numpy(), spectra.numpy(), problem.windows


@pytest.fixture
def counts_are_rates(monkeypatch):
    """Both packages' Poisson stage returns its rates: the forward models
    become deterministic and comparable walker by walker."""
    monkeypatch.setattr(jpoisson, "poisson_auto", lambda key, lam: lam)
    monkeypatch.setattr(
        tforward, "poisson", lambda lam, seed, n_runs, **counters:
        lam[:, None].expand(-1, n_runs, -1))


def test_parity_without_rint(jax_observed, counts_are_rates):
    """rint_draws=False: spectra rtol 1e-5 plus 1e-5 of each run's peak
    (the few lattice cells that feed a far-tail bin carry the A operator's
    cancellation, so such a bin agrees only to the peak's precision); the
    corrected log-likelihood to 1e-5 of its term scale sum|obs log(rate)|
    + sum(rate), the magnitude its float32 sum cancels down from."""
    thetas = _thetas()
    lp_j, spec_j = _jax_logp_and_spectra(
        _spec(jsimult, rint_draws=False), "poisson", jax_observed, thetas, 1)
    lp_t, spec_t, windows = _port_logp_and_spectra(
        _spec(tsimult, rint_draws=False), "poisson", jax_observed, thetas, 1)
    for r, win in enumerate(windows):
        want = spec_j[r]
        np.testing.assert_allclose(spec_t[:, r, :win.n_bins], want,
                                   rtol=1e-5, atol=1e-5 * want.max())
        np.testing.assert_array_equal(spec_t[:, r, win.n_bins:], 0.0)
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(s, 1e-3))) + s, -1)
                for o, s in zip(jax_observed, spec_j))
    assert np.all(np.isfinite(lp_j)) and np.all(np.isfinite(lp_t))
    assert np.all(np.abs(lp_t - lp_j) <= 1e-5 * scale), (lp_t, lp_j)


def test_parity_with_injected_counts(jax_observed, monkeypatch):
    """Both packages' Poisson stage returns the same counts, a non-linear
    function of the rates with a pattern along the cells (smooth, so that a
    last-bit difference of a rate moves no count by a whole draw, and
    tending to the rate itself where the rate underflows and the
    conditional moments are rounding noise), so the path from the draw on
    is held: the port's draw takes the rates once per walker and returns
    counts per run.  Tolerances of test_parity_without_rint."""
    def counts(lam, cells):
        return lam * (1.0 + 0.5 * ((cells % 3) - 1.0) * lam / (1.0 + lam))

    monkeypatch.setattr(
        jpoisson, "poisson_auto", lambda key, lam:
        counts(lam, jnp.arange(lam.shape[-1])))
    monkeypatch.setattr(
        tforward, "poisson", lambda lam, seed, n_runs, **counters:
        counts(lam, torch.arange(lam.shape[-1]))[:, None]
        .expand(-1, n_runs, -1))
    thetas = _thetas(4, seed=7)
    lp_j, spec_j = _jax_logp_and_spectra(
        _spec(jsimult, rint_draws=False), "poisson", jax_observed, thetas, 5)
    lp_t, spec_t, windows = _port_logp_and_spectra(
        _spec(tsimult, rint_draws=False), "poisson", jax_observed, thetas, 5)
    for r, win in enumerate(windows):
        want = spec_j[r]
        np.testing.assert_allclose(spec_t[:, r, :win.n_bins], want,
                                   rtol=1e-5, atol=1e-5 * want.max())
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(s, 1e-3))) + s, -1)
                for o, s in zip(jax_observed, spec_j))
    assert np.all(np.isfinite(lp_j)) and np.all(np.isfinite(lp_t))
    assert np.all(np.abs(lp_t - lp_j) <= 1e-5 * scale), (lp_t, lp_j)


@pytest.mark.parametrize("variant", [
    {"moment_closure": "cell"},
    {"e0_mean_mode": "expected"},
    {"n_redraw_rounds": 0},
], ids=lambda v: "-".join(f"{k}={v}" for k, v in v.items()))
def test_parity_spec_variants(jax_observed, counts_are_rates, variant):
    """The other result-changing spec fields the port runs, each against
    the JAX package with the tolerances of test_parity_without_rint."""
    thetas = _thetas(4, seed=5)
    lp_j, spec_j = _jax_logp_and_spectra(
        _spec(jsimult, rint_draws=False, **variant), "poisson",
        jax_observed, thetas, 3)
    lp_t, spec_t, windows = _port_logp_and_spectra(
        _spec(tsimult, rint_draws=False, **variant), "poisson",
        jax_observed, thetas, 3)
    for r, win in enumerate(windows):
        want = spec_j[r]
        np.testing.assert_allclose(spec_t[:, r, :win.n_bins], want,
                                   rtol=1e-5, atol=1e-5 * want.max())
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(s, 1e-3))) + s, -1)
                for o, s in zip(jax_observed, spec_j))
    assert np.all(np.isfinite(lp_j)) and np.all(np.isfinite(lp_t))
    assert np.all(np.abs(lp_t - lp_j) <= 1e-5 * scale), (lp_t, lp_j)


def test_parity_with_rint(jax_observed, counts_are_rates):
    """rint_draws=True (the production setting): a float32 rounding
    difference moves rint across .5 in a few lattice cells, so spectra
    agree to 1e-3 in relative L1 per (walker, run); the faithful
    likelihood is compared bin by bin where floor(model) agrees."""
    thetas = _thetas()
    lp_j, spec_j = _jax_logp_and_spectra(
        _spec(jsimult), "reference", jax_observed, thetas, 2)
    lp_t, spec_t, windows = _port_logp_and_spectra(
        _spec(tsimult), "reference", jax_observed, thetas, 2)
    assert np.all(np.isfinite(lp_t))
    for r, win in enumerate(windows):
        got, want = spec_t[:, r, :win.n_bins], spec_j[r]
        rel_l1 = np.abs(got - want).sum(-1) / np.abs(want).sum(-1)
        assert np.all(rel_l1 < 1e-3), (r, rel_l1)
        obs = jax_observed[r].astype(np.float32)
        terms_t = tlike.poisson_binned_terms(torch.as_tensor(got),
                                             torch.as_tensor(obs)).numpy()
        terms_j = np.asarray(jlike.poisson_binned_terms(jnp.asarray(want),
                                                        jnp.asarray(obs)))
        same = np.floor(got) == np.floor(want)
        assert same.mean() > 0.5
        # with equal floors a term is linear in the model, slope
        # obs * log(obs): what remains is that slope times the spectrum
        # difference, plus float32 rounding of the term's three parts
        # (obs, gammaln(floor(model) + 1), model * log(obs)), which cancel
        obs_c = np.where(obs == 0, 1.0, obs)
        parts = obs_c * (obs_c + gammaln(np.floor(np.maximum(want, 1.0))
                                         + 1.0)
                         + np.abs(want * np.log(obs_c)))
        bound = (1.01 * np.abs(obs_c * np.log(obs_c) * (got - want))
                 + 1e-6 * parts)
        bad = same & (np.abs(terms_t - terms_j) > bound)
        assert not bad.any(), (r, got[bad], want[bad], terms_t[bad],
                               terms_j[bad], obs_c[np.nonzero(bad)[1]])


def test_distributional_parity(jax_observed):
    """Real Poisson draws on both sides (different streams): mean and
    standard deviation of the corrected log-prob over 64 evaluations at
    one theta agree within 3 standard errors."""
    n = 64
    theta = np.repeat(_thetas(1, seed=3), n, axis=0)
    lp_j, _ = _jax_logp_and_spectra(_spec(jsimult), "poisson", jax_observed,
                                    theta, 4)
    lp_t, _, _ = _port_logp_and_spectra(_spec(tsimult), "poisson",
                                        jax_observed, theta, 4)
    assert np.all(np.isfinite(lp_j)) and np.all(np.isfinite(lp_t))
    sd_j, sd_t = lp_j.std(ddof=1), lp_t.std(ddof=1)
    se_mean = np.sqrt((sd_j ** 2 + sd_t ** 2) / n)
    se_sd = np.sqrt((sd_j ** 2 + sd_t ** 2) / (2 * (n - 1)))
    assert abs(lp_t.mean() - lp_j.mean()) < 3 * se_mean, (lp_t, lp_j)
    assert abs(sd_t - sd_j) < 3 * se_sd, (sd_t, sd_j)


def test_short_de_fit_on_cpu():
    problem = tsimult.SimultFitProblem(_spec(tsimult), n_runs=N_RUNS,
                                       likelihood="poisson", device="cpu")
    observed = tdata_io.synthesize_observed(0, problem, TRUTH)
    logp = problem.make_log_prob_fn(observed)
    gen = torch.Generator().manual_seed(1)
    p0 = problem.initial_walkers_from_observed(gen, 16, observed)
    state = sampler.init_state(p0, logp, generator=gen,
                               eval_generator=torch.Generator().manual_seed(2))
    assert torch.all(torch.isfinite(state.log_probs))
    chain = sampler.run_mcmc(state, 10, logp, move="de")
    assert chain.positions.shape == (10, 16, problem.n_dim)
    assert chain.log_probs.shape == (10, 16)
    acc = chain.acceptance_fraction.float().mean().item()
    assert 0.0 < acc < 1.0
    assert chain.state.step == 10
    # the input state is left as it was
    assert torch.equal(state.positions, p0)


@pytest.mark.parametrize("move", ["de", "stretch"])
def test_moves_recover_gaussian(move):
    rng = np.random.default_rng(0)
    q, _ = np.linalg.qr(rng.normal(size=(4, 4)))
    cov = (q * np.array([2.0, 1.0, 0.5, 0.3]) ** 2) @ q.T
    mean = np.array([1.0, -2.0, 0.5, 3.0])
    prec = torch.as_tensor(np.linalg.inv(cov), dtype=torch.float32)
    mu = torch.as_tensor(mean, dtype=torch.float32)

    def logp(thetas, generator):
        d = thetas - mu
        return -0.5 * torch.einsum("wi,ij,wj->w", d, prec, d)

    gen = torch.Generator().manual_seed(3)
    p0 = mu + 0.1 * torch.randn((64, 4), generator=gen)
    chain = sampler.sample(p0, 1500, logp, generator=gen,
                           eval_generator=torch.Generator(), move=move)
    samples = chain.positions[300:].reshape(-1, 4).double().numpy()
    sd = np.sqrt(np.diag(cov))
    np.testing.assert_allclose(samples.mean(0), mean, atol=0.15 * sd.max())
    np.testing.assert_allclose(np.cov(samples.T), cov, atol=0.15 * cov.max())
    acc = chain.acceptance_fraction.float().mean().item()
    assert 0.15 < acc < 0.95


def test_init_refresh_guard():
    """Non-finite first estimates are re-drawn; deterministic -inf walkers
    stay -inf and stop the refresh once a round fixes nothing."""
    calls = []

    def flaky(thetas, generator):
        calls.append(1)
        lp = -thetas.sum(-1)
        if len(calls) == 1:
            lp = torch.where(torch.arange(4) == 1, -torch.inf, lp)
        return torch.where(torch.arange(4) == 3, -torch.inf, lp)

    p0 = torch.ones((4, 2))
    state = sampler.init_state(p0, flaky, generator=torch.Generator(),
                               eval_generator=torch.Generator())
    assert torch.isfinite(state.log_probs[:3]).all()
    assert torch.isneginf(state.log_probs[3])
    assert len(calls) == 3      # first, one fixing round, one futile round
    with pytest.raises(ValueError):
        sampler.init_state(torch.ones((3, 2)), flaky,
                           generator=torch.Generator(),
                           eval_generator=torch.Generator())


def test_mixed_move_and_errors():
    def logp(thetas, generator):
        return -0.5 * (thetas ** 2).sum(-1)

    gen = torch.Generator().manual_seed(0)
    p0 = torch.randn((8, 2), generator=gen)
    state = sampler.init_state(p0, logp, generator=gen,
                               eval_generator=torch.Generator())
    chain = sampler.run_mcmc(state, 6, logp, move="mixed")
    assert chain.positions.shape == (6, 8, 2)
    with pytest.raises(ValueError):
        sampler.run_mcmc(state, 1, logp, move="walk")
    small = sampler.init_state(torch.zeros((2, 2)), logp, generator=gen,
                               eval_generator=torch.Generator())
    with pytest.raises(ValueError):
        sampler.run_mcmc(small, 1, logp, move="de")


def test_log_prob_gates_the_prior_box():
    problem = tsimult.SimultFitProblem(_spec(tsimult), n_runs=N_RUNS,
                                       device="cpu")
    observed = tdata_io.synthesize_observed(1, problem, TRUTH)
    thetas = torch.as_tensor(np.stack([TRUTH, TRUTH, TRUTH]),
                             dtype=torch.float32)
    thetas[1, 3] = -0.5           # s outside the box (and <= 0)
    thetas[2, 0] = 2000.0         # beamE above the box
    lp = problem.make_log_prob_fn(observed)(thetas, torch.Generator())
    assert torch.isfinite(lp[0])
    assert torch.isneginf(lp[1]) and torch.isneginf(lp[2])


def test_synthesize_observed():
    problem = tsimult.SimultFitProblem(_spec(tsimult), n_runs=N_RUNS,
                                       device="cpu")
    a = tdata_io.synthesize_observed(5, problem, TRUTH)
    b = tdata_io.synthesize_observed(5, problem, TRUTH)
    c = tdata_io.synthesize_observed(6, problem, TRUTH)
    for r, win in enumerate(problem.windows):
        assert a[r].shape == (win.n_bins,) and a[r].dtype == np.float64
        assert np.all(a[r] == np.floor(a[r])) and np.all(a[r] >= 0)
        np.testing.assert_array_equal(a[r], b[r])
        # the scale is the expected total of each run
        assert abs(a[r].sum() - 5.0e4) < 5 * np.sqrt(5.0e4)
    assert any(not np.array_equal(a[r], c[r]) for r in range(N_RUNS))


# refused by earlier slices, ported with the remaining forward models
NOT_PORTED = [("counts", "zero_degree", "none"),
              ("mc", "n_redraw_rounds", 3)]
# what earlier slices of the port refused and it now runs
NOW_PORTED = [("counts", "sampling", "mc"),
              ("counts", "sampling", "expected"),
              ("counts", "a_dtype", "bfloat16"),
              ("counts", "cell_attenuation", True),
              ("counts", "zero_degree", "expo"),
              ("counts", "bg_mode", "expected")]


@pytest.mark.parametrize("base,field,value", NOT_PORTED)
def test_unported_spec_values_raise(base, field, value):
    """The values that earlier slices refused with ``NotImplementedError``
    build a spec now (the remaining forward models' slice ported them):
    an unknown zero-degree stage raises ``ValueError``, as in the JAX
    package, and k redraw rounds draw 1 + k sets of normals.  ``base``:
    the counts spec of this file, or the mc spec on the ODE path."""
    spec = (_spec(tsimult) if base == "counts" else
            tsimult.default_spec(N_DRAWS, transport="rk4", sampling="mc"))
    new = dataclasses.replace(spec, **{field: value})
    assert getattr(new, field) == value
    if field == "zero_degree":
        with pytest.raises(ValueError, match=field):
            dataclasses.replace(spec, zero_degree="bogus")
    else:
        u = tforward.draw_beam(new, (2, 1, 5),
                               torch.Generator().manual_seed(0), "cpu")
        assert u.shape == (1 + value, 2, 1, 5)


@pytest.mark.parametrize("base,field,value", NOW_PORTED)
def test_ported_spec_values_run(base, field, value):
    """Each value builds a forward on the counts spec of this file whose
    spectra are finite, of the windows' shape and zero on the padding
    bins; a result-changing value changes them."""
    spec = dataclasses.replace(_spec(tsimult), **{field: value})
    thetas = torch.as_tensor(_thetas(2))
    bg = torch.full((2, N_RUNS), 7.0) if field == "bg_mode" else None
    spectra = []
    for sp in (_spec(tsimult), spec):
        fwd = tsimult.SimultFitProblem(sp, n_runs=N_RUNS,
                                       device="cpu").forward
        spectra.append(fwd(thetas[:, :4], thetas[:, 4:],
                           torch.Generator().manual_seed(3), bg))
    base_spectra, got = spectra
    assert got.shape == (2, N_RUNS, 70) and torch.all(torch.isfinite(got))
    for r, win in enumerate(fwd.windows):
        assert torch.all(got[:, r, win.n_bins:] == 0)
    assert not torch.equal(got, base_spectra)
    if field == "bg_mode":
        # 'expected' adds the level itself; the counts draw has the seed
        # of the 'poisson' run, whose background is a draw around it
        diff = (got - base_spectra)[:, 0, :50]
        assert (diff != 0).float().mean() > 0.5
        assert abs(diff.mean().item()) < 2.0


def test_unported_entry_points_raise():
    # the JAX default (mc, table, e0grid, F = 256) is the port's default
    assert tsimult.default_spec(N_DRAWS).e0_grid_fine == 256
    # counts needs the table, as in the JAX package
    with pytest.raises(ValueError, match="transport='table'"):
        tsimult.default_spec(N_DRAWS, sampling="counts", transport="rk4")
    with pytest.raises(ValueError):
        dataclasses.replace(_spec(tsimult), moment_closure="quadratic")
    with pytest.raises(ValueError, match="stopping_table"):
        dataclasses.replace(_spec(tsimult), stopping_table=None)
    with pytest.raises(ValueError, match="bg_mode"):
        dataclasses.replace(_spec(tsimult), bg_mode="gaussian")
    # the background of earlier slices' refusal: levels (W, R) are added
    # to the real bins
    problem = tsimult.SimultFitProblem(_spec(tsimult), n_runs=N_RUNS,
                                       device="cpu")
    theta = torch.as_tensor(TRUTH[None], dtype=torch.float32)
    spec_bg = dataclasses.replace(_spec(tsimult), bg_mode="expected")
    with_bg = tsimult.SimultFitProblem(spec_bg, n_runs=N_RUNS,
                                       device="cpu").forward(
        theta[:, :4], theta[:, 4:], torch.Generator().manual_seed(1),
        torch.ones((1, N_RUNS)))
    without = problem.forward(theta[:, :4], theta[:, 4:],
                              torch.Generator().manual_seed(1))
    mask = problem.forward.pad_mask
    torch.testing.assert_close(with_bg, without + mask.float()[None],
                               rtol=0, atol=0)


def test_default_device_is_the_gpu(monkeypatch):
    """Entry points default to the GPU; without one they raise and never
    fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec(tsimult)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsimult.SimultFitProblem(spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tforward.TofForward(spec, (300.0,), (jsimult.tof_windows.mid,))
