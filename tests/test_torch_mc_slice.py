"""The mc estimator on the literal ODE path (simultFit, transport='rk4') as
a whole: the port (mcmctoffitting_tpu_torch) against the JAX package at a
small size (4 walkers x 4 runs x 4096 draws), both xs_modes, both
likelihoods.

(f) The same initial energies are injected on both sides (the JAX
    package's ``sample_beam_energies`` looks its draw up by the key it is
    given), so the log-probs and spectra are compared walker by walker.
    The JAX side runs its fused transport kernel in interpret mode for
    'taylor' (``use_pallas``: the closed-form dE/dx of kernel K4), and its
    RK4 with the same closed form for 'exact'; tests/test_torch_transport.py
    holds the closed form against the full Bethe formula.
(g) A short DE fit on the CPU, all initial log-probs finite.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln, ndtr, ndtri

import mcmctoffitting_tpu.ops.pallas_forward as jpallas_forward
from mcmctoffitting_tpu.models import forward as jforward
from mcmctoffitting_tpu.models import simult as jsimult
from mcmctoffitting_tpu.ops import likelihoods as jlike
from mcmctoffitting_tpu.ops import stopping as jstopping
from mcmctoffitting_tpu_torch import sampler
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import likelihoods as tlike
from mcmctoffitting_tpu_torch.utils import data_io as tdata_io

torch.set_num_threads(1)

N_DRAWS, N_RUNS, N_WALKERS = 4096, 4, 4
TRUTH = np.concatenate([jsimult.GUESS_SHARED, np.full(N_RUNS, 5.0e4)])


def _thetas(n=N_WALKERS, seed=0):
    rng = np.random.default_rng(seed)
    spread = np.concatenate([jsimult.AGITATORS_SHARED, 0.05 * TRUTH[4:]])
    return (TRUTH + spread * rng.standard_normal((n, TRUTH.size))).astype(
        np.float32)


def _e0_draws(thetas, seed):
    """Truncated-lognormal initial energies (W, R, N) at each walker's
    parameters, by inverse CDF in float64."""
    rng = np.random.default_rng(seed)
    beam_e, e_loss, scale, s = (thetas[:, k, None, None].astype(np.float64)
                                for k in range(4))
    u = rng.uniform(1e-12, 1.0, (thetas.shape[0], N_RUNS, N_DRAWS))
    z = ndtri(u * ndtr(np.log((beam_e - e_loss) / scale) / s))
    return (beam_e - (e_loss + scale * np.exp(s * z))).astype(np.float32)


@pytest.fixture(scope="module")
def observed():
    """Observed spectra from the port's own mc forward at the truth."""
    problem = tsimult.SimultFitProblem(
        tsimult.default_spec(N_DRAWS, transport="rk4", sampling="mc"),
        n_runs=N_RUNS, device="cpu")
    return tdata_io.synthesize_observed(0, problem, TRUTH)


def _inject(monkeypatch, thetas, e0, seed):
    """Both packages' beam draws return ``e0`` (W, R, N); the JAX side
    finds walker w, run r by its draw key, split(fold_in(key_w, r))[0]."""
    keys = jax.random.split(jax.random.PRNGKey(seed), thetas.shape[0])
    table = jnp.stack([jax.random.split(jax.random.fold_in(k, r))[0]
                       for k in keys for r in range(N_RUNS)])
    flat = jnp.asarray(e0.reshape(-1, N_DRAWS))

    def jax_draw(key, spec, params, n=0):
        hit = jnp.all(table == key[None], axis=-1)
        return flat[jnp.argmax(hit)]

    monkeypatch.setattr(jforward, "sample_beam_energies", jax_draw)
    monkeypatch.setattr(tforward.TofForward, "sample_beam_energies",
                        lambda self, params, generator: torch.as_tensor(e0))

    # the JAX side's transport uses K4's closed form (see module docstring)
    a, p, q = jpallas_forward.bethe_closed_form_constants(
        jstopping.d2_gas_stopping())
    rk4 = jstopping.rk4_transport

    def closed_form(dedx_fn, e0_, x_eval, n_substeps=4):
        return rk4(lambda e: -(a / e) * (p + q * jnp.log(e)), e0_, x_eval,
                   n_substeps=n_substeps)

    monkeypatch.setattr(jforward, "rk4_transport", closed_form)
    fused = jpallas_forward.fused_transport_moments
    monkeypatch.setattr(jpallas_forward, "fused_transport_moments",
                        lambda *args, **kw: fused(*args, **kw,
                                                  interpret=True))
    return keys


def _both(monkeypatch, xs_mode, likelihood, rint, observed, seed):
    thetas = _thetas(seed=seed)
    e0 = _e0_draws(thetas, seed)
    keys = _inject(monkeypatch, thetas, e0, seed)
    jspec = dataclasses.replace(
        jsimult.default_spec(N_DRAWS, transport="rk4", xs_mode=xs_mode),
        use_pallas=xs_mode == "taylor", rint_draws=rint)
    jprob = jsimult.SimultFitProblem(jspec, n_runs=N_RUNS,
                                     likelihood=likelihood)
    jlogp = jprob.make_log_prob_fn(observed)
    fn = jax.jit(jax.vmap(lambda t, k: (jlogp(t, k),
                                        jprob.run_spectra(t, k))))
    lp_j, spec_j = fn(jnp.asarray(thetas), keys)
    tspec = dataclasses.replace(
        tsimult.default_spec(N_DRAWS, transport="rk4", sampling="mc",
                             xs_mode=xs_mode), rint_draws=rint)
    tprob = tsimult.SimultFitProblem(tspec, n_runs=N_RUNS,
                                     likelihood=likelihood, device="cpu")
    t = torch.as_tensor(thetas)
    lp_t = tprob.make_log_prob_fn(observed)(t, torch.Generator())
    spec_t = tprob.run_spectra(t, torch.Generator())
    return (np.asarray(lp_j), [np.asarray(s) for s in spec_j],
            lp_t.numpy(), spec_t.numpy(), tprob.windows)


@pytest.mark.parametrize("xs_mode", ["taylor", "exact"])
def test_mc_parity_without_rint(monkeypatch, observed, xs_mode):
    """Corrected likelihood, rint_draws=False: the tolerances of
    tests/test_torch_slice.py::test_parity_without_rint (spectra rtol 1e-5
    plus 1e-5 of each run's peak; log-likelihood to 1e-5 of its term
    scale)."""
    lp_j, spec_j, lp_t, spec_t, windows = _both(
        monkeypatch, xs_mode, "poisson", False, observed, 1)
    for r, win in enumerate(windows):
        want = spec_j[r]
        np.testing.assert_allclose(spec_t[:, r, :win.n_bins], want,
                                   rtol=1e-5, atol=1e-5 * want.max())
        np.testing.assert_array_equal(spec_t[:, r, win.n_bins:], 0.0)
    scale = sum(np.sum(np.abs(o * np.log(np.maximum(s, 1e-3))) + s, -1)
                for o, s in zip(observed, spec_j))
    assert np.all(np.isfinite(lp_j)) and np.all(np.isfinite(lp_t))
    assert np.all(np.abs(lp_t - lp_j) <= 1e-5 * scale), (lp_t, lp_j)


@pytest.mark.parametrize("xs_mode", ["taylor", "exact"])
def test_mc_parity_with_rint(monkeypatch, observed, xs_mode):
    """Faithful likelihood, rint_draws=True: the tolerances of
    tests/test_torch_slice.py::test_parity_with_rint (spectra to 1e-3
    relative L1 per walker and run; the faithful terms bin by bin where
    floor(model) agrees)."""
    lp_j, spec_j, lp_t, spec_t, windows = _both(
        monkeypatch, xs_mode, "reference", True, observed, 2)
    assert np.all(np.isfinite(lp_t)) and np.all(np.isfinite(lp_j))
    for r, win in enumerate(windows):
        got, want = spec_t[:, r, :win.n_bins], spec_j[r]
        rel_l1 = np.abs(got - want).sum(-1) / np.abs(want).sum(-1)
        assert np.all(rel_l1 < 1e-3), (r, rel_l1)
        obs = observed[r].astype(np.float32)
        terms_t = tlike.poisson_binned_terms(torch.as_tensor(got),
                                             torch.as_tensor(obs)).numpy()
        terms_j = np.asarray(jlike.poisson_binned_terms(jnp.asarray(want),
                                                        jnp.asarray(obs)))
        same = np.floor(got) == np.floor(want)
        assert same.mean() > 0.5
        obs_c = np.where(obs == 0, 1.0, obs)
        parts = obs_c * (obs_c + gammaln(np.floor(np.maximum(want, 1.0))
                                         + 1.0)
                         + np.abs(want * np.log(obs_c)))
        bound = (1.01 * np.abs(obs_c * np.log(obs_c) * (got - want))
                 + 1e-6 * parts)
        assert not (same & (np.abs(terms_t - terms_j) > bound)).any(), r


@pytest.mark.parametrize("likelihood", ["reference", "poisson"])
def test_short_de_fit_on_cpu(likelihood):
    spec = tsimult.default_spec(2048, transport="rk4", sampling="mc")
    problem = tsimult.SimultFitProblem(spec, n_runs=N_RUNS,
                                       likelihood=likelihood, device="cpu")
    observed = tdata_io.synthesize_observed(0, problem, TRUTH)
    logp = problem.make_log_prob_fn(observed)
    gen = torch.Generator().manual_seed(1)
    p0 = problem.initial_walkers_from_observed(gen, 16, observed)
    eval_gen = torch.Generator().manual_seed(2)
    # an mc grid is a sum of non-negative weights: every walker is finite
    assert torch.all(torch.isfinite(logp(p0, eval_gen)))
    state = sampler.init_state(p0, logp, generator=gen,
                               eval_generator=eval_gen)
    chain = sampler.run_mcmc(state, 8, logp, move="de")
    assert chain.positions.shape == (8, 16, problem.n_dim)
    assert torch.all(torch.isfinite(chain.log_probs))
    acc = chain.acceptance_fraction.float().mean().item()
    assert 0.0 < acc < 1.0


def test_exact_chunks_agree(monkeypatch):
    """The 'exact' grid does not depend on how its rows are chunked."""
    spec = tsimult.default_spec(1024, transport="rk4", sampling="mc",
                                xs_mode="exact")
    fwd = tsimult.SimultFitProblem(spec, device="cpu").forward
    e0 = torch.as_tensor(_e0_draws(_thetas(2), 3)[:, :, :1024])
    whole = fwd.energy_weight_grid(e0)
    monkeypatch.setattr(tforward, "_EXACT_CHUNK", 3 * 10 * 1024)
    chunked = fwd.energy_weight_grid(e0)
    assert whole.shape == (2, N_RUNS, 10, 50)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)
