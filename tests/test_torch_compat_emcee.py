"""The port's emcee 2.x shim (mcmctoffitting_tpu_torch.compat.emcee)
against the JAX package's, on a Gaussian target on the CPU.

* The surface: the reference drivers' call shapes (segment loops with
  lnprob0/rstate0 resume, reset, run_mcmc(None, ...), thin) give the same
  attributes with the same shapes and layouts as the JAX shim, on both of
  the port's backends (torch: a batched (W, D) tensor function; host: a
  numpy function of one walker) and the JAX shim's two.
* In distribution: the chains' means and variances agree with the
  analytic posterior and with the JAX shim's, on both backends.
* Differences by design: ``backend='jax'`` raises a ``ValueError`` that
  names 'torch'.
* ``PTSampler``: the reference's sample -> reset -> sample pattern on both
  backends (torch: batched (N, D) tensor functions; host: numpy functions
  of one walker) gives the JAX shim's shapes and the analytic cold
  posterior; its thermodynamic-integration ln Z matches the analytic
  evidence; 'auto' lets a log-likelihood's exception through.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcmctoffitting_tpu.compat import emcee as jemcee
from mcmctoffitting_tpu_torch.compat import emcee as temcee

torch.set_num_threads(1)

D, N_WALKERS = 2, 24
MU = np.array([1.0, -2.0])
SIG = np.array([1.0, 0.5])


def _lnpost_torch(p, scale=1.0):
    mu = torch.as_tensor(MU, dtype=p.dtype)
    sig = torch.as_tensor(SIG, dtype=p.dtype)
    return -0.5 * torch.sum(((p - mu) / (scale * sig)) ** 2, dim=-1)


def _lnpost_host(p, scale=1.0):
    # float() of one walker's value: the host backend
    return -0.5 * float(np.sum(((np.asarray(p) - MU) / (scale * SIG)) ** 2))


def _lnpost_jax(p, scale=1.0):
    return -0.5 * jnp.sum(((p - MU) / (scale * SIG)) ** 2)


def _port(fn, **kw):
    return temcee.EnsembleSampler(N_WALKERS, D, fn, kwargs={"scale": 1.0},
                                  threads=4, seed=7, device="cpu", **kw)


def _drive(sampler, n_burn=40, n_main=300):
    """The reference's pattern: burn-in loop, reset, resume with lnprob0
    and rstate0, then run_mcmc(None, ...) continues."""
    p0 = MU + np.random.default_rng(0).standard_normal((N_WALKERS, D))
    out = None
    for out in sampler.sample(p0, iterations=n_burn):
        pass
    pos, prob, rstate = out
    shapes = {"burn_chain": sampler.chain.shape}
    sampler.reset()
    shapes["reset_chain"] = sampler.chain.shape
    shapes["reset_lnprob"] = sampler.lnprobability.shape
    for out in sampler.sample(pos, lnprob0=prob, rstate0=rstate,
                              iterations=n_main):
        pass
    shapes.update(
        pos=out[0].shape, prob=out[1].shape, chain=sampler.chain.shape,
        flatchain=sampler.flatchain.shape,
        lnprobability=sampler.lnprobability.shape,
        flatlnprobability=sampler.flatlnprobability.shape,
        acceptance_fraction=sampler.acceptance_fraction.shape,
        acor=sampler.acor.shape,
        autocorr=sampler.get_autocorr_time().shape)
    sampler.run_mcmc(None, 10)
    shapes["continued"] = sampler.chain.shape
    return shapes


@pytest.mark.parametrize("fn,backend", [(_lnpost_torch, "torch"),
                                        (_lnpost_host, "host")])
def test_surface_matches_the_jax_shim(fn, backend):
    port = _port(fn)
    got = _drive(port)
    assert port.backend == backend
    jshim = jemcee.EnsembleSampler(
        N_WALKERS, D, _lnpost_jax if backend == "torch" else _lnpost_host,
        kwargs={"scale": 1.0}, threads=4, seed=7)
    want = _drive(jshim)
    assert got == want
    assert got["chain"] == (N_WALKERS, 300, D)
    assert got["continued"] == (N_WALKERS, 310, D)
    assert np.all(np.isfinite(port.flatlnprobability))
    assert port.chain.dtype == port.lnprobability.dtype == np.float64
    assert 0.2 < port.acceptance_fraction.mean() < 0.95
    assert np.all(np.isfinite(port.acor))
    # get_lnprob of one walker, either backend
    np.testing.assert_allclose(port.get_lnprob(MU + 1.0),
                               _lnpost_host(MU + 1.0), rtol=1e-6)


@pytest.mark.parametrize("fn", [_lnpost_torch, _lnpost_host])
def test_moments_match_the_posterior_and_the_jax_shim(fn):
    """Means and variances of the main chains after burn-in: within 0.2
    (standard units) of the analytic N(MU, SIG^2) and of the JAX shim's."""
    def moments(sampler):
        p0 = MU + np.random.default_rng(1).standard_normal((N_WALKERS, D))
        sampler.run_mcmc(p0, 600)
        samples = sampler.chain[:, 100:, :].reshape(-1, D)
        return samples.mean(0), samples.std(0)

    mean_t, std_t = moments(_port(fn))
    mean_j, std_j = moments(jemcee.EnsembleSampler(
        N_WALKERS, D, _lnpost_jax if fn is _lnpost_torch else _lnpost_host,
        kwargs={"scale": 1.0}, seed=7))
    for mean, std in ((mean_t, std_t), (mean_j, std_j)):
        assert np.all(np.abs(mean - MU) / SIG < 0.2), mean
        assert np.all(np.abs(std / SIG - 1.0) < 0.2), std
    assert np.all(np.abs(mean_t - mean_j) / SIG < 0.3)
    assert np.all(np.abs(std_t - std_j) / SIG < 0.3)


@pytest.mark.parametrize("backend", ["torch", "host"])
def test_thin_matches_emcee2_semantics(backend):
    """emcee 2 stores iterations 0, thin, 2*thin, ...: iterations=10,
    thin=3 keeps 4 rows, as the JAX shim does."""
    fn = _lnpost_torch if backend == "torch" else _lnpost_host
    s = temcee.EnsembleSampler(8, D, fn, seed=11, backend=backend,
                               device="cpu")
    p0 = np.random.default_rng(1).standard_normal((8, D))
    for _ in s.sample(p0, iterations=10, thin=3):
        pass
    j = jemcee.EnsembleSampler(8, D, _lnpost_jax, seed=11)
    for _ in j.sample(p0, iterations=10, thin=3):
        pass
    assert s.chain.shape == j.chain.shape == (8, 4, D)
    assert s.lnprobability.shape == j.lnprobability.shape == (8, 4)
    assert s.iterations == 10


def test_rstate_resumes_the_same_stream():
    """The torch backend's rstate is a snapshot of its move generator:
    resuming from one gives the same steps as the uninterrupted run."""
    p0 = MU + np.random.default_rng(2).standard_normal((N_WALKERS, D))
    whole = _port(_lnpost_torch)
    whole.run_mcmc(p0, 20)
    parts = _port(_lnpost_torch)
    pos, prob, rstate = parts.run_mcmc(p0, 10)
    parts.run_mcmc(pos, 10, lnprob0=prob, rstate0=rstate)
    np.testing.assert_array_equal(parts.chain, whole.chain)


def test_backend_choice_and_refusals(monkeypatch):
    s = temcee.EnsembleSampler(8, D, _lnpost_host, device="cpu")
    with pytest.warns(UserWarning, match="host"):
        next(iter(s.sample(np.zeros((8, D)), iterations=1)))
    assert s.backend == "host"
    s = temcee.EnsembleSampler(8, D, _lnpost_host, backend="torch",
                               device="cpu")
    with pytest.raises(TypeError, match=r"\(W, D\) tensor"):
        next(iter(s.sample(np.zeros((8, D)), iterations=1)))
    with pytest.raises(ValueError, match="'torch'"):
        temcee.EnsembleSampler(8, D, _lnpost_torch, backend="jax")
    with pytest.raises(ValueError, match="even"):
        temcee.EnsembleSampler(7, D, _lnpost_torch, device="cpu")
    # the host backend needs no device; the torch backend's default is
    # the GPU, which is an error without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    temcee.EnsembleSampler(8, D, _lnpost_host, backend="host")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        temcee.EnsembleSampler(8, D, _lnpost_torch)


def test_auto_lets_the_probe_s_errors_reach_the_caller():
    """'auto' chooses from the probe's result and swallows nothing: a
    log-prob that raises on the batch of walkers (here as a device launch
    that fails would) raises to the caller, with a note that names
    backend='host'; no backend is chosen."""
    class LaunchFailed(RuntimeError):
        pass

    def failing(p):
        raise LaunchFailed("CUDA error: launch failed")

    s = temcee.EnsembleSampler(8, D, failing, device="cpu")
    with pytest.raises(LaunchFailed) as info:
        next(iter(s.sample(np.zeros((8, D)), iterations=1)))
    assert any("backend='host'" in note for note in info.value.__notes__)
    assert s.backend is None

    def one_walker_only(p):
        # a per-walker numpy function that cannot take a batch of tensors
        if p[0] < -10.0:
            return -np.inf
        return _lnpost_host(p)

    s = temcee.EnsembleSampler(8, D, one_walker_only, device="cpu")
    with pytest.raises(RuntimeError, match="ambiguous"):
        next(iter(s.sample(np.zeros((8, D)), iterations=1)))
    s = temcee.EnsembleSampler(8, D, one_walker_only, backend="host",
                               seed=3)
    pos, lp, _ = s.run_mcmc(np.zeros((8, D)), 5)
    assert s.backend == "host" and np.all(np.isfinite(lp))


S_PRIOR, PT_SIG = 3.0, 1.0
POST_STD = (1.0 / S_PRIOR ** 2 + 1.0 / PT_SIG ** 2) ** -0.5


def _logl_torch(p, sig=PT_SIG):
    return (-0.5 * torch.sum((p / sig) ** 2, dim=-1)
            - 0.5 * D * np.log(2 * np.pi * sig ** 2))


def _logprior_torch(p):
    return (-0.5 * torch.sum((p / S_PRIOR) ** 2, dim=-1)
            - 0.5 * D * np.log(2 * np.pi * S_PRIOR ** 2))


def _logl_host(p, sig=PT_SIG):
    # float() of one walker's value: the host backend
    return float(-0.5 * np.sum((np.asarray(p) / sig) ** 2)
                 - 0.5 * D * np.log(2 * np.pi * sig ** 2))


def _logprior_host(p):
    return float(-0.5 * np.sum((np.asarray(p) / S_PRIOR) ** 2)
                 - 0.5 * D * np.log(2 * np.pi * S_PRIOR ** 2))


def _logl_jax(p, sig=PT_SIG):
    return (-0.5 * jnp.sum((p / sig) ** 2)
            - 0.5 * D * jnp.log(2 * jnp.pi * sig ** 2))


def _logprior_jax(p):
    return (-0.5 * jnp.sum((p / S_PRIOR) ** 2)
            - 0.5 * D * jnp.log(2 * jnp.pi * S_PRIOR ** 2))


def _pt_pattern(pt, iters):
    """The reference's PTSampler use: burn-in loop, reset, resume with
    lnprob0 and lnlike0, thin=2; returns the shapes it saw."""
    ntemps, nwalkers = pt.ntemps, pt.nwalkers
    p0 = 1e-3 * np.random.default_rng(2).standard_normal(
        (ntemps, nwalkers, D))
    n_burn, n_main = iters
    for p, lnp, lnl in pt.sample(p0, iterations=n_burn):
        pass
    shapes = {"p": p.shape, "lnp": lnp.shape, "lnl": lnl.shape}
    pt.reset()
    for p, lnp, lnl in pt.sample(p, lnprob0=lnp, lnlike0=lnl,
                                 iterations=n_main, thin=2):
        pass
    shapes.update(chain=pt.chain.shape, lnlikelihood=pt.lnlikelihood.shape,
                  lnprobability=pt.lnprobability.shape,
                  flatchain=pt.flatchain.shape,
                  acceptance_fraction=pt.acceptance_fraction.shape,
                  tswap=pt.tswap_acceptance_fraction.shape)
    return shapes


@pytest.mark.parametrize("backend, iters", [("torch", (60, 400)),
                                            ("host", (30, 150))])
def test_pt_sampler_reference_pattern(backend, iters):
    """tests/test_compat_emcee.py::test_pt_sampler_reference_pattern on the
    port's two backends: the JAX shim's shapes, emcee 2's thinning rule,
    the analytic cold posterior, swaps on every rung."""
    ntemps, nwalkers = 8, 16
    logl, logp = ((_logl_torch, _logprior_torch) if backend == "torch"
                  else (_logl_host, _logprior_host))
    pt = temcee.PTSampler(ntemps, nwalkers, D, logl, logp, threads=10,
                          loglkwargs={"sig": PT_SIG}, seed=3, device="cpu")
    if backend == "host":
        with pytest.warns(UserWarning, match="host"):
            got = _pt_pattern(pt, iters)
    else:
        got = _pt_pattern(pt, iters)
    assert pt.backend == backend
    n_main = iters[1]
    assert got["p"] == (ntemps, nwalkers, D)
    assert got["lnp"] == got["lnl"] == (ntemps, nwalkers)
    # emcee 2 stores iterations 0, thin, 2*thin, ... -> ceil(N/thin) rows
    assert got["chain"] == (ntemps, nwalkers, -(-n_main // 2), D)
    assert got["lnlikelihood"] == got["lnprobability"] == (
        ntemps, nwalkers, -(-n_main // 2))
    assert pt.chain.dtype == pt.lnlikelihood.dtype == np.float64
    zero_temp = pt.chain[0].reshape(-1, D)   # the reference's slicing
    assert np.all(np.abs(zero_temp.mean(axis=0)) < 0.25)
    assert np.all(np.abs(zero_temp.std(axis=0) - POST_STD) < 0.25)
    tswap = pt.tswap_acceptance_fraction
    assert tswap.shape == (ntemps,)
    assert np.all(tswap > 0.05) and np.all(tswap <= 1.0)
    # lnprobability is the tempered posterior, logp + beta logl
    np.testing.assert_allclose(
        pt.lnprobability[..., -1],
        np.array([[_logprior_host(w) for w in rung]
                  for rung in pt.chain[..., -1, :]])
        + pt.betas[:, None] * pt.lnlikelihood[..., -1], rtol=1e-5)


def test_pt_sampler_shapes_match_the_jax_shim():
    """The same calls on the port's torch backend and the JAX shim's jax
    backend give the same attribute shapes."""
    port = temcee.PTSampler(4, 8, D, _logl_torch, _logprior_torch, seed=1,
                            device="cpu")
    jshim = jemcee.PTSampler(4, 8, D, _logl_jax, _logprior_jax, seed=1)
    assert _pt_pattern(port, (3, 5)) == _pt_pattern(jshim, (3, 5))
    assert port.iterations == jshim.iterations == 5


def test_pt_ti_evidence_via_shim():
    ntemps, nwalkers = 16, 32
    pt = temcee.PTSampler(ntemps, nwalkers, D, _logl_torch, _logprior_torch,
                          seed=5, device="cpu")
    p0 = np.random.default_rng(4).standard_normal(
        (ntemps, nwalkers, D)) * S_PRIOR
    for _ in pt.sample(p0, iterations=500):
        pass
    ln_z, d_ln_z = pt.thermodynamic_integration_log_evidence(fburnin=0.3)
    lnz_true = D * (-0.5 * np.log(2 * np.pi * (PT_SIG ** 2 + S_PRIOR ** 2)))
    assert abs(ln_z - lnz_true) < 0.2
    assert 0.0 < d_ln_z < 0.5


def test_pt_auto_lets_the_probe_s_errors_reach_the_caller(monkeypatch):
    """'auto' swallows nothing: a log-likelihood that raises on the batch
    of walkers (as a device launch that fails would) raises to the caller
    with a note that names backend='host', and no backend is chosen.  The
    refusals: an unknown backend, odd walkers, a wrong ladder, and the
    default device without a GPU."""
    class LaunchFailed(RuntimeError):
        pass

    def failing(p):
        raise LaunchFailed("CUDA error: launch failed")

    pt = temcee.PTSampler(3, 8, D, failing, _logprior_torch, device="cpu")
    with pytest.raises(LaunchFailed) as info:
        next(iter(pt.sample(np.zeros((3, 8, D)), iterations=1)))
    assert any("backend='host'" in note for note in info.value.__notes__)
    assert pt.backend is None
    pt = temcee.PTSampler(3, 8, D, _logl_host, _logprior_host,
                          backend="torch", device="cpu")
    with pytest.raises(TypeError, match=r"\(N, D\) tensor"):
        next(iter(pt.sample(np.zeros((3, 8, D)), iterations=1)))
    with pytest.raises(ValueError, match="auto\|torch\|host"):
        temcee.PTSampler(3, 8, D, _logl_torch, _logprior_torch,
                         backend="jax")
    with pytest.raises(ValueError, match="even"):
        temcee.PTSampler(3, 7, D, _logl_torch, _logprior_torch,
                         device="cpu")
    with pytest.raises(ValueError, match="ntemps"):
        temcee.PTSampler(3, 8, D, _logl_torch, _logprior_torch,
                         betas=[1.0, 0.5], device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    temcee.PTSampler(3, 8, D, _logl_host, _logprior_host, backend="host")
    with pytest.raises(RuntimeError, match="CUDA GPU"):
        temcee.PTSampler(3, 8, D, _logl_torch, _logprior_torch)
