"""The port's beam sources ('skewnorm', 'gaussian', the lognorm redraw
rounds), pdfs and the CsI-2016 preset against scipy and the JAX package,
on the CPU.

* The laws in distribution: the port's draws against scipy (KS p > 1e-3)
  and against the JAX package's draws (two-sample KS p > 1e-3), fixed
  seeds, 40k draws.
* The deterministic cores exactly: the skew-normal core against the JAX
  package's ``skewnorm_rvs`` on the same normals, the redraw core against
  the JAX package's semantics (first positive draw, stragglers keep the
  last) on the same normals; the ``scale <= 0`` fallback.
* lognorm / skewnorm pdfs against scipy and the JAX package.
* The csi2016 single-run spectrum on shared initial energies against the
  JAX package's ``tof_spectrum`` (the JAX side transports with the
  closed-form dE/dx of kernel K4, as the port does), and the PPC on a
  skewnorm-era chain (the JAX package's
  ``tests/test_beam_sources.py::test_ppc_on_skewnorm_era_chain``).
* ``zero_degree='none'`` with ``add_half_zero_deg``: the lattice equals
  the JAX package's ``cell_tof_lattice`` bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import mcmctoffitting_tpu.ops.pallas_forward as jpallas_forward
from mcmctoffitting_tpu.models import csi2016 as jcsi
from mcmctoffitting_tpu.models import forward as jforward
from mcmctoffitting_tpu.ops import pdfs as jpdfs
from mcmctoffitting_tpu.ops import stopping as jstopping
from mcmctoffitting_tpu_torch.models import csi2016 as tcsi
from mcmctoffitting_tpu_torch.models import forward as tforward
from mcmctoffitting_tpu_torch.models import simult as tsimult
from mcmctoffitting_tpu_torch.ops import pdfs as tpdfs
from mcmctoffitting_tpu_torch.utils.ppc import PPCSampler

torch.set_num_threads(1)

N = 40_000


def _port_draws(spec, params, seed):
    fwd = tforward.TofForward(spec, (100.0,),
                              (tcsi.tof_windows["mid"],), device="cpu")
    e = fwd.sample_beam_energies(
        torch.as_tensor(np.asarray([params], np.float32)),
        torch.Generator().manual_seed(seed), n=N)
    return e[0, 0].numpy()


def _jax_draws(spec, params, seed):
    return np.asarray(jforward.sample_beam_energies(
        jax.random.PRNGKey(seed), spec, jnp.asarray(params, jnp.float32),
        n=N))


SOURCES = {
    # name: (port spec, JAX spec, params, scipy law or None)
    "skewnorm": (dict(), dict(), [900.0, 0.05, 2.0, 1.0],
                 st.skewnorm(a=2.0, loc=900.0, scale=45.0)),
    "gaussian": (dict(beam_source="gaussian"), dict(beam_source="gaussian"),
                 [1000.0, 0.08, 0.0, 0.0], st.norm(1000.0, 80.0)),
}


@pytest.mark.parametrize("name", list(SOURCES))
def test_law_against_scipy_and_the_jax_draws(name):
    tkw, jkw, params, law = SOURCES[name]
    tspec = dataclasses.replace(tcsi.default_spec(N), **tkw)
    jspec = dataclasses.replace(jcsi.default_spec(N), **jkw)
    got = _port_draws(tspec, params, 1)
    assert st.kstest(got, law.cdf).pvalue > 1e-3
    assert st.ks_2samp(got, _jax_draws(jspec, params, 2)).pvalue > 1e-3


def test_skewnorm_core_equals_the_jax_arithmetic(monkeypatch):
    """The JAX package's skewnorm_rvs on the given normals (its two
    jax.random.normal calls replaced for the call) and the port's core."""
    rng = np.random.default_rng(3)
    u0, v = rng.standard_normal((2, 5000)).astype(np.float32)
    a, loc, scale = (jnp.float32(x) for x in (-3.0, 1234.5, 61.7))
    calls = iter((u0, v))
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape=(), dtype=None: jnp.asarray(
                            next(calls)))
    want = np.asarray(jpdfs.skewnorm_rvs(jax.random.PRNGKey(0), (5000,),
                                         a=a, loc=loc, scale=scale))
    monkeypatch.undo()
    got = tpdfs.skewnorm_from_normals(
        torch.as_tensor(u0), torch.as_tensor(v), torch.tensor(-3.0),
        torch.tensor(1234.5), torch.tensor(61.7)).numpy()
    np.testing.assert_array_equal(got, want)


def test_skewnorm_fallback_where_the_scale_is_not_positive():
    """sigma0 = 0: the reference's fallback, a normal of scale 1 around
    e0 (the JAX package the same): finite draws, mean at e0; a walker with
    a positive scale beside it keeps its skew normal."""
    spec = tcsi.default_spec(N)
    params = torch.tensor([[900.0, 0.0, 2.0, 1.0], [900.0, 0.05, 2.0, 1.0]])
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (3, 2, 1, N)).astype(np.float32))
    e = tforward.beam_energies_from_draws(spec, u, params)[:, 0].numpy()
    assert np.isfinite(e).all()
    np.testing.assert_array_equal(e[0], 900.0 + u[2, 0, 0].numpy())
    assert abs(e[0].mean() - 900.0) < 0.05
    np.testing.assert_array_equal(e[1], tpdfs.skewnorm_from_normals(
        u[0, 1, 0], u[1, 1, 0], 2.0, 900.0, torch.tensor(45.0)).numpy())
    jdraws = _jax_draws(jcsi.default_spec(N), [900.0, 0.0, 2.0, 1.0], 5)
    assert np.isfinite(jdraws).all() and abs(jdraws.mean() - 900.0) < 0.05


def test_redraw_rounds():
    """n_redraw_rounds = 3 at parameters with a 28% negative tail: the core
    keeps the first positive draw of each sample and the stragglers their
    last one; in distribution equal to the JAX package's redraw."""
    params = [1000.0, 800.0, 150.0, 0.5]
    base = tsimult.default_spec(N, transport="rk4", sampling="mc")
    tspec = dataclasses.replace(base, n_redraw_rounds=3)
    rng = np.random.default_rng(6)
    z = rng.standard_normal((4, 1, 1, 2000)).astype(np.float32)
    got = tforward.beam_energies_from_draws(
        tspec, torch.as_tensor(z), torch.tensor([params]))[0, 0].numpy()
    p = torch.tensor(params)[:, None]
    draws = [tpdfs.beam_energies_from_uniforms(
        torch.as_tensor(zk[0]), *p, False)[0].numpy() for zk in z]
    want = draws[0]
    for fresh in draws[1:]:
        want = np.where(want <= 0, fresh, want)
    np.testing.assert_array_equal(got, want)
    assert (draws[0] <= 0).mean() > 0.2 and (got <= 0).mean() < 0.02
    port = _port_draws(tspec, params, 7)
    jspec = dataclasses.replace(
        jcsi.default_spec(N), beam_source="lognorm", n_redraw_rounds=3)
    assert st.ks_2samp(port, _jax_draws(jspec, params, 8)).pvalue > 1e-3


def test_pdfs_against_scipy_and_the_jax_package():
    x = np.linspace(-50.0, 3000.0, 400).astype(np.float32)
    got = tpdfs.lognorm_pdf(torch.as_tensor(x), 0.5, 100.0, 300.0).numpy()
    np.testing.assert_allclose(got, st.lognorm(0.5, 100.0, 300.0).pdf(x),
                               rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(got, np.asarray(jpdfs.lognorm_pdf(
        x, 0.5, 100.0, 300.0)), rtol=1e-6, atol=1e-12)
    got = tpdfs.skewnorm_pdf(torch.as_tensor(x), 3.0, 900.0, 80.0).numpy()
    np.testing.assert_allclose(got, st.skewnorm(3.0, 900.0, 80.0).pdf(x),
                               rtol=1e-4, atol=1e-10)
    np.testing.assert_allclose(got, np.asarray(jpdfs.skewnorm_pdf(
        x, 3.0, 900.0, 80.0)), rtol=1e-6, atol=1e-9)
    draws = tpdfs.lognorm_rvs(torch.Generator().manual_seed(9), 0.5, 100.0,
                              300.0, (N,), device="cpu").numpy()
    assert st.kstest(draws, st.lognorm(0.5, 100.0, 300.0).cdf).pvalue > 1e-3
    draws = tpdfs.skewnorm_rvs(torch.Generator().manual_seed(10), (N,), 3.0,
                               900.0, 80.0, device="cpu").numpy()
    # the reference scales both normals: the law is skewnorm(a, loc, scale)
    assert st.kstest(draws, st.skewnorm(3.0, 900.0, 80.0).cdf).pvalue > 1e-3


def test_spec_rules():
    """An unknown beam source is the JAX package's ValueError; the
    closed-form estimators need the lognorm source."""
    spec = tcsi.default_spec(16)
    with pytest.raises(ValueError, match="beam_source"):
        dataclasses.replace(spec, beam_source="cauchy")
    with pytest.raises(ValueError, match="lognorm"):
        dataclasses.replace(spec, e0_mean_mode="expected")
    counts = tsimult.default_spec(4096, sampling="counts", fine_grid=64)
    with pytest.raises(ValueError, match="lognorm"):
        dataclasses.replace(counts, beam_source="gaussian")


def _closed_form_rk4(monkeypatch):
    a, p, q = jpallas_forward.bethe_closed_form_constants(
        jstopping.d2_gas_stopping(rho=8.565e-5))
    rk4 = jstopping.rk4_transport
    monkeypatch.setattr(
        jforward, "rk4_transport",
        lambda dedx_fn, e0, x_eval, n_substeps=4: rk4(
            lambda e: -(a / e) * (p + q * jnp.log(e)), e0, x_eval,
            n_substeps=n_substeps))


def test_csi2016_spectrum_on_shared_energies(monkeypatch):
    """run_spectrum of every run, 3 walkers, the same 4000 initial
    energies per (walker, run) on both sides: within 1e-4 relative L1
    (rint'd lattice cells may land one draw apart)."""
    _closed_form_rk4(monkeypatch)
    n = 4000
    rng = np.random.default_rng(11)
    thetas = np.array([[900.0, 0.05, 1.0, 1e4], [880.0, 0.06, 2.0, 2e4],
                       [920.0, 0.04, -1.0, 5e3]], np.float32)
    e0 = (thetas[:, None, 0:1] + thetas[:, None, 0:1] * thetas[:, None, 1:2]
          * rng.standard_normal((3, 4, n))).astype(np.float32)
    jprob = jcsi.Csi2016Problem(jcsi.default_spec(n), n_runs=4)
    tprob = tcsi.Csi2016Problem(tcsi.default_spec(n), n_runs=4, device="cpu")
    for run in range(4):
        monkeypatch.setattr(
            tforward.TofForward, "sample_beam_energies",
            lambda self, params, generator, n_runs=None, n=None, r=run:
            torch.as_tensor(e0[:, r:r + 1]))
        got = tprob.run_spectrum(torch.Generator(), torch.as_tensor(thetas),
                                 run).numpy()
        for w in range(3):
            monkeypatch.setattr(jforward, "sample_beam_energies",
                                lambda key, spec, params, n=0, w=w, r=run:
                                jnp.asarray(e0[w, r]))
            want = np.asarray(jprob.run_spectrum(
                jax.random.PRNGKey(0), jnp.asarray(thetas[w]), run))
            l1 = np.abs(got[w] - want).sum() / np.abs(want).sum()
            assert l1 < 1e-4, (run, w, l1)


def test_ppc_on_skewnorm_era_chain():
    """PPC on an old-campaign (skewnorm-parameterized) chain through the
    port's forward: spectra of every run and the weight grids, finite."""
    spec = tcsi.default_spec(n_samples=2000)
    problem = tcsi.Csi2016Problem(spec, n_runs=2, device="cpu")
    rng = np.random.default_rng(5)
    center = np.array([900.0, 0.05, 1.0, 1e4])
    scales = np.array([10.0, 0.005, 0.2, 500.0])
    chain = center + scales * rng.standard_normal((40, 6, 4))
    probs = -500.0 + rng.standard_normal((40, 6))
    result = PPCSampler(problem, chain, probs).generate(
        torch.Generator().manual_seed(6), n_draws=3)
    assert len(result.tof_spectra) == 2
    assert result.tof_spectra[0].shape == (3, problem.windows[0].n_bins)
    assert result.neutron_spectra.shape == (3, spec.x_binning.n,
                                            spec.ed_binning.n)
    for s in result.tof_spectra:
        assert np.isfinite(s).all() and np.all(s.sum(-1) > 0)
    assert result.neutron_spectra.sum() > 0


def test_no_zero_degree_and_the_detector_half_length():
    """zero_degree='none' with add_half_zero_deg: the port's lattice of
    every (x, eD) cell equals the JAX package's cell_tof_lattice bit for
    bit, one segment of time 0 and weight 1."""
    tspec = dataclasses.replace(tcsi.default_spec(1000), zero_degree="none",
                                add_half_zero_deg=True)
    jspec = dataclasses.replace(jcsi.default_spec(1000), zero_degree="none",
                                add_half_zero_deg=True)
    prob = tcsi.Csi2016Problem(tspec, n_runs=4, device="cpu")
    fwd = prob.forward
    assert fwd.zt.shape == (100, 1) and torch.all(fwd.zt == 0)
    assert torch.all(fwd.zw == 1)
    means = torch.tensor([[870.5, 901.25, 888.0, 912.0]])
    got = fwd.cell_tof_lattice(means)[0].numpy()
    for r, standoff in enumerate(prob.standoffs):
        want = np.asarray(jforward.cell_tof_lattice(
            jspec, standoff, jnp.float32(means[0, r].item())))
        np.testing.assert_array_equal(got[r], want)
